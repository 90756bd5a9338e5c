"""noize_tpu_torch noise + fractal against noize_tpu on the same inputs.

Reference arithmetic: JAX evaluated one primitive at a time
(``jax.disable_jit()``), which rounds every float32 op on its own as the
TPU does.  Against it the port is bit-exact.  The jitted CPU program
differs because XLA's CPU backend contracts multiply-adds into FMAs
(ROADMAP.md §3); against it the tolerance is 1e-4 relative
(BASELINE.md's bar), measured ≤ 1e-6 here.

The octave gain G = exp2(-hurst) is a host scalar: ``ops.f32.exp2``
replays XLA's CPU runtime exp2 (the value eager and traced-hurst JAX
take), bit for bit; PyTorch's exp2 differs by an ulp at ~20% of hurst
values, 0.9 among them (ROADMAP.md §3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import fractal as JF
from noize_tpu.ops import noise as JN
from noize_tpu_torch.ops import f32 as F32
from noize_tpu_torch.ops import fractal as TF
from noize_tpu_torch.ops import noise as TN


def _coords(seed, n=4096, scale=300.0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-scale, scale, n).astype(np.float32),
            rng.uniform(-scale, scale, n).astype(np.float32))


def test_snoise2_bit_exact_vs_eager_jax():
    x, y = _coords(0)
    with jax.disable_jit():
        want = np.asarray(JN.snoise2(jnp.asarray(x), jnp.asarray(y)))
    got = TN.snoise2(torch.from_numpy(x), torch.from_numpy(y)).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.abs(got).max() > 0.5


def test_snoise2_helpers_bit_exact():
    v = np.random.default_rng(1).uniform(0, 5000, 2048).astype(np.float32)
    t = torch.from_numpy(v)
    with jax.disable_jit():
        for jf, tf in ((JN._mod289, TN._mod289), (JN._permute, TN._permute),
                       (JN._taylor_inv_sqrt, TN._taylor_inv_sqrt)):
            np.testing.assert_array_equal(tf(t).numpy(), np.asarray(jf(jnp.asarray(v))))


@pytest.mark.parametrize("res,octaves,xpos,zpos", [(64, 8, 0.0, 0.0),
                                                   (48, 13, 123.0, -77.0)])
def test_fractal_simplex_matches(res, octaves, xpos, zpos):
    kw = dict(noise_type="Simplex", hurst=0.4, octaves=octaves, noise_size=170.0)
    with jax.disable_jit():
        eager = np.asarray(JF.fractal(res, xpos, zpos, **kw))
    jitted = np.asarray(JF.fractal(res, xpos, zpos, **kw))
    got = TF.fractal(res, xpos, zpos, device="cpu", **kw).numpy()
    assert got.shape == (res, res) and got.dtype == np.float32
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=1e-4, atol=0)


def test_fractal_norm_value_and_noise_types():
    assert TF.NOISE_TYPES == JF.NOISE_TYPES
    for h, o in ((0.4, 13), (0.0, 1), (1.0, 24)):
        assert TF.fractal_norm_value(h, o) == JF.fractal_norm_value(h, o)


@pytest.mark.parametrize("kind", [k for k in JF.NOISE_TYPES if k != "Simplex"])
def test_unported_bases_raise(kind):
    """The bases the first slice left unported now evaluate: bit-exact
    against eager JAX, or within 1e-4 relative where they call sin/cos
    (``torch.sin``/``cos`` approximate differently from XLA's; see
    tests/test_torch_noise_bases.py); an unknown basis still raises."""
    x, y = _coords(11)
    got = TF.noise_value(kind, torch.from_numpy(x), torch.from_numpy(y)).numpy()
    with jax.disable_jit():
        want = np.asarray(JF.noise_value(kind, jnp.asarray(x), jnp.asarray(y)))
    if kind in ("Sin", "PeriodicPerlin", "RotatedSimplex"):
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max()
    else:
        np.testing.assert_array_equal(got, want)
    z = torch.zeros(4)
    with pytest.raises(ValueError):
        TF.noise_value("Bogus", z, z)


def test_gain_exp2_bit_exact_vs_jax_runtime():
    """G = exp2(-hurst) at 2**20 float32 hurst values in [0, 2] (the
    NoiseStage range) against ``jnp.exp2`` on the XLA runtime."""
    rng = np.random.default_rng(20)
    hurst = rng.uniform(0, 2, 1 << 20).astype(np.float32)
    hurst[:2001] = np.arange(2001) / np.float32(1000)
    want = np.asarray(jnp.exp2(-jnp.asarray(hurst)))
    np.testing.assert_array_equal(F32.exp2(-hurst), want)
    assert F32.exp2(np.float32(-0.9)) == want[900]


#: hurst values where PyTorch's exp2 (the port's earlier gain) is an ulp off
#: the reference's, plus 0.7635; 0.059 and 0.123 also differ from the value
#: XLA folds for a constant hurst
GAIN_HURST = [0.9, 0.7635, 0.059, 0.123]


@pytest.mark.parametrize("kind", ["Perlin", "Simplex", "Cellular"])
@pytest.mark.parametrize("hurst", GAIN_HURST)
def test_fractal_bit_exact_at_gain_sensitive_hurst(kind, hurst):
    kw = dict(noise_type=kind, hurst=hurst, octaves=6, noise_size=90.0)
    with jax.disable_jit():
        eager = np.asarray(JF.fractal(64, 31.0, -17.0, **kw))
    got = TF.fractal(64, 31.0, -17.0, device="cpu", **kw).numpy()
    np.testing.assert_array_equal(got, eager)
