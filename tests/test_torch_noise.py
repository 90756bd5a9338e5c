"""noize_tpu_torch noise + fractal against noize_tpu on the same inputs.

Reference arithmetic: JAX evaluated one primitive at a time
(``jax.disable_jit()``), which rounds every float32 op on its own as the
TPU does.  Against it the port is bit-exact.  The jitted CPU program
differs because XLA's CPU backend contracts multiply-adds into FMAs
(ROADMAP.md §3); against it the tolerance is 1e-4 relative
(BASELINE.md's bar), measured ≤ 1e-6 here.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import fractal as JF
from noize_tpu.ops import noise as JN
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
