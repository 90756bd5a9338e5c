"""Every noise basis of the port (``noize_tpu_torch.ops.noise``) through
``fractal``, against ``noize_tpu`` on the same inputs, on the CPU.

Tolerances:
  * Perlin, Simplex, Cellular, DomainRotatedPerlin, DomainRotatedSimplex:
    bit-exact against JAX evaluated one primitive at a time
    (``jax.disable_jit()``), where every float32 op rounds on its own as
    in the port; the D2 branch predicates of ``cnoise3``/``snoise3`` are
    exact integer tests in both;
  * Sin, PeriodicPerlin, RotatedSimplex: 1e-4 relative only.  They call
    sin/cos, and ``torch.sin``/``torch.cos`` are other approximations than
    XLA's (measured: ≤ 1.2e-7 absolute, a few hundred cells of 128²);
  * every basis within 1e-4 relative of the compiled program (XLA
    contracts multiply-adds into FMAs; ROADMAP.md §3).
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

EXACT = ("Perlin", "Simplex", "Cellular", "DomainRotatedPerlin", "DomainRotatedSimplex")
TRIG = ("Sin", "PeriodicPerlin", "RotatedSimplex")
KW = dict(hurst=0.5, octaves=4, stepdown=1.9, detune_rate=0.03, noise_size=57.0,
          starting_amplitude=1.3)


def _rel(got, want):
    return np.abs(got.astype(np.float64) - want).max() / np.abs(want).max()


def test_every_basis_is_listed():
    assert TF.NOISE_TYPES == JF.NOISE_TYPES
    assert set(EXACT) | set(TRIG) == set(JF.NOISE_TYPES)


@pytest.mark.parametrize("kind", JF.NOISE_TYPES)
@pytest.mark.parametrize("res,xpos,zpos", [(64, 130.0, -70.0), (33, -5000.0, 12345.0)])
def test_fractal_basis_matches_reference(kind, res, xpos, zpos):
    got = TF.fractal(res, xpos, zpos, noise_type=kind, device="cpu", **KW).numpy()
    with jax.disable_jit():
        eager = np.asarray(JF.fractal(res, xpos, zpos, noise_type=kind, **KW))
    compiled = np.asarray(JF.fractal(res, xpos, zpos, noise_type=kind, **KW))
    assert got.dtype == np.float32 and got.shape == (res, res) and np.isfinite(got).all()
    if kind in EXACT:
        np.testing.assert_array_equal(got, eager)
    else:
        assert _rel(got, eager) <= 1e-4
    assert _rel(got, compiled) <= 1e-4


def test_default_basis_is_perlin():
    got = TF.fractal(32, 0.0, 0.0, device="cpu").numpy()
    with jax.disable_jit():
        want = np.asarray(JF.fractal(32, 0.0, 0.0))
    np.testing.assert_array_equal(got, want)


def _coords(seed, n=20000, scale=300.0):
    rng = np.random.default_rng(seed)
    return [rng.uniform(-scale, scale, n).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("seed,name,nargs", [(1, "cnoise2", 2), (2, "cnoise3", 3),
                                             (3, "snoise2", 2), (4, "snoise3", 3),
                                             (5, "cellular2", 2)])
def test_primitive_bit_exact_on_wide_coords(seed, name, nargs):
    args = _coords(seed)[:nargs]
    got = getattr(TN, name)(*(torch.from_numpy(a) for a in args))
    with jax.disable_jit():
        want = getattr(JN, name)(*(jnp.asarray(a) for a in args))
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("rot", [0.0, 0.62])
def test_psrnoise2_truncated_fmod(rot):
    """PARITY.md D6: negative coordinates wrap with a truncated fmod; the
    gradients' sin/cos hold the result to 1e-4 relative."""
    x, y, _ = _coords(7, scale=3000.0)
    got = TN.psrnoise2(torch.from_numpy(x), torch.from_numpy(y), 1010.0, 102.0, rot).numpy()
    with jax.disable_jit():
        want = np.asarray(JN.psrnoise2(jnp.asarray(x), jnp.asarray(y), 1010.0, 102.0, rot))
    assert _rel(got, want) <= 1e-4
