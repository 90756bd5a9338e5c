"""noize_tpu_torch blur (kernels, blur, K1's module ops/cuda/stencil)
against noize_tpu on the same inputs.

Tolerances:
  * bit-exact against JAX evaluated one primitive at a time
    (``jax.disable_jit()``) — every float32 op rounded on its own, as on
    the TPU and in K1 (built with -fmad=false);
  * against the jitted CPU program, ≤ 2 ulp-scale (atol 1e-6 on [0, 1]
    data): XLA's CPU backend contracts the tap multiply-adds into FMAs
    (ROADMAP.md §3);
  * against the Pallas kernel in interpret mode, atol 1e-5 — the bound
    tests/test_pallas.py holds that kernel to against the XLA chain.
Here, on the CPU, the wrappers run their plain versions.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.app import flagship as JFL
from noize_tpu.ops import blur as JB
from noize_tpu.ops import kernels as JK
from noize_tpu.ops.pallas import stencil as JS
from noize_tpu_torch.ops import blur as TB
from noize_tpu_torch.ops import kernels as TK
from noize_tpu_torch.ops.cuda import stencil as TS


def _field(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


@pytest.mark.parametrize("sigma,width", [(1.0, 5), (2.0, 9), (0.5, 3), (1.5, 25)])
def test_gaussian_taps_identical(sigma, width):
    np.testing.assert_array_equal(TK.gaussian_taps(sigma, width),
                                  JK.gaussian_taps(sigma, width))


def test_limit_width_and_sigma_value():
    for w in range(0, 40):
        assert TB.limit_width(w) == JB.limit_width(w)
    for s in ("s0d50", "s2d50", "s8d00", 0, 3, 15, 1.25, 7.0):
        assert TB.sigma_value(s) == JB.sigma_value(s)


@pytest.mark.parametrize("taps", [JK.gaussian_taps(1.0, 5),
                                  np.array([1.0, 2.0, -3.0], np.float32)])
def test_conv_passes_bit_exact(taps):
    a = _field(0, (40, 56))
    with jax.disable_jit():
        wx = np.asarray(JK.conv_x(jnp.asarray(a), jnp.asarray(taps)))
        wz = np.asarray(JK.conv_z(jnp.asarray(a), jnp.asarray(taps)))
        ws = np.asarray(JK.separable_series(jnp.asarray(a), jnp.asarray(taps),
                                            jnp.asarray(taps[::-1].copy()), 1.0))
    t = torch.from_numpy(a)
    np.testing.assert_array_equal(TK.conv_x(t, taps).numpy(), wx)
    np.testing.assert_array_equal(TK.conv_z(t, taps).numpy(), wz)
    np.testing.assert_array_equal(
        TK.separable_series(t, taps, taps[::-1].copy(), 1.0).numpy(), ws)


@pytest.mark.parametrize("res,iters", [(64, 1), (128, 17)])
def test_gauss_chain_matches_flagship_blur(res, iters):
    a = _field(1, (res, res))
    with jax.disable_jit():
        eager = np.asarray(JFL._blur_chain(jnp.asarray(a), 5, 1.0, iters))
    jitted = np.asarray(jax.jit(lambda h: JFL._blur_chain(h, 5, 1.0, iters))(a))
    before = TS.separable_chain.launches
    got = TS.gauss_chain(torch.from_numpy(a), 5, 1.0, iters).numpy()
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)
    # on the CPU the wrapper runs the plain version and launches nothing
    assert TS.separable_chain.launches == before


def test_gauss_chain_matches_pallas_kernel_interpret():
    a = _field(2, (64, 64))
    want = np.asarray(JS.gauss_chain(jnp.asarray(a), 5, "s1d00", 3, block=32,
                                     interpret=True))
    got = TS.gauss_chain(torch.from_numpy(a), 5, "s1d00", 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_separable_chain_plain_equals_wrapper_on_cpu():
    a = torch.from_numpy(_field(3, (32, 48)))
    taps = TK.gaussian_taps(2.0, 7)
    np.testing.assert_array_equal(TS.separable_chain(a, taps, 4).numpy(),
                                  TS.separable_chain_plain(a, taps, 4).numpy())
    np.testing.assert_array_equal(TS.separable_chain(a, taps, 0).numpy(), a.numpy())


@pytest.mark.parametrize("name", ["fused_separable_chain", "fused_separable_chain_rows"])
def test_stencil_entries_match_pallas_interpret(name):
    """The port's entries of TPU kernels #1 (2-D blocks) and #2 (row
    blocks) against the JAX entries in interpret mode, same tolerance as
    test_gauss_chain_matches_pallas_kernel_interpret."""
    from jax.experimental.pallas import tpu as pltpu

    a = _field(4, (64, 64))
    taps = JK.gaussian_taps(1.0, 5)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(getattr(JS, name)(jnp.asarray(a), taps, 2, block=32))
    entry = getattr(TS, name)
    before = entry.launches
    got = entry(torch.from_numpy(a), taps, 2, block=32).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got, TS.separable_chain_plain(torch.from_numpy(a), taps,
                                                                2).numpy())
    assert entry.launches == before


@pytest.mark.parametrize("width,sigma", [(5, "s1d00"), (8, 2.5), (3, 0)])
def test_gauss_and_smooth_blur_bit_exact(width, sigma):
    a = _field(5, (48, 48))
    with jax.disable_jit():
        wg = np.asarray(JB.gauss_blur(jnp.asarray(a), width, sigma))
        ws = np.asarray(JB.smooth_blur(jnp.asarray(a), width))
    np.testing.assert_array_equal(TB.gauss_blur(torch.from_numpy(a), width, sigma).numpy(), wg)
    np.testing.assert_array_equal(TB.smooth_blur(torch.from_numpy(a), width).numpy(), ws)
    np.testing.assert_array_equal(TB.smooth_taps(TB.limit_width(width)),
                                  JB.smooth_taps(JB.limit_width(width)))
