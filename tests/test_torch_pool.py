"""noize_tpu_torch pool automata (erosion/pool, K4's module
erosion/pool_cuda) against noize_tpu on the same inputs.

Tolerance: bit-exact against the reference's compiled XLA path — the pool
arithmetic has no multiply-add for XLA's CPU backend to contract, and
tests/test_pallas.py holds the TPU kernels K4 replaces bit-exact to that
path.  Here, on the CPU, the wrapper runs the plain version.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from noize_tpu.erosion import pool as JP
from noize_tpu.erosion import pool_pallas as JPP
from noize_tpu_torch.erosion import pool as TP
from noize_tpu_torch.erosion.pool_cuda import pool_automata_cuda


def _wet(res, seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = rng.uniform(-0.05, 0.05, (res, res)).clip(0).astype(np.float32)
    return h, p


def _run_both(h, p, iters, drain):
    wp, wd = JP.pool_automata(jnp.asarray(h), jnp.asarray(p), iterations=iters,
                              drain_particles=drain)
    gp, gd = pool_automata_cuda(torch.from_numpy(h), torch.from_numpy(p), iters, drain)
    return (gp.numpy(), gd.numpy()), (np.asarray(wp), np.asarray(wd))


@pytest.mark.parametrize("res,iters,drain", [(128, 2, True), (128, 3, False),
                                             (32, 10, True), (17, 2, True)])
def test_wet_pool_bit_exact(res, iters, drain):
    h, p = _wet(res, res + iters)
    (gp, gd), (wp, wd) = _run_both(h, p, iters, drain)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    assert not np.array_equal(gp, p)
    if drain:
        assert (wd > 0).sum() > 0  # drains really fired


def test_border_touching_pool_bit_exact():
    """Water only on the four border bands: every SafeIdx self-return
    (up/down/left/right) path carries real volume."""
    rng = np.random.default_rng(11)
    res = 64
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = np.zeros((res, res), np.float32)
    for sl in (np.s_[:2, :], np.s_[-2:, :], np.s_[:, :2], np.s_[:, -2:]):
        p[sl] = rng.uniform(0, 0.05, p[sl].shape).astype(np.float32)
    (gp, gd), (wp, wd) = _run_both(h, p, 3, True)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    assert not np.array_equal(gp[0], p[0]) and not np.array_equal(gp[:, -1], p[:, -1])


def test_dry_gate_fixed_point():
    rng = np.random.default_rng(12)
    res = 128
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = rng.uniform(0, JP.MIN_WATER * 0.99, (res, res)).astype(np.float32)
    (gp, gd), (wp, wd) = _run_both(h, p, 4, True)
    np.testing.assert_array_equal(gp, p)
    np.testing.assert_array_equal(wp, p)
    assert not gd.any() and not wd.any()
    assert TP.MIN_WATER == JP.MIN_WATER


def test_matches_pallas_mega_kernel_interpret():
    h, p = _wet(32, 21)
    with pltpu.force_tpu_interpret_mode():
        wp, wd = JPP.pool_automata_pallas_mega(
            jnp.asarray(h), jnp.asarray(p), iterations=2, drain_particles=True,
            block=8, phases_per_launch=4)
    gp, gd = pool_automata_cuda(torch.from_numpy(h), torch.from_numpy(p), 2, True)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_cpu_wrapper_launches_nothing():
    h, p = _wet(16, 3)
    before = pool_automata_cuda.launches
    pool_automata_cuda(torch.from_numpy(h), torch.from_numpy(p), 1, True)
    assert pool_automata_cuda.launches == before


def _quad_both(h, p, iters, drain):
    wp, wd = JP.pool_automata_quad(jnp.asarray(h), jnp.asarray(p), iterations=iters,
                                   drain_particles=drain)
    gp, gd = TP.pool_automata_quad(torch.from_numpy(h), torch.from_numpy(p), iters, drain)
    return (gp.numpy(), gd.numpy()), (np.asarray(wp), np.asarray(wd))


@pytest.mark.parametrize("res", [8, 12, 64, 128])
@pytest.mark.parametrize("drain", [True, False])
def test_pool_automata_quad_bit_exact(res, drain):
    """The quadrant entry against the reference's ``pool_automata_quad``
    (its own diagonal-quadrant XLA path), wet, bit for bit."""
    h, p = _wet(res, 40 + res)
    (gp, gd), (wp, wd) = _quad_both(h, p, 3, drain)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    assert not np.array_equal(gp, p)
    if drain:
        assert (wd > 0).sum() > 0


@pytest.mark.parametrize("wetness", ["dry", "below-min-water"])
def test_pool_automata_quad_gate(wetness):
    """The reference gates each step on any(pool > 0), the port each call
    on MIN_WATER: a dry pool and one whose every wet cell lies in
    (0, MIN_WATER) are fixed points either way."""
    rng = np.random.default_rng(13)
    res = 32
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = np.zeros((res, res), np.float32)
    if wetness != "dry":
        p = rng.uniform(0, JP.MIN_WATER, (res, res)).astype(np.float32)
        p[rng.uniform(size=p.shape) < 0.3] = 0.0
        assert (p > 0).any() and p.max() < JP.MIN_WATER
    (gp, gd), (wp, wd) = _quad_both(h, p, 4, True)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gp, p)
    assert not gd.any()


@pytest.mark.parametrize("res", [6, 7, 10])
def test_pool_automata_quad_shape_rule(res):
    """The reference runs only where the side is a multiple of 4 (it fails
    in a reshape elsewhere); the port raises ValueError naming the rule."""
    h, p = _wet(res, 5)
    with pytest.raises(TypeError):
        JP.pool_automata_quad(jnp.asarray(h), jnp.asarray(p), iterations=1)
    with pytest.raises(ValueError, match="multiple of 4"):
        TP.pool_automata_quad(torch.from_numpy(h), torch.from_numpy(p), 1, True)


def test_pool_automata_quad_cpu_launches_nothing():
    h, p = _wet(16, 9)
    before = pool_automata_cuda.launches
    TP.pool_automata_quad(torch.from_numpy(h), torch.from_numpy(p), 2, True)
    assert pool_automata_cuda.launches == before == 0
