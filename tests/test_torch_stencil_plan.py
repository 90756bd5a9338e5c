"""The blocking plans of K1 (``ops/cuda/stencil.chain_plan``), K2
(``ops/cuda/flow.flow_plan``) and K3 (``ops/cuda/thermal.thermal_plan``),
replayed on the CPU.

The CUDA kernels cannot run here, but what makes their tiles exact can be
checked: each launch of a plan computes every output tile from a window
that is the tile with the plan's halo, cut at the grid's edge, and clamps
its reads to that window (K3: decides coverage on grid coordinates).  The
replay does the same with the plain versions (which clamp at the edge of
what they are given) and must equal the whole-grid plain result bit for
bit, and the JAX reference evaluated one primitive at a time.  A halo one
cell short must not.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import flow as JF
from noize_tpu.ops import kernels as JK
from noize_tpu.ops import thermal as JT
from noize_tpu_torch.ops import flow as TF
from noize_tpu_torch.ops import thermal as TT
from noize_tpu_torch.ops.blur import smooth_taps
from noize_tpu_torch.ops.cuda import flow as TC
from noize_tpu_torch.ops.cuda import stencil as TS
from noize_tpu_torch.ops.cuda import thermal as TH
from noize_tpu_torch.ops.kernels import gaussian_taps


def _field(seed, shape):
    return torch.from_numpy(np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32))


def _tiles(n, tile):
    return range(0, n, tile)


def _window(start, tile, halo, n):
    """Grid slice of a tile's window, and the tile's slice inside it."""
    lo, hi = max(0, start - halo), min(n, start + tile + halo)
    return slice(lo, hi), slice(start - lo, min(n, start + tile) - lo)


def replay_chain(x, taps, plan, shrink=0):
    """K1's plan on windows: each launch runs its iterations of the plain
    chain on every tile's window and keeps the tile."""
    rows, cols = x.shape
    tz, tx = plan.tile
    for m, halo in zip(plan.launches, plan.halos):
        halo -= shrink
        out = torch.empty_like(x)
        for z in _tiles(rows, tz):
            wz, iz = _window(z, tz, halo, rows)
            for c in _tiles(cols, tx):
                wx, ix = _window(c, tx, halo, cols)
                part = TS.separable_chain_plain(x[wz, wx], taps, m)
                out[z:z + tz, c:c + tx] = part[iz, ix]
        x = out
    return x


def replay_flow(height, plan, norm_min=-0.1, norm_max=0.1, shrink=0):
    """K2's plan on windows: each launch carries water and the four flows
    through its iterations on every tile's window, the last computes
    velocity and the normalise on its tiles."""
    res = height.shape[0]
    state = [torch.full_like(height, TF.WATER_INIT)] + [torch.zeros_like(height)] * 4
    n = len(plan.launches)
    for i, (m, halo, tile) in enumerate(zip(plan.launches, plan.halos, plan.tiles)):
        halo -= shrink
        last = i == n - 1
        nxt = [torch.empty_like(height) for _ in range(1 if last else 5)]
        for z in _tiles(res, tile):
            wz, iz = _window(z, tile, halo, res)
            for c in _tiles(res, tile):
                wx, ix = _window(c, tile, halo, res)
                h = height[wz, wx]
                w, fw, fe, fs, fn = (s[wz, wx] for s in state)
                for _ in range(m):
                    fw, fe, fs, fn = TF.compute_flow_step(h, w, fw, fe, fs, fn)
                    w = TF.update_water_step(w, fw, fe, fs, fn)
                if last:
                    v = TF.velocity_field(fw, fe, fs, fn)
                    lo, rng = TF.norm_params(norm_min, norm_max)
                    if rng < np.float32(1e-12):
                        v = torch.zeros_like(v)
                    parts = [(v - float(lo)) / torch.tensor(float(rng))]
                else:
                    parts = [w, fw, fe, fs, fn]
                for dst, part in zip(nxt, parts):
                    dst[z:z + tile, c:c + tile] = part[iz, ix]
        state = nxt
    return state[0]


def test_chain_plan_splits():
    p = TS.chain_plan(5, 17, halo=12)
    assert (p.launches, p.halos, p.tile) == ((6, 6, 5), (12, 12, 10), TS.TILE)
    assert TS.chain_plan(5, 6, halo=12).launches == (6,)
    assert TS.chain_plan(5, 7, halo=12).launches == (4, 3)
    assert TS.chain_plan(3, 32, halo=12).launches == (11, 11, 10)
    assert TS.chain_plan(25, 3).launches == (1, 1, 1)
    assert TS.chain_plan(25, 3).halos == (12, 12, 12)
    assert TS.chain_plan(1, 32).launches == (32,)
    assert TS.chain_plan(1, 32).halos == (0,)
    assert TS.chain_plan(5, 0).launches == ()
    for k in range(1, 26, 2):
        off = (k - 1) // 2
        for it in (1, 5, 17, 32):
            p = TS.chain_plan(k, it)
            assert sum(p.launches) == it
            assert max(p.halos) <= max(TS.HALO, off)
            assert max(p.launches) - min(p.launches) <= 1


def test_flow_plan_splits():
    p = TC.flow_plan(8, per_launch=8, region=96)
    assert (p.launches, p.halos, p.tiles) == ((8,), (16,), (64,))
    p = TC.flow_plan(17, per_launch=8)
    assert (p.launches, p.halos) == ((6, 6, 5), (12, 12, 10))
    p = TC.flow_plan(0)
    assert (p.launches, p.halos, p.tiles) == ((0,), (0,), (TC.REGION,))
    assert TC.flow_plan(128, per_launch=8).launches == (8,) * 16
    assert TC.flow_plan(9, per_launch=8).launches == (5, 4)
    for it in (1, 5, 8, 17, 128):
        p = TC.flow_plan(it)
        assert sum(p.launches) == it and max(p.launches) <= TC.PER_LAUNCH
        assert p.tiles == tuple(TC.REGION - 4 * m for m in p.launches)
    with pytest.raises(ValueError, match="no tile"):
        TC.flow_plan(24, per_launch=24, region=64)


@pytest.mark.parametrize("k,taps", [(1, "gauss"), (3, "box"), (5, "gauss"), (7, "box"),
                                    (9, "gauss"), (25, "gauss")])
@pytest.mark.parametrize("iterations", [1, 6, 7, 17])
def test_chain_plan_replay_is_exact(k, taps, iterations):
    x = _field(k + iterations, (37, 50))
    t = gaussian_taps(1.5, k) if taps == "gauss" else smooth_taps(k)
    plan = TS.chain_plan(k, iterations, tile=(8, 16))
    want = TS.separable_chain_plain(x, t, iterations)
    np.testing.assert_array_equal(replay_chain(x, t, plan).numpy(), want.numpy())


@pytest.mark.parametrize("shape", [(1, 40), (40, 1), (3, 5), (16, 16), (17, 33)])
def test_chain_plan_replay_edge_shapes(shape):
    x = _field(sum(shape), shape)
    t = gaussian_taps(1.0, 5)
    plan = TS.chain_plan(5, 17, tile=(8, 8))
    want = TS.separable_chain_plain(x, t, 17)
    np.testing.assert_array_equal(replay_chain(x, t, plan).numpy(), want.numpy())


def test_chain_plan_replay_matches_jax():
    x = _field(5, (30, 41))
    t = gaussian_taps(1.0, 5)
    with jax.disable_jit():
        want = jnp.asarray(x.numpy())
        for _ in range(7):
            want = JK.separable_series(want, t, t, 1.0)
    got = replay_chain(x, t, TS.chain_plan(5, 7, tile=(8, 8)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_chain_plan_halo_one_short_is_not_exact():
    x = _field(6, (40, 40))
    t = gaussian_taps(1.0, 5)
    plan = TS.chain_plan(5, 6, tile=(8, 8))
    want = TS.separable_chain_plain(x, t, 6)
    assert not torch.equal(replay_chain(x, t, plan, shrink=1), want)


@pytest.mark.parametrize("iterations,per_launch", [(0, 3), (1, 3), (3, 3), (4, 3), (7, 3),
                                                   (9, 4)])
def test_flow_plan_replay_is_exact(iterations, per_launch):
    h = _field(iterations, (45, 45))
    plan = TC.flow_plan(iterations, per_launch=per_launch, region=24)
    want = TF.flow_map(h, iterations)
    np.testing.assert_array_equal(replay_flow(h, plan).numpy(), want.numpy())


@pytest.mark.parametrize("res", [1, 2, 7, 23])
def test_flow_plan_replay_small_grids(res):
    h = _field(res, (res, res))
    plan = TC.flow_plan(5, per_launch=2, region=16)
    want = TF.flow_map(h, 5)
    np.testing.assert_array_equal(replay_flow(h, plan).numpy(), want.numpy())


def test_flow_plan_replay_matches_jax():
    h = _field(8, (30, 30))
    with jax.disable_jit():
        want = np.asarray(JF.flow_map(jnp.asarray(h.numpy()), iterations=5))
    got = replay_flow(h, TC.flow_plan(5, per_launch=2, region=16))
    np.testing.assert_array_equal(got.numpy(), want)


def test_flow_plan_halo_one_short_is_not_exact():
    h = _field(9, (40, 40))
    plan = TC.flow_plan(3, per_launch=1, region=12)
    want = TF.flow_map(h, 3)
    assert not torch.equal(replay_flow(h, plan, shrink=1), want)


# --- K3 ---------------------------------------------------------------------

_TALUS, _INC, _HWR = 10.0, 0.5, 1.0  # max_diff far below the field's steps


def replay_thermal(h, plan, shrink=(0, 0)):
    """K3's plan on windows: each launch runs the 4m phases of its m
    iterations of the plain masked phase on every tile's window, with the
    window's grid origin, and keeps the tile.  ``shrink`` takes (rows,
    columns) off every halo."""
    res = h.shape[0]
    md = TT.max_diff_value(_TALUS, _HWR, res)
    tz, tx = plan.tile
    for m, (hz, hx) in zip(plan.launches, plan.halos):
        hz, hx = hz - shrink[0], hx - shrink[1]
        out = torch.empty_like(h)
        for z in _tiles(res, tz):
            wz, iz = _window(z, tz, hz, res)
            for c in _tiles(res, tx):
                wx, ix = _window(c, tx, hx, res)
                part = h[wz, wx]
                for _ in range(m):
                    for x0, z0 in TT._PHASE_OFFSETS:
                        part = TT.thermal_phase_masked(part, x0, z0, wz.start, wx.start, res,
                                                       md, _INC)
                out[z:z + tz, c:c + tx] = part[iz, ix]
        h = out
    return h


def test_thermal_plan_splits():
    m = TH.PER_LAUNCH
    p = TH.thermal_plan(0)
    assert (p.launches, p.halos, p.tile, p.threads) == ((), (), TH.TILE, TH.THREADS)
    p = TH.thermal_plan(1)
    assert (p.launches, p.halos) == ((1,), ((2, 3),))
    p = TH.thermal_plan(m)
    assert (p.launches, p.halos) == ((m,), ((2 * m, 4 * m - 1),))
    p = TH.thermal_plan(m + 1)
    assert p.launches == ((m + 2) // 2, (m + 1) // 2)
    p = TH.thermal_plan(32)
    assert sum(p.launches) == 32 and max(p.launches) == m
    assert len(p.launches) == -(-32 // m) and max(p.launches) - min(p.launches) <= 1
    assert p.halos == tuple((2 * k, 4 * k - 1) for k in p.launches)
    assert TH.thermal_plan(32, per_launch=4).launches == (4,) * 8
    assert TH.thermal_plan(5, per_launch=4).launches == (3, 2)
    for tile in ((7, 8), (8, 1), (0, 4)):
        with pytest.raises(ValueError, match="even"):
            TH.thermal_plan(1, tile=tile)


@pytest.mark.parametrize("res,iterations,per_launch,tile", [
    (37, 0, 2, (8, 8)), (37, 1, 2, (8, 8)), (36, 1, 2, (8, 6)), (36, 2, 2, (6, 8)),
    (37, 3, 2, (8, 8)), (35, 5, 2, (10, 12)), (36, 4, 4, (12, 12)), (6, 3, 2, (8, 8)),
    (1, 1, 2, (8, 8)), (2, 2, 1, (4, 4)), (5, 2, 4, (2, 2)),
])
def test_thermal_plan_replay_is_exact(res, iterations, per_launch, tile):
    h = _field(res + iterations, (res, res))
    plan = TH.thermal_plan(iterations, per_launch=per_launch, tile=tile)
    want = TT.thermal_erosion(h, _TALUS, _INC, _HWR, iterations)
    np.testing.assert_array_equal(replay_thermal(h, plan).numpy(), want.numpy())
    if res >= 4 and iterations:
        assert not torch.equal(want, h)


@pytest.mark.parametrize("res", [29, 30])
def test_thermal_plan_replay_matches_jax(res):
    h = _field(res, (res, res))
    with jax.disable_jit():
        want = np.asarray(JT.thermal_erosion(jnp.asarray(h.numpy()), _TALUS, _INC, _HWR,
                                             iterations=3))
    got = replay_thermal(h, TH.thermal_plan(3, per_launch=2, tile=(8, 8)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shrink", [(1, 0), (0, 1)], ids=["row", "column"])
@pytest.mark.parametrize("m", [1, 2])
def test_thermal_plan_halo_one_short_is_not_exact(shrink, m):
    h = _field(11 + m, (40, 40))
    plan = TH.thermal_plan(m, tile=(8, 8))
    want = TT.thermal_erosion(h, _TALUS, _INC, _HWR, m)
    assert not torch.equal(replay_thermal(h, plan, shrink=shrink), want)
