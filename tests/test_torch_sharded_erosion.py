"""The port's sharded erosion cycle (``noize_tpu_torch.parallel.
sharded_erosion``) on 4 gloo ranks on the CPU, 2×2 and 4×1 meshes of a 32²
grid (``PARTICLES_PER_CYCLE=48, MAXAGE=12, WATER_STEPS=3,
PILING_RADIUS=4``, as tests/test_parallel.py sets it up), against the
port's single-device ops and ``noize_tpu.parallel.sharded_erosion`` on
``jax.devices()[:4]``; then the plain versions of the pieces it stands on
(windowed descent tables, the K5 window, the K6 pile table) at world size
1, with no ranks.

The ranks run as one launch of subprocesses (``tests/torch_ranks.py``,
suite ``erosion``; a one-rank launch, ``sim1``, for the store path), each
bounded by a 120 s timeout.

Tolerances:
  * spawn (particles, leftover drains, key), the pool automata (pool and
    drains), both sediment paths (the tent and ``EXACT_PILES``, piles
    across block borders and chained), the sim's save and resume, and the
    plain window and table versions against the single-device ones:
    bit-equality;
  * a whole cycle against the port's ``erosion_cycle``: atol 2e-6, the
    reference's own bound for the descent's event sums, which reassociate
    across block borders (D8, the module's docstring); the keys equal;
  * against the JAX sharded cycle (compiled: XLA's CPU backend contracts
    multiply-adds into FMAs, ROADMAP.md §3): atol 2e-6, keys equal;
  * ``tuned=`` against static settings: the reference's rtol 1e-6, atol
    1e-9.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from noize_tpu_torch.erosion import particles as PA
from noize_tpu_torch.erosion import pool as PO
from noize_tpu_torch.erosion import sediment as SD
from noize_tpu_torch.erosion import sim as SIM
from noize_tpu_torch.erosion.params import ErosionSettings
from noize_tpu_torch.prng import PRNGKey

import torch_ranks as R
from torch_ranks import launch

MAPS = ("height", "pool", "flow", "track", "plants", "drain")
D8_ATOL = 2e-6


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("erosion", 4, tmp_path_factory.mktemp("erosion"))


def T(a):
    return torch.from_numpy(np.asarray(a))


def _single(seed, cycles, settings=None):
    st = R._state(seed)
    for _ in range(cycles):
        st = SIM.erosion_cycle(st, settings or ErosionSettings(**R.EROSION_SETTINGS),
                               R.erosion_meta())
    return st


def _maps(state):
    w = {k: getattr(state.world, k).numpy() for k in MAPS[:-1]}
    w["drain"] = state.drain_water.numpy()
    return w


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_spawn_bit_equal(results, mesh):
    parts, left, key = SIM._spawn_with_drains(PRNGKey(3, device="cpu"), 48, 32,
                                              T(R.spawn_drains()))
    assert int((parts.water != 1.0).sum()) == 48  # every slot took a drain
    for f in parts._fields:
        np.testing.assert_array_equal(results[f"{mesh}/spawn/{f}"], getattr(parts, f).numpy(), f)
    np.testing.assert_array_equal(results[f"{mesh}/spawn/leftover"], left.numpy())
    np.testing.assert_array_equal(results[f"{mesh}/spawn/key"], key.numpy())


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_descent_matches_single_device(results, mesh):
    """``_sharded_descent`` (fixed chunks, owner mask, one merge a chunk,
    the fold): the particles bit-equal to ``descend_all``'s, the event
    sums within the D8 bound."""
    st = R._state(6)
    params = ErosionSettings(**R.EROSION_SETTINGS).as_parameters()
    parts = PA.spawn(PRNGKey(4, device="cpu"), 48, 32)
    want = PA.descend_all(parts, st.world, params, 500.0, 1, 32)
    for f in parts._fields:
        np.testing.assert_array_equal(results[f"{mesh}/descent/{f}"],
                                      getattr(want[0], f).numpy(), f)
    for k, acc in zip(("track", "pool", "sed"), want[1:]):
        assert float(np.abs(acc.numpy()).max()) > 0, k
        np.testing.assert_allclose(results[f"{mesh}/descent/{k}"], acc.numpy(), rtol=0,
                                   atol=D8_ATOL, err_msg=k)


@pytest.mark.parametrize("mesh,drain", [(m, d) for m in R.MESHES for d in (1, 0)])
def test_pool_automata_bit_equal(results, mesh, drain):
    h, p = R.pool_inputs()
    want_p, want_d = PO.pool_automata(T(h), T(p), 3, bool(drain))
    assert not torch.equal(want_p, T(p))
    np.testing.assert_array_equal(results[f"{mesh}/pool/{drain}/pool"], want_p.numpy())
    np.testing.assert_array_equal(results[f"{mesh}/pool/{drain}/drains"], want_d.numpy())


@pytest.mark.parametrize("mesh,case", [(m, c) for m in R.MESHES
                                       for c in ("tent",) + R.EXACT_CASES])
def test_sediment_bit_equal(results, mesh, case):
    """The tent path and ``EXACT_PILES`` (piles on both sides of block
    borders, overlapping in a chain, clipped at the grid's corner, and more
    candidates than the 64 solved)."""
    h, sed = R.sediment_inputs(case)
    params = ErosionSettings(PILING_RADIUS=4, EXACT_PILES=case != "tent").as_parameters()
    want = SD.write_sediment_map(T(h), T(sed), params, 500.0).numpy()
    np.testing.assert_array_equal(results[f"{mesh}/sediment/{case}"], want)


@pytest.mark.parametrize("mesh,case", [(m, c[0]) for m in R.MESHES for c in R.CYCLE_CASES])
def test_cycle_matches_single_device_within_d8(results, mesh, case):
    """One cycle, and two (the second respawns drain particles across
    blocks): within the descent's reassociation, keys equal."""
    seed, cycles = {c: (s, n) for c, s, n in R.CYCLE_CASES}[case]
    want = _maps(_single(seed, cycles))
    gaps = {k: float(np.abs(results[f"{mesh}/{case}/{k}"] - v).max()) for k, v in want.items()}
    print(f"{mesh} {case}: largest difference from the single-device cycle {gaps}")
    assert max(gaps.values()) <= D8_ATOL, gaps
    np.testing.assert_array_equal(results[f"{mesh}/{case}/key"],
                                  _single(seed, cycles).key.numpy())


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_exact_piles_cycle(results, mesh):
    settings = dataclasses.replace(ErosionSettings(**R.EROSION_SETTINGS), EXACT_PILES=True)
    want = _maps(_single(6, 1, settings))
    for k, v in want.items():
        np.testing.assert_allclose(results[f"{mesh}/exact_cycle/{k}"], v, rtol=0,
                                   atol=D8_ATOL, err_msg=k)


def _jax_cycle(mesh_name, seed, cycles):
    from noize_tpu.core.tiles import TileSetMeta
    from noize_tpu.erosion import params as JP
    from noize_tpu.erosion.sim import SimState, init_state
    from noize_tpu.parallel.sharded_erosion import sharded_erosion_cycle

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(R.MESHES[mesh_name]), ("x", "y"))
    sh = NamedSharding(mesh, P("x", "y"))
    st = init_state(jnp.asarray(R.erosion_height(seed)), jax.random.PRNGKey(9))
    w = st.world
    st = SimState(world=type(w)(**{k: jax.device_put(getattr(w, k), sh) for k in MAPS[:-1]}),
                  drain_water=jax.device_put(st.drain_water, sh), key=st.key)
    meta = TileSetMeta(tile_res=32, tile_size=32, generator_res=32, height=500, margin=0)
    for _ in range(cycles):
        st = sharded_erosion_cycle(mesh, st, JP.ErosionSettings(**R.EROSION_SETTINGS), meta,
                                   chunk=4)
    return st


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_cycle_matches_jax_sharded_cycle(results, mesh):
    st = _jax_cycle(mesh, 13, 2)
    for k in MAPS[:-1]:
        np.testing.assert_allclose(results[f"{mesh}/cycle2/{k}"],
                                   np.asarray(getattr(st.world, k)), rtol=0, atol=D8_ATOL,
                                   err_msg=k)
    np.testing.assert_allclose(results[f"{mesh}/cycle2/drain"], np.asarray(st.drain_water),
                               rtol=0, atol=D8_ATOL)
    np.testing.assert_array_equal(results[f"{mesh}/cycle2/key"], np.asarray(st.key))


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_tuned_equals_static(results, mesh):
    """``tuned=`` (the tunables rounded to float32, as the reference's traced
    scalars) against the static settings, to the reference's own tolerance
    for this check (rtol 1e-6, atol 1e-9: a product of two settings rounds
    once more when one of them is a float32)."""
    for k in MAPS:
        np.testing.assert_allclose(results[f"{mesh}/tuned/static/{k}"],
                                   results[f"{mesh}/tuned/traced/{k}"], rtol=1e-6, atol=1e-9,
                                   err_msg=k)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_sim_resumes_bit_exact_from_its_checkpoint(results, mesh):
    """Per-shard checkpoint (4 ranks): six maps a rank, restored equal, the
    next cycle equal."""
    for a, b in (("saved", "restored"), ("a", "b")):
        for k in MAPS:
            np.testing.assert_array_equal(results[f"{mesh}/sim/{a}/{k}"],
                                          results[f"{mesh}/sim/{b}/{k}"], f"{a} {k}")
    assert tuple(results[f"{mesh}/sim/cycles"]) == (2, 1)
    assert int(results[f"{mesh}/sim/files"][0]) == 6  # rank 0's blocks of the six maps


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_sim_keeps_erosion_sims_surface(results, mesh):
    """Resets, ``update``'s continuous mode, curvature and the plant map,
    inherited from ``ErosionSim``, on the sharded state."""
    assert results[f"{mesh}/sim/surface"].tolist() == [True] * 6


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_checkpoint_topology_mismatch_raises(results, mesh):
    assert "topology must match" in str(results[f"{mesh}/sim/mismatch"][0])


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_checkpoint_replicated_array_round_trips(results, mesh):
    """A plain tensor saves as one replicated block and loads on (mesh,
    placements); an absent name loads as None."""
    assert results[f"{mesh}/ckpt/replicated"].tolist() == [True, True, True]


def test_sim_one_rank_checkpoints_through_the_store(tmp_path):
    from noize_tpu_torch.parallel.sharded_erosion import ShardedErosionSim

    res = launch("sim1", 1, tmp_path)
    for k in MAPS:
        np.testing.assert_array_equal(res[f"sim1/a/{k}"], res[f"sim1/b/{k}"], k)
    names = set(res["sim1/manifest"])
    assert {f"0_0__32__{a}" for a, _ in ShardedErosionSim._SAVE_ALIASES} <= names


# --- the plain versions the sharded cycle stands on (world size 1) ----------

def test_windowed_descent_table_equals_full_table():
    """``descend_step`` on a window's table gives the full table's result
    for the particles inside it (the window holds their neighbourhood);
    others read clamped cells and stay finite."""
    res, h = 48, 8
    rng = np.random.default_rng(11)
    world = SIM.WorldState.create(T(rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)))
    world = dataclasses.replace(world, flow=T(rng.uniform(0, 0.3, (res, res)).astype(np.float32)))
    params = ErosionSettings(**R.EROSION_SETTINGS).as_parameters()
    parts = PA.spawn(PRNGKey(2, device="cpu"), 200, res)
    full = PA.step_maps(world, params, 500.0)
    r0, c0, lr, lc = 16, 8, 16, 24
    origin, shape = (r0 - h, c0 - h), (lr + 2 * h, lc + 2 * h)
    sl = (slice(origin[0], origin[0] + shape[0]), slice(origin[1], origin[1] + shape[1]))
    win = torch.cat([m[sl].reshape(-1) for m in (
        500.0 * (world.height + world.pool),
        500.0 * (world.height + world.pool) + params.FLOW_HEIGHT_CONTRIBUTION * world.flow,
        world.flow)])
    inside = ((parts.row >= r0) & (parts.row < r0 + lr) & (parts.col >= c0)
              & (parts.col < c0 + lc))
    assert 0 < int(inside.sum()) < 200
    p_full, p_win = parts, parts
    for _ in range(h):
        p_full, ev_f = PA.descend_step(p_full, world, params, 500.0, 1, res, maps=full)
        p_win, ev_w = PA.descend_step(p_win, None, params, 500.0, 1, res, maps=win,
                                      window_origin=origin, window_shape=shape)
        for k in ("row", "col", "d_track", "d_pool", "d_sed"):
            assert torch.equal(ev_f[k][inside], ev_w[k][inside]), k
        assert all(bool(torch.isfinite(getattr(p_win, f).float()).all()) for f in p_win._fields)
    for f in parts._fields:
        assert torch.equal(getattr(p_full, f)[inside], getattr(p_win, f)[inside]), f
    with pytest.raises(NotImplementedError, match="patch prefetch"):
        PA.descend_step(parts, world, params, 500.0, 1, res, patch_ctx=(0, 0, 0, 0))


def _windows(res, nx, ny, halo):
    """Blocks of an nx × ny split of a res² grid, each extended ``halo``
    cells toward its neighbours: (window, core within it, block) slices."""
    lr, lc = res // nx, res // ny
    out = []
    for i in range(nx):
        for j in range(ny):
            r0, c0 = i * lr, j * lc
            er0, ec0 = max(0, r0 - halo), max(0, c0 - halo)
            er1, ec1 = min(res, r0 + lr + halo), min(res, c0 + lc + halo)
            out.append(((slice(er0, er1), slice(ec0, ec1)),
                        (slice(r0 - er0, r0 - er0 + lr), slice(c0 - ec0, c0 - ec0 + lc)),
                        (slice(r0, r0 + lr), slice(c0, c0 + lc))))
    return out


@pytest.mark.parametrize("res,nx,ny,odd", [(32, 2, 2, False), (32, 4, 1, False),
                                           (30, 3, 2, True), (33, 3, 3, True),
                                           (48, 2, 3, False)])
@pytest.mark.parametrize("drain", [True, False])
@pytest.mark.parametrize("group", [1, 2, 3])
def test_pool_window_plain_stitches_to_full_grid(res, nx, ny, odd, drain, group):
    """The K5 window's plain version on each block extended 8 cells a step
    of a group of ``group`` water steps (odd origins at 30 = 3 × 2 and 33 =
    3 × 3, non-square windows; at 3 steps on 4×1 of 32² the 24-cell halo
    spans three neighbour blocks), one call a group with the drains carried
    in, the kept block's cells stitched: 3 steps of the full-grid phases, bit
    for bit, whatever the grouping (the sharded pool's schedule)."""
    rng = np.random.default_rng(res + nx)
    h = T(rng.uniform(0, 1, (res, res)).astype(np.float32))
    p = T(rng.uniform(-0.3, 0.1, (res, res)).clip(0).astype(np.float32))
    want_p, want_d = PO._pool_automata_fullgrid(h, p, 3, drain)
    got_p, got_d = p.clone(), torch.zeros_like(p)
    wins = _windows(res, nx, ny, 8 * group)
    if group == 1:  # wider halos reach the grid's edge, an even origin
        assert any(w[0].start % 2 or w[1].start % 2 for w, _, _ in wins) == odd
    for done in range(0, 3, group):
        new_p, new_d = got_p.clone(), got_d.clone()
        for win, core, block in wins:
            op, od = PO._pool_automata_window(h[win], got_p[win], got_d[win],
                                              min(group, 3 - done), drain,
                                              (win[0].start, win[1].start), res)
            new_p[block], new_d[block] = op[core], od[core]
        got_p, got_d = new_p, new_d
    assert not torch.equal(want_p, p)
    assert torch.equal(got_p, want_p) and torch.equal(got_d, want_d)
    with pytest.raises(ValueError, match="leaves"):
        PO._pool_automata_window(h, p, p, 1, drain, (1, 0), res)


def _table_solve(new_h, pile_part, radius, inc, max_piles=64):
    """The sharded exact solve's steps at world size 1: the table, its
    plain solve, the commits replayed last-pile-wins."""
    res_r, res_c = new_h.shape
    t = SD._pile_tables(radius)
    vols, idxs = SD.select_piles(pile_part, max_piles)
    rows = (idxs // res_c)[:, None] + T(t["off_r"]).long()[None]
    cols = (idxs % res_c)[:, None] + T(t["off_c"]).long()[None]
    valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
    cr, cc = rows.clamp(0, res_r - 1), cols.clamp(0, res_c - 1)
    cid = cr * res_c + cc
    vals0 = new_h.reshape(-1)[cid]
    com_vals, com_eff = SD.solve_pile_table_plain(vals0, valid, vols, cid, inc, radius)
    out = new_h.clone().reshape(-1)
    for j in range(com_vals.shape[0]):
        out[cid[j][com_eff[j]]] = com_vals[j][com_eff[j]]
    return out.reshape(res_r, res_c), com_eff, cid


@pytest.mark.parametrize("case", R.EXACT_CASES)
@pytest.mark.parametrize("radius", [4, 9])
def test_pile_table_plain_equals_full_map_solver(case, radius):
    """K6's table entry, plain: the piles solved on the gathered table with
    the commit overlay equal the serial solver on the map, chained and
    border-clipped overlaps included."""
    h, sed = R.sediment_inputs(case)
    pile = torch.where(T(sed) > 0.1, T(sed), 0.0)
    inc = SD.pile_increment(ErosionSettings().as_parameters(), 500.0)
    got, eff, cid = _table_solve(T(h), pile, radius, inc)
    want = SD.exact_pile_deposit_plain(T(h), pile, inc, radius)
    assert not torch.equal(want, T(h))
    assert torch.equal(got, want)
    if case == "chained":  # later piles read cells earlier ones wrote: the overlay ran
        written = [set(cid[j][eff[j]].tolist()) for j in range(cid.shape[0])]
        reads = [set(c.tolist()) for c in cid]
        assert sum(bool(written[i] & reads[j]) for i in range(len(reads))
                   for j in range(i + 1, len(reads))) >= 2
