"""K7's plain version — the fixed-step particle descent — against the JAX
reference, and the two properties K7's design rests on, on the CPU.

On the card ``descend_all`` runs every step of every particle in one K7
launch (``erosion/descent_cuda.py``, ``csrc/descent.cu``), with no early
exit, and scatters the ``[steps, N]`` events once a map.  Its plain
version, ``particles.descend_steps_plain``, is the ``descend_step`` loop
over the same steps; ``particles._descend_all_fixed`` is the path the card
runs, and on CPU tensors it takes the plain version.

* The fixed-step descent equals JAX's ``descend_all`` (compiled, its
  ``scatter="chunk"`` and ``scatter="end"`` modes) on a 48² world with 160
  particles: trajectories (cell, heading, age, alive, water), track and
  pool bit-equal; velocities, carried sediment and the sediment sums
  within ``tests/test_torch_erosion.py``'s 1e-4 relative (XLA's CPU atan,
  sin and FMAs differ from PyTorch's by an ulp, ROADMAP.md §3).
* Dead slots add +0.0 or -0.0 events, and the sums stay bit-equal, signs of
  zero included: an accumulator that starts at +0.0 never holds -0.0.  So
  the fixed-step sums equal the early-exit loop's (``_descend_all_plain``)
  bit for bit.
* The windowed form (K7@window: a window of the table, chunks, an owner
  mask), as the sharded descent runs it, gives the unwindowed events and
  particles bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.erosion import particles as JPa
from noize_tpu.erosion import world as JW
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.ops import kernels as JK
from noize_tpu_torch import prng
from noize_tpu_torch.erosion import descent_cuda as DC
from noize_tpu_torch.erosion import particles as TPa
from noize_tpu_torch.erosion import world as TW

RES = 48
N = 160
HS = 1000.0
PATCH = 1.0


def _world(seed, res=RES, plants=False):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 1, (res, res)).astype(np.float32)
    taps = JK.gaussian_taps(2.0, 9)
    for _ in range(3):
        h = np.array(JK.separable_series(jnp.asarray(h), taps, taps))
    z = np.zeros((res, res), np.float32)
    return dict(height=h,
                pool=np.where(rng.uniform(0, 1, (res, res)) < 0.3,
                              rng.uniform(0, 1e-3, (res, res)), 0.0).astype(np.float32),
                flow=rng.uniform(0, 0.6, (res, res)).astype(np.float32),
                track=z,
                plants=rng.uniform(0, 4, (res, res)).astype(np.float32) if plants else z)


def _params(maxage, plants):
    return ErosionSettings(MAXAGE=maxage,
                           VEGETATION_FRICTION=5.0 if plants else 0.0).as_parameters()


def _port_world(world):
    return TW.WorldState(**{k: torch.from_numpy(v.copy()) for k, v in world.items()})


def _spawn(seed, n=N, res=RES):
    """The spawn, part of it drain-like: some particles carry water > 1
    and sediment, some start old or nearly dry, a few start dead."""
    p = TPa.spawn(prng.PRNGKey(seed, device="cpu"), n, res)
    rng = np.random.default_rng(seed)
    return p._replace(
        water=torch.from_numpy(rng.choice([1.0, 2.5, 0.011], n, p=[0.8, 0.1, 0.1])
                               .astype(np.float32)),
        sediment=torch.from_numpy(rng.uniform(0, 1e-3, n).astype(np.float32)),
        age=torch.from_numpy(rng.choice([0, 5], n, p=[0.9, 0.1]).astype(np.int32)),
        alive=torch.from_numpy(rng.uniform(0, 1, n) > 0.05))


def _assert_close(got, want, rtol=1e-4):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= rtol * max(np.abs(want).max(), 1e-30)


def _bits_equal(a, b):
    """Bit-equality of float tensors, signs of zero included."""
    assert a.shape == b.shape
    assert torch.equal(a.contiguous().view(torch.int32), b.contiguous().view(torch.int32))


@pytest.mark.parametrize("plants", [False, True], ids=["bare", "plants"])
@pytest.mark.parametrize("maxage", [30, 100])
@pytest.mark.parametrize("scatter", ["chunk", "end"])
def test_fixed_step_descent_matches_reference(scatter, maxage, plants):
    world = _world(maxage + plants, plants=plants)
    jw = JW.WorldState(**{k: jnp.asarray(v) for k, v in world.items()})
    params = _params(maxage, plants)
    tp = _spawn(maxage)
    jp = JPa.Particles(**{k: jnp.asarray(getattr(tp, k).numpy()) for k in tp._fields})
    jout = jax.jit(lambda p, w: JPa.descend_all(p, w, params, HS, PATCH, RES,
                                                scatter=scatter))(jp, jw)
    steps = -(-(maxage + 1) // 8) * 8
    tout = TPa._descend_all_fixed(tp, _port_world(world), params, HS, PATCH, RES, steps)
    for k in ("row", "col", "heading", "age", "alive", "water"):
        np.testing.assert_array_equal(getattr(tout[0], k).numpy(),
                                      np.asarray(getattr(jout[0], k)), err_msg=k)
    _assert_close(tout[0].vel.numpy(), jout[0].vel)
    _assert_close(tout[0].sediment.numpy(), jout[0].sediment)
    np.testing.assert_array_equal(tout[1].numpy(), np.asarray(jout[1]))  # track
    np.testing.assert_array_equal(tout[2].numpy(), np.asarray(jout[2]))  # pool
    _assert_close(tout[3].numpy(), jout[3])                             # sediment
    assert (np.asarray(jout[1]) > 0).sum() > 100
    assert float(np.abs(np.asarray(jout[2])).max()) > 0  # payouts into the pool
    assert not bool(tout[0].alive.any())  # every trajectory ended


@pytest.mark.parametrize("plants", [False, True], ids=["bare", "plants"])
@pytest.mark.parametrize("maxage,max_steps", [(30, None), (100, None), (30, 5), (12, 40)])
def test_fixed_steps_equal_early_exit_bit_for_bit(maxage, max_steps, plants):
    """``_descend_all_fixed`` (K7's path: every step, dead slots' zero
    events included, one scatter a map) against ``_descend_all_plain`` (the
    early exit, one scatter a chunk): the particles and all three sums
    bit-equal, signs of zero included.  ``max_steps`` 5 stops with
    particles alive (one chunk of 8 steps either way); 40 runs chunks after
    every particle died."""
    world = _port_world(_world(7 + maxage, plants=plants))
    params = _params(maxage, plants)
    p = _spawn(3 + maxage)
    steps = (maxage + 1) if max_steps is None else max_steps
    syncs = []
    want = TPa._descend_all_plain(p, world, params, HS, PATCH, RES, steps, 8, syncs=syncs)
    got = TPa._descend_all_fixed(p, world, params, HS, PATCH, RES, -(-steps // 8) * 8)
    for f in p._fields:
        a, b = getattr(got[0], f), getattr(want[0], f)
        if a.is_floating_point():
            _bits_equal(a, b)
        else:
            assert torch.equal(a, b), f
    for a, b in zip(got[1:], want[1:]):
        _bits_equal(a, b)
        assert not bool(torch.signbit(a[a == 0]).any())
    assert len(syncs) >= 1
    # the CPU dispatch of descend_all is the early-exit loop
    out = TPa.descend_all(p, world, params, HS, PATCH, RES, max_steps=max_steps)
    for a, b in zip(out[1:], want[1:]):
        _bits_equal(a, b)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_zero_events_leave_accumulators_bit_equal(seed):
    """Events with exact cancellations (x then -x on one cell), -0.0 and
    +0.0 deltas: the sums never hold -0.0, and appending any number of
    dead slots' zero events (either sign) changes no bit."""
    rng = np.random.default_rng(seed)
    size, m = 64, 4000
    cells = torch.from_numpy(rng.integers(0, size, m).astype(np.int64))
    vals = rng.normal(0, 1e-3, m).astype(np.float32)
    vals[rng.uniform(0, 1, m) < 0.2] = 0.0
    vals[rng.uniform(0, 1, m) < 0.2] = -0.0
    vals = torch.from_numpy(vals)
    # exact cancellations: each of some cells gets x and then -x
    pair = torch.from_numpy(rng.integers(0, size, 200).astype(np.int64))
    x = torch.from_numpy(rng.normal(0, 1, 200).astype(np.float32))
    cells = torch.cat([pair, cells, pair])
    vals = torch.cat([x, vals, -x])
    (acc,) = TPa.scatter_events(cells, [vals], size)
    assert not bool(torch.signbit(acc[acc == 0]).any())
    dead = torch.from_numpy(rng.integers(0, size, 3000).astype(np.int64))
    zeros = torch.from_numpy(np.where(rng.uniform(0, 1, 3000) < 0.5, 0.0, -0.0)
                             .astype(np.float32))
    (more,) = TPa.scatter_events(torch.cat([cells, dead]), [torch.cat([vals, zeros])], size)
    _bits_equal(more, acc)
    # a -0.0 start would not be a fixed point: the reason the sums start at +0.0
    neg = torch.full((1,), -0.0).index_put_((torch.zeros(1, dtype=torch.int64),),
                                            torch.zeros(1), accumulate=True)
    assert not bool(torch.signbit(neg).any())


@pytest.mark.parametrize("m", [TPa.CPU_IN_ORDER, 100_000])
def test_cpu_scatter_adds_events_in_order_at_any_count(m):
    """On the CPU ``scatter_events`` adds each cell's events to it one by
    one in their order, whatever their number and the thread count
    (one ``index_put_`` of 32768 values or more would add with atomics
    across threads), into zeros or into accumulators it is handed."""
    rng = np.random.default_rng(m)
    size = 40
    ids = rng.integers(0, size, m)
    vals = rng.normal(0, 1, (2, m)).astype(np.float32)
    want = np.zeros((2, size), np.float32)
    start = rng.normal(0, 1, (2, size)).astype(np.float32)
    want_on = start.copy()
    for k in range(2):
        for i, v in zip(ids, vals[k]):
            want[k, i] += v
            want_on[k, i] += v
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        cells = torch.from_numpy(ids)
        deltas = list(torch.from_numpy(vals))
        got = TPa.scatter_events(cells, deltas, size)
        on = [torch.from_numpy(a.copy()) for a in start]
        assert TPa.scatter_events(cells, deltas, size, on) is on
    finally:
        torch.set_num_threads(threads)
    for k in range(2):
        _bits_equal(got[k], torch.from_numpy(want[k]))
        _bits_equal(on[k], torch.from_numpy(want_on[k]))


def _window_table(full_maps, res, parts, origin, shape):
    """The window of each part of the grid's table, edge-clamped outside
    the grid (the cells a window reads beyond the grid are never used:
    reads clamp to the grid first)."""
    r = np.clip(np.arange(origin[0], origin[0] + shape[0]), 0, res - 1)
    c = np.clip(np.arange(origin[1], origin[1] + shape[1]), 0, res - 1)
    tiles = full_maps.reshape(parts, res, res)
    return torch.cat([t[r][:, c].reshape(-1) for t in tiles])


@pytest.mark.parametrize("split,plants", [((2, 2), False), ((4, 1), False), ((3, 3), True)],
                         ids=["2x2", "4x1", "3x3-plants"])
def test_windowed_owner_masked_chunks_equal_unwindowed(split, plants):
    """The sharded descent's form of K7 (``descend_steps_window``: one call
    a chunk of 8 on each block's window extended by the chunk, events of
    particles the block does not own zeroed, the owners' particles merged
    after each chunk) against ``descend_steps`` on the whole grid: every
    owned event (cell, deltas) and every merged particle bit-equal, and the
    other blocks' events zero."""
    chunk, maxage = 8, 30
    world = _port_world(_world(21, plants=plants))
    params = _params(maxage, plants)
    full = TPa.step_maps(world, params, HS)
    parts = 4 if plants else 3
    nx, ny = split
    lr, lc = RES // nx, RES // ny
    blocks = []
    for bx in range(nx):
        for by in range(ny):
            r0, c0 = bx * lr, by * lc
            origin, shape = (r0 - chunk, c0 - chunk), (lr + 2 * chunk, lc + 2 * chunk)
            blocks.append((r0, c0, origin, shape,
                           _window_table(full, RES, parts, origin, shape)))
    p_full = p_win = _spawn(11)
    for _ in range(-(-(maxage + 1) // chunk)):
        p_full, cells_f, *deltas_f = DC.descend_steps(p_full, full, params, HS, PATCH, RES,
                                                      chunk)
        row_i = torch.clamp(torch.round(p_win.row).to(torch.int32), 0, RES - 1)
        col_i = torch.clamp(torch.round(p_win.col).to(torch.int32), 0, RES - 1)
        merged = None
        n_owners = torch.zeros(N, dtype=torch.int64)
        for r0, c0, origin, shape, table in blocks:
            owned = (row_i >= r0) & (row_i < r0 + lr) & (col_i >= c0) & (col_i < c0 + lc)
            n_owners += owned.long()
            p_b, cells_b, *deltas_b = DC.descend_steps_window(
                p_win, table, params, HS, PATCH, RES, chunk, origin, shape, owned)
            own = owned.repeat(chunk)
            g_cells = ((cells_b // shape[1] + origin[0]) * RES + cells_b % shape[1] + origin[1])
            assert torch.equal(g_cells[own], cells_f[own])
            for d_b, d_f in zip(deltas_b, deltas_f):
                _bits_equal(d_b[own], d_f[own])
                assert not bool(d_b[~own].any())
            stack = torch.stack([getattr(p_b, f).to(torch.float32) for f in p_b._fields])
            stack = torch.where(owned[None, :], stack, 0.0)
            merged = stack if merged is None else merged + stack
        assert bool((n_owners == 1).all())
        p_win = TPa.Particles(*[merged[k].to(getattr(p_full, f).dtype) if f != "alive"
                                else merged[k] > 0.5 for k, f in enumerate(p_full._fields)])
        for f in p_full._fields:
            assert torch.equal(getattr(p_win, f), getattr(p_full, f)), f
    assert not bool(p_full.alive.any())


def test_descent_wrappers_take_the_plain_version_on_the_cpu():
    world = _port_world(_world(5))
    params = _params(30, False)
    maps = TPa.step_maps(world, params, HS)
    p = _spawn(5)
    before = (DC.descend_steps.launches, DC.descend_steps_window.launches)
    got = DC.descend_steps(p, maps, params, HS, PATCH, RES, 16)
    want = TPa.descend_steps_plain(p, maps, params, HS, PATCH, RES, 16)
    win = DC.descend_steps_window(p, maps, params, HS, PATCH, RES, 16, (0, 0), (RES, RES))
    for a, b, c in zip(got[1:], want[1:], win[1:]):
        assert a.shape == (16 * N,)
        assert torch.equal(a, b) and torch.equal(a, c)
    assert (DC.descend_steps.launches, DC.descend_steps_window.launches) == before
    empty = DC.descend_steps(p, maps, params, HS, PATCH, RES, 0)
    assert all(t.numel() == 0 for t in empty[1:])


def _emulate_k8(key, x0, x1):
    """K8's indexing in NumPy: each output element's key words and counters
    read through ``_threefry_layout``'s strides from the tensors' storage,
    then the rounds in uint32."""
    key, x0, x1, shape, (sk, s0, s1) = prng._threefry_layout(key, x0, x1)
    kw = key.stride(-1)
    def storage(t, dtype):  # the tensor's storage from its first element on
        flat = torch.tensor([], dtype=t.dtype).set_(t.untyped_storage())
        return flat.to(torch.int64).numpy().astype(dtype)[t.storage_offset():]

    kst, x0s, x1s = storage(key, np.uint32), storage(x0, np.int64), storage(x1, np.int64)
    idx = np.indices(shape).reshape(len(shape), -1)
    ok, o0, o1 = (np.tensordot(np.asarray(s, np.int64), idx, 1) if shape else np.zeros(1, int)
                  for s in (sk, s0, s1))
    k0, k1 = kst[ok], kst[ok + kw]
    ks = (k0, k1, k0 ^ k1 ^ np.uint32(0x1BD11BDA))
    a = (x0s[o0].astype(np.uint32) + ks[0]).astype(np.uint32)
    c = (x1s[o1].astype(np.uint32) + ks[1]).astype(np.uint32)
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    with np.errstate(over="ignore"):
        for i in range(5):
            for r in rot[i % 2]:
                a = a + c
                c = ((c << np.uint32(r)) | (c >> np.uint32(32 - r))) ^ a
            a = a + ks[(i + 1) % 3]
            c = c + ks[(i + 2) % 3] + np.uint32(i + 1)
    return a.astype(np.int64).reshape(shape), c.astype(np.int64).reshape(shape)


@pytest.mark.parametrize("shapes", [((2, 1), (7,), (7,)), ((3, 1), (3, 1), (3, 1)),
                                    ((2, 2, 1), (7,), (1,)), ((1,), (0,), (0,)),
                                    ((), (5,), (5,)), ((4, 2, 1), (1, 9), (9,))])
def test_threefry_broadcast_matches_torch(shapes):
    assert prng._broadcast(*shapes) == tuple(torch.broadcast_shapes(*shapes))


def test_threefry_broadcast_refuses_mismatched_shapes():
    with pytest.raises(ValueError, match="do not broadcast"):
        prng._broadcast((2, 1), (3,), (4,))


@pytest.mark.parametrize("case", ["split", "split_stack", "fold_in_stack", "fold_in_keys",
                                  "bits_stack", "view"])
def test_threefry_layout_broadcasts_as_the_plain_version(case):
    """K8 reads the key words and counters through strides (0 where
    broadcast) instead of copies; its indexing, emulated on the CPU, gives
    the plain version's words for each way the port calls the hash."""
    key = prng.PRNGKey(5, device="cpu")
    stack = prng.split(key, 3)
    n = torch.arange(7, dtype=torch.int64)
    args = {
        "split": (key, n >> 32, n & 0xFFFFFFFF),
        "split_stack": (stack, n >> 32, n & 0xFFFFFFFF),
        "fold_in_stack": (key, torch.zeros(4, dtype=torch.int64), n[:4] * 977),
        "fold_in_keys": (stack, torch.zeros(3, 1, dtype=torch.int64), n[:3, None] + 11),
        "bits_stack": (prng.split(stack, 2), n >> 32, n & 0xFFFFFFFF),
        "view": (stack[1], n[2:] >> 32, n[2:]),  # a key and counters at an offset
    }[case]
    want = prng._threefry2x32_plain(*args)
    got = _emulate_k8(*args)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w.numpy())
    before = prng.threefry2x32.launches
    for g, w in zip(prng.threefry2x32(*args), want):
        assert torch.equal(g, w)
    assert prng.threefry2x32.launches == before  # the CPU takes the plain version


@pytest.mark.parametrize("plants", [False, True], ids=["bare", "plants"])
@pytest.mark.parametrize("seed", [0, 1])
def test_record_table_plain_matches_step_maps_and_reference(seed, plants):
    """K7's record table (``step_records_plain``, and ``descent_table`` on the
    CPU, which is ``step_maps``): each record's quantised all-heights, WIH,
    flow and plants bit-equal to ``step_maps`` + ``_quantize`` and to the
    reference's table (``noize_tpu.erosion.particles``, lines 306-311) one
    primitive at a time.  The reference's ``_quantize`` divides by 100, which
    its compiled programs turn into a multiply by the float32 reciprocal;
    the port multiplies, as the compiled reference does (ROADMAP.md §3), so
    the quantised field is held against the compiled ``_quantize``."""
    res = 96
    world = _world(40 + seed, res=res, plants=True)
    world["pool"] = world["pool"] * 10.0 + world["height"] * 0.5
    params = _params(30, plants)
    tw = _port_world(world)
    got = DC.step_records_plain(tw.height, tw.pool, tw.flow, tw.plants if plants else None,
                                params, HS)
    assert got.shape == (res * res, 4) and got.dtype == torch.float32
    cells = res * res
    maps = TPa.step_maps(tw, params, HS)
    assert DC.descent_table(tw, params, HS).shape == maps.shape  # the CPU keeps step_maps
    _bits_equal(got[:, 0], TPa._quantize(maps[cells:2 * cells]))
    _bits_equal(got[:, 1], maps[:cells])
    _bits_equal(got[:, 2], maps[2 * cells:3 * cells])
    _bits_equal(got[:, 3], maps[3 * cells:] if plants else torch.zeros(cells))
    jw = {k: jnp.asarray(v) for k, v in world.items()}
    with jax.disable_jit():
        wih = HS * (jw["height"] + jw["pool"])
        all_h = wih + params.FLOW_HEIGHT_CONTRIBUTION * jw["flow"]
    q = jax.jit(JPa._quantize)(all_h)
    for k, want in enumerate((q, wih, jw["flow"], jw["plants"] if plants else jnp.zeros_like(q))):
        _bits_equal(got[:, k], torch.from_numpy(np.asarray(want).reshape(-1).copy()))
    assert float(got[:, 0].abs().max()) > 0


def _runs_with_zeros(seed, run, n_cells, zeros=40):
    """Events of ``n_cells`` cells, each a run of ``run`` N(0, 1) values with
    ``zeros`` zeros (either sign) at random places inside it, all runs
    interleaved at random."""
    rng = np.random.default_rng(seed)
    cells = np.repeat(np.arange(n_cells) * 3 + 1, run + zeros)
    vals = rng.normal(0, 1, cells.size).astype(np.float32)
    for c in range(n_cells):
        at = c * (run + zeros) + rng.choice(run + zeros, zeros, replace=False)
        vals[at] = np.where(rng.uniform(0, 1, zeros) < 0.5, 0.0, -0.0)
    order = rng.permutation(cells.size)
    return torch.from_numpy(cells[order].astype(np.int64)), torch.from_numpy(vals[order])


@pytest.mark.parametrize("run", [32, 33, 100, 1000])
@pytest.mark.parametrize("pieces", [2, 13, 97])
def test_scatter_chunks_equal_one_call(run, pieces):
    """``scatter_events`` of the events cut in ``pieces`` consecutive calls
    into the same maps against one call: bit-equal, with runs of 32 or more
    N(0, 1) events a cell and zeros inside them (the dead slots' events,
    the early-exit loop's scatter a chunk)."""
    cells, vals = _runs_with_zeros(run + pieces, run, 60)
    size = 200
    other = vals.flip(0)
    one = TPa.scatter_events(cells, [vals, other], size)
    acc = [torch.zeros(size), torch.zeros(size)]
    for c, v, o in zip(cells.tensor_split(pieces), vals.tensor_split(pieces),
                       other.tensor_split(pieces)):
        TPa.scatter_events(c, [v, o], size, acc)
    for a, b in zip(acc, one):
        _bits_equal(a, b)
    nonzero = vals[vals != 0]
    _bits_equal(TPa.scatter_events(cells[vals != 0], [nonzero], size)[0], one[0])


@pytest.mark.parametrize("given", [False, True], ids=["into-zeros", "into-maps"])
@pytest.mark.parametrize("seed", [0, 1])
def test_scatter_events_with_and_without_zero_events(seed, given):
    """``scatter_events`` with zero events of either sign inside runs, held
    against NumPy's one-by-one float32 adds: into fresh zeros the same
    bits with the all-zero events dropped (a sum that starts at +0.0 never
    holds -0.0, so they change nothing; the card's K9 drops them), and
    into maps that hold -0.0 the zero events kept (-0.0 + +0.0 is +0.0)."""
    rng = np.random.default_rng(seed)
    cells, vals = _runs_with_zeros(seed, 35, 20, zeros=10)
    extra = torch.from_numpy(rng.integers(0, 64, 3000).astype(np.int64))
    cells = torch.cat([cells, extra])
    deltas = [torch.cat([vals, torch.from_numpy(rng.normal(0, 1, 3000).astype(np.float32))])
              for _ in range(3)]
    deltas[1][rng.uniform(0, 1, deltas[1].numel()) < 0.5] = -0.0
    size = 64
    start = [np.where(rng.uniform(0, 1, size) < 0.3, -0.0, rng.normal(0, 1, size))
             .astype(np.float32) if given else np.zeros(size, np.float32) for _ in range(3)]
    got = TPa.scatter_events(cells, deltas, size,
                             [torch.from_numpy(a.copy()) for a in start] if given else None)
    for a, d, g in zip(start, deltas, got):
        want = a.copy()
        np.add.at(want, cells.numpy(), d.numpy())
        _bits_equal(g, torch.from_numpy(want))
    if not given:
        live = torch.stack([d != 0 for d in deltas]).any(0)
        for a, b in zip(TPa.scatter_events(cells[live], [d[live] for d in deltas], size), got):
            _bits_equal(a, b)
