"""The port's exact PileSolver (``EXACT_PILES``: ``noize_tpu_torch.erosion.
sediment``, the plain version of kernel K6) against ``noize_tpu``'s, on the
CPU.

Tolerance: bit-equality, against JAX evaluated one primitive at a time
(``jax.disable_jit()``), where every float32 op rounds on its own as the
plain version's host scalars and K6's ``__f*_rn`` do, and against the
compiled reference, which computes the same bits on these cases.  Eager
JAX runs a scan step in milliseconds, so the eager cases are small (a few
hundred visits) and the compiled reference takes the large ones.  Cases
(``pile_cases``, which the card tests reuse): radius 2, 4 and 15, piles in
the corners and on the borders, a partial deposit mid-round, a volume of
whole increments, many sweeps, an increment float32 rounds (1/3000),
overlapping piles, a chain among disjoint piles, more than 64 piles with
ties in volume, and ``write_sediment_map(EXACT_PILES=True)``.  K6's
wrapper tables (the slots on one cell, the whole increments summed) are
held against the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import pile_cases as C
from noize_tpu.erosion import sediment as JSe
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu_torch.erosion import pile_cuda as PC
from noize_tpu_torch.erosion import sediment as TSe

HS = C.HS
INC = C.INC


@pytest.mark.parametrize("radius", [1, 4, 15])
def test_pile_tables_match_reference(radius):
    t = TSe._pile_tables(radius)
    j = JSe._pile_tables(radius)
    np.testing.assert_array_equal(t["off_r"], j["off_r"])
    np.testing.assert_array_equal(t["off_c"], j["off_c"])
    np.testing.assert_array_equal(t["visit_slot"], np.argmax(j["onehot"], axis=1))
    np.testing.assert_array_equal(t["visit_round"], j["visit_round"])
    assert len(t["off_r"]) == 2 * radius * radius + 6 * radius  # S = 4·Σ_{d<r}(d + 2)


@pytest.mark.parametrize("case", list(C.handle_cases()))
def test_handle_pile_bit_equal(case):
    radius, r0, c0, amount, inc, eager = C.handle_cases()[case]
    h = C.height(32, radius + r0)
    args = (jnp.asarray(h), jnp.float32(amount), jnp.float32(inc))
    if eager:
        with jax.disable_jit():
            want = JSe._handle_pile(args[0], r0, c0, args[1], args[2], radius)
    else:
        want = jax.jit(lambda hh, a, i: JSe._handle_pile(hh, r0, c0, a, i, radius))(*args)
    got = TSe._handle_pile(torch.from_numpy(h.copy()), r0, c0, np.float32(amount),
                           np.float32(inc), radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.array_equal(got, h)


@pytest.mark.parametrize("case", list(C.map_cases()))
def test_exact_pile_deposit_bit_equal(case):
    cells, vols, radius, hs, res = C.map_cases()[case]
    h = C.height(res, 7)
    piles = C.pile_map(res, cells, vols)
    params = ErosionSettings(PILING_RADIUS=radius).as_parameters()
    want = np.asarray(jax.jit(lambda hh, pp: JSe.exact_pile_deposit(hh, pp, params, hs))(
        jnp.asarray(h), jnp.asarray(piles)))
    before = PC.exact_piles.launches
    got = TSe.exact_pile_deposit(torch.from_numpy(h), torch.from_numpy(piles), params,
                                 hs).numpy()
    np.testing.assert_array_equal(got, want)
    assert PC.exact_piles.launches == before  # CPU tensors: the plain version
    if len(cells) > 64:
        # the selection: 64 largest volumes, ties to the lower index, in
        # ascending cell order
        vols_t, idxs_t = TSe.select_piles(torch.from_numpy(piles))
        jv, ji = jax.lax.top_k(jnp.asarray(piles).reshape(-1), 64)
        order = np.argsort(np.asarray(ji), kind="stable")
        np.testing.assert_array_equal(idxs_t.numpy(), np.asarray(ji)[order])
        np.testing.assert_array_equal(vols_t.numpy(), np.asarray(jv)[order])


@pytest.mark.parametrize("radius", [1, 2, 15])
def test_k6_tables_match_reference(radius):
    """K6's wrapper tables: each slot's chain of later slots on its cell is
    the reference's ``dup_higher`` row, the reach is radius + 1, and the
    whole increments summed are the reference's ``deposited + diff`` chain
    at diff = increment (an increment float32 rounds, 1/3000, too)."""
    j = JSe._pile_tables(radius)
    _, _, later, ends, visits, reach = PC._tables(radius, torch.device("cpu"))
    later = later.numpy()
    for k in range(later.size):
        chain, nxt = set(), int(later[k])
        while nxt >= 0:
            chain.add(nxt)
            nxt = int(later[nxt])
        assert chain == set(np.nonzero(j["dup_higher"][k])[0].tolist()), k
    assert reach == radius + 1 and visits == len(j["visit_round"])
    assert ends.numpy().tolist() == TSe._pile_tables(radius)["ends"].tolist()
    for inc in (INC, np.float32(1.0 / 3000.0)):
        step = jnp.float32(inc)
        _, want = jax.lax.scan(lambda d, _: (d + step, d + step), jnp.float32(0.0), None,
                               length=visits)
        deps = PC._deposits(float(inc), visits, torch.device("cpu")).numpy()
        assert deps[0] == 0.0
        np.testing.assert_array_equal(deps[1:], np.asarray(want))


def test_select_piles_orders_ties_and_zeros():
    m = torch.zeros(10 * 10)
    m[[55, 3, 77, 12]] = 0.5
    m[40] = 0.9
    vols, idxs = TSe.select_piles(m.reshape(10, 10), max_piles=4)
    # 0.9 and the three lowest-index 0.5s, in cell order
    assert idxs.tolist() == [3, 12, 40, 55]
    vols, idxs = TSe.select_piles(m.reshape(10, 10), max_piles=8)
    assert idxs.tolist()[:5] == [3, 12, 40, 55, 77] and vols[5:].eq(0).all()
    assert idxs.tolist()[5:] == [0, 1, 2]  # zeros after the piles, in index order


def test_write_sediment_map_exact_piles_bit_equal():
    rng = np.random.default_rng(5)
    res = 48
    h = rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)
    sed = rng.normal(0, 1e-4, (res, res)).astype(np.float32)
    sed[10, 10] = sed[11, 12] = sed[40, 3] = sed[0, 47] = 0.004  # > PILE_THRESHOLD / HEIGHT
    params = ErosionSettings(PILING_RADIUS=2, EXACT_PILES=True).as_parameters()
    with jax.disable_jit():
        want = np.asarray(JSe.write_sediment_map(jnp.asarray(h), jnp.asarray(sed), params, HS))
    syncs = []
    got = TSe.write_sediment_map(torch.from_numpy(h), torch.from_numpy(sed), params, HS,
                                 syncs=syncs).numpy()
    np.testing.assert_array_equal(got, want)
    assert syncs == ["sediment.piles"]
    tent = TSe.write_sediment_map(
        torch.from_numpy(h), torch.from_numpy(sed),
        ErosionSettings(PILING_RADIUS=2).as_parameters(), HS).numpy()
    assert not np.array_equal(got, tent)


def test_stalled_sweep_stops():
    """An increment below the pile cell's ulp places nothing: the reference
    would loop for ever; the port stops after the first empty sweep."""
    slots = TSe._pile_tables(2)["off_r"].size
    vals, modified = TSe._solve_pile(np.full(slots, 0.5, np.float32), np.ones(slots, bool),
                                     np.float32(0.01), np.float32(1e-9), 2)
    assert not modified.any() and np.array_equal(vals, np.full(slots, 0.5, np.float32))
