"""The port's exact PileSolver (``EXACT_PILES``: ``noize_tpu_torch.erosion.
sediment``, the plain version of kernel K6) against ``noize_tpu``'s, on the
CPU.

Tolerance: bit-equality, against JAX evaluated one primitive at a time
(``jax.disable_jit()``), where every float32 op rounds on its own as the
plain version's host scalars and K6's ``__f*_rn`` do, and against the
compiled reference, which computes the same bits on these cases.  Eager
JAX runs a scan step in milliseconds, so the eager cases are small (a few
hundred visits) and the compiled reference takes the large ones.  Cases:
radius 4 and 15, a pile at the border, overlapping piles, more than 64
piles with ties in volume, and ``write_sediment_map(EXACT_PILES=True)``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.erosion import sediment as JSe
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu_torch.erosion import pile_cuda as PC
from noize_tpu_torch.erosion import sediment as TSe

HS = 1000.0
INC = np.float32(1.0 / HS)  # MIN_PILE_INCREMENT / HEIGHT at the defaults


def _height(res, seed):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)


@pytest.mark.parametrize("radius", [1, 4, 15])
def test_pile_tables_match_reference(radius):
    t = TSe._pile_tables(radius)
    j = JSe._pile_tables(radius)
    np.testing.assert_array_equal(t["off_r"], j["off_r"])
    np.testing.assert_array_equal(t["off_c"], j["off_c"])
    np.testing.assert_array_equal(t["visit_slot"], np.argmax(j["onehot"], axis=1))
    np.testing.assert_array_equal(t["visit_round"], j["visit_round"])
    assert len(t["off_r"]) == 2 * radius * radius + 6 * radius  # S = 4·Σ_{d<r}(d + 2)


@pytest.mark.parametrize("radius,r0,c0,amount,eager", [
    (2, 0, 1, 0.03, True),     # at the border, several sweeps, eager
    (4, 20, 17, 0.4, False),   # several sweeps
    (4, 0, 1, 0.05, False),    # at the border: out-of-grid slots skipped
    (15, 31, 30, 0.03, False),  # the default radius, at the far corner
    (15, 12, 9, 2.0, False),
])
def test_handle_pile_bit_equal(radius, r0, c0, amount, eager):
    h = _height(32, radius + r0)
    args = (jnp.asarray(h), jnp.float32(amount), jnp.float32(INC))
    if eager:
        with jax.disable_jit():
            want = JSe._handle_pile(args[0], r0, c0, args[1], args[2], radius)
    else:
        want = jax.jit(lambda hh, a, i: JSe._handle_pile(hh, r0, c0, a, i, radius))(*args)
    got = TSe._handle_pile(torch.from_numpy(h.copy()), r0, c0, np.float32(amount), INC,
                           radius).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
    assert not np.array_equal(got, h)


def _pile_map(res, cells, vols):
    m = np.zeros((res, res), np.float32)
    for (r, c), v in zip(cells, vols):
        m[r, c] = v
    return m


def _exact_cases():
    rng = np.random.default_rng(3)
    # overlapping piles and one at the border, radius 4
    overlap = ([(10, 10), (11, 12), (13, 9), (10, 14), (0, 5), (31, 31)],
               [0.05, 0.08, 0.03, 0.12, 0.02, 0.04], 4)
    # 90 piles, volumes in 5 tied levels: the 64 kept are the largest, ties
    # to the lower cell index
    flat = rng.choice(32 * 32, 90, replace=False)
    cells = [(int(f) // 32, int(f) % 32) for f in flat]
    vols = list(np.float32(0.01) * rng.integers(1, 6, 90).astype(np.float32))
    many = (cells, vols, 2)
    return {"overlap-r4": overlap, "many-ties-r2": many}


@pytest.mark.parametrize("case", ["overlap-r4", "many-ties-r2"])
def test_exact_pile_deposit_bit_equal(case):
    cells, vols, radius = _exact_cases()[case]
    res = 32
    h = _height(res, 7)
    piles = _pile_map(res, cells, vols)
    params = ErosionSettings(PILING_RADIUS=radius).as_parameters()
    want = np.asarray(jax.jit(lambda hh, pp: JSe.exact_pile_deposit(hh, pp, params, HS))(
        jnp.asarray(h), jnp.asarray(piles)))
    before = PC.exact_piles.launches
    got = TSe.exact_pile_deposit(torch.from_numpy(h), torch.from_numpy(piles), params,
                                 HS).numpy()
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
