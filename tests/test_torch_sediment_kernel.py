"""K11, the sediment write-back kernel (``csrc/sediment.cu``, wrapper
``erosion/sediment_cuda``), on the CPU.

The CUDA kernel cannot run here, but what makes it exact can be checked:

- a CPU tensor takes the plain version (``write_sediment_map_plain``) and
  never reaches K11: its launch counters stay at 0;
- the weights K11 is given are the plain version's own
  (``sediment.axis_weights``), packed into the by-value struct with the
  tent off (``kt`` 0) or on;
- a replay of K11's kernel in NumPy: the same tiles (the source's
  ``kTileRows`` × ``kTileCols``) and sediment window (a halo of the widest
  stamp's reach, zero beyond the grid), the split on every read, the first
  axis over the window's columns rounded to float32, the second axis a
  cell, the folds on the grid's edge cells after each tap sum, the tent
  added to the dispersal and the sum to the height, then the breaker.  It
  must equal ``write_sediment_map_plain`` bit for bit on square, ragged
  and narrow grids at radius 6, 8 and 15, piles on corners and edges; a
  halo one cell short must not;
- the operations and bytes ``cost`` counts.
"""

import pathlib
import re

import numpy as np
import pytest
import torch

from noize_tpu_torch import _cuda
from noize_tpu_torch.erosion import sediment as SE
from noize_tpu_torch.erosion import sediment_cuda as SK
from noize_tpu_torch.erosion.params import ErosionSettings

SOURCE = (pathlib.Path(__file__).resolve().parent.parent / "noize_tpu_torch" / "csrc"
          / "sediment.cu").read_text()
TILE_ROWS = int(re.search(r"kTileRows = (\d+)", SOURCE).group(1))
TILE_COLS = int(re.search(r"kTileCols = (\d+)", SOURCE).group(1))
HEIGHT = 1000.0
F32 = np.float32


def _case(shape, seed, piles=True, radius=15, negative=False):
    """A height with cells near 0 and 1 (the breaker engages), sediment of
    both signs with values on and beside the threshold, and piles on the
    corners, on each edge and one reach in from an edge."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    h = rng.uniform(0.2, 0.8, shape).astype(F32)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = F32(0.99999)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = F32(1e-6)
    sed = rng.normal(-1e-3 if negative else 0.0, 3e-4 if negative else 1e-4, shape).astype(F32)
    thresh = F32(2.0 / HEIGHT)
    edge = [thresh, np.nextafter(thresh, F32(0)), -thresh, 0.0, -0.0]
    if piles:
        edge.append(np.nextafter(thresh, F32(1)))
    sed.flat[rng.choice(sed.size, len(edge), replace=False)] = edge
    if piles:
        for r, c in [(0, 0), (0, cols - 1), (rows - 1, 0), (rows - 1, cols - 1),
                     (0, cols // 2), (rows // 2, 0), (rows - 1, cols // 3),
                     (rows // 3, cols - 1), (1, 5), (radius - 1, radius), (rows // 2, cols // 2)]:
            sed[r, c] = rng.uniform(0.005, 0.05)
    return h, sed


def _params(radius, exact=False):
    return ErosionSettings(PILING_RADIUS=radius, EXACT_PILES=exact).as_parameters()


# --- the CPU path ---------------------------------------------------------------

@pytest.mark.parametrize("exact, piles", [(False, True), (True, True), (False, False),
                                          (True, False)],
                         ids=["False", "True", "False-no_pile", "True-no_pile"])
def test_cpu_tensor_takes_the_plain_path(exact, piles):
    """``write_sediment_map`` and ``write_sediment_cuda`` on CPU tensors
    give the plain version's result, record the one host sync, and launch
    nothing; so does ``write_sediment_piles`` given the answer of
    ``piles_flag``, into a map of its own or into ``out``."""
    h, sed = _case((48, 48), 1, piles=piles, radius=6)
    h, sed = torch.from_numpy(h), torch.from_numpy(sed)
    params = _params(6, exact)
    want = SE.write_sediment_map_plain(h, sed, params, HEIGHT)
    for fn in (SE.write_sediment_map, SK.write_sediment_cuda):
        syncs = []
        got = fn(h, sed, params, HEIGHT, syncs=syncs)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
        assert syncs == ["sediment.piles"]
    assert bool(SE.piles_flag(sed, params, HEIGHT)) == piles
    for out in (None, torch.full_like(h, float("nan"))):
        got = SE.write_sediment_piles(h, sed, params, HEIGHT, piles, out=out)
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.numpy().view(np.int32))
        if out is not None and not (exact and piles):  # the exact solver commits on a copy
            assert got is out
    assert SK.write_sediment_cuda.launches == 0
    assert SK.write_sediment_cuda.tent_launches == 0
    assert not torch.equal(want, h)


def test_axis_weights_are_the_plain_versions():
    """Product weights are the taps reversed, fold weights the taps'
    float32 running sums from the middle down; KERNEL5 and every tent up
    to K11's widest."""
    w, f = SE.axis_weights(SE.KERNEL5)
    np.testing.assert_array_equal(w, SE.KERNEL5[::-1])
    np.testing.assert_array_equal(f, [SE.KERNEL5[0] + SE.KERNEL5[1], SE.KERNEL5[0]])
    for radius in range(1, SK.MAX_RADIUS + 1):
        taps = SE._triangle_taps(radius)
        w, f = SE.axis_weights(taps)
        assert w.dtype == f.dtype == np.float32 and len(w) == 2 * radius + 1
        np.testing.assert_array_equal(f, np.cumsum(taps)[radius - 1::-1])


def test_constants_pack_the_weights():
    """The by-value struct holds the threshold, KERNEL5's weights and, with
    the tent on, the tent's; its widths are the source's."""
    assert f"kMaxTaps = {_cuda.MAX_SEDIMENT_TAPS};" in SOURCE
    assert SK.MAX_RADIUS == (_cuda.MAX_SEDIMENT_TAPS - 1) // 2
    off = SK._constants(float(F32(0.002)), 0)
    assert off.kt == 0 and off.kd == 5 and off.thresh == float(F32(0.002))
    on = SK._constants(float(F32(0.002)), 15)
    assert on.kt == 31
    w, f = SE.axis_weights(SE._triangle_taps(15))
    np.testing.assert_array_equal(np.asarray(on.wt[:31], F32), w)
    np.testing.assert_array_equal(np.asarray(on.ft[:15], F32), f)
    w, f = SE.axis_weights(SE.KERNEL5)
    np.testing.assert_array_equal(np.asarray(on.wd[:5], F32), w)
    np.testing.assert_array_equal(np.asarray(on.fd[:2], F32), f)


def test_cost_counts():
    """24 operations a cell without the tent, 149 with radius 15, plus 2 a
    fold on the edge lines; 12 bytes a cell."""
    ops, nbytes = SK.cost(2048, 2048)
    assert nbytes == 12 * 2048 ** 2
    assert ops == 24 * 2048 ** 2 + 2 * 4 * 2 * 2048
    ops, _ = SK.cost(2048, 2048, 15)
    assert ops == 149 * 2048 ** 2 + 2 * (4 + 30) * 2 * 2048


# --- the kernel, replayed -------------------------------------------------------

def _disperse(src, at, g, n, w, f):
    """``disperse`` of the source along axis 0 of ``src`` for the cells at
    window positions ``at`` (grid positions ``g`` of ``n``): the taps in
    order from the first product, then each edge cell's folds."""
    off = (len(w) - 1) // 2
    s = src[at - off] * w[0]
    for i in range(1, len(w)):
        s = s + src[at - off + i] * w[i]
    for edge, sign in ((0, 1), (n - 1, -1)):
        for t in np.nonzero(g == edge)[0]:
            for j in range(off):
                s[t] = s[t] + src[at[t] + sign * j] * f[j]
    return s


def _replay(h, sed, thresh, radius, halo_short=0):
    """K11's tiles in NumPy float32 (``radius`` 0: no tent); ``halo_short``
    loads the window that many cells short of the stamps' reach."""
    rows, cols = h.shape
    stamps = [SE.axis_weights(SE.KERNEL5)]
    if radius:
        stamps.append(SE.axis_weights(SE._triangle_taps(radius)))
    halo = max((len(w) - 1) // 2 for w, _ in stamps)
    parts = [lambda s: np.where(s <= thresh, s, F32(0)), lambda s: np.where(s > thresh, s, F32(0))]
    out = np.empty_like(h)
    for r0 in range(0, rows, TILE_ROWS):
        for c0 in range(0, cols, TILE_COLS):
            gr = np.arange(r0 - halo, r0 + TILE_ROWS + halo)
            gc = np.arange(c0 - halo, c0 + TILE_COLS + halo)
            in_r, in_c = (gr >= 0) & (gr < rows), (gc >= 0) & (gc < cols)
            win = np.zeros((gr.size, gc.size), F32)
            win[np.ix_(in_r, in_c)] = sed[np.ix_(gr[in_r], gc[in_c])]
            if halo_short:  # a window loaded one ring short
                ring = np.ones(win.shape, bool)
                ring[halo_short:-halo_short, halo_short:-halo_short] = False
                win[ring] = 0.0
            tr = np.arange(TILE_ROWS)
            tc = np.arange(TILE_COLS)
            delta = None
            for (w, f), part in zip(stamps, parts):
                first = _disperse(part(win), tr + halo, r0 + tr, rows, w, f)
                first[(r0 + tr) >= rows] = 0.0
                first[:, ~in_c] = 0.0
                d = _disperse(first.T, tc + halo, c0 + tc, cols, w, f).T
                delta = d if delta is None else delta + d
            rr, cc = slice(r0, min(r0 + TILE_ROWS, rows)), slice(c0, min(c0 + TILE_COLS, cols))
            hh = h[rr, cc]
            nh = hh + delta[:hh.shape[0], :hh.shape[1]]
            out[rr, cc] = np.where((nh >= 0.0) & (nh <= 1.0), nh, hh)
    return out


@pytest.mark.parametrize("radius", [6, 8, 15])
@pytest.mark.parametrize("shape", [(48, 48), (97, 150), (70, 33)])
def test_replay_matches_plain(shape, radius):
    """Square, ragged on both axes and narrower than a tile; piles on the
    corners and edges, so that every fold runs."""
    h, sed = _case(shape, radius, radius=radius)
    params = _params(radius)
    want = SE.write_sediment_map_plain(torch.from_numpy(h), torch.from_numpy(sed), params,
                                       HEIGHT).numpy()
    got = _replay(h, sed, F32(params.PILE_THRESHOLD / HEIGHT), radius)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("negative", [False, True])
def test_replay_matches_plain_without_piles(negative):
    """No pile: the tent is off, the halo KERNEL5's; sediment of both signs,
    or mostly negative, so that the breaker holds cells at 0."""
    h, sed = _case((97, 150), 3, piles=False, negative=negative)
    params = _params(15)
    assert not (sed > params.PILE_THRESHOLD / HEIGHT).any()
    want = SE.write_sediment_map_plain(torch.from_numpy(h), torch.from_numpy(sed), params,
                                       HEIGHT).numpy()
    got = _replay(h, sed, F32(params.PILE_THRESHOLD / HEIGHT), 0)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert (got == h).sum() > h.size // 100  # the breaker kept some heights


@pytest.mark.parametrize("radius,short", [(0, 1), (15, 2)])
def test_replay_with_a_short_halo_differs(radius, short):
    """The halo is what makes tiles exact: loaded ``short`` cells short,
    sediment across a tile's edge changes cells the next tile computes.
    (The tent's outermost taps are 0, so its halo must be two short.)"""
    h, sed = _case((97, 150), 5, piles=bool(radius), radius=15)
    if radius:
        sed[40, TILE_COLS - 20:TILE_COLS + 20] = 0.03
    params = _params(15)
    want = SE.write_sediment_map_plain(torch.from_numpy(h), torch.from_numpy(sed), params,
                                       HEIGHT).numpy()
    thresh = F32(params.PILE_THRESHOLD / HEIGHT)
    np.testing.assert_array_equal(_replay(h, sed, thresh, radius), want)
    assert not np.array_equal(_replay(h, sed, thresh, radius, halo_short=short), want)
