"""Sediment write-back: kernel dispersal + pile deposition; port of
``noize_tpu.erosion.sediment``.

A clamped-scatter stamp is a full correlation whose out-of-range margins
fold onto the edge rows/columns; it is separable because the reference
clamps each axis on its own.  The [0,1] "bad build breaker" applies per
destination cell on the summed delta.  Piles (cells banking more than
PILE_THRESHOLD metres) are deposited as a separable tent of radius
PILING_RADIUS, or, with ``EXACT_PILES``, by the reference's serial
PileSolver transcription (``exact_pile_deposit``: kernel K6 on the card,
``erosion.pile_cuda``).

The piles decision is made once: ``pile_threshold`` is the threshold,
``piles_flag`` the device bool of "a cell piles", which the
``sediment.piles`` host sync reads, and ``write_sediment_piles`` the
write-back given that answer (the split, the dispersal, the tent when a
cell piles and ``EXACT_PILES`` is off, the breaker; then K6 when a cell
piles and ``EXACT_PILES`` is on).  ``write_sediment_map`` is the flag,
the sync and the write-back; the erosion cycle (``erosion.sim``) takes the
sync between its two halves instead.  On the card the split, dispersal,
tent and breaker are kernel K11 (``erosion.sediment_cuda``); its plain
version is ``write_sediment_map_plain``.
"""

from __future__ import annotations

import numpy as np
import torch

from ..utils.tracking import sync_bool

# ErodeHeightMaps kernel5 (MultiThreadErosionJob.cs:449-455)
KERNEL5 = np.array(
    [0.12007838424321349, 0.23388075658535032, 0.29208171834287244,
     0.23388075658535032, 0.12007838424321349],
    np.float32,
)


def axis_weights(taps):
    """The float32 weights of ``_disperse_axis``: (product weights, fold
    weights).  Product i multiplies the zero-padded source at offset i by
    ``taps[k - 1 - i]``; fold j adds source j (n - 1 - j) to the low (high)
    edge cell times ``cumsum(taps)[off - 1 - j]``, off = (k − 1) // 2."""
    taps = np.asarray(taps, np.float32)
    off = (len(taps) - 1) // 2
    t_lo = np.cumsum(taps)
    return taps[::-1].copy(), np.array([t_lo[off - j - 1] for j in range(off)], np.float32)


def _disperse_axis(s, taps, axis: int):
    """Clamped-scatter 1-D dispersal: every source cell stamps taps at
    clamp(c+d); out-of-range taps accumulate on the edge cell."""
    w, folds = axis_weights(taps)
    k = len(w)
    off = (k - 1) // 2
    n = s.shape[axis]
    s = torch.movedim(s, axis, -1)
    zpad = torch.nn.functional.pad(s, (off, off))
    out = None
    for i in range(k):
        piece = zpad[..., i:i + n] * float(w[i])
        out = piece if out is None else out + piece
    # fold: source col j (< off) sends Σ_{i<off-j} taps[i] to col 0
    for j in range(off):
        w_lo = float(folds[j])
        out[..., 0] = out[..., 0] + s[..., j] * w_lo
        out[..., n - 1] = out[..., n - 1] + s[..., n - 1 - j] * w_lo
    return torch.movedim(out, -1, axis)


def kernel_disperse(sed, taps=KERNEL5):
    """2-D separable clamped-scatter stamp (KernelDisperse)."""
    return _disperse_axis(_disperse_axis(sed, taps, 0), taps, 1)


def _triangle_taps(radius: int) -> np.ndarray:
    """Normalised 1-D triangle taps (radius − |d|)₊ with an emphasised
    peak — the separable factor of the pile profile."""
    d = np.arange(-radius, radius + 1)
    w = np.maximum(radius - np.abs(d), 0.0).astype(np.float64)
    w[radius] = radius
    return (w / w.sum()).astype(np.float32)


def pile_deposit(pile_map, radius: int):
    """Deposit each cell's pile volume as a separable tent (triangle ⊗
    triangle) of radius ``radius``, folding at the borders so mass is
    conserved."""
    taps = _triangle_taps(radius)
    return _disperse_axis(_disperse_axis(pile_map, taps, 0), taps, 1)


# --------------------------------------------------------------------------
# Exact PileSolver (opt-in, ``EXACT_PILES``): the reference's serial
# transcription of the Manhattan-ring algorithm, quirks included —
# duplicate ring vertices with their own value caches, commits of modified
# slots only with the last write winning, out-of-grid vertices skipped.
# PileSolver / ManhattanVertex, LiveErosionDataTypes.cs:1052-1228.

_PILE_TABLES = {}


def _pile_tables(radius: int):
    """Static slot and visit tables for one solver radius.

    Slots enumerate as PileSolver.Init: dist 0..radius-1, direction pairs
    (up,right), (right,down), (down,left), (left,up), i in 0..dist+1 with
    offset = dist·dirA + i·(dirB − dirA).  Slots come in ascending dist,
    so a DepositSediment round ``rnd`` (1..radius) visits the first
    ``ends[rnd - 1]`` slots, in slot order; ``visit_slot`` and
    ``visit_round`` spell that sequence out, as the reference's tables
    do."""
    if radius in _PILE_TABLES:
        return _PILE_TABLES[radius]
    dirs = [(1, 0), (0, 1), (-1, 0), (0, -1)]  # up, right, down, left
    pairs = [(dirs[0], dirs[1]), (dirs[1], dirs[2]),
             (dirs[2], dirs[3]), (dirs[3], dirs[0])]
    off_r, off_c, dist_l = [], [], []
    for dist in range(radius):
        for (ar, ac), (br, bc) in pairs:
            for i in range(dist + 2):
                off_r.append(dist * ar + i * (br - ar))
                off_c.append(dist * ac + i * (bc - ac))
                dist_l.append(dist)
    dist_l = np.asarray(dist_l, np.int32)
    off_r, off_c = np.asarray(off_r, np.int32), np.asarray(off_c, np.int32)
    # a slot's occurrence rank among the slots on its cell; dup_higher[k, k']:
    # slot k' is on k's cell with a higher rank, so its commit overrides k's
    seen, rank = {}, np.zeros(len(off_r), np.int32)
    for k, cell in enumerate(zip(off_r.tolist(), off_c.tolist())):
        rank[k] = seen.get(cell, 0)
        seen[cell] = rank[k] + 1
    same = (off_r[:, None] == off_r[None, :]) & (off_c[:, None] == off_c[None, :])
    ends = np.asarray([int((dist_l < rnd).sum()) for rnd in range(1, radius + 1)], np.int32)
    visit_slot = np.concatenate([np.arange(e, dtype=np.int32) for e in ends])
    visit_round = np.concatenate([np.full(e, rnd, np.float32)
                                  for rnd, e in zip(range(1, radius + 1), ends)])
    tables = dict(off_r=off_r, off_c=off_c, ends=ends, visit_slot=visit_slot,
                  visit_round=visit_round, rank=rank,
                  dup_higher=same & (rank[None, :] > rank[:, None]))
    _PILE_TABLES[radius] = tables
    return tables


def _solve_pile(vals0, valid, amount, increment, radius: int):
    """The DepositSediment sweep loop of one pile on its slot cache: repeat
    the whole (round, slot) visit sequence until ``amount`` is placed.
    Returns (vals, modified), the commit's inputs.

    ``vals0`` (float32[S]) and ``valid`` (bool[S]) are host arrays.  The
    visits are serial — each reads the amount the ones before it placed —
    so they run on the host as float32 scalars, every op rounded on its
    own in the reference's order: ``remaining = amount − deposited``,
    ``level = vals[0] + increment·rnd``, ``diff = min(increment,
    remaining)``, ``vals[k] + diff``, ``deposited + diff``, then ``amount −
    deposited`` for the next sweep.  A sweep that places nothing leaves
    the state as it found it, so the loop stops there (the reference's
    loop would not end)."""
    t = _pile_tables(radius)
    f32 = np.float32
    vals = np.array(vals0, dtype=f32)
    valid = np.asarray(valid, dtype=bool)
    modified = np.zeros(vals.shape, dtype=bool)
    inc = f32(increment)
    rounds = [f32(r) for r in range(1, radius + 1)]
    left = f32(amount)
    while left > f32(0.0):
        deposited = f32(0.0)
        for rf, end in zip(rounds, t["ends"].tolist()):
            for k in range(end):
                remaining = left - deposited
                level = vals[0] + inc * rf
                ok = bool(valid[k]) and vals[k] < level and remaining > f32(0.0)
                diff = min(inc, remaining) if ok else f32(0.0)
                vals[k] = vals[k] + diff
                modified[k] |= ok
                deposited = deposited + diff
        if deposited == f32(0.0):
            break
        left = left - deposited
    return vals, modified


def _handle_pile(height, r0, c0, amount, increment, radius: int):
    """HandlePile (LiveErosionDataTypes.cs:1157-1166) for one pile: sweep
    DepositSediment until the volume is placed (``_solve_pile``), then
    commit the modified in-grid slots in slot order, the last write to a
    cell winning.  ``height`` is updated in place and returned."""
    t = _pile_tables(radius)
    res_r, res_c = height.shape
    rows = int(r0) + t["off_r"]
    cols = int(c0) + t["off_c"]
    valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
    cr = np.clip(rows, 0, res_r - 1)
    cc = np.clip(cols, 0, res_c - 1)
    flat = height.view(-1)
    vals0 = flat[torch.from_numpy(cr * res_c + cc).long().to(height.device)].cpu().numpy()
    vals, modified = _solve_pile(vals0, valid, amount, increment, radius)
    # last write wins: of the slots committing to one cell keep the last
    commit = np.nonzero(modified & valid)[0]
    cells = rows[commit] * res_c + cols[commit]
    _, last = np.unique(cells[::-1], return_index=True)
    keep = commit[::-1][last]
    idx = torch.from_numpy((rows[keep] * res_c + cols[keep]).astype(np.int64))
    flat[idx.to(height.device)] = torch.from_numpy(vals[keep]).to(height.device)
    return height


def solve_pile_table_plain(vals0, valid, vols, cid, increment, radius: int):
    """The plain version of K6's table entry (``pile_cuda.solve_pile_table``):
    the sharded ``EXACT_PILES`` solve on a table of K piles × S slots that
    every rank holds — ``vals0`` (f32[K, S]) the slot values gathered from
    the map, ``valid`` (bool) the in-grid slots, ``vols`` (f32[K]) the
    volumes in processing order, ``cid`` (int64) the clamped cell each slot
    reads.  Pile j runs ``_solve_pile`` on its row; its effective writes
    (modified, in grid, and the last slot on their cell: ``dup_higher``)
    then overlay every later pile's slots on the same cells, as the
    reference's ``fori_loop`` does (its sum over the matching slots has one
    term: a pile writes a cell once).  Returns (com_vals f32[K, S], com_eff
    bool[K, S]) on ``vals0``'s device."""
    dup = _pile_tables(radius)["dup_higher"]
    cur = vals0.detach().cpu().numpy().astype(np.float32, copy=True)
    valid_h = valid.detach().cpu().numpy().astype(bool)
    vols_h = vols.detach().cpu().numpy().astype(np.float32)
    cid_h = cid.detach().cpu().numpy()
    com_vals = np.zeros_like(cur)
    com_eff = np.zeros(cur.shape, bool)
    for j in range(cur.shape[0]):
        vals, modified = _solve_pile(cur[j], valid_h[j], vols_h[j], increment, radius)
        write = modified & valid_h[j]
        eff = write & ~np.any(dup & write[None, :], axis=1)
        com_vals[j], com_eff[j] = vals, eff
        # only the later piles that read a written cell can change
        near = j + 1 + np.nonzero(np.isin(cid_h[j + 1:], cid_h[j][eff]).any(1))[0]
        if near.size:
            m = eff[None, None, :] & (cid_h[near][:, :, None] == cid_h[j][None, None, :])
            newv = np.where(m, vals[None, None, :], np.float32(0.0)).sum(-1, dtype=np.float32)
            cur[near] = np.where(m.any(-1), newv, cur[near])
    dev = vals0.device
    return torch.from_numpy(com_vals).to(dev), torch.from_numpy(com_eff).to(dev)


def select_piles(pile_map, max_piles: int = 64):
    """The piles ``exact_pile_deposit`` solves, in its order: the
    ``max_piles`` largest volumes (ties to the lower cell index, as
    ``lax.top_k`` gives them), then ascending cell index for the positive
    ones, the rest after them.  A stable sort of ``-volume`` over the flat
    map keeps ties in index order on the CPU and the card alike.  Returns
    (volumes f32[k], flat cell indices int64[k]) on ``pile_map``'s device;
    nothing syncs with the host."""
    flat = pile_map.reshape(-1)
    order = torch.sort(-flat, stable=True).indices[:max_piles]
    vols = flat[order]
    big = torch.full_like(order, flat.numel())
    order = order[torch.sort(torch.where(vols > 0.0, order, big), stable=True).indices]
    return flat[order], order


def pile_increment(params, height_scale) -> float:
    """MIN_PILE_INCREMENT / HEIGHT as the reference's float32 scalar."""
    return float(np.float32(params.MIN_PILE_INCREMENT / float(height_scale)))


def exact_pile_deposit_plain(height, pile_map, increment, radius: int,
                             max_piles: int = 64):
    """The plain version of kernel K6: every selected pile of positive
    volume through ``_handle_pile``, one after another, on a copy of
    ``height`` (on its device; the visits run on the host)."""
    res_c = height.shape[1]
    vols, idxs = select_piles(pile_map, max_piles)
    out = height.clone(memory_format=torch.contiguous_format)
    for vol, idx in zip(vols.tolist(), idxs.tolist()):
        if vol > 0.0:
            _handle_pile(out, idx // res_c, idx % res_c, np.float32(vol), increment, radius)
    return out


def exact_pile_deposit(height, pile_map, params, height_scale,
                       max_piles: int = 64):
    """Apply the exact PileSolver to the ``max_piles`` largest piles,
    serially in ascending cell order (the reference drains a hash-ordered
    queue; ascending index is its deterministic stand-in).  A CUDA tensor
    runs kernel K6, one launch for all the piles; a CPU tensor the plain
    version."""
    from .pile_cuda import exact_piles

    return exact_piles(height, pile_map, pile_increment(params, height_scale),
                       params.PILING_RADIUS, max_piles)


def pile_threshold(params, height_scale) -> float:
    """PILE_THRESHOLD / HEIGHT rounded to float32, as a float32 map's
    comparisons with it round it: sediment above it piles."""
    return float(np.float32(params.PILE_THRESHOLD / float(height_scale)))


def piles_flag(sed_acc, params, height_scale):
    """Whether a cell of ``sed_acc`` piles (banks more than
    ``pile_threshold``, and more than 0): a device bool, the value the
    ``sediment.piles`` host sync reads."""
    return (sed_acc > max(pile_threshold(params, height_scale), 0.0)).any()


def _write_back(height, sed_acc, params, height_scale, piles: bool, out, k11: bool):
    """The write-back given the ``sediment.piles`` answer ``piles``, on K11
    where ``k11`` (CUDA tensors) or as PyTorch operations."""
    thresh = pile_threshold(params, height_scale)
    radius = int(params.PILING_RADIUS) if piles and not params.EXACT_PILES else 0
    if k11:
        from .sediment_cuda import _launch

        new_height = _launch(height, sed_acc, thresh, radius, out)
    else:
        delta = kernel_disperse(torch.where(sed_acc <= thresh, sed_acc, 0.0), KERNEL5)
        if radius:
            delta = delta + pile_deposit(torch.where(sed_acc > thresh, sed_acc, 0.0), radius)
        new_height = height + delta
        ok = (new_height >= 0.0) & (new_height <= 1.0)
        new_height = torch.where(ok, new_height, height, out=out)
    if piles and params.EXACT_PILES:
        # the exact solver commits heights after the dispersal's breaker, as
        # PileSolver.CommitChanges does
        new_height = exact_pile_deposit(new_height, torch.where(sed_acc > thresh, sed_acc, 0.0),
                                        params, height_scale)
    return new_height


def _synced(height, sed_acc, params, height_scale, syncs, k11: bool):
    piles = sync_bool("sediment.piles", piles_flag(sed_acc, params, height_scale), syncs)
    return _write_back(height, sed_acc, params, height_scale, piles, None, k11)


def write_sediment_piles(height, sed_acc, params, height_scale, piles: bool, *, out=None):
    """The write-back of ``write_sediment_map`` given the ``sediment.piles``
    sync's answer ``piles``: deltas up to ``pile_threshold`` disperse
    through KERNEL5, larger ones pile as the tent when ``piles``; then the
    [0,1] breaker.  With ``EXACT_PILES`` the breaker applies to the
    dispersal only and, when ``piles``, the exact solver commits heights
    after it.  A CUDA tensor runs kernel K11 (``sediment_cuda``), a CPU
    tensor the plain version.  ``out``: the map to write into, apart from
    ``height`` and ``sed_acc`` (None: a new one); with ``EXACT_PILES`` and
    a pile the solver commits on a copy of it, which is returned."""
    return _write_back(height, sed_acc, params, height_scale, piles, out,
                       height.device.type == "cuda")


def write_sediment_map(height, sed_acc, params, height_scale, *, syncs: list = None):
    """ErodeHeightMaps + WriteSedimentMap: ``piles_flag``, the
    ``sediment.piles`` host sync (counted in ``syncs`` when given) and
    ``write_sediment_piles``.  A CPU tensor runs the plain version
    (``write_sediment_map_plain``); a CUDA tensor kernel K11
    (``sediment_cuda``) or raises."""
    return _synced(height, sed_acc, params, height_scale, syncs,
                   height.device.type == "cuda")


def write_sediment_map_plain(height, sed_acc, params, height_scale, *, syncs: list = None):
    """The plain version of kernel K11: ``write_sediment_map`` as PyTorch
    operations on any device."""
    return _synced(height, sed_acc, params, height_scale, syncs, False)
