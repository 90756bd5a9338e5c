"""K11 — the sediment write-back in CUDA (``csrc/sediment.cu``).

``sediment.write_sediment_piles`` (ErodeHeightMaps + WriteSedimentMap,
given the ``sediment.piles`` answer) splits a cycle's sediment at
``sediment.pile_threshold``, disperses the light part through KERNEL5,
deposits the heavy part as a tent of radius PILING_RADIUS when a cell
piles, adds both to the height and keeps a cell's old height where the sum
leaves [0, 1].  Its plain version, ``sediment.write_sediment_map_plain``,
runs each stamp axis as a multiply and an add a tap and three updates a
fold, some 370 launches a cycle with a pile; K11 computes the whole
write-back in one launch, bit-equal to it.  It replaces no TPU kernel: the
JAX package leaves this path to XLA's fusion.

The piles decision and the dispatch live in ``erosion.sediment``, which
sends CUDA tensors here: the taps come from ``params`` (KERNEL5 and
``_triangle_taps(PILING_RADIUS)``), the tent is on when the answer is a
pile and ``EXACT_PILES`` is off (with it, K6 commits the piles after K11),
and the grid's shape is the tensors'.

``write_sediment_cuda`` is ``sediment.write_sediment_map`` under K11's
name; ``write_sediment_cuda.launches`` counts K11's launches and
``.tent_launches`` those that ran the tent.
"""

from __future__ import annotations

import functools

import torch

from .. import _cuda
from . import sediment as _sediment

#: the widest tent K11 takes (csrc/sediment.cu's ``kMaxTaps`` = 2·31 + 1)
MAX_RADIUS = 31


@functools.lru_cache(maxsize=32)
def _constants(thresh: float, radius: int) -> _cuda.Sediment:
    """K11's by-value constants: the threshold and KERNEL5's weights, and
    the tent's of ``radius`` (0: no tent), as ``sediment.axis_weights``
    gives them to the plain version."""
    p = _cuda.Sediment()
    p.thresh = thresh
    w, f = _sediment.axis_weights(_sediment.KERNEL5)
    p.kd = len(w)
    p.wd[:len(w)], p.fd[:len(f)] = w.tolist(), f.tolist()
    if radius:
        w, f = _sediment.axis_weights(_sediment._triangle_taps(radius))
        p.kt = len(w)
        p.wt[:len(w)], p.ft[:len(f)] = w.tolist(), f.tolist()
    return p


def cost(rows: int, cols: int, radius: int = 0):
    """(float32 operations, bytes) of one K11 call on ``rows`` × ``cols``,
    with the tent of ``radius`` (0: none), as ``csrc/sediment.cu`` counts
    them: each part of the split 2 a cell, each axis of a k-tap stamp
    2k − 1 a cell and 2 a fold on its two edge lines, the tent's add 1, the
    height's add 1 and the breaker 3 a cell; the height and the sediment
    read once and the height written once."""
    cells = rows * cols

    def stamp(k):
        return 2 * (2 * k - 1) * cells + 2 * (k - 1) * (rows + cols)

    ops = 2 * cells + stamp(len(_sediment.KERNEL5)) + 4 * cells
    if radius:
        ops += 2 * cells + stamp(2 * radius + 1) + cells
    return ops, 12 * cells


def _launch(height, sed_acc, thresh: float, radius: int, out=None):
    """One K11 launch: the new height of ``height`` with ``sed_acc``
    written back at the threshold ``thresh``, with the tent of ``radius``
    (0: none), into ``out`` (a map apart from both; None: a new one)."""
    name = "write_sediment_cuda"
    _cuda.check_map(height, name, square=False)
    _cuda.check_map(sed_acc, name, square=False)
    if sed_acc.shape != height.shape or sed_acc.device != height.device:
        raise ValueError(f"{name}: height and sed_acc must match in shape and device")
    if radius and not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"{name}: PILING_RADIUS must be in [1, {MAX_RADIUS}], got {radius}")
    rows, cols = height.shape
    need = max(2, radius)
    if rows < need or cols < need:
        raise ValueError(f"{name}: a {rows} × {cols} grid is smaller than the stamps' reach; "
                         f"need at least {need} × {need}")
    if out is None:
        out = torch.empty_like(height)
    else:
        _cuda.check_map(out, name, square=False)
        if out.shape != height.shape or out.device != height.device \
                or out.data_ptr() in (height.data_ptr(), sed_acc.data_ptr()):
            raise ValueError(f"{name}: out must be a map of the height's shape and device "
                             "apart from height and sed_acc")
    index = height.device.index
    with _cuda.on_device(index):
        _cuda.call("noize_sediment", height.data_ptr(), sed_acc.data_ptr(), out.data_ptr(), rows,
                   cols, _constants(thresh, radius), _cuda.raw_stream(index))
    write_sediment_cuda.launches += 1
    write_sediment_cuda.tent_launches += bool(radius)
    return out


def write_sediment_cuda(height, sed_acc, params, height_scale, *, syncs: list = None):
    """``sediment.write_sediment_map``: on CUDA tensors one K11 launch a
    call, after the ``sediment.piles`` host sync (recorded in ``syncs`` when
    given) that says whether the tent runs, or raises; CPU tensors take the
    plain version."""
    return _sediment.write_sediment_map(height, sed_acc, params, height_scale, syncs=syncs)


write_sediment_cuda.launches = 0
write_sediment_cuda.tent_launches = 0
