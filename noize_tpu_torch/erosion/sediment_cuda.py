"""K11 — the sediment write-back in CUDA (``csrc/sediment.cu``).

``sediment.write_sediment_map`` (ErodeHeightMaps + WriteSedimentMap) splits
a cycle's sediment at PILE_THRESHOLD / HEIGHT, disperses the light part
through KERNEL5, deposits the heavy part as a tent of radius
PILING_RADIUS, adds both to the height and keeps a cell's old height where
the sum leaves [0, 1].  Its plain version, ``write_sediment_map_plain``,
runs each stamp axis as a multiply and an add a tap and three updates a
fold, some 370 launches a cycle with a pile; K11 computes the whole
write-back in one launch, bit-equal to it.  It replaces no TPU kernel: the
JAX package leaves this path to XLA's fusion.

The wrapper adapts to what it can observe: the taps from ``params``
(KERNEL5 and ``_triangle_taps(PILING_RADIUS)``), the tent on when the
existing ``sediment.piles`` host sync finds a pile, and the grid's shape.
``piles_flag`` and ``write_sediment_piles`` are the two halves around that
sync, which the erosion cycle's CUDA graphs (``erosion.graphs``) capture
apart.
With ``EXACT_PILES`` K11 runs the dispersal and the breaker without the
tent, and K6 (``erosion.pile_cuda``) commits the piles after it.

``write_sediment_cuda.launches`` counts K11's launches and
``.tent_launches`` those that ran the tent.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import _cuda
from ..utils.tracking import sync_bool
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
    written back, with the tent of ``radius`` (0: none), into ``out`` (a
    map apart from both; None: a new one)."""
    rows, cols = height.shape
    need = max(2, radius)
    if rows < need or cols < need:
        raise ValueError(f"write_sediment_cuda: a {rows} × {cols} grid is smaller than the "
                         f"stamps' reach; need at least {need} × {need}")
    if out is None:
        out = torch.empty_like(height)
    else:
        _cuda.check_map(out, "write_sediment_cuda", square=False)
        if out.shape != height.shape or out.device != height.device \
                or out.data_ptr() in (height.data_ptr(), sed_acc.data_ptr()):
            raise ValueError("write_sediment_cuda: out must be a map of the height's shape "
                             "and device apart from height and sed_acc")
    index = height.device.index
    with _cuda.on_device(index):
        _cuda.call("noize_sediment", height.data_ptr(), sed_acc.data_ptr(), out.data_ptr(), rows,
                   cols, _constants(thresh, radius), _cuda.raw_stream(index))
    write_sediment_cuda.launches += 1
    write_sediment_cuda.tent_launches += bool(radius)
    return out


def _threshold(params, height_scale) -> float:
    # the plain version's comparisons with the Python scalar round it to float32
    return float(np.float32(params.PILE_THRESHOLD / height_scale))


def piles_flag(sed_acc, params, height_scale):
    """Whether a cell of ``sed_acc`` piles, where(sed > thresh, sed, 0) > 0:
    a device bool, the value the ``sediment.piles`` host sync reads."""
    return (sed_acc > max(_threshold(params, height_scale), 0.0)).any()


def write_sediment_piles(height, sed_acc, params, height_scale, piles: bool, *, out=None):
    """One K11 launch on CUDA tensors, with the pile tent when ``piles``
    (the ``sediment.piles`` sync's answer), into ``out`` (None: a new
    map)."""
    thresh = _threshold(params, height_scale)
    if not piles:
        return _launch(height, sed_acc, thresh, 0, out)
    radius = int(params.PILING_RADIUS)
    if not 1 <= radius <= MAX_RADIUS:
        raise ValueError(f"write_sediment_cuda: PILING_RADIUS must be in [1, {MAX_RADIUS}], "
                         f"got {radius}")
    return _launch(height, sed_acc, thresh, radius, out)


def write_sediment_cuda(height, sed_acc, params, height_scale, *, syncs: list = None):
    """``sediment.write_sediment_map`` on K11: one launch a call, after the
    ``sediment.piles`` host sync (recorded in ``syncs`` when given) that
    says whether the tent runs.  A CPU tensor takes the plain version; a
    CUDA tensor launches K11 or raises."""
    if height.device.type == "cpu":
        return _sediment.write_sediment_map_plain(height, sed_acc, params, height_scale,
                                                  syncs=syncs)
    name = "write_sediment_cuda"
    _cuda.check_map(height, name, square=False)
    _cuda.check_map(sed_acc, name, square=False)
    if sed_acc.shape != height.shape or sed_acc.device != height.device:
        raise ValueError(f"{name}: height and sed_acc must match in shape and device")
    if params.EXACT_PILES:
        new_height = _launch(height, sed_acc, _threshold(params, height_scale), 0)
        pile_part = torch.where(sed_acc > params.PILE_THRESHOLD / height_scale, sed_acc, 0.0)
        if sync_bool("sediment.piles", (pile_part > 0.0).any(), syncs):
            new_height = _sediment.exact_pile_deposit(new_height, pile_part, params,
                                                      height_scale)
        return new_height
    piles = sync_bool("sediment.piles", piles_flag(sed_acc, params, height_scale), syncs)
    return write_sediment_piles(height, sed_acc, params, height_scale, piles)


write_sediment_cuda.launches = 0
write_sediment_cuda.tent_launches = 0
