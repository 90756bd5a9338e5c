"""K9 — the in-order event scatter in CUDA (``csrc/scatter.cu``).

The reference scatter-adds the descent's events, and the vegetation
stamps, with XLA scatters that add each cell's values in order; the CPU's
``index_put_(accumulate=True)`` does the same below 32768 values a call,
which ``particles.scatter_events`` keeps to.  CUDA's ``index_put_`` sums a
cell's run of 32 or more in a warp's lanes, so its bits depend on how the
events are split over calls (ROADMAP.md §3).  K9 adds each cell's events to
it one by one, in event order, so the card's sums are the CPU's bit for
bit: one stable sort of the cells (``torch.sort``) shared by every map,
then one thread a run of equal cells.  ``particles.scatter_events`` is its
plain version and its one caller on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

#: maps a call adds at once (``scatter.cu``'s ``kMaxMaps``)
MAX_MAPS = 4


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def scatter_in_order(cells, deltas, size: int, acc=None):
    """Add each event's deltas to its cell of the flat f32 maps ``acc``
    (in place; zeros of ``size`` when None), each cell's events in their
    order: ``cells`` i64[n] in [0, size), ``deltas`` up to four f32[n],
    all on one CUDA device.  Into fresh zeros an event whose deltas are all
    zero is skipped: adding ±0.0 to a sum that started at +0.0 changes no
    bit.  One call of K9 (a key pass, ``torch.sort``, the run pass); a
    cell outside [0, size) traps on the card, as ``index_put_`` asserts."""
    dev = cells.device
    if dev.type != "cuda":
        raise ValueError(f"scatter_in_order: expected CUDA tensors, got {dev}")
    k = len(deltas)
    if not 1 <= k <= MAX_MAPS:
        raise ValueError(f"scatter_in_order: 1 to {MAX_MAPS} maps a call, got {k}")
    if not 1 <= size < 2**31 - 1:
        raise ValueError(f"scatter_in_order: size {size} outside [1, 2^31 - 1)")
    n = cells.numel()
    if cells.dtype != torch.int64 or cells.shape != (n,) or not cells.is_contiguous():
        raise ValueError("scatter_in_order: cells must be a contiguous i64 [n] tensor")
    for d in deltas:
        if d.dtype != torch.float32 or d.shape != (n,) or d.device != dev \
                or not d.is_contiguous():
            raise ValueError(f"scatter_in_order: deltas must be contiguous f32 [{n}] on {dev}")
    fresh = acc is None
    if fresh:  # one fill for every map
        acc = list(torch.zeros((k, size), dtype=torch.float32, device=dev).unbind(0))
    if len(acc) != k or any(a.dtype != torch.float32 or a.shape != (size,) or a.device != dev
                            or not a.is_contiguous() for a in acc):
        raise ValueError(f"scatter_in_order: {k} contiguous f32 [{size}] maps on {dev} "
                         "to add into")
    if n == 0:
        return acc
    stream = _cuda.stream(cells)
    keys = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("noize_scatter_keys", cells.data_ptr(), _pointers(deltas), k, n, size,
                   int(fresh), keys.data_ptr(), stream)
        order, perm = torch.sort(keys, stable=True)
        _cuda.call("noize_scatter_runs", order.data_ptr(), perm.data_ptr(), n,
                   _pointers(deltas), _pointers(acc), k, stream)
    scatter_in_order.launches += 1
    return acc


scatter_in_order.launches = 0
