"""K9 — the in-order event scatter in CUDA (``csrc/scatter.cu``).

The reference scatter-adds the descent's events, and the vegetation
stamps, with XLA scatters that add each cell's values in order; the CPU's
``index_put_(accumulate=True)`` does the same below 32768 values a call,
which ``particles.scatter_events`` keeps to.  CUDA's ``index_put_`` sums a
cell's run of 32 or more in a warp's lanes, so its bits depend on how the
events are split over calls (ROADMAP.md §3).  K9 adds each cell's events to
it one by one, in event order, so the card's sums are the CPU's bit for
bit: one cooperative launch sorts the cells with a stable LSD radix sort
of its own (only the bits ``size`` needs, :func:`sort_plan`; each event
moves as one 16-byte record of its key and deltas, so nothing is gathered
through a permutation), shared by every map, then adds each run of equal
cells on one thread.  ``particles.scatter_events`` is its plain version
and its one caller on the card.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _cuda

#: maps a call adds at once (``scatter.cu``'s ``kMaxMaps``)
MAX_MAPS = 4
#: the widest digit a sort pass takes (``kMaxDigitBits``: a block keeps a
#: count of each of its 2^11 + 1 buckets a warp in shared memory)
DIGIT_BITS = 11
#: events a tile of a sort pass ranks in shared memory (``kTileEvents``)
TILE_EVENTS = 2048
#: past this many tiles a pass takes at most ``MANY_TILES_DIGIT_BITS``: the scan
#: across tiles and each tile's work on its buckets grow with the buckets,
#: and at the vegetation's 524,288 events (256 tiles) three passes of 257
#: buckets cost less than two of 2,049; at the descent's 104,000 (51 tiles)
#: two of 2,049 cost less (PERF.md, scripts/k9_shapes.py --digit-bits)
MANY_TILES = 128
MANY_TILES_DIGIT_BITS = 8


def sort_plan(size: int, n: int):
    """K9's sort of ``n`` events on ``size`` cells: (key bits, passes,
    digit bits, tiles).  The keys are cells in [0, size), so only
    ``ceil(log2 size)`` bits are sorted (at least one), in the fewest
    passes of at most :data:`DIGIT_BITS` bits (:data:`MANY_TILES_DIGIT_BITS`
    past :data:`MANY_TILES` tiles), spread evenly over them; each pass
    ranks ``tiles`` tiles of :data:`TILE_EVENTS` events."""
    bits = max(1, (size - 1).bit_length())
    tiles = -(-n // TILE_EVENTS)
    passes = -(-bits // (DIGIT_BITS if tiles <= MANY_TILES else MANY_TILES_DIGIT_BITS))
    return bits, passes, -(-bits // passes), tiles


def scratch_words(n: int, digit_bits: int, maps: int) -> int:
    """The 32-bit words of scratch a call needs (``scatter.cu``'s layout):
    two buffers of 16-byte records (an event's key and three deltas), the
    first pass's keys, two buffers of the fourth map's deltas when there is
    one, each tile's count of each bucket (the digits and the skipped
    events' bucket) and the buckets' totals."""
    buckets = (1 << digit_bits) + 1
    return (9 + 2 * (maps == MAX_MAPS)) * n + (-(-n // TILE_EVENTS) + 1) * buckets


def _pointers(tensors):
    return (ctypes.c_void_p * len(tensors))(*(t.data_ptr() for t in tensors))


def scatter_in_order(cells, deltas, size: int, acc=None):
    """Add each event's deltas to its cell of the flat f32 maps ``acc``
    (in place; zeros of ``size`` when None), each cell's events in their
    order: ``cells`` i64[n] in [0, size), ``deltas`` up to four f32[n],
    all on one CUDA device.  Into fresh zeros an event whose deltas are all
    zero is skipped: adding ±0.0 to a sum that started at +0.0 changes no
    bit.  One launch of K9 (the sort and the run pass; no host sync), after
    the fresh maps' fill; a cell outside [0, size) traps on the card, as
    ``index_put_`` asserts."""
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
    if n >= 2**31 - 1:
        raise ValueError(f"scatter_in_order: {n} events, K9's 32-bit positions take fewer "
                         "than 2^31 - 1")
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
    _, passes, digit_bits, _ = sort_plan(size, n)
    scratch = torch.empty(scratch_words(n, digit_bits, k), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _cuda.call("noize_scatter_in_order", cells.data_ptr(), _pointers(deltas),
                   _pointers(acc), k, n, size, int(fresh), passes, digit_bits,
                   scratch.data_ptr(), _cuda.stream(cells))
    scatter_in_order.launches += 1
    return acc


scatter_in_order.launches = 0
