"""K1 — the iterated separable stencil chain (``csrc/stencil.cu``), with
its own X and Z taps and a per-pass factor.

Port of the TPU kernels ``noize_tpu.ops.pallas.stencil.fused_separable_chain``
(2-D halo blocks) and ``fused_separable_chain_rows`` (full-width row
blocks) and of their entry ``gauss_chain``: ``iterations`` × (X pass,
flipped Z pass) of an edge-clamped correlation, i.e.
``kernels.separable_series`` iterated.  The blur stages, the flagship
blur, ``KernelFilterStage`` (every ``kernels.KERNEL_FILTER_TYPES`` entry,
Sobel/Prewitt with distinct X and Z taps, Smooth3 with its factor 1/3) and
the edge filters run here.  The two JAX entries have counterparts of the same names;
their blocking arguments choose TPU layouts, not results, and are ignored.

K1 keeps several iterations on chip: :func:`chain_plan` splits the chain
into launches, each of which runs its iterations on a tile and its halo in
shared memory.  A stack of maps ``[T, R, C]`` (``parallel.tiled``'s tiles)
runs in the same launches as one map, each map clamped at its own edges.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ... import _cuda
from .. import kernels as _kernels
from ..blur import limit_width, sigma_value

#: K1's blocking (``scripts/stencil_flow_sweep.py`` chose it; PERF.md):
#: output tiles of TILE rows × columns, THREADS threads a block, and at most
#: HALO cells of halo a side, so a launch runs up to HALO // off iterations
#: of a k = 2·off + 1 chain.
TILE = (128, 128)
THREADS = 768
HALO = 10


@dataclass(frozen=True)
class ChainPlan:
    """How K1 runs a chain: ``launches[i]`` iterations in launch ``i``, on
    ``tile`` output tiles whose windows carry ``halos[i]`` cells a side."""

    launches: tuple
    halos: tuple
    tile: tuple
    threads: int


def chain_plan(k: int, iterations: int, tile=TILE, halo: int = HALO,
               threads: int = THREADS) -> ChainPlan:
    """Split ``iterations`` of a ``k``-tap chain into as few launches as a
    halo of at most ``halo`` cells allows, as evenly as they go (17 at
    k = 5 and the default halo of 10: 5 + 4 + 4 + 4).  A 1-tap chain needs
    no halo and runs in one launch; 0 iterations in none.  A chain whose
    half-width exceeds ``halo`` runs one iteration a launch."""
    off = (k - 1) // 2
    if iterations == 0:
        return ChainPlan((), (), tuple(tile), threads)
    per = iterations if off == 0 else max(1, halo // off)
    n = -(-iterations // per)
    base, extra = divmod(iterations, n)
    launches = tuple(base + (i < extra) for i in range(n))
    return ChainPlan(launches, tuple(off * m for m in launches), tuple(tile), threads)


def separable_chain_plain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """The plain PyTorch version: ``separable_series(x, taps, taps_z,
    factor)`` applied ``iterations`` times (``taps_z=None``: ``taps`` on
    both axes), on a map or a stack of maps."""
    taps = np.asarray(taps, np.float32)
    taps_z = taps if taps_z is None else np.asarray(taps_z, np.float32)
    for _ in range(iterations):
        x = _kernels.separable_series(x, taps, taps_z, factor)
    return x


def _taps_arg(taps, name):
    taps = np.ascontiguousarray(np.asarray(taps, np.float32))
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > 25:
        raise ValueError(f"separable_chain: {name} must be 1-D, odd, ≤ 25 long; "
                         f"got shape {taps.shape}")
    return taps


def separable_chain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """``iterations`` × (X pass with ``taps``, flipped Z pass with
    ``taps_z``), each pass's sum multiplied by ``factor`` (float32), as
    ``kernels.conv_x`` / ``conv_z`` do; ``taps_z=None`` takes ``taps`` on
    both axes.  Both tap lists are odd and at most 25 long; the shorter is
    centred in zeros for the kernel, which adds exact zeros on a finite
    map.  ``factor`` 1.0 multiplies by one exactly.  ``x`` is a map
    ``[R, C]`` or a stack ``[T, R, C]``, whose maps run in the launches of
    one.  A CPU tensor takes the plain version; a CUDA tensor launches K1
    or raises."""
    if x.device.type == "cpu":
        return separable_chain_plain(x, taps, iterations, taps_z, factor)
    _cuda.check_map(x, "separable_chain", square=False, stack=True)
    tx = _taps_arg(taps, "taps")
    tz = tx if taps_z is None else _taps_arg(taps_z, "taps_z")
    if iterations < 0:
        raise ValueError(f"separable_chain: iterations must be ≥ 0, got {iterations}")
    k = max(len(tx), len(tz))
    tx, tz = (np.pad(t, (k - len(t)) // 2) for t in (tx, tz))
    plan = chain_plan(k, int(iterations))
    out = torch.empty_like(x)
    tmp = torch.empty_like(x) if len(plan.launches) > 1 else None
    per_launch = np.asarray(plan.launches, np.int32)
    rows, cols = x.shape[-2:]
    batch = x.shape[0] if x.dim() == 3 else 1
    with torch.cuda.device(x.device):
        _cuda.call("noize_separable_chain", x.data_ptr(), out.data_ptr(),
                   None if tmp is None else tmp.data_ptr(), rows, cols, batch,
                   tx.ctypes.data, tz.ctypes.data, k, float(np.float32(factor)),
                   per_launch.ctypes.data, len(per_launch), plan.tile[0],
                   plan.tile[1], plan.threads, _cuda.stream(x))
    separable_chain.launches += 1
    return out


separable_chain.launches = 0


def gauss_chain(x, width: int, sigma, iterations: int, block: int = None,
                interpret: bool = False):
    """StageGaussianBlur's iterated blur on K1 (``stencil.gauss_chain``).
    ``block`` (the TPU's row block) and ``interpret`` (the Pallas
    interpreter) do not change the result and are ignored."""
    taps = _kernels.gaussian_taps(sigma_value(sigma), limit_width(width))
    return separable_chain(x, taps, iterations)


def _entry(entry, x, taps, iterations):
    out = separable_chain(x, taps, iterations)
    if x.device.type != "cpu":
        entry.launches += 1
    return out


def fused_separable_chain(x, taps, iterations: int, block: int = 256):
    """``stencil.fused_separable_chain`` (2-D blocks on the TPU) on K1."""
    return _entry(fused_separable_chain, x, taps, iterations)


def fused_separable_chain_rows(x, taps, iterations: int, block: int = None,
                               iterations_per_launch: int = 6):
    """``stencil.fused_separable_chain_rows`` (row blocks on the TPU) on
    K1."""
    return _entry(fused_separable_chain_rows, x, taps, iterations)


fused_separable_chain.launches = 0
fused_separable_chain_rows.launches = 0
