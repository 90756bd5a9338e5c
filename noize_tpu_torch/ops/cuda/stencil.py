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

K1 has two kernels, and :func:`separable_chain` picks one by
:func:`chain_route`.  A long chain (the flagship's Gauss-5 ×17) runs on
``chain_tile`` (:func:`tile_chain`): :func:`chain_plan` splits it into
launches, each of which keeps its iterations on a 128² tile and its halo
in shared memory.  A short chain, whose total halo off·iterations is at
most ``SHORT_HALO`` (every ``KernelFilterStage`` call of the BasicDemo
presets), runs on K1@short (:func:`short_chain`): one launch on small
tiles (32 × 256 at one iteration, 64 × 64 at more), several blocks an SM,
each iteration one pass that keeps the X pass in registers.  K1@rss
(:func:`root_sum_squares_chain`) computes Sobel3_2D and ``edge.edge_2d``
in one launch: both series from one window, then √(H² + V²).  A stack
of maps ``[T, R, C]`` (``parallel.tiled``'s tiles) runs in the same
launches as one map, each map clamped at its own edges.

Each wrapper checks a chain's taps, picks its route and builds its launch
constants on the chain's first call and keeps them (``_CHAINS``); a later
call of the same chain checks the tensor, allocates the output and makes
one ctypes call.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from ... import _cuda
from .. import blur as _blur
from .. import kernels as _kernels
from ..filters import root_sum_squares_tiles

#: K1's long-chain blocking (``scripts/stencil_flow_sweep.py`` chose it;
#: PERF.md): output tiles of TILE rows × columns, THREADS threads a block,
#: and at most HALO cells of halo a side, so a launch runs up to
#: HALO // off iterations of a k = 2·off + 1 chain.
TILE = (128, 128)
THREADS = 768
HALO = 10

#: K1@short's blocking (``scripts/stencil_flow_sweep.py``'s short-chain
#: sweep; PERF.md): (tile rows, tile columns, threads, rows a thread walks
#: at a time) for one iteration (SHORT_ONE) and for more (SHORT_MANY);
#: chains whose total halo off·iterations is at most SHORT_HALO run on it,
#: in one launch.  Taps at most SHORT_MAX_TAPS long (K1@rss: RSS_MAX_TAPS).
SHORT_ONE = (32, 256, 256, 32)
SHORT_MANY = (64, 64, 128, 32)
SHORT_HALO = 8
SHORT_MAX_TAPS = 17
RSS_MAX_TAPS = 9


@dataclass(frozen=True)
class ChainPlan:
    """How K1 runs a chain: ``launches[i]`` iterations in launch ``i``, on
    ``tile`` output tiles whose windows carry ``halos[i]`` cells a side."""

    launches: tuple
    halos: tuple
    tile: tuple
    threads: int


@dataclass(frozen=True)
class ShortPlan:
    """How K1@short runs a chain: all ``iterations`` in one launch on
    ``tile`` output tiles whose windows carry ``halo`` cells a side,
    ``threads`` a block, a thread walking ``strip`` rows at a time."""

    iterations: int
    halo: int
    tile: tuple
    threads: int
    strip: int


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


def short_plan(k: int, iterations: int, blocking=None, halo=SHORT_HALO):
    """K1@short's launch for ``iterations`` of a ``k``-tap chain, or None when
    the chain is not short: no iterations, more than 17 taps, or a total
    halo off·iterations above ``halo`` (None: any halo).  All iterations
    run in the one launch, on tiles whose windows carry off·iterations
    cells a side; ``blocking`` (tile rows, tile columns, threads, strip)
    defaults to SHORT_ONE at one iteration and SHORT_MANY above."""
    off = (k - 1) // 2
    if (iterations < 1 or k > SHORT_MAX_TAPS
            or (halo is not None and off * iterations > halo)):
        return None
    if blocking is None:
        blocking = SHORT_ONE if iterations == 1 else SHORT_MANY
    rows, cols, threads, strip = blocking
    return ShortPlan(int(iterations), off * int(iterations), (rows, cols), threads, strip)


def chain_route(k: int, iterations: int) -> str:
    """Which K1 kernel runs a chain: "short" (K1@short, one launch) where
    :func:`short_plan` gives a launch, else "tile" (``chain_tile``, the
    launches of :func:`chain_plan`)."""
    return "tile" if short_plan(k, iterations) is None else "short"


def short_window_bytes(k: int, plan: ShortPlan) -> int:
    """Shared memory a K1@short block takes (``stencil.cu``'s
    ``short_bytes``): at one iteration one window buffer of the tile and its
    halo, rows at a pitch of whole 16-byte units, the first column -halo
    mod 4 floats past one; at more, two buffers at an odd pitch."""
    h = plan.halo
    tz, tx = plan.tile
    if plan.iterations == 1:
        return 4 * (tz + 2 * h) * ((-h % 4 + tx + 2 * h + 3) // 4 * 4)
    return 2 * 4 * (tz + 2 * h) * ((tx + 2 * h) | 1)


def separable_chain_plain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """The plain PyTorch version: ``separable_series(x, taps, taps_z,
    factor)`` applied ``iterations`` times (``taps_z=None``: ``taps`` on
    both axes), on a map or a stack of maps."""
    taps = np.asarray(taps, np.float32)
    taps_z = taps if taps_z is None else np.asarray(taps_z, np.float32)
    for _ in range(iterations):
        x = _kernels.separable_series(x, taps, taps_z, factor)
    return x


def root_sum_squares_chain_plain(x, taps_h, taps_v):
    """K1@rss's plain version: the H series ``taps_h`` = (X taps, Z taps)
    and the V series ``taps_v`` on ``x``, one iteration each, combined by
    ``filters.root_sum_squares_tiles``."""
    h = separable_chain_plain(x, taps_h[0], 1, taps_z=taps_h[1])
    v = separable_chain_plain(x, taps_v[0], 1, taps_z=taps_v[1])
    return root_sum_squares_tiles(h, v)


def _taps_arg(taps, name, longest=25):
    taps = np.ascontiguousarray(np.asarray(taps, np.float32))
    if taps.ndim != 1 or len(taps) % 2 == 0 or len(taps) > longest:
        raise ValueError(f"separable_chain: {name} must be 1-D, odd, ≤ {longest} long; "
                         f"got shape {taps.shape}")
    return taps


def _centred(taps_list):
    """The tap lists centred in zeros to the longest one's length."""
    k = max(len(t) for t in taps_list)
    return k, [np.pad(t, (k - len(t)) // 2) for t in taps_list]


class _Series(ctypes.Structure):
    """One K1@short or K1@rss chain's constants (``stencil.cu``'s
    ``NoizeSeries``), handed to the kernel by pointer."""

    _fields_ = [("hx", ctypes.c_float * SHORT_MAX_TAPS), ("hz", ctypes.c_float * SHORT_MAX_TAPS),
                ("vx", ctypes.c_float * SHORT_MAX_TAPS), ("vz", ctypes.c_float * SHORT_MAX_TAPS),
                ("factor", ctypes.c_float), ("k", ctypes.c_int), ("iterations", ctypes.c_int),
                ("tile_z", ctypes.c_int), ("tile_x", ctypes.c_int), ("threads", ctypes.c_int),
                ("strip", ctypes.c_int), ("rss", ctypes.c_int)]


def _series(k, plan, series, factor=1.0):
    """The ``_Series`` of a plan; ``series`` is [(X taps, Z taps)] (K1@short)
    or [H, V] (K1@rss), each list ``k`` long."""
    s = _Series()
    for (tx, tz), (nx, nz) in zip(series, (("hx", "hz"), ("vx", "vz"))):
        getattr(s, nx)[:k] = tx.tolist()
        getattr(s, nz)[:k] = tz.tolist()
    s.factor, s.k, s.iterations = factor, k, plan.iterations
    s.tile_z, s.tile_x = plan.tile
    s.threads, s.strip, s.rss = plan.threads, plan.strip, int(len(series) == 2)
    return s


def _check(x, name):
    """``_cuda.check_map(x, name, square=False, stack=True)``, which runs
    (and raises with the reason) only where the quick test fails."""
    if not (x.is_cuda and x.dtype == torch.float32 and 2 <= x.dim() <= 3
            and x.is_contiguous() and x.numel() > 0):
        _cuda.check_map(x, name, square=False, stack=True)


class _SeriesLaunch:
    """A K1@short or K1@rss chain, ready to launch: its ``_Series`` and the
    C entry; a call is one ctypes call, one launch."""

    def __init__(self, wrapper, series):
        self.wrapper, self.series = wrapper, series
        self.address = ctypes.addressof(series)

    def __call__(self, x):
        _check(x, self.wrapper.__name__)
        out = torch.empty_like(x)
        rows, cols = x.shape[-2:]
        dev = x.get_device()
        rc = _cuda.library().noize_series_chain(
            x.data_ptr(), out.data_ptr(), rows, cols, x.shape[0] if x.dim() == 3 else 1,
            self.address, dev, _cuda.raw_stream(dev))
        if rc:
            raise RuntimeError(f"noize_series_chain: CUDA error {rc}")
        self.wrapper.launches += 1
        return out


class _TileLaunch:
    """A chain on ``chain_tile``, ready to launch: the centred taps, the plan
    and its launch array (kept alive here) and the C entry's arguments that
    do not change between calls."""

    def __init__(self, k, tx, tz, factor, iterations):
        self.taps = (tx, tz)
        self.plan = chain_plan(k, iterations)
        self.per_launch = np.asarray(self.plan.launches, np.int32)
        self.args = (tx.ctypes.data, tz.ctypes.data, k, factor, self.per_launch.ctypes.data,
                     len(self.per_launch), *self.plan.tile, self.plan.threads)

    def __call__(self, x):
        _check(x, "separable_chain")
        out = torch.empty_like(x)
        tmp = torch.empty_like(x) if len(self.per_launch) > 1 else None
        rows, cols = x.shape[-2:]
        dev = x.get_device()
        with _cuda.on_device(dev):
            rc = _cuda.library().noize_separable_chain(
                x.data_ptr(), out.data_ptr(), None if tmp is None else tmp.data_ptr(), rows,
                cols, x.shape[0] if x.dim() == 3 else 1, *self.args, _cuda.raw_stream(dev))
        if rc:
            raise RuntimeError(f"noize_separable_chain: CUDA error {rc}")
        tile_chain.launches += 1
        return out


def _build(route, taps, taps_z, factor, iterations):
    """The launch of a chain, checked: ``route`` "short" or "tile", or
    "auto" (:func:`chain_route`'s choice)."""
    if iterations < 0:
        raise ValueError(f"separable_chain: iterations must be ≥ 0, got {iterations}")
    longest = SHORT_MAX_TAPS if route == "short" else 25
    tx = _taps_arg(taps, "taps", longest)
    tz = tx if taps_z is None else _taps_arg(taps_z, "taps_z", longest)
    k, (tx, tz) = _centred((tx, tz))
    if route == "auto":
        route = chain_route(k, iterations)
    if route == "tile":
        return _TileLaunch(k, tx, tz, factor, iterations)
    plan = short_plan(k, iterations, halo=None)
    if plan is None:
        raise ValueError(f"short_chain: iterations must be ≥ 1, got {iterations}")
    return _SeriesLaunch(short_chain, _series(k, plan, [(tx, tz)], factor))


#: the launch of each chain a wrapper has run, by (route, taps, Z taps,
#: factor, iterations): checked and built on a chain's first call only;
#: emptied past MAX_CHAINS chains
_CHAINS = {}
MAX_CHAINS = 256


def _launch(route, taps, taps_z, factor, iterations):
    key = (route, np.asarray(taps, np.float32).tobytes(),
           None if taps_z is None else np.asarray(taps_z, np.float32).tobytes(),
           float(np.float32(factor)), int(iterations))
    launch = _CHAINS.get(key)
    if launch is None:
        if len(_CHAINS) >= MAX_CHAINS:
            _CHAINS.clear()
        launch = _CHAINS[key] = _build(route, taps, taps_z, key[3], key[4])
    return launch


def separable_chain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """``iterations`` × (X pass with ``taps``, flipped Z pass with
    ``taps_z``), each pass's sum multiplied by ``factor`` (float32), as
    ``kernels.conv_x`` / ``conv_z`` do; ``taps_z=None`` takes ``taps`` on
    both axes.  Both tap lists are odd and at most 25 long; the shorter is
    centred in zeros for the kernel, which adds exact zeros on a finite
    map.  ``factor`` 1.0 multiplies by one exactly.  ``x`` is a map
    ``[R, C]`` or a stack ``[T, R, C]``, whose maps run in the launches of
    one.  A CPU tensor takes the plain version; a CUDA tensor launches K1
    (:func:`chain_route`: K1@short for a short chain, else ``chain_tile``)
    or raises."""
    if x.is_cpu:
        return separable_chain_plain(x, taps, iterations, taps_z, factor)
    out = _launch("auto", taps, taps_z, factor, iterations)(x)
    separable_chain.launches += 1
    return out


def short_chain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """K1@short: ``iterations`` ≥ 1 × (X pass, flipped Z pass) in one launch
    on small resident tiles (:func:`short_plan`'s blocking, any halo whose
    window fits in shared memory; taps at most 17 long).  The same series
    as :func:`separable_chain`, which routes short chains here.  A CPU
    tensor takes the plain version; a CUDA tensor launches K1@short or
    raises."""
    if x.is_cpu:
        return separable_chain_plain(x, taps, iterations, taps_z, factor)
    return _launch("short", taps, taps_z, factor, iterations)(x)


def tile_chain(x, taps, iterations: int, taps_z=None, factor=1.0):
    """K1's long-chain kernel ``chain_tile`` on the launches of
    :func:`chain_plan` (0 iterations: a copy), whatever the chain; the
    series of :func:`separable_chain`, which routes long chains here.  A
    CPU tensor takes the plain version; a CUDA tensor launches
    ``chain_tile`` or raises."""
    if x.is_cpu:
        return separable_chain_plain(x, taps, iterations, taps_z, factor)
    return _launch("tile", taps, taps_z, factor, iterations)(x)


def root_sum_squares_chain(x, taps_h, taps_v):
    """K1@rss: ``√(H² + V²)`` of the H series ``taps_h`` = (X taps, Z taps)
    and the V series ``taps_v``, one iteration each, in one launch
    (Sobel3_2D, ``edge.edge_2d``); taps at most 9 long.  A CPU tensor takes
    the plain version (:func:`root_sum_squares_chain_plain`); a CUDA
    tensor launches K1@rss or raises."""
    if x.is_cpu:
        return root_sum_squares_chain_plain(x, taps_h, taps_v)
    key = ("rss",) + tuple(np.asarray(t, np.float32).tobytes() for t in (*taps_h, *taps_v))
    launch = _CHAINS.get(key)
    if launch is None:
        taps = [_taps_arg(t, n, RSS_MAX_TAPS) for t, n in zip(
            (*taps_h, *taps_v), ("H taps", "H Z taps", "V taps", "V Z taps"))]
        k, taps = _centred(taps)
        series = _series(k, short_plan(k, 1), [(taps[0], taps[1]), (taps[2], taps[3])])
        if len(_CHAINS) >= MAX_CHAINS:
            _CHAINS.clear()
        launch = _CHAINS[key] = _SeriesLaunch(root_sum_squares_chain, series)
    return launch(x)


separable_chain.launches = 0
short_chain.launches = 0
root_sum_squares_chain.launches = 0
tile_chain.launches = 0


def gauss_chain(x, width: int, sigma, iterations: int, block: int = None,
                interpret: bool = False):
    """StageGaussianBlur's iterated blur on K1 (``stencil.gauss_chain``).
    ``block`` (the TPU's row block) and ``interpret`` (the Pallas
    interpreter) do not change the result and are ignored."""
    taps = _kernels.gaussian_taps(_blur.sigma_value(sigma), _blur.limit_width(width))
    return separable_chain(x, taps, iterations)


def _entry(entry, x, taps, iterations):
    out = separable_chain(x, taps, iterations)
    if not x.is_cpu:
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
