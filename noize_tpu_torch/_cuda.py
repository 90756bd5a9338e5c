"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled on first use with nvcc, one process per source,
all started together, and linked into one shared library with a plain C
interface, bound with ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -Xcompiler -fPIC -c <source>        (each csrc/*.cu)
    nvcc -gencode arch=compute_90a,code=sm_90a -shared <objects>

``-fmad=false`` keeps every multiply and add separately rounded, as the
reference's f32 arithmetic is; several kernels branch on exact f32 values
(the pool clamp, the thermal rectify).

The library lands in ``build/noize_tpu_torch/lib_<hash of sources>.so``
beside the package, so an edited source rebuilds and an unchanged one
loads the cached build.  Every C entry point launches on the stream it is
given and returns ``cudaGetLastError()``; :func:`call` raises on a non-zero
code.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
BUILD_DIR = CSRC.parent.parent / "build" / "noize_tpu_torch"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ARCH_FLAGS + ("-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_U = ctypes.c_uint
_L = ctypes.c_longlong
_F = ctypes.c_float

#: K8's broadcast dims (threefry.cu's ``kMaxDims``), one value a dim
MAX_DIMS = 8
Dims = _L * MAX_DIMS


class Bcast(ctypes.Structure):
    """K8's broadcast, passed by value (threefry.cu's ``NoizeBcast``): the dims,
    the shape and the element strides of the key words and the counters."""

    _fields_ = [("ndim", _I), ("shape", Dims), ("key", Dims), ("x0", Dims), ("x1", Dims)]


#: K10's octave table (fractal.cu's ``kMaxOctaves``), one value an octave
MAX_OCTAVES = 32
Octaves = _F * MAX_OCTAVES


class Fractal(ctypes.Structure):
    """K10's call, passed by value (fractal.cu's ``NoizeFractal``): the basis
    (its index in ``NOISE_TYPES``), the octaves, the stack's depth, the
    window, 1 / noise_size, the origin of a single tile, the norm and each
    octave's frequency and amplitude."""

    _fields_ = [("basis", _I), ("octaves", _I), ("tiles", _L), ("rows", _I), ("cols", _I),
                ("row0", _I), ("col0", _I), ("inv_size", _F), ("x0", _F), ("z0", _F),
                ("acc", _F), ("f", Octaves), ("a", Octaves)]


#: K11's widest stamp (sediment.cu's ``kMaxTaps``, radius 31) and its folds
MAX_SEDIMENT_TAPS = 63
Taps = _F * MAX_SEDIMENT_TAPS
Folds = _F * ((MAX_SEDIMENT_TAPS - 1) // 2)


class Sediment(ctypes.Structure):
    """K11's constants, passed by value (sediment.cu's ``NoizeSediment``): the
    threshold as float32, the dispersal's and the tent's tap counts (0: no
    tent), and each stamp's product and fold weights."""

    _fields_ = [("thresh", _F), ("kd", _I), ("kt", _I), ("wd", Taps), ("fd", Folds),
                ("wt", Taps), ("ft", Folds)]


class Decay(ctypes.Structure):
    """K12's scalars, passed by value (decay.cu's ``NoizeDecay``): the two
    placement multipliers, MINFLOWPOOL, the pool's and the plain flow's keep
    factors, the track's gain and the evaporation a cycle, each the plain
    expression's Python scalar as float32."""

    _fields_ = [("pm", _F), ("tm", _F), ("minpool", _F), ("keep_pool", _F), ("keep", _F),
                ("gain", _F), ("evap", _F)]


#: argtypes of every C entry point (csrc/*.cu); all return int.
SIGNATURES = {
    # x, out, tmp, rows, cols, maps in the stack, X taps and Z taps (host
    # f32[k] each), k, factor, iterations per launch (host i32[launches]),
    # launches, tile rows, tile cols, threads, stream
    "noize_separable_chain": (_P, _P, _P, _I, _I, _I, _P, _P, _I, _F, _P, _I, _I, _I, _I,
                              _P),
    # x, out, rows, cols, maps in the stack, the call's constants (host
    # NoizeSeries: taps, factor, k, iterations, tile, threads, strip, rss),
    # x's device, stream (K1@short and K1@rss)
    "noize_series_chain": (_P, _P, _I, _I, _I, _P, _I, _P),
    # height, out, carry (2 x 5 stacks), rows, cols, maps in the stack,
    # iterations per launch (host i32[launches]), launches, window side,
    # norm_min, rng, stream
    "noize_flow_map": (_P, _P, _P, _I, _I, _I, _P, _I, _I, _F, _F, _P),
    # in, out, tmp, rows, cols, the map's origin row and column on the
    # grid, grid side, iterations per launch (host i32[launches]),
    # launches, tile rows, tile cols, threads, max_diff, increment, stream
    "noize_thermal_erosion": (_P, _P, _P, _I, _I, _I, _I, _I, _P, _I, _I, _I, _I, _F, _F,
                              _P),
    # height, pool_in, pool_out, drains, flag, pool_tmp, res, iterations,
    # drain_particles, stream (K4: even res; K5: any res)
    "noize_pool_automata": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    "noize_pool_automata_full": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _P),
    # height, pool_in, pool_out, drains_in, drains, flag, pool_tmp, rows,
    # cols, the window's origin row and column on the grid, grid side,
    # iterations, drain_particles, stream (K5 on a window)
    "noize_pool_automata_window": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                                   _P),
    # height (in place), volumes, flat cell indices (i64), piles, rows,
    # cols, slot row and column offsets, each slot's next slot on its cell,
    # round ends, radius, slots, whole increments summed (f32), visits a
    # sweep, increment, the slots' reach, done flags (u32 scratch), stream
    # (K6)
    "noize_exact_piles": (_P, _P, _P, _I, _I, _I, _P, _P, _P, _P, _I, _I, _P, _I, _F, _I, _P,
                          _P),
    # valid (u8), volumes, cell ids (i64), work (the gathered slot values,
    # overlaid in place), com_vals, com_eff (u8), hash keys (u64), hash
    # slots (i32), hash capacity, piles, round ends, radius, slots, whole
    # increments summed (f32), visits a sweep, increment, stream (K6 on a
    # pile table)
    "noize_pile_table": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P, _I, _I, _P, _I, _F, _P),
    # record table (float4 a cell), f32 params (host), i32 params (host),
    # the 8 particle fields in, owned (u8 or null), the 8 fields out, event
    # cells (i64), d_track, d_pool, d_sed, stream (K7)
    "noize_descent": (_P,) * 25,
    # height, pool, flow, plants (or null), cells, height scale,
    # FLOW_HEIGHT_CONTRIBUTION, recip(100), record table, stream (K7's table)
    "noize_descent_records": (_P, _P, _P, _P, _L, _F, _F, _F, _P, _P),
    # x, atan(x), sin(x), n, stream (K7's atanf and sinf)
    "noize_atan_sin": (_P, _P, _P, _L, _P),
    # key (u32), key word stride, x0, x1 (i64), the broadcast (by value),
    # y0, y1 (i64), stream (K8)
    "noize_threefry": (_P, _L, _P, _P, Bcast, _P, _P, _P),
    # keys (u32 [K, 2]), K, draws a key, split first, minval, span, mult,
    # float32 out, out, stream (K8's draw)
    "noize_randint": (_P, _L, _L, _I, _I, _U, _U, _I, _P, _P),
    # cells (i64), deltas, accumulators (host arrays of k pointers), k, n,
    # size, skip zeros, passes, digit bits, scratch (i32), stream (K9)
    "noize_scatter_in_order": (_P, _P, _P, _I, _L, _L, _I, _I, _I, _P, _P),
    # out, origins (f32 [T, 2] or null), the call (by value), stream (K10)
    "noize_fractal": (_P, _P, Fractal, _P),
    # x, sin(x), cos(x), n, stream (K10's sinf and cosf)
    "noize_sin_cos": (_P, _P, _P, _L, _P),
    # height, sediment, out, rows, cols, the call's constants (by value),
    # stream (K11)
    "noize_sediment": (_P, _P, _P, _I, _I, Sediment, _P),
    # pool, pool_acc, track, track_acc (the accumulators both null: no
    # spawn), flow, pool_out, flow_out, track_out, cells, the call's scalars
    # (by value), stream (K12)
    "noize_decay": (_P, _P, _P, _P, _P, _P, _P, _P, _L, Decay, _P),
}

_LIB = None


def _sources():
    return sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh"))


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def library_path() -> pathlib.Path:
    digest = hashlib.sha256()
    for src in _sources():
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib_{digest.hexdigest()[:16]}.so"


def _run(cmds):
    """Run the nvcc commands in parallel; raise with every failure's
    output."""
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for c in cmds]
    failed = []
    for cmd, proc in zip(cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
    if failed:
        raise RuntimeError("\n".join(failed))


def build() -> pathlib.Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        srcs = sorted(CSRC.glob("*.cu"))
        objs = [os.path.join(tmpdir, f"{src.stem}.o") for src in srcs]
        _run([[nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", obj]
              for src, obj in zip(srcs, objs)])
        lib = os.path.join(tmpdir, "lib.so")
        _run([[nvcc, *ARCH_FLAGS, "-shared", "-o", lib, *objs]])
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library, building it on first use."""
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def call(name: str, *args) -> None:
    """Call C entry ``name``; raise if it reports a CUDA error."""
    rc = getattr(library(), name)(*args)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")


def stream(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def on_device(device_index: int):
    """A context in which ``device_index`` is the current CUDA device: a
    ``torch.cuda.device`` where it is not already (that costs several µs of
    host time a call), else nothing."""
    if device_index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device_index)


def raw_stream(device_index: int) -> int:
    """The current stream of CUDA device ``device_index`` as a pointer, with
    no ``torch.cuda.Stream`` made (the wrappers whose host enqueue is
    measured take it so)."""
    return torch._C._cuda_getCurrentRawStream(device_index)


def check_map(t: torch.Tensor, name: str, square: bool = True,
              stack: bool = False) -> None:
    """Refuse what the kernels do not take: non-CUDA, non-f32, non-2-D,
    non-contiguous, non-square where ``square``.  ``stack`` (K1 and K2)
    also admits a non-empty stack of maps, ``[T, R, C]``."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != torch.float32:
        raise ValueError(f"{name}: expected float32, got {t.dtype}")
    dims_ok = t.dim() == 2 or (stack and t.dim() == 3 and t.shape[0] >= 1)
    if not dims_ok or (square and t.shape[-2] != t.shape[-1]):
        what = f"{'square ' if square else ''}2-D map" + (" or a stack of them" if stack else "")
        raise ValueError(f"{name}: expected a {what}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")
