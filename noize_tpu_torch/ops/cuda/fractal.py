"""K10 — the fBm heightmap in CUDA (``csrc/fractal.cu``).

Ports no TPU kernel: the reference's fBm (``noize_tpu/ops/fractal.py:106-155``
with ``ops/noise.py``'s bases) is plain JAX, which XLA fused on the TPU.  Its
plain version here is ``ops.fractal.fractal_window_plain``, some 170
elementwise passes an octave.  K10 runs every octave of a cell in registers,
one thread a cell, one launch a call for any basis of ``NOISE_TYPES`` and
any depth of a stack of tiles.

The host computes what the plain version computes on the host: the octave
table (f, a) and the norm (``ops.fractal.octave_table``), 1 / noise_size
and the origins, all float32, and :func:`pack` hands them to the kernel in
one struct (``_cuda.Fractal``), a stack's origins as one small array.
"""

from __future__ import annotations

import numpy as np
import torch

from ... import _cuda
from .. import fractal as _fractal

MAX_OCTAVES = _cuda.MAX_OCTAVES

#: float32 operations a cell an octave, counted from ``csrc/fractal.cu``
#: (PERF.md's bound): each __f*_rn, floorf, fabsf, compare, select, min and
#: max one; the library routines by their instruction counts, sinf and cosf
#: 20 each, fmodf 10, __fsqrt_rn 8; the octave's own f·x, f·z, a·v and sum 4.
OPS_PER_OCTAVE = {
    "Sin": 49,
    "Perlin": 190,
    "PeriodicPerlin": 312,
    "Simplex": 168,
    "RotatedSimplex": 312,
    "Cellular": 358,
    "DomainRotatedPerlin": 605,
    "DomainRotatedSimplex": 412,
}
#: and once a cell: the coordinates (2 adds, 2 multiplies) and the division
OPS_PER_CELL = 12


def pack(row0: int, col0: int, rows: int, cols: int, xpos, zpos, *, noise_type: str,
         hurst, octaves: int, stepdown, detune_rate, noise_size, starting_amplitude):
    """K10's arguments for a call: (the ``_cuda.Fractal`` struct, the
    origins as float32 ``[T, 2]`` (xpos, zpos) or None for one tile, the
    output's shape).  Scalar origins give one ``[rows, cols]`` tile; any
    sequence gives a stack ``[T, rows, cols]``, the two sequences
    broadcast against each other as in the plain version."""
    if noise_type not in _fractal.NOISE_TYPES:
        raise ValueError(f"unknown noise type {noise_type!r}; expected one of "
                         f"{_fractal.NOISE_TYPES}")
    if octaves > MAX_OCTAVES:
        raise ValueError(f"fractal on the card: at most {MAX_OCTAVES} octaves, got {octaves}")
    if min(row0, col0, rows, cols) < 0:
        raise ValueError(f"fractal_window: a negative window {(row0, col0, rows, cols)}")
    f32 = np.float32
    fs, amps, acc = _fractal.octave_table(hurst, octaves, stepdown, detune_rate,
                                          starting_amplitude)
    xs = np.asarray(xpos, f32)
    zs = np.asarray(zpos, f32)
    p = _cuda.Fractal()
    p.basis = _fractal.NOISE_TYPES.index(noise_type)
    p.octaves = len(fs)
    p.rows, p.cols, p.row0, p.col0 = rows, cols, row0, col0
    p.inv_size = float(f32(1.0) / f32(noise_size))
    p.acc = float(acc)
    p.f[:len(fs)] = fs.tolist()
    p.a[:len(amps)] = amps.tolist()
    if xs.ndim:
        xb, zb = np.broadcast_arrays(xs.reshape(-1), zs.reshape(-1))
        origins = np.ascontiguousarray(np.stack([xb, zb], axis=1), f32)
        p.tiles = len(origins)
        return p, origins, (len(origins), rows, cols)
    p.tiles = 1
    p.x0, p.z0 = float(xs), float(zs)
    return p, None, (rows, cols)


def fractal_fused(row0: int, col0: int, rows: int, cols: int, xpos, zpos, *,
                  noise_type: str = "Perlin", hurst=0.0, octaves: int = 1, stepdown=2.0,
                  detune_rate=0.0, noise_size=1000.0, starting_amplitude=1.0,
                  device="cuda"):
    """``ops.fractal.fractal_window`` on K10: one launch on a CUDA
    ``device`` (counted in ``fractal_fused.launches``), or raises.  At most
    ``MAX_OCTAVES`` octaves (``ValueError`` above; NoiseStage's range is
    [1, 24])."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"fractal_fused: expected a CUDA device, got {device}")
    p, origins, shape = pack(row0, col0, rows, cols, xpos, zpos, noise_type=noise_type,
                             hurst=hurst, octaves=octaves, stepdown=stepdown,
                             detune_rate=detune_rate, noise_size=noise_size,
                             starting_amplitude=starting_amplitude)
    index = torch.cuda.current_device() if device.index is None else device.index
    out = torch.empty(shape, dtype=torch.float32, device=index)
    if out.numel() == 0:
        return out
    dev_origins = None if origins is None else torch.from_numpy(origins).to(out.device)
    with _cuda.on_device(index):
        _cuda.call("noize_fractal", out.data_ptr(),
                   None if dev_origins is None else dev_origins.data_ptr(), p,
                   _cuda.raw_stream(index))
    fractal_fused.launches += 1
    return out


fractal_fused.launches = 0


def sin_cos(x):
    """``sinf`` and ``cosf`` of the f32 CUDA tensor ``x`` as K10's source
    compiles them: the card test holds them against ``torch.sin`` and
    ``torch.cos``, on which the Sin, PeriodicPerlin and RotatedSimplex
    bases' bit-equality with the plain version rests."""
    x = x.contiguous()
    _cuda.check_map(x.reshape(1, -1), "sin_cos", square=False)
    s, c = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        _cuda.call("noize_sin_cos", x.data_ptr(), s.data_ptr(), c.data_ptr(), x.numel(),
                   _cuda.stream(x))
    return s, c
