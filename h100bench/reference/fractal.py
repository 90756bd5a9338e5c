"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.ops.fractal``: fBm heightmap generation,
the plain path only (no K10).

Same formulas and the same float32 accumulation order as the reference
(fractal.py:106-155):

  * world coords:  xi = (x + xpos) / noiseSize, zi = (z + zpos) / noiseSize
  * per octave i:  t += a * noise(f * xi, f * zi)
                   detune += detuneRate;  f *= (stepdown - detune);  a *= G
  * normalisation: t / sum_{i<octaves} G^i  with G = exp2(-hurst)

Every basis of ``NOISE_TYPES`` is ported (``ops/noise.py``); the scalar
recurrences run on the host in float32 (``octave_table``), so the device
sees the same constants on the CPU and the card.  On the card a call is
one launch of K10 (``ops/cuda/fractal``, ``csrc/fractal.cu``: every octave
of a cell in registers); ``fractal_window_plain``, one elementwise pass an
operation, is its plain version and the CPU's path.

The gain G is ``f32.exp2``, the value
XLA's CPU runtime gives ``jnp.exp2`` (eager JAX, and ``fractal`` with its
traced hurst); PyTorch's exp2 is an ulp off it at ~20% of hurst values.
A compiled reference program whose hurst is a constant (the sharded
fractal under ``jax.jit``) folds G instead, another rounding, which differs
from the runtime value at ~8% of hurst values (ROADMAP.md §3).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from . import f32 as _f32
from . import noise as _n

_F32 = torch.float32

#: Order matches the reference's ``FractalNoise`` enum (NoiseStage.cs:15-24).
NOISE_TYPES = (
    "Sin",
    "Perlin",
    "PeriodicPerlin",
    "Simplex",
    "RotatedSimplex",
    "Cellular",
    "DomainRotatedPerlin",
    "DomainRotatedSimplex",
)

# Domain rotation constants (Fractal.cs:160-166): skew 2D -> 3D so the
# "grain" of the 3D lattice does not align with the 2D plane.
_ROT_S2 = -0.211324865405187
_ROT_Y = -0.577350269189626


def _rectify_half(v):
    """(1 + v) / 2 — maps [-1,1] noise to [0,1] (Fractal.cs:151-153)."""
    return (1.0 + v) * 0.5


def noise_value(kind: str, x, z):
    """One rectified noise basis at world coords (x, z), as the
    ``IMakeNoise`` getters (Fractal.cs:141-278); output in [0, 1]-ish."""
    if kind == "Sin":
        vx = 0.5 + 0.5 * torch.sin(x)
        vz = 0.5 + 0.5 * torch.sin(z)
        return vx * vz
    if kind == "Perlin":
        return _rectify_half(_n.cnoise2(x, z))
    if kind == "PeriodicPerlin":
        return _rectify_half(_n.psrnoise2(x, z, 1010.0, 102.0, 0.0))
    if kind == "Simplex":
        return _rectify_half(_n.snoise2(x, z))
    if kind == "RotatedSimplex":
        return _rectify_half(_n.psrnoise2(x, z, 1010.0, 102.0, 0.62))
    if kind == "Cellular":
        f1, f2 = _n.cellular2(x, z)
        return _rectify_half(f1) * _rectify_half(f2)
    if kind == "DomainRotatedPerlin":
        xz = x + z
        s2 = xz * _ROT_S2
        return _rectify_half(_n.cnoise3(x + s2, z + s2, xz * _ROT_Y))
    if kind == "DomainRotatedSimplex":
        xz = x + z
        s2 = xz * _ROT_S2
        return _rectify_half(_n.snoise3(x + s2, z + s2, xz * _ROT_Y))
    raise ValueError(f"unknown noise type {kind!r}; expected one of {NOISE_TYPES}")


def fractal_norm_value(hurst: float, octaves: int) -> float:
    """CalcFractalNormValue (Fractal.cs:31-40): sum of G^i, i < octaves."""
    g = 2.0 ** (-hurst)
    t, a = 0.0, 1.0
    for _ in range(octaves):
        t += a
        a *= g
    return t


@functools.lru_cache(maxsize=256)
def _gain(hurst: float) -> np.float32:
    """G = exp2(-hurst), once a hurst (``f32.exp2`` is a few hundred µs
    of NumPy scalar steps)."""
    return _f32.exp2(-np.float32(hurst))


def fractal(
    resolution: int,
    xpos,
    zpos,
    *,
    noise_type: str = "Perlin",
    hurst=0.0,
    octaves: int = 1,
    stepdown=2.0,
    detune_rate=0.0,
    noise_size=1000.0,
    starting_amplitude=1.0,
    device="cuda",
):
    """One fBm tile of shape ``(resolution, resolution)``, row-major
    ``[z, x]``, on ``device``; ``xpos``/``zpos`` offset the tile in the
    global noise domain.  Sequences of T origins give a stack ``[T,
    resolution, resolution]`` whose tiles equal their own calls bit for
    bit (``jax.vmap`` of the reference over float32 origins)."""
    return fractal_window_plain(0, 0, resolution, resolution, xpos, zpos, noise_type=noise_type,
                          hurst=hurst, octaves=octaves, stepdown=stepdown,
                          detune_rate=detune_rate, noise_size=noise_size,
                          starting_amplitude=starting_amplitude, device=device)


def octave_table(hurst, octaves: int, stepdown, detune_rate, starting_amplitude):
    """The fBm's host scalars in float32, the reference's recurrence
    (fractal.py:142-155): each octave's frequency f and amplitude a (two
    read-only float32 arrays of ``max(octaves, 0)``) and the norm ``acc`` =
    sum of G^i, i < octaves, with G = ``_gain(hurst)``; computed once a
    setting."""
    f32 = np.float32
    return _octave_table(float(f32(hurst)), int(octaves), float(f32(stepdown)),
                         float(f32(detune_rate)), float(f32(starting_amplitude)))


@functools.lru_cache(maxsize=256)
def _octave_table(hurst, octaves, stepdown, detune_rate, starting_amplitude):
    f32 = np.float32
    g = _gain(hurst)
    stepdown = f32(stepdown)
    detune_rate = f32(detune_rate)
    fs, amps = [], []
    f = f32(1.0)
    a = f32(starting_amplitude)
    detune = f32(0.0)
    for _ in range(octaves):
        fs.append(f)
        amps.append(a)
        detune = f32(detune + detune_rate)
        f = f32(f * f32(stepdown - detune))
        a = f32(a * g)

    # norm value with the same accumulation (amplitude 1 start)
    norm = f32(1.0)
    acc = f32(0.0)
    for _ in range(octaves):
        acc = f32(acc + norm)
        norm = f32(norm * g)
    fs, amps = np.asarray(fs, f32), np.asarray(amps, f32)
    fs.setflags(write=False)
    amps.setflags(write=False)
    return fs, amps, acc


def fractal_window_plain(row0: int, col0: int, rows: int, cols: int, xpos, zpos, *,
                         noise_type: str = "Perlin", hurst=0.0, octaves: int = 1,
                         stepdown=2.0, detune_rate=0.0, noise_size=1000.0,
                         starting_amplitude=1.0, device="cuda"):
    """``fractal_window`` as PyTorch elementwise passes on ``device``, one
    basis evaluation an octave over the whole window: K10's plain version
    (the CPU's path; on the card only to hold K10 against it)."""
    device = torch.device(device)
    f32 = np.float32
    xs = np.asarray(xpos, f32)
    zs = np.asarray(zpos, f32)
    if xs.ndim:
        xpos = torch.from_numpy(xs.reshape(-1, 1, 1)).to(device)
        zpos = torch.from_numpy(zs.reshape(-1, 1, 1)).to(device)
    else:
        xpos, zpos = float(xs), float(zs)
    inv_size = float(f32(1.0) / f32(noise_size))
    col = torch.arange(col0, col0 + cols, dtype=_F32, device=device)[None, :].expand(rows, cols)
    row = torch.arange(row0, row0 + rows, dtype=_F32, device=device)[:, None].expand(rows, cols)
    xi = (col + xpos) * inv_size
    zi = (row + zpos) * inv_size

    fs, amps, acc = octave_table(hurst, octaves, stepdown, detune_rate, starting_amplitude)
    t = torch.zeros(xi.shape, dtype=_F32, device=device)
    for f, a in zip(fs, amps):
        t = t + float(a) * noise_value(noise_type, float(f) * xi, float(f) * zi)
    # a device tensor divisor: CUDA turns division by a host scalar into a
    # reciprocal multiply, which would differ from the CPU by an ulp
    return t / torch.tensor(float(acc), dtype=_F32, device=device)
