"""Pointwise, reduction and remap filter ops — port of
``noize_tpu.ops.filters``:

  * constant ops — ``ConstantMultiply`` / ``ConstantBinarize``
    (SimpleMutation.cs:16-54);
  * binary reduces of two tiles, dispatched by ``ReduceStage``
    (SimpleMutation.cs:56-171, ReduceStage.cs:12-63);
  * range scan and normalise (NormalizeJob.cs:18-93,
    FlowMapComponents.cs:150-173);
  * the curve LUT remap (CurveJob.cs:56-89), crop (CropJob.cs:18-60) and
    fill (FlowMapComponents.cs:176-204).

All run on their input's device; ``sample_curve`` and ``fill`` make a new
tensor on ``device`` (the card by default).
"""

from __future__ import annotations

import math

import torch

from .f32 import sqrt

_F32 = torch.float32


def _device(device):
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("filters: device='cuda' but no CUDA device")
    return device


# --- constant ops (SimpleMutation.cs:16-54) --------------------------------

def constant_multiply(a, value):
    return a * value


def constant_binarize(a, value):
    """1 where a >= value else 0 (SimpleMutation.cs:44)."""
    return (a >= value).to(a.dtype)


#: ConstantStage.ConstantOperationType parity (ConstantStage.cs:15-18).
CONSTANT_OPS = {"MULTIPLY": constant_multiply, "BINARIZE": constant_binarize}


# --- binary reduces (SimpleMutation.cs:56-171) -----------------------------

def subtract_tiles(a, b):
    return a - b


def multiply_tiles(a, b):
    return a * b


def min_tiles(a, b):
    return torch.minimum(a, b)


def max_tiles(a, b):
    return torch.maximum(a, b)


def root_sum_squares_tiles(a, b):
    return sqrt(a * a + b * b)


#: ReductionType enum parity (ReduceStage.cs:12-18).
REDUCTION_OPS = {
    "SUBTRACT": subtract_tiles,
    "MULTIPLY": multiply_tiles,
    "ROOTSUMSQUARES": root_sum_squares_tiles,
    "MAX": max_tiles,
    "MIN": min_tiles,
}


# --- range / normalize (NormalizeJob.cs:18-56, FlowMapComponents.cs:150-173)

def map_range(a, lim_min=math.inf, lim_max=-math.inf):
    """GetMapRangeJob: (min, max, range) as a float32 tensor of 3 on
    ``a``'s device.  ``lim_min``/``lim_max`` seed the scan (HIGHEST_MIN /
    LOWEST_MAX), so callers can force bounds."""
    mn = torch.clamp_max(torch.amin(a), lim_min)
    mx = torch.clamp_min(torch.amax(a), lim_max)
    return torch.stack([mn, mx, mx - mn]).to(_F32)


def normalize_map(a, args):
    """NormalizeMap.CalculateCell: (v - args[0]) / args[2]; below a range of
    1e-12 the *value* is zeroed first and still divided by the tiny range
    (FlowMapComponents.cs:160-164)."""
    rng = args[2]
    v = torch.where(rng < 1e-12, 0.0, a)
    return (v - args[0]) / rng


def normalize(a, lim_min=math.inf, lim_max=-math.inf):
    """The range, then the map normalised by it."""
    return normalize_map(a, map_range(a, lim_min, lim_max))


# --- curve remap (CurveJob.cs:56-89) ---------------------------------------

def curve_apply(a, curve):
    """LUT lerp with the reference's clamp / extrapolate quirks:
    rect = clamp(v,0,1)·N; lo = min(floor(rect), N−2); out = clamp01(lerp).
    At v == 1 the lerp factor is 2 (it extrapolates past the last knot)
    before the final clamp (CurveJob.cs:72-79).  ``curve`` is a float32
    tensor on ``a``'s device."""
    n = curve.shape[0]
    rect = torch.clamp(a, 0.0, 1.0) * n
    lower = torch.clamp_max(torch.floor(rect), float(n - 2))
    li = lower.to(torch.int64)
    left = curve[li]
    right = curve[li + 1]
    value = left + (right - left) * (rect - lower)
    return torch.clamp(value, 0.0, 1.0)


def sample_curve(fn, samples=256, *, device="cuda"):
    """CurveStage.ExtractCurve parity: curve[i] = fn(i / samples)
    (CurveStage.cs:26-34), float32 on ``device``."""
    return torch.tensor([float(fn(i / samples)) for i in range(samples)], dtype=_F32,
                        device=_device(device))


# --- crop (CropJob.cs:18-60) -----------------------------------------------

def crop(a, out_resolution: int, offset: int = 0):
    """Cut an ``out_resolution²`` window.  The reference job never assigns
    its ``Offset`` field (CropJob.cs:43-59), so the crop starts at (0, 0);
    pass ``offset=(in-out)//2`` for a centred crop."""
    return a[offset:offset + out_resolution, offset:offset + out_resolution]


def fill(shape, value, *, device="cuda"):
    """FillArrayJob parity: a float32 tensor of ``value`` on ``device``."""
    return torch.full(tuple(shape), value, dtype=_F32, device=_device(device))
