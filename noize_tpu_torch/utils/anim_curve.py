"""Unity AnimationCurve evaluation — exact keyframe Hermite/Bezier math;
the port's own copy of ``noize_tpu.utils.anim_curve`` (NumPy on the host).

The reference's CurveStage discretizes a Unity ``AnimationCurve`` into a
256-sample LUT (``curve[i] = unityCurve.Evaluate(i / samples)`` —
Filter/Curve/CurveStage.cs:26-34); the demo assets
(BasicDemo~/Invert.asset, CurveBoostContrast.asset) carry real serialized
keyframes.  This module reproduces ``AnimationCurve.Evaluate`` exactly so
those assets can be used verbatim instead of analytic approximations.

Host-side NumPy: LUT extraction happens once at pipeline-definition time
(the reference does the same on the main thread); only the LUT itself goes
to the device (ops.filters.curve_apply).

Semantics implemented (matching UnityEngine.AnimationCurve):
  * unweighted segments (weightedMode == 0): cubic Hermite on
    (value, slope · dt) pairs;
  * weighted segments: cubic Bezier with tangent-weight control points,
    solving the x-cubic for the segment parameter;
  * an infinite in/out slope makes the segment a step (constant at the
    left key's value);
  * evaluation outside the key range clamps to the end keys' values
    (WrapMode Clamp / m_PreInfinity = m_PostInfinity = 2, which every
    asset in the demo uses);
  * empty curve → 0, single key → constant.
"""

from __future__ import annotations

import math
import re
from dataclasses import dataclass
from typing import Sequence, Tuple

import numpy as np


@dataclass(frozen=True)
class Keyframe:
    """One serialized Unity keyframe (serializedVersion 3 fields)."""

    time: float
    value: float
    in_slope: float = 0.0
    out_slope: float = 0.0
    weighted_mode: int = 0    # 0 none, 1 in, 2 out, 3 both
    in_weight: float = 1.0 / 3.0
    out_weight: float = 1.0 / 3.0


def _hermite(u: np.ndarray, v0, m0, m1, v1) -> np.ndarray:
    """Cubic Hermite with slopes pre-multiplied by dt."""
    u2 = u * u
    u3 = u2 * u
    return (
        (2.0 * u3 - 3.0 * u2 + 1.0) * v0
        + (u3 - 2.0 * u2 + u) * m0
        + (u3 - u2) * m1
        + (-2.0 * u3 + 3.0 * u2) * v1
    )


def _bezier_y(u, p0, p1, p2, p3):
    w = 1.0 - u
    return (
        w * w * w * p0
        + 3.0 * w * w * u * p1
        + 3.0 * w * u * u * p2
        + u * u * u * p3
    )


def _solve_bezier_u(x: float, x0, x1, x2, x3, iters: int = 40) -> float:
    """Parameter u with bezier_x(u) == x, via bisection (x is monotone in u
    for valid tangent weights ∈ [0, 1])."""
    lo, hi = 0.0, 1.0
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        if _bezier_y(mid, x0, x1, x2, x3) < x:
            lo = mid
        else:
            hi = mid
    return 0.5 * (lo + hi)


def _eval_segment(t: float, k0: Keyframe, k1: Keyframe) -> float:
    dt = k1.time - k0.time
    if dt <= 0.0:
        return float(k1.value)
    m0 = k0.out_slope
    m1 = k1.in_slope
    if math.isinf(m0) or math.isinf(m1) or math.isnan(m0) or math.isnan(m1):
        return float(k0.value)  # constant tangent → step at the next key
    u = (t - k0.time) / dt
    out_weighted = k0.weighted_mode in (2, 3)
    in_weighted = k1.weighted_mode in (1, 3)
    if not out_weighted and not in_weighted:
        return float(_hermite(u, k0.value, m0 * dt, m1 * dt, k1.value))
    # weighted: cubic Bezier control points from tangent weights
    wo = k0.out_weight if out_weighted else 1.0 / 3.0
    wi = k1.in_weight if in_weighted else 1.0 / 3.0
    x0, x3 = k0.time, k1.time
    x1 = x0 + wo * dt
    x2 = x3 - wi * dt
    y0, y3 = k0.value, k1.value
    y1 = y0 + wo * dt * m0
    y2 = y3 - wi * dt * m1
    ub = _solve_bezier_u(t, x0, x1, x2, x3)
    return float(_bezier_y(ub, y0, y1, y2, y3))


def evaluate(keys: Sequence[Keyframe], t) -> np.ndarray:
    """``AnimationCurve.Evaluate`` for scalar or array ``t`` (Clamp wrap)."""
    ts = np.atleast_1d(np.asarray(t, np.float64))
    out = np.empty_like(ts)
    if len(keys) == 0:
        out[:] = 0.0
        return out if np.ndim(t) else out[0]
    ks = sorted(keys, key=lambda k: k.time)
    times = np.asarray([k.time for k in ks])
    for i, tv in enumerate(ts.ravel()):
        if tv <= ks[0].time:
            out.flat[i] = ks[0].value
        elif tv >= ks[-1].time:
            out.flat[i] = ks[-1].value
        else:
            seg = int(np.searchsorted(times, tv, side="right")) - 1
            out.flat[i] = _eval_segment(float(tv), ks[seg], ks[seg + 1])
    return out if np.ndim(t) else float(out[0])


def sample_lut(keys: Sequence[Keyframe], samples: int = 256) -> Tuple[float, ...]:
    """The reference's ExtractCurve discretization:
    ``curve[i] = Evaluate(i / samples)`` (CurveStage.cs:26-34)."""
    return tuple(
        float(evaluate(keys, i / samples)) for i in range(samples)
    )


_FRAME_RE = re.compile(
    r"serializedVersion: 3\s+"
    r"time: ([-\w.+]+)\s+value: ([-\w.+]+)\s+"
    r"inSlope: ([-\w.+]+)\s+outSlope: ([-\w.+]+)\s+"
    r"tangentMode: \d+\s+weightedMode: (\d+)\s+"
    r"inWeight: ([-\w.+]+)\s+outWeight: ([-\w.+]+)"
)


def _num(s: str) -> float:
    return float("inf") if s in ("Infinity", "+Infinity") else (
        float("-inf") if s == "-Infinity" else float(s)
    )


def parse_unity_curve(asset_text: str) -> Tuple[Keyframe, ...]:
    """Extract the keyframes of the (first) AnimationCurve in a serialized
    Unity .asset file (YAML, m_Curve keyframe list, serializedVersion 3)."""
    return tuple(
        Keyframe(
            time=_num(m[0]), value=_num(m[1]),
            in_slope=_num(m[2]), out_slope=_num(m[3]),
            weighted_mode=int(m[4]),
            in_weight=_num(m[5]), out_weight=_num(m[6]),
        )
        for m in _FRAME_RE.findall(asset_text)
    )
