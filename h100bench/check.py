"""The comparison that decides ``correct``: each number is the largest gap
between a map the program produced and the reference's map, as a share of
the reference map's largest magnitude (float64 arithmetic).  A map of
another shape, or with a value that is not finite where the reference's
is, reads infinity; integer maps (a mesh's indices) read 0 when equal and
infinity otherwise.
"""

from __future__ import annotations

import math


def rel_gap(got, want) -> float:
    import torch

    if got is None or tuple(got.shape) != tuple(want.shape):
        return math.inf
    if not want.is_floating_point():
        return 0.0 if torch.equal(got.to(want.device), want) else math.inf
    g = got.to(want.device, torch.float64)
    w = want.to(torch.float64)
    gap = float((g - w).abs().max()) if w.numel() else 0.0
    if math.isnan(gap):
        return math.inf
    scale = float(w.abs().max()) if w.numel() else 0.0
    if scale > 0.0:
        return gap / scale
    return 0.0 if gap == 0.0 else math.inf


def mesh_gap(got: dict, want: dict) -> float:
    """The widest gap over a mesh's streams."""
    if set(got) != set(want):
        return math.inf
    return max(rel_gap(got[k], want[k]) for k in want)


def merge(into: dict, numbers: dict) -> dict:
    """Keep each number's largest reading."""
    for k, v in numbers.items():
        into[k] = max(into.get(k, 0.0), v)
    return into


def judge(numbers: dict, limits: dict):
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a limited number that was not read fails."""
    out, ok = {}, True
    for name, limit in limits.items():
        v = numbers.get(name, math.inf)
        out[name] = {"value": v if math.isfinite(v) else 1e300, "limit": limit}
        ok = ok and v <= limit
    return ok, out
