"""Frozen copy, for the benchmark's reference, of ``noize_tpu_torch.ops.flow``.

Flow map — virtual-pipes relaxation producing a velocity map; port of
``noize_tpu.ops.flow``.

This is the plain PyTorch version of kernel K2
(``ops.cuda.flow.flow_map_fused``).  Neighbour access uses edge-clamped
shifts, the reference's clamped ``getIdx`` reads.  Normalisation uses the
stage's static {normMin, normMax} = {-0.1, 0.1} by default.
"""

from __future__ import annotations

import numpy as np
import torch

from .f32 import sqrt

TIMESTEP = 0.2
WATER_INIT = 1e-4  # FlowMapStage.cs:129


def shift_clamped(a, dz: int, dx: int):
    """out[z, x] = a[clamp(z + dz), clamp(x + dx)] — edge-replicated shift
    on the last two axes (a stack of maps shifts map by map)."""
    if dz:
        n = a.shape[-2]
        a = a.index_select(-2, (torch.arange(n, device=a.device) + dz).clamp_(0, n - 1))
    if dx:
        n = a.shape[-1]
        a = a.index_select(-1, (torch.arange(n, device=a.device) + dx).clamp_(0, n - 1))
    return a


def compute_flow_step(height, water, flow_w, flow_e, flow_s, flow_n):
    """ComputeFlowStep: diff_d = (h + w) − (h + w)(neighbour d);
    flow_d' = max(0, flow_d + diff_d), rescaled by
    K = clamp(water / (Σflow · Δt), 0, 1); all-zero when Σ == 0."""
    total = height + water
    diff_w = total - shift_clamped(total, 0, -1)
    diff_e = total - shift_clamped(total, 0, 1)
    diff_s = total - shift_clamped(total, -1, 0)
    diff_n = total - shift_clamped(total, 1, 0)
    fw = torch.clamp_min(flow_w + diff_w, 0.0)
    fe = torch.clamp_min(flow_e + diff_e, 0.0)
    fs = torch.clamp_min(flow_s + diff_s, 0.0)
    fn = torch.clamp_min(flow_n + diff_n, 0.0)
    s = fw + fe + fs + fn
    k = torch.where(s > 0.0, torch.clamp(water / (s * TIMESTEP), 0.0, 1.0), 0.0)
    return fw * k, fe * k, fs * k, fn * k


def update_water_step(water, flow_w, flow_e, flow_s, flow_n):
    """UpdateWaterStep: flux divergence."""
    flow_out = flow_w + flow_e + flow_s + flow_n
    flow_in = (
        shift_clamped(flow_e, 0, -1)
        + shift_clamped(flow_w, 0, 1)
        + shift_clamped(flow_n, -1, 0)
        + shift_clamped(flow_s, 1, 0)
    )
    return torch.clamp_min(water + (flow_in - flow_out) * TIMESTEP, 0.0)


def velocity_field(flow_w, flow_e, flow_s, flow_n):
    """CreateVelocityField: staggered flux → |velocity| magnitude."""
    dl = shift_clamped(flow_e, 0, -1) - flow_w
    dr = flow_e - shift_clamped(flow_w, 0, 1)
    dt = shift_clamped(flow_s, 1, 0) - flow_n
    db = flow_s - shift_clamped(flow_n, -1, 0)
    vx = (dl + dr) * 0.5
    vy = (dt + db) * 0.5
    return sqrt(vx * vx + vy * vy)


def norm_params(norm_min, norm_max):
    """(norm_min, norm_max − norm_min) rounded as the reference's float32
    scalars are."""
    lo = np.float32(norm_min)
    return lo, np.float32(np.float32(norm_max) - lo)


def flow_map(height, iterations: int = 5, norm_min=-0.1, norm_max=0.1):
    """FlowMapStage end to end: fill water, iterate (flow, water), return
    the normalised velocity map (same shape as ``height``: a map, or a
    stack of maps taken map by map)."""
    water = torch.full_like(height, WATER_INIT)
    fw = fe = fs = fn = torch.zeros_like(height)
    for _ in range(iterations):
        fw, fe, fs, fn = compute_flow_step(height, water, fw, fe, fs, fn)
        water = update_water_step(water, fw, fe, fs, fn)
    v = velocity_field(fw, fe, fs, fn)
    lo, rng = norm_params(norm_min, norm_max)
    if rng < np.float32(1e-12):
        v = torch.zeros_like(v)
    # a device tensor divisor keeps true division on CUDA as well
    return (v - float(lo)) / torch.tensor(float(rng), device=v.device)
