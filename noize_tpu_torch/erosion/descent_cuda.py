"""K7 — particle descent in CUDA (``csrc/descent.cu``).

The reference steps every particle together (``noize_tpu.erosion.particles
.descend_step`` inside ``descend_all``'s ``lax.scan``/``while_loop``, and on
a rank's extended block in ``noize_tpu.parallel.sharded_erosion``); it has
no Pallas kernel.  As torch operations every step is some 150 launches, and
the all-dead check a host sync every 8 steps, so the card runs one thread a
particle for all the steps of a call: ``descend_steps`` on the grid's table
(``particles.descend_all``), ``descend_steps_window`` on a window of it
with an owner mask (``parallel.sharded_erosion``, one launch a chunk).
Both return every step's events, step-major then particle slot, for one
in-order scatter (``particles.scatter_events``, K9 on the card); the plain
version is ``particles.descend_steps_plain``.

The table differs by device (``descent_table``): the plain version reads
``particles.step_maps``; K7 reads one 16-byte record a cell,
{quantised all-heights, WIH, flow, plants or 0} (``step_records``, built by
one launch of K7's record pass; ``step_records_plain`` is its plain
version), so a step's 3×3 is nine aligned loads.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import _cuda
from ..ops.f32 import recip
from . import particles as _pa
from .particles import Particles
from .world import NEIGHBOR_OFFSETS, WorldState


def _f32(v) -> float:
    return float(np.float32(v))


def step_records_plain(height, pool, flow, plants, params, height_scale):
    """The record table as torch operations: f32 [cells, 4] of
    {``_quantize(all_h)``, wih, flow, plants or 0} with wih = height_scale ·
    (height + pool) and all_h = wih + FLOW_HEIGHT_CONTRIBUTION · flow,
    rounded op by op as ``particles.step_maps`` and ``_quantize`` round
    them; ``plants`` None gives zeros."""
    wih = height_scale * (height + pool)
    all_h = wih + params.FLOW_HEIGHT_CONTRIBUTION * flow
    fourth = torch.zeros_like(flow) if plants is None else plants
    return torch.stack([_pa._quantize(all_h), wih, flow, fourth], -1).reshape(-1, 4)


def step_records(height, pool, flow, plants, params, height_scale):
    """K7's record table of the maps ``height``, ``pool``, ``flow`` and
    ``plants`` (or None: zeros), f32 [cells, 4], 16-byte records.  A CPU
    tensor takes the plain version; a CUDA tensor launches K7's record pass
    (one launch) or raises."""
    if height.device.type == "cpu":
        return step_records_plain(height, pool, flow, plants, params, height_scale)
    maps = [height, pool, flow] + ([] if plants is None else [plants])
    if any(m.shape != height.shape or m.device != height.device for m in maps):
        raise ValueError("step_records: the maps must match in shape and device")
    maps = [m.contiguous() for m in maps]
    for m in maps:
        _cuda.check_map(m.reshape(1, -1), "step_records", square=False)
    n = height.numel()
    out = torch.empty((n, 4), dtype=torch.float32, device=height.device)
    with torch.cuda.device(height.device):
        _cuda.call("noize_descent_records", *(m.data_ptr() for m in maps[:3]),
                   None if plants is None else maps[3].data_ptr(), n, _f32(height_scale),
                   _f32(params.FLOW_HEIGHT_CONTRIBUTION), recip(100.0), out.data_ptr(),
                   _cuda.stream(height))
    step_records.launches += 1
    return out


step_records.launches = 0


def descent_table(state: WorldState, params, height_scale):
    """The descent's table of ``state`` for its device: ``step_maps`` on the
    CPU (the plain version's), ``step_records`` on the card (K7's)."""
    if state.height.device.type == "cpu":
        return _pa.step_maps(state, params, height_scale)
    plants = state.plants if _pa._with_plants(params) else None
    return step_records(state.height, state.pool, state.flow, plants, params, height_scale)


def _launch(p: Particles, table, params, height_scale, patch_res, res: int, steps: int,
            origin, shape, owned, name: str):
    """One K7 launch; see ``descend_steps_plain`` for the arguments and the
    result."""
    dev = table.device
    n = int(p.row.shape[0])
    rows_w, cols_w = (int(v) for v in shape)
    if table.shape != (rows_w * cols_w, 4):
        raise ValueError(f"{name}: expected the record table of {rows_w}x{cols_w} cells "
                         f"(step_records), got {tuple(table.shape)}")
    _cuda.check_map(table, name, square=False)
    if table.data_ptr() % 16:
        raise ValueError(f"{name}: the record table must be 16-byte aligned")
    plants = _pa._with_plants(params)
    if steps < 0 or res < 1:
        raise ValueError(f"{name}: bad steps {steps} or res {res}")
    fields = (p.row, p.col, p.heading, p.vel, p.water, p.sediment, p.age, p.alive)
    if any(f.device != dev or f.shape != (n,) for f in fields):
        raise ValueError(f"{name}: the particle fields must be [N] tensors on {dev}")
    dtypes = (torch.float32, torch.float32, torch.int32, torch.float32, torch.float32,
              torch.float32, torch.int32, torch.uint8)
    ins = [f.to(dt).contiguous() for f, dt in zip(fields, dtypes)]
    outs = [torch.empty(n, dtype=dt, device=dev) for dt in dtypes]
    outs[-1] = torch.empty(n, dtype=torch.bool, device=dev)
    if owned is not None:
        if owned.shape != (n,) or owned.device != dev:
            raise ValueError(f"{name}: owned must be a bool [N] tensor on {dev}")
        owned = owned.to(torch.uint8).contiguous()
    cells = torch.empty(steps * n, dtype=torch.int64, device=dev)
    deltas = [torch.empty(steps * n, dtype=torch.float32, device=dev) for _ in range(3)]
    f = np.array([recip(height_scale), recip(patch_res), recip(100.0), recip(3.14159),
                  _f32(params.GRAVITY), _f32(params.DRAG), _f32(params.FRICTION),
                  _f32(getattr(params, "VEGETATION_FRICTION", 0.0)),
                  _f32(params.TERMINAL_VELOCITY), _f32(params.CAPACITY), _f32(-params.EROSION),
                  _f32(params.DEPOSITION), _f32(1.0 - params.EVAP)], np.float32)
    i = np.array([int(params.MAXAGE), res, int(origin[0]), int(origin[1]), rows_w, cols_w,
                  int(plants), steps, n]
                 + [o[0] for o in NEIGHBOR_OFFSETS] + [o[1] for o in NEIGHBOR_OFFSETS]
                 + list(_pa.RING_DR) + list(_pa.RING_DC), np.int32)
    with torch.cuda.device(dev):
        _cuda.call("noize_descent", table.data_ptr(), f.ctypes.data, i.ctypes.data,
                   *(t.data_ptr() for t in ins),
                   None if owned is None else owned.data_ptr(),
                   *(t.data_ptr() for t in outs), cells.data_ptr(),
                   *(t.data_ptr() for t in deltas), _cuda.stream(table))
    return (Particles(*outs), cells) + tuple(deltas)


def descend_steps(p: Particles, table, params, height_scale, patch_res, res: int,
                  steps: int):
    """``steps`` descent steps of every particle on the grid's table
    (``descent_table``: ``step_maps`` on the CPU, ``step_records`` on the
    card): (particles, cells i64[steps·N], d_track, d_pool, d_sed
    f32[steps·N]), step-major then particle slot.  A CPU tensor takes the
    plain version; a CUDA tensor launches K7 (one launch) or raises."""
    if table.device.type == "cpu":
        return _pa.descend_steps_plain(p, table, params, height_scale, patch_res, res, steps)
    out = _launch(p, table, params, height_scale, patch_res, res, steps, (0, 0), (res, res),
                  None, "descend_steps")
    descend_steps.launches += 1
    return out


descend_steps.launches = 0


def descend_steps_window(p: Particles, table, params, height_scale, patch_res, res: int,
                         steps: int, window_origin, window_shape, owned=None):
    """``descend_steps`` on the table of a window of the grid (its cell
    (0, 0) at the global ``window_origin``, ``window_shape`` cells; reads
    clamp into it) with the events of particles not ``owned`` (bool[N])
    zeroed and each event's cell the window's: the sharded descent's chunk.
    A CPU tensor takes the plain version; a CUDA tensor launches K7 (one
    launch) or raises."""
    if table.device.type == "cpu":
        return _pa.descend_steps_plain(p, table, params, height_scale, patch_res, res, steps,
                                       window_origin=window_origin,
                                       window_shape=window_shape, owned=owned)
    out = _launch(p, table, params, height_scale, patch_res, res, steps, window_origin,
                  window_shape, owned, "descend_steps_window")
    descend_steps_window.launches += 1
    return out


descend_steps_window.launches = 0


def atan_sin(x):
    """``atanf`` and ``sinf`` of the f32 CUDA tensor ``x`` as K7's source
    compiles them: the card test holds them against ``torch.atan`` and
    ``torch.sin``, on which K7's bit-equality with its plain version
    rests."""
    x = x.contiguous()
    _cuda.check_map(x.reshape(1, -1), "atan_sin", square=False)
    a, s = torch.empty_like(x), torch.empty_like(x)
    with torch.cuda.device(x.device):
        _cuda.call("noize_atan_sin", x.data_ptr(), a.data_ptr(), s.data_ptr(), x.numel(),
                   _cuda.stream(x))
    return a, s
