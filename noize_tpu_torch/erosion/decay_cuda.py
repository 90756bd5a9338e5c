"""K12 — the deposit's adds and the track/flow decay in CUDA (``csrc/decay.cu``).

``world.deposit_and_decay`` adds a cycle's pool and track accumulators
(times the placement multipliers) to the pool and track maps and runs
``update_flow_from_track``: the track decays into the flow, pools evaporate
and the track resets.  Its plain version, ``world.deposit_and_decay_plain``,
runs that as some 19 whole-map PyTorch launches; K12 computes it in one
launch, bit-equal to it, and writes the flow and track where the caller
says (graph B: straight into the static state).  It replaces no TPU kernel:
the JAX package leaves this path to XLA's fusion.

The dispatch lives in ``erosion.world``, which sends CUDA tensors here.
``deposit_and_decay_cuda`` is ``world.deposit_and_decay`` under K12's name;
``deposit_and_decay_cuda.launches`` counts K12's launches.
"""

from __future__ import annotations

import functools

import torch

from .. import _cuda
from . import world as _world


@functools.lru_cache(maxsize=64)
def _constants(pm: float, tm: float, flr: float, ser: float,
               height_scale: float) -> _cuda.Decay:
    """K12's by-value scalars: each Python scalar of the plain expressions,
    rounded to float32 as PyTorch rounds a Python scalar against a float32
    map."""
    return _cuda.Decay(pm=pm, tm=tm, minpool=_world.MINFLOWPOOL, keep_pool=1.0 - 0.1 * flr,
                       keep=1.0 - flr, gain=flr * 50.0, evap=ser / height_scale)


def cost(rows: int, cols: int, spawn: bool = True):
    """(float32 operations, bytes) of one K12 call on ``rows`` × ``cols``,
    as ``csrc/decay.cu`` counts them: at most 14 operations a cell (the adds
    4, the compares 2, the saturating flow 6, the evaporation 2); pool,
    track and flow read and written once, the two accumulators read once
    where the cycle spawns."""
    cells = rows * cols
    return (14 if spawn else 10) * cells, (32 if spawn else 24) * cells


def _launch(world, track_acc, pool_acc, params, height_scale, out=None):
    """One K12 launch: ``world`` with the accumulators added (None: no
    spawn) and the decay run; the new flow and track in ``out``'s maps
    (None: new ones), the new pool in a new map."""
    name = "deposit_and_decay_cuda"
    if (track_acc is None) != (pool_acc is None):
        raise ValueError(f"{name}: track_acc and pool_acc are both given or both None")
    maps = [world.pool, world.track, world.flow]
    accs = [] if track_acc is None else [pool_acc, track_acc]
    for t in maps + accs:
        _cuda.check_map(t, name, square=False)
        if t.shape != world.pool.shape or t.device != world.pool.device:
            raise ValueError(f"{name}: pool, track, flow and the accumulators must match in "
                             "shape and device")
    pool_out = torch.empty_like(world.pool)
    flow_out = torch.empty_like(world.flow) if out is None else out.flow
    track_out = torch.empty_like(world.track) if out is None else out.track
    if out is not None:
        inputs = {t.data_ptr() for t in maps + accs}
        for field, t in (("flow", flow_out), ("track", track_out)):
            _cuda.check_map(t, name, square=False)
            mine = getattr(world, field).data_ptr()
            if t.shape != world.pool.shape or t.device != world.pool.device \
                    or (t.data_ptr() != mine and t.data_ptr() in inputs):
                raise ValueError(f"{name}: out's {field} must be a map of the pool's shape and "
                                 f"device, world's {field} or apart from every input")
    consts = _constants(params.POOL_PLACEMENT_MULTIPLIER, params.TRACK_PLACEMENT_MULTIPLIER,
                        params.FLOW_LOSS_RATE, params.SURFACE_EVAPORATION_RATE,
                        float(height_scale))
    index = world.pool.device.index
    with _cuda.on_device(index):
        _cuda.call("noize_decay", world.pool.data_ptr(),
                   None if pool_acc is None else pool_acc.data_ptr(), world.track.data_ptr(),
                   None if track_acc is None else track_acc.data_ptr(), world.flow.data_ptr(),
                   pool_out.data_ptr(), flow_out.data_ptr(), track_out.data_ptr(),
                   world.pool.numel(), consts, _cuda.raw_stream(index))
    deposit_and_decay_cuda.launches += 1
    return _world.WorldState(height=world.height, pool=pool_out, flow=flow_out,
                             track=track_out, plants=world.plants)


def deposit_and_decay_cuda(world, track_acc, pool_acc, params, height_scale, *, out=None):
    """``world.deposit_and_decay``: on CUDA tensors one K12 launch a call,
    or raises; CPU tensors take the plain version."""
    return _world.deposit_and_decay(world, track_acc, pool_acc, params, height_scale, out=out)


deposit_and_decay_cuda.launches = 0
