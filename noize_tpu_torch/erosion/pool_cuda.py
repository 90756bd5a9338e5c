"""K4 and K5 — pool automata in CUDA (``csrc/pool.cu``).

K4 (``pool_automata_cuda`` on an even grid) computes ``pool.pool_automata``
on the half-row pair layout.  It stands in for the TPU kernels
``noize_tpu.erosion.pool_pallas._mega_call``, ``_fused_pair_call``,
``_phase_pair_call`` and ``_fused_quad_call``; their JAX entries
(``pool_automata_pallas_mega``, ``_pair_fused``, ``_pair``, ``_quad``) have
counterparts here with the same signatures, all on K4.

K5 (``pool_automata_full_cuda``) computes ``pool._pool_automata_fullgrid``,
the full-grid masked phases, at any size, odd included.  It stands in for
``pool_pallas._phase_call``; its JAX entry ``pool_automata_pallas`` runs on
K5 here at every size, and ``pool_automata_cuda`` hands odd grids to it, as
``pool.pool_automata`` does.  ``pool_automata_window`` runs K5 on a window of
a grid with its drains carried in: the sharded pool's extended block, a
group of water steps a call between halo exchanges (8 cells of halo a
step); each step computes only the tiles that can still be exact.

The TPU blocking arguments (``block``, ``phases_per_launch``, ``unroll``)
are accepted and ignored: they choose Mosaic layouts, not results.

Both run as one fused launch per water step, with the phase chain of a
tile and its halo in shared memory: a call is ``1 + iterations`` device
kernels.  The pool ping-pongs between the output and a second buffer the
wrapper allocates; the drains are updated in place.

The wetness gate never syncs the host: the first kernel raises a device
flag when any cell holds ``>= MIN_WATER`` and every step launch returns at
once when it is down.  Each wrapper's ``wet_calls`` adds up those flags on
the device (an int32 tensor; ``None`` until the first call on the card —
set it back to ``None`` to reset), so a caller can count the calls that ran
phases without stalling the main path; reading it syncs.  A window call
runs a whole group of the sharded pool's water steps, so its
``wet_calls`` counts groups, not steps.  Every wrapper counts its calls on
the card in ``launches``.
"""

from __future__ import annotations

import torch

from .. import _cuda
from . import pool as _pool


def _launch(wrapper, entry: str, height, pool, iterations: int,
            drain_particles: bool, out=None):
    """Launch ``entry`` (K4 or K5) on CUDA tensors; returns (pool, drains),
    the pool in ``out`` (a map apart from both inputs; None: a new one),
    and adds the call's gate flag to ``wrapper.wet_calls``."""
    _cuda.check_map(height, wrapper.__name__)
    _cuda.check_map(pool, wrapper.__name__)
    if pool.shape != height.shape or pool.device != height.device:
        raise ValueError(f"{wrapper.__name__}: height and pool must match in "
                         "shape and device")
    res = height.shape[0]
    if out is None:
        out = torch.empty_like(pool)
    else:
        _cuda.check_map(out, wrapper.__name__)
        if out.shape != pool.shape or out.device != pool.device \
                or out.data_ptr() in (height.data_ptr(), pool.data_ptr()):
            raise ValueError(f"{wrapper.__name__}: out must be a map of the pool's shape "
                             "and device apart from height and pool")
    drains = torch.empty_like(pool)
    flag = torch.empty((1,), dtype=torch.int32, device=pool.device)
    tmp = torch.empty_like(pool)  # the pool's ping-pong partner
    with torch.cuda.device(pool.device):
        _cuda.call(entry, height.data_ptr(), pool.data_ptr(), out.data_ptr(),
                   drains.data_ptr(), flag.data_ptr(), tmp.data_ptr(), res,
                   int(iterations), int(bool(drain_particles)), _cuda.stream(pool))
    _count(wrapper, flag)
    return out, drains


def _count(wrapper, flag):
    """One launch of ``wrapper``'s kernel, and its gate flag added to
    ``wrapper.wet_calls`` on the device."""
    wrapper.launches += 1
    add_wet(wrapper, flag)


def add_wet(wrapper, flag):
    """Add a call's gate flag (an int32 [1] device tensor) to
    ``wrapper.wet_calls``."""
    wet = wrapper.wet_calls
    if wet is None or wet.device != flag.device:
        wrapper.wet_calls = flag.clone()
    else:
        wet.add_(flag)


def pool_automata_full_cuda(height, pool, iterations: int = 10,
                            drain_particles: bool = True, *, out=None):
    """``pool._pool_automata_fullgrid`` on K5, any square size.  A CPU
    tensor takes the plain version; a CUDA tensor launches K5 or raises.
    ``out`` (CUDA only): the map to write the pool into."""
    if height.device.type == "cpu":
        return _pool._pool_automata_fullgrid(height, pool, iterations,
                                             drain_particles)
    return _launch(pool_automata_full_cuda, "noize_pool_automata_full",
                   height, pool, iterations, drain_particles, out)


def pool_automata_cuda(height, pool, iterations: int = 10,
                       drain_particles: bool = True, *, out=None):
    """``pool_automata``: K4 on an even grid, K5 on an odd one (the
    reference's full-grid fallback).  A CPU tensor takes the plain
    version; a CUDA tensor launches a kernel or raises.  ``out`` (CUDA
    only): the map to write the pool into."""
    if height.device.type == "cpu":
        return _pool.pool_automata(height, pool, iterations, drain_particles)
    if height.dim() == 2 and height.shape[0] % 2:
        return pool_automata_full_cuda(height, pool, iterations, drain_particles, out=out)
    return _launch(pool_automata_cuda, "noize_pool_automata", height, pool,
                   iterations, drain_particles, out)


def pool_automata_window(height, pool, drains, iterations: int, drain_particles: bool,
                         origin, res: int):
    """K5 on a window of a ``res``² grid: ``height``, ``pool`` and the
    running ``drains`` are rows × cols cells from ``origin`` = (row, col)
    on.  Returns (pool, drains), ``drains`` with each phase's drains added
    in phase order.  Cells within 2 a phase of a window edge that is not
    the grid's edge are stale (``pool._pool_automata_window``, its plain
    version, says why); on the card each step computes only the tiles that
    can still be exact, so those cells are undefined there after the call.
    A CPU tensor takes the plain version; a CUDA tensor launches K5 or
    raises."""
    if height.device.type == "cpu":
        return _pool._pool_automata_window(height, pool, drains, iterations,
                                           drain_particles, origin, res)
    name = "pool_automata_window"
    for t in (height, pool, drains):
        _cuda.check_map(t, name, square=False)
    if pool.shape != height.shape or drains.shape != height.shape \
            or pool.device != height.device or drains.device != height.device:
        raise ValueError(f"{name}: height, pool and drains must match in shape and device")
    _pool._check_window(height.shape, origin, res, name)
    if iterations < 0:
        raise ValueError(f"{name}: iterations must be ≥ 0, got {iterations}")
    rows, cols = height.shape
    out = torch.empty_like(pool)
    drains_out = torch.empty_like(pool)
    flag = torch.empty((1,), dtype=torch.int32, device=pool.device)
    tmp = torch.empty_like(pool)
    with torch.cuda.device(pool.device):
        _cuda.call("noize_pool_automata_window", height.data_ptr(), pool.data_ptr(),
                   out.data_ptr(), drains.data_ptr(), drains_out.data_ptr(), flag.data_ptr(),
                   tmp.data_ptr(), rows, cols, int(origin[0]), int(origin[1]), int(res),
                   int(iterations), int(bool(drain_particles)), _cuda.stream(pool))
    _count(pool_automata_window, flag)
    return out, drains_out


for _w in (pool_automata_cuda, pool_automata_full_cuda, pool_automata_window):
    _w.launches = 0
    _w.wet_calls = None


# --- the JAX entries of the five TPU pool kernels ---------------------------

def _counted(entry, kernel, height, pool, iterations, drain_particles):
    out = kernel(height, pool, iterations, drain_particles)
    if height.device.type != "cpu":
        entry.launches += 1
    return out


def _even(entry, height):
    if height.shape[0] % 2:
        raise ValueError(f"{entry.__name__}: the pair and quad layouts need an "
                         f"even grid, got {height.shape[0]}")


def pool_automata_pallas(height, pool, iterations: int = 10,
                         drain_particles: bool = True, block: int = 256):
    """``pool_pallas.pool_automata_pallas`` (TPU kernel ``_phase_call``):
    the full-grid masked phases, on K5 at every size."""
    return _counted(pool_automata_pallas, pool_automata_full_cuda, height,
                    pool, iterations, drain_particles)


def pool_automata_pallas_pair(height, pool, iterations: int = 10,
                              drain_particles: bool = True, block: int = None):
    """``pool_pallas.pool_automata_pallas_pair`` (TPU kernel
    ``_phase_pair_call``) on K4.  The reference gates each step on
    ``any(pool > 0)``, K4 each call on ``MIN_WATER``: both skip only fixed
    points, so the results are equal."""
    _even(pool_automata_pallas_pair, height)
    return _counted(pool_automata_pallas_pair, pool_automata_cuda, height,
                    pool, iterations, drain_particles)


def pool_automata_pallas_quad(height, pool, iterations: int = 10,
                              drain_particles: bool = True, block: int = None,
                              phases_per_launch: int = 4, unroll: bool = None):
    """``pool_pallas.pool_automata_pallas_quad`` (TPU kernel
    ``_fused_quad_call``, diagonal quadrants) on K4; same gate note as
    :func:`pool_automata_pallas_pair`."""
    _even(pool_automata_pallas_quad, height)
    return _counted(pool_automata_pallas_quad, pool_automata_cuda, height,
                    pool, iterations, drain_particles)


def pool_automata_pallas_pair_fused(height, pool, iterations: int = 10,
                                    drain_particles: bool = True,
                                    block: int = None,
                                    phases_per_launch: int = 4,
                                    unroll: bool = True):
    """``pool_pallas.pool_automata_pallas_pair_fused`` (TPU kernel
    ``_fused_pair_call``) on K4."""
    _even(pool_automata_pallas_pair_fused, height)
    return _counted(pool_automata_pallas_pair_fused, pool_automata_cuda,
                    height, pool, iterations, drain_particles)


def pool_automata_pallas_mega(height, pool, iterations: int = 10,
                              drain_particles: bool = True, block: int = None,
                              phases_per_launch: int = 4):
    """``pool_pallas.pool_automata_pallas_mega`` (TPU kernel ``_mega_call``)
    on K4."""
    _even(pool_automata_pallas_mega, height)
    return _counted(pool_automata_pallas_mega, pool_automata_cuda, height,
                    pool, iterations, drain_particles)


ENTRIES = (pool_automata_pallas, pool_automata_pallas_pair,
           pool_automata_pallas_quad, pool_automata_pallas_pair_fused,
           pool_automata_pallas_mega)
for _w in ENTRIES:
    _w.launches = 0
