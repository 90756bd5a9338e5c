"""Device meshes for tile-batch (dp) and spatial (sp) sharding; port of
``noize_tpu.parallel.device_mesh``.

  * multi-tile parallelism → a ``batch`` mesh axis: whole tiles per rank,
    no communication (the reference's independent-tile model);
  * one large grid split spatially → ``x``/``y`` mesh axes: a field
    sharded 2-D, halo strips exchanged between neighbours
    (``parallel.halo``) in place of margin recompute.

A mesh spans every rank of the default process group
(``parallel.distributed.initialize``), or the global ranks in
``devices``; every rank builds the same mesh.  Its device type is
``device`` when given, else the group's: ``cuda`` under NCCL, ``cpu``
under gloo.
"""

from __future__ import annotations

import math
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard


def _split2(n: int) -> Tuple[int, int]:
    """Most-square factorisation of n (prefers wide x)."""
    best = (n, 1)
    for a in range(1, int(math.isqrt(n)) + 1):
        if n % a == 0:
            best = (n // a, a)
    return best


def _mesh(devices, shape, names, device) -> DeviceMesh:
    if not dist.is_initialized():
        raise RuntimeError("no process group: call parallel.distributed.initialize "
                           "(or torch.distributed.init_process_group) first")
    if device is None:
        device = "cuda" if dist.get_backend() == "nccl" else "cpu"
    device_type = torch.device(device).type
    if devices is None:
        return init_device_mesh(device_type, tuple(shape), mesh_dim_names=names)
    ranks = torch.tensor([int(r) for r in devices], dtype=torch.int64).reshape(shape)
    return DeviceMesh(device_type, ranks, mesh_dim_names=names)


def spatial_mesh(devices: Optional[Sequence] = None, *, device=None) -> DeviceMesh:
    """2-D ('x', 'y') mesh over every rank (or the given ranks) for sp
    sharding."""
    n = dist.get_world_size() if devices is None else len(devices)
    return _mesh(devices, _split2(n), ("x", "y"), device)


def batch_mesh(devices: Optional[Sequence] = None, *, device=None) -> DeviceMesh:
    """1-D ('batch',) mesh for dp tile sharding."""
    n = dist.get_world_size() if devices is None else len(devices)
    return _mesh(devices, (n,), ("batch",), device)


def hybrid_mesh(batch: int, devices: Optional[Sequence] = None, *,
                device=None) -> DeviceMesh:
    """('batch', 'x', 'y') mesh: tile groups × a spatial split within each
    group."""
    n = dist.get_world_size() if devices is None else len(devices)
    if n % batch:
        raise ValueError(f"{n} devices not divisible by batch={batch}")
    return _mesh(devices, (batch, *_split2(n // batch)), ("batch", "x", "y"), device)


def field_sharding(mesh: DeviceMesh):
    """Placements of a single (H, W) field over a spatial mesh: rows over
    ``x``, columns over ``y``, replicated over any other axis."""
    return [Shard(0) if a == "x" else Shard(1) if a == "y" else Replicate()
            for a in mesh.mesh_dim_names]


def tile_batch_sharding(mesh: DeviceMesh):
    """Placements of a (T, H, W) tile stack over a batch mesh: tiles over
    ``batch``, replicated over any other axis."""
    return [Shard(0) if a == "batch" else Replicate() for a in mesh.mesh_dim_names]
