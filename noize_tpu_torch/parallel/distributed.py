"""Multi-process initialisation and meshes; port of
``noize_tpu.parallel.distributed``.

``initialize`` starts the default ``torch.distributed`` process group —
NCCL when the ranks drive cards, gloo on the CPU — with the coordinator's
address given to it (nothing on the machine announces a cluster).  Only
the outer axis of the multi-host meshes (``host``) crosses hosts: tiles
are independent, so cross-host traffic stays at orchestration scale.
"""

from __future__ import annotations

import os
from typing import Optional

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from .device_mesh import _mesh


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device="cuda"):
    """Join the process group; a no-op returning False when neither a
    coordinator nor the environment (``MASTER_ADDR``, as ``torchrun``
    sets it) names one.  ``coordinator`` is ``host:port`` (TCP) or an
    init-method URL (``tcp://...``, ``file://...``).  On ``device="cuda"``
    the group is NCCL and the rank takes card ``process_id`` modulo the
    cards it sees; on the CPU it is gloo.  Returns True."""
    if coordinator is None and "MASTER_ADDR" not in os.environ:
        return False
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device")
        rank = process_id if process_id is not None else int(os.environ.get("RANK", 0))
        torch.cuda.set_device(rank % torch.cuda.device_count())
    if coordinator is None:
        method = "env://"
    else:
        method = coordinator if "://" in coordinator else f"tcp://{coordinator}"
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo", init_method=method,
        world_size=-1 if num_processes is None else int(num_processes),
        rank=-1 if process_id is None else int(process_id))
    return True


def _local_count() -> int:
    """Ranks on this host: ``LOCAL_WORLD_SIZE`` where a launcher sets it,
    else one (each process its own host)."""
    return int(os.environ.get("LOCAL_WORLD_SIZE", 1))


def multihost_tile_mesh() -> DeviceMesh:
    """('host', 'batch') mesh: the host axis crosses hosts (independent
    tiles only), the batch axis is a host's ranks."""
    n_local = _local_count()
    return _mesh(None, (dist.get_world_size() // n_local, n_local), ("host", "batch"), None)


def multihost_spatial_mesh() -> DeviceMesh:
    """('host', 'x', 'y'): one spatial field per host; halo exchange stays
    within a host's ranks, hosts own independent fields."""
    n_local = _local_count()
    nx = int(n_local ** 0.5)
    while n_local % nx:
        nx -= 1
    return _mesh(None, (dist.get_world_size() // n_local, nx, n_local // nx),
                 ("host", "x", "y"), None)


def is_primary() -> bool:
    return not dist.is_initialized() or dist.get_rank() == 0
