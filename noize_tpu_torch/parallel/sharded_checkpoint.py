"""Per-rank checkpoints of sharded fields; port of
``noize_tpu.parallel.sharded_checkpoint``.

Each rank addresses only its own block of a ``DTensor``, so a sharded world
is checkpointed block by block: every rank writes its block through the
port's ``core.serde`` (NZTFU files on the native write pool, the
``files.json`` manifest) under ``<root>/save__proc{rank}_0/``, keyed by the
block's global spans, plus a ``{name}.meta.json`` sidecar with the global
shape, dtype and the rank's block keys — the reference's layout.  Restore
reads the blocks the same rank owns under the target placement, so it
needs the topology of the save (the same ranks and mesh); another one
raises ``IOError``.  No bytes cross ranks either way.
"""

from __future__ import annotations

import json
import os
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh
from torch.distributed.tensor import DTensor, Shard

from ..core.serde import SerdeManager
from .device_mesh import field_sharding
from .halo import _mesh_device


def _shard_key(name: str, spans, shape) -> str:
    """The buffer key of one global block: its [start, stop) span in each
    dimension."""
    return f"{name}__shard__{'_'.join(f'{a}-{b}' for a, b in spans)}"


def _spans(shape, mesh, placements):
    """This rank's [start, stop) in each dimension of a ``shape`` tensor
    placed on ``mesh`` (even blocks, as the sharded fields are)."""
    spans = [[0, int(n)] for n in shape]
    if mesh is None:
        return [tuple(s) for s in spans]
    for i, p in enumerate(placements):
        if isinstance(p, Shard):
            n = mesh.size(i)
            a, b = spans[p.dim]
            if (b - a) % n:
                raise ValueError(f"dimension {p.dim} of {tuple(shape)} does not divide over "
                                 f"{n} ranks")
            step = (b - a) // n
            a += mesh.get_local_rank(i) * step
            spans[p.dim] = [a, a + step]
    return [tuple(s) for s in spans]


def _target(sharding):
    """(mesh, placements) of a load target: a ``DeviceMesh`` (a field's
    placements) or a (mesh, placements) pair."""
    if isinstance(sharding, DeviceMesh):
        return sharding, field_sharding(sharding)
    mesh, placements = sharding
    return mesh, list(placements)


class ShardedCheckpoint:
    """Per-rank block writer and reader rooted at a shared save directory
    (typically ``PipelineStateManager.serde.root``).  ``process_index``
    defaults to the rank in the default process group (0 without one)."""

    def __init__(self, root: str, process_index: Optional[int] = None):
        if process_index is None:
            process_index = dist.get_rank() if dist.is_initialized() else 0
        self.root = root
        self.serde = SerdeManager(root, f"proc{process_index}", "0")

    def _meta_path(self, name: str) -> str:
        return os.path.join(self.serde.root, f"{name.replace('/', '_')}.meta.json")

    def save(self, name: str, arr, async_: bool = False):
        """Write this rank's block of ``arr`` (a ``DTensor``; a plain tensor
        is one replicated block), ``async_`` on the native write pool
        (``flush()`` waits for it)."""
        shape = tuple(arr.shape)
        if isinstance(arr, DTensor):
            spans = _spans(shape, arr.device_mesh, arr.placements)
            block = arr.to_local()
        else:
            spans, block = _spans(shape, None, None), arr
        key = _shard_key(name, spans, shape)
        block = block.detach().cpu().numpy()
        self.serde.save(key, block, async_=async_)
        os.makedirs(self.serde.root, exist_ok=True)
        with open(self._meta_path(name), "w") as fh:
            json.dump({"shape": list(shape), "dtype": str(block.dtype), "blocks": [key]}, fh)

    def exists(self, name: str) -> bool:
        if not os.path.exists(self._meta_path(name)):
            return False
        with open(self._meta_path(name)) as fh:
            meta = json.load(fh)
        return all(self.serde.exists(k) for k in meta["blocks"])

    def flush(self):
        """Barrier for ``async_`` writes."""
        self.serde.flush()

    def load(self, name: str, sharding):
        """Rebuild the ``DTensor`` placed as ``sharding`` (a ``DeviceMesh``
        for a field, or (mesh, placements)) from this rank's block file;
        None if ``name`` was not saved.  The topology must be the save's."""
        if not os.path.exists(self._meta_path(name)):
            return None
        with open(self._meta_path(name)) as fh:
            meta = json.load(fh)
        shape = tuple(meta["shape"])
        mesh, placements = _target(sharding)
        spans = _spans(shape, mesh, placements)
        block = self.serde.load(_shard_key(name, spans, shape))
        if block is None:
            raise IOError(f"checkpoint {name!r} lacks block {spans} for rank "
                          f"{dist.get_rank() if dist.is_initialized() else 0} — restore "
                          "topology must match the save (same process count and mesh layout)")
        local = torch.from_numpy(np.array(block)).to(_mesh_device(mesh))
        stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
        return DTensor.from_local(local, mesh, placements, run_check=False,
                                  shape=torch.Size(shape), stride=stride)
