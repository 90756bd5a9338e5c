"""Mesh bakery — port of ``noize_tpu.app.bakery``: the batched
mesh-finalization queue.

Reference: ``MeshBakery``/``MeshBakeOrder`` (Scripts/MeshBakery.cs:16-110)
and the bake jobs (Mesh/Job/BakeSingleMeshJob.cs, BakeManyMeshJob.cs).

Unity's "bake" precomputes physics-collider structures on worker threads;
here "make the mesh consumable by the engine" is host materialization:
each tensor comes to the host as ``.cpu().numpy()`` (which waits for the
card), then an optional callback.  Dedup-by-uuid and batch limits are
preserved (MeshBakery.cs:66-73)."""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np
import torch


@dataclass
class MeshBakeOrder:
    """MeshBakery.cs:16-21."""

    uuid: str
    mesh: object  # MeshArrays
    on_complete_bake: Optional[Callable[[str], None]] = None


@dataclass
class BakedMesh:
    positions: np.ndarray
    normals: np.ndarray
    tangents: np.ndarray
    uvs: np.ndarray
    indices: np.ndarray


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class MeshBakery:
    def __init__(self, max_batch: int = 8):
        self.max_batch = max_batch
        self.queue: List[MeshBakeOrder] = []
        self.known: Dict[str, BakedMesh] = {}
        self._in_flight: set = set()

    def enqueue(self, order: MeshBakeOrder):
        # duplicate-bake suppression (MeshBakery.cs:66-73)
        if order.uuid in self._in_flight or order.uuid in self.known:
            return False
        self._in_flight.add(order.uuid)
        self.queue.append(order)
        return True

    def service(self):
        """One batch tick (Update → BakeBatch, MeshBakery.cs:75-109);
        returns (meshes baked, ms)."""
        batch, self.queue = self.queue[: self.max_batch], self.queue[self.max_batch:]
        t0 = time.perf_counter()
        for order in batch:
            m = order.mesh
            baked = BakedMesh(
                positions=_host(m.positions),
                normals=_host(m.normals),
                tangents=_host(m.tangents),
                uvs=_host(m.uvs),
                indices=_host(m.indices),
            )
            self.known[order.uuid] = baked
            self._in_flight.discard(order.uuid)
            if order.on_complete_bake is not None:
                order.on_complete_bake(order.uuid)
        return len(batch), (time.perf_counter() - t0) * 1e3

    def drain(self):
        while self.queue:
            self.service()
