"""``app.server.TileServer``: tiles streamed around a moving player.

The player sweeps a fixed square of ``region``² tiles row by row, turning
at each edge (a lawnmower path, each order the next tile), from a start
and in an orientation the seed draws: every seed requests the same
terrain in another order.

The server batches the orders it is given (``batch_size``, ``max_wait_ms``
from the traffic) and runs each batch as one ``tile_batch``: the field
stages on the stack, erosion tile by tile, the mesh planes on the stack.
Every tile is a pure function of its origin and the server's seed, so the
reference recomputes every tile of a batch drawn from the seed and of the
window's last batch, from their positions alone.
"""

from __future__ import annotations

import threading

import numpy as np

from ..check import merge, rel_gap
from ..reference import pipeline as ref
from .common import pipeline_config, port_meta, rng_of, sub_seed


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from noize_tpu_torch.app.server import TileServer

        self.config, self.traffic, self.device = config, traffic, device
        self.rng = rng_of(seed)
        self.meta = port_meta(config)
        self.seed = sub_seed(self.rng)
        self.path = self._lawnmower()
        self.cycles_per_call = traffic["erosion_cycles"]
        cfg = pipeline_config(config, erosion_cycles=traffic["erosion_cycles"],
                              emit_mesh=True)
        self.server = TileServer(cfg, batch_size=traffic["batch_size"],
                                 max_wait_ms=traffic["max_wait_ms"], seed=self.seed,
                                 device=device)
        self._lock = threading.Lock()
        self.kept = {}          # batch id -> [(pos, heights, planes)]
        self.sample_batch = None
        self.last_batch = None

    def warm(self):
        """Full batches of the path's first tiles, through the server: a
        path's first meeting with a kind of tile (wet, steep) costs the
        process once, up to a second, and the window starts there."""
        self.server.start()
        n = self.traffic["warm_calls"] * self.traffic["batch_size"]
        for i, pos in enumerate(self.walk(n)):
            self.server.submit(f"warm{i}", pos)
        if not self.server.drain(timeout=600):
            raise RuntimeError("TileServer did not drain its warm-up orders")
        self.base_served, self.base_batches = self.server.served, self.server.batches

    def _lawnmower(self) -> list:
        """The region's tiles in the order the player sweeps them, from
        the seed's start tile and in its orientation."""
        side = self.traffic["region"]
        path = [(x if z % 2 == 0 else side - 1 - x, z) for z in range(side) for x in range(side)]
        flip, swap = self.rng.integers(0, 2, 2)
        if flip:
            path = [(side - 1 - x, z) for x, z in path]
        if swap:
            path = [(z, x) for x, z in path]
        start = int(self.rng.integers(0, len(path)))
        return path[start:] + path[:start]

    def walk(self, n: int) -> list:
        """The player's first ``n`` positions, round the path again at its
        end."""
        return [self.path[i % len(self.path)] for i in range(n)]

    def choose_sample(self, n_orders: int):
        """A batch to keep, among those that surely exist: at most
        ``batch_size`` orders a batch, so there are n / batch_size or more."""
        top = max(1, n_orders // self.traffic["batch_size"])
        self.sample_batch = self.base_batches + 1 + int(self.rng.integers(0, top))

    def submit(self, tile_id: str, pos, on_complete):
        self.server.submit(tile_id, pos, on_complete)

    def delivered(self, st):
        """Keep the tiles of the sampled batch and of the latest batch."""
        if st.error is not None:
            return
        with self._lock:
            b = st.batch_id
            if b != self.sample_batch and b != self.last_batch:
                if self.last_batch != self.sample_batch:
                    self.kept.pop(self.last_batch, None)
                self.last_batch = b
            if b in (self.sample_batch, self.last_batch):
                self.kept.setdefault(b, []).append((st.request.pos, st.heights,
                                                    st.mesh_planes))

    def counters(self) -> dict:
        return {"served": self.server.served - self.base_served,
                "batches": self.server.batches - self.base_batches,
                "batch_size": self.traffic["batch_size"]}

    def drain(self, timeout: float) -> bool:
        return self.server.drain(timeout=timeout)

    def finish(self):
        self.server.stop()

    def numbers(self, device, cast=None) -> dict:
        """{height, mesh} over every tile of the kept batches."""
        out = {}
        cycles = self.traffic["erosion_cycles"]
        for b, tiles in sorted(self.kept.items()):
            origins = np.asarray([self.meta.tile_origin(p) for p, _, _ in tiles], np.int32)
            want = ref.tile_batch(self.config, origins, self.seed, cycles, device=device)
            if cast is not None:
                got = ref.tile_batch(self.config, origins, self.seed, cycles, device=device,
                                     cast=cast)
                heights, planes = got["height"], got["mesh"]["planes"]
            else:
                heights = _stack([h for _, h, _ in tiles], device)
                planes = _stack([p for _, _, p in tiles], device)
            merge(out, {"height": rel_gap(heights, want["height"]),
                        "mesh": rel_gap(planes, want["mesh"]["planes"])})
            del want
        return out


def _stack(ts, device):
    import torch

    if any(t is None for t in ts):
        return None
    return torch.stack([t.to(device) for t in ts])
