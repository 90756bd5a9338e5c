"""``parallel.tiled.tile_batch``: a world strip baked with the generator
pipeline, one call a block of neighbouring tiles (the next block along a
row each call), erosion as the traffic says, mesh planes on.

A tile is a pure function of its origin and the seed, so the reference
recomputes every tile of a sampled call among the window's first few and
of the window's last call.
"""

from __future__ import annotations

import numpy as np

from ..check import merge, rel_gap
from ..reference import pipeline as ref
from .common import pipeline_config, port_meta, rng_of, start_tile, sub_seed, sync


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.device = config, traffic, device
        rng = rng_of(seed)
        self.meta = port_meta(config)
        self.corner = start_tile(rng)
        self.seed = sub_seed(rng)
        self.sample = int(rng.integers(0, traffic["sample_within"]))
        self.cycles_per_call = traffic["erosion_cycles"] * traffic["block"] ** 2
        self.tiles_per_call = traffic["block"] ** 2
        self.cfg = pipeline_config(config, erosion_cycles=traffic["erosion_cycles"],
                                   emit_mesh=True)
        self.calls = 0
        self.kept = {}

    def origins(self, i: int) -> np.ndarray:
        """The ``block``² tiles of call ``i``: block ``i`` along the row."""
        b = self.traffic["block"]
        x0, z0 = self.corner[0] + b * i, self.corner[1]
        return np.asarray([self.meta.tile_origin((x0 + dx, z0 + dz))
                           for dz in range(b) for dx in range(b)], np.int32)

    def _run(self, i: int):
        from noize_tpu_torch.parallel.tiled import tile_batch

        return tile_batch(self.cfg, self.origins(i), seed=self.seed, device=self.device)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self._run(-1 - i)
        sync(self.device)

    def call(self):
        i = self.calls
        out = self._run(i)
        if i == self.sample:
            self.kept[i] = out
        self.last = (i, out)
        self.calls += 1

    def counters(self) -> dict:
        return {}

    def finish(self):
        i, out = self.last
        self.kept[i] = out

    def numbers(self, device, cast=None) -> dict:
        """{height, mesh} over every tile of the kept calls."""
        out = {}
        cycles = self.traffic["erosion_cycles"]
        for i, got in sorted(self.kept.items()):
            o = self.origins(i)
            want = ref.tile_batch(self.config, o, self.seed, cycles, device=device)
            if cast is not None:
                got = ref.tile_batch(self.config, o, self.seed, cycles, device=device,
                                     cast=cast)
                planes = got["mesh"]["planes"]
            else:
                planes = got["mesh_planes"]
            merge(out, {"height": rel_gap(got["height"], want["height"]),
                        "mesh": rel_gap(planes, want["mesh"]["planes"])})
            del want, got
        return out
