"""``app.flagship.make_tile_step``: the flagship step as a stream of whole
tiles, one call a tile, the next origin along a row each call, the
particle key ``fold_in(PRNGKey(seed), call)``.  The row is the traffic's
``row_tiles`` tiles from the origin, walked round from a tile the seed
draws: every seed meets the same terrain in another order.

Each call is a pure function of its origin and key, so the reference
recomputes a sampled call of the window's first few and the window's last
call from those alone, and compares every map the step returns and the
mesh.
"""

from __future__ import annotations

from ..check import merge, mesh_gap, rel_gap
from ..reference import pipeline as ref
from .common import port_meta, port_settings, rng_of, sub_seed, sync

MAPS = ("height", "flow_velocity", "pool", "stream")
MESH = ("positions", "normals", "tangents", "uvs", "indices")


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from noize_tpu_torch.app.flagship import make_tile_step

        self.config, self.traffic, self.device = config, traffic, device
        rng = rng_of(seed)
        self.meta = port_meta(config)
        self.first_tile = int(rng.integers(0, traffic["row_tiles"]))
        self.key_seed = sub_seed(rng)
        self.sample = int(rng.integers(0, traffic["sample_within"]))
        f = config["field"]
        self.cycles_per_call = traffic["erosion_cycles"]
        self.step, _, _ = make_tile_step(
            self.meta, port_settings(config), octaves=f["octaves"], hurst=f["hurst"],
            noise_size=f["noise_size"], noise_type=f["noise_type"],
            blur_iterations=f["blur_iterations"], flow_iterations=f["flow_iterations"],
            erosion_cycles=self.cycles_per_call, emit_mesh=True, mesh_layout=config["mesh"],
            device=device)
        self.calls = 0
        self.kept = {}

    def _inputs(self, i: int):
        from noize_tpu_torch.prng import PRNGKey, fold_in

        x, z = self.meta.tile_origin(((self.first_tile + i) % self.traffic["row_tiles"], 0))
        return x, z, fold_in(PRNGKey(self.key_seed, device=self.device), i)

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.step(*self._inputs(-1 - i))
        sync(self.device)

    def call(self):
        i = self.calls
        out = self.step(*self._inputs(i))
        if i == self.sample:
            self.kept[i] = out
        self.last = (i, out)
        self.calls += 1

    def counters(self) -> dict:
        return {}

    def finish(self):
        i, out = self.last
        self.kept[i] = out
        self.step = None

    def numbers(self, device, cast=None) -> dict:
        """{height, flow_velocity, pool, stream, mesh} over the kept calls."""
        out = {}
        for i, got in sorted(self.kept.items()):
            x, z, key = self._inputs(i)
            key = key.to(device)
            want = ref.tile_step(self.config, x, z, key, self.cycles_per_call, device=device)
            if cast is not None:
                got = ref.tile_step(self.config, x, z, key, self.cycles_per_call,
                                    device=device, cast=cast)
                got_mesh = got["mesh"]
            else:
                m = got["mesh"]
                got_mesh = {k: getattr(m, k) for k in MESH}
            merge(out, {k: rel_gap(got[k], want[k]) for k in MAPS})
            merge(out, {"mesh": mesh_gap(got_mesh, want["mesh"])})
        return out
