"""``erosion.sim.ErosionSim.step`` on one tile, its state carried over from
step to step: an editor eroding a tile live.

Set-up makes the Quickstart field of the configuration's tile (the
traffic's ``tile``, the Quickstart's (0, 0)) with the port's field ops (fBm on K10, Gauss chain on K1, flow map on K2, written as the
height, as the Quickstart's ``FlowMapStage`` writes it) and the sim on it,
its particle key drawn from the seed: every seed erodes the same terrain,
with other particles.  The reference can only follow the program step by
step from the program's own state, so the check covers: the start (the
program's field against the reference's, from the same tile), the first
step from the reference's own start (the warm-up's first step), and the
window's last step from the state the program carried into it.
"""

from __future__ import annotations

from ..check import merge, rel_gap
from ..reference import pipeline as ref
from .common import port_meta, port_settings, rng_of, sub_seed, sync

MAPS = (("height", "height"), ("pool", "pool"), ("stream", "flow"))


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device):
        from noize_tpu_torch.erosion.sim import ErosionSim
        from noize_tpu_torch.ops.cuda.flow import flow_map_fused
        from noize_tpu_torch.ops.cuda.stencil import gauss_chain
        from noize_tpu_torch.ops.fractal import fractal

        self.config, self.traffic, self.device = config, traffic, device
        rng = rng_of(seed)
        meta = port_meta(config)
        self.origin = meta.tile_origin(tuple(traffic["tile"]))
        self.sim_seed = sub_seed(rng)
        f = config["field"]
        h = fractal(meta.generator_res, self.origin[0], self.origin[1],
                    noise_type=f["noise_type"], hurst=f["hurst"], octaves=f["octaves"],
                    noise_size=f["noise_size"], device=device)
        h = gauss_chain(h, f["blur_width"], f["blur_sigma"], f["blur_iterations"])
        h = flow_map_fused(h, iterations=f["flow_iterations"])
        self.sim = ErosionSim(h, settings=port_settings(config), meta=meta,
                              seed=self.sim_seed, device=device)
        self.start = self.sim.state
        self.cycles_per_call = self.sim.settings.CYCLES
        self.first = self.prev = None

    def warm(self):
        for i in range(self.traffic["warm_calls"]):
            self.sim.step()
            if i == 0:
                self.first = self.sim.state
        sync(self.device)

    def call(self):
        self.prev = self.sim.state
        self.sim.step()

    def counters(self) -> dict:
        return {}

    def finish(self):
        self.last = self.sim.state
        self.sim = None

    def numbers(self, device, cast=None) -> dict:
        """{start_height, height, pool, stream}: the largest gaps of the
        start and of the two steps checked."""
        c = cast or ref.same
        out = {}
        want0 = ref.sim_start(self.config, self.origin[0], self.origin[1], self.sim_seed,
                              device=device)
        if cast is None:
            out["start_height"] = rel_gap(self.start.world.height, want0.world.height)
        else:
            got0 = ref.sim_start(self.config, self.origin[0], self.origin[1], self.sim_seed,
                                 device=device, cast=c)
            out["start_height"] = rel_gap(got0.world.height, want0.world.height)
        pairs = [(want0, self.first), (_to(self.prev, device), self.last)]
        for before, after in pairs:
            want = ref.erode(before, self.config, self.cycles_per_call, tuned=True)
            got = (after if cast is None else
                   ref.erode(before, self.config, self.cycles_per_call, tuned=True, cast=c))
            merge(out, {name: rel_gap(getattr(got.world, m), getattr(want.world, m))
                        for name, m in MAPS})
            del want, got
        return out


def _to(state, device):
    """The program's state as the reference's ``SimState`` on ``device``."""
    from ..reference.sim import SimState
    from ..reference.world import WorldState

    w = state.world
    world = WorldState(**{k: getattr(w, k).to(device) for k in
                          ("height", "pool", "flow", "track", "plants")})
    return SimState(world=world, drain_water=state.drain_water.to(device),
                    key=state.key.to(device))
