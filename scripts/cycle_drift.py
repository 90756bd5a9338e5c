#!/usr/bin/env python3
"""The card against the CPU over many erosion cycles: how far the two drift
apart when one seed drives both.

    python3 scripts/cycle_drift.py [--res 2048] [--cycles 30] [--seed 0]
    python3 scripts/cycle_drift.py --device cpu --res 64 --cycles 3   # a rehearsal

Makes the README Quickstart's terrain (Simplex fBm of 13 octaves, Gauss-5
×17, flow ×8) on the CPU, copies it to the card, and runs ``ErosionSim``
with ``ErosionSettings()`` defaults and the key of ``--seed`` on both
devices, one cycle a step.  After each cycle it prints, for each map
(height, pool, track, flow, drain water), the largest difference between
the card's and the CPU's values relative to the CPU map's largest magnitude,
and whether the keys are equal; at the end, the first cycle at which each
map passes ``chip_smoke.py``'s card-against-CPU tolerance (1e-4), and the
time each device took.  ``--device cpu`` runs the CPU against itself (a
rehearsal: every gap 0).
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CROSS_DEVICE_RTOL = 1e-4
MAPS = ("height", "pool", "track", "flow", "drain")


def terrain(res: int):
    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import FlowMapStage, NoiseStage, StageGaussianBlur

    pipe = Pipeline([NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
                     StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
                     FlowMapStage(iterations=8)], device="cpu")
    return pipe.run(GeneratorData(uuid="t00", resolution=res, xpos=0, zpos=0)).data


def maps(sim):
    w = sim.state.world
    return dict(height=w.height, pool=w.pool, track=w.track, flow=w.flow,
                drain=sim.state.drain_water)


def main():
    import torch

    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim

    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--cycles", type=int, default=30)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda":
        if not torch.cuda.is_available():
            raise SystemExit("cycle_drift: needs a CUDA device (or --device cpu)")
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True).stdout.strip())
    print(f"torch {torch.__version__}, {torch.get_num_threads()} CPU threads; {a.res}², "
          f"{a.cycles} cycles of ErosionSettings() defaults, seed {a.seed}")
    height = terrain(a.res)
    settings = ErosionSettings(CYCLES=1)
    sims = {d: ErosionSim(height.to(d), settings=settings, seed=a.seed, device=d)
            for d in (a.device, "cpu")}
    if a.device == "cpu":  # the rehearsal: a second CPU sim
        sims = {"cpu*": ErosionSim(height.clone(), settings=settings, seed=a.seed,
                                   device="cpu"), "cpu": sims["cpu"]}
    dev = next(iter(sims))
    first = {}
    spent = {d: 0.0 for d in sims}
    for cycle in range(1, a.cycles + 1):
        for d, sim in sims.items():
            t0 = time.perf_counter()
            sim.step()
            if d == "cuda":
                torch.cuda.synchronize()
            spent[d] += time.perf_counter() - t0
        got, want = maps(sims[dev]), maps(sims["cpu"])
        gaps = {}
        for k in MAPS:
            g, w = got[k].cpu().double(), want[k].double()
            gaps[k] = float((g - w).abs().max()) / max(float(w.abs().max()), 1e-30)
            if gaps[k] > CROSS_DEVICE_RTOL and k not in first:
                first[k] = cycle
        keys = torch.equal(sims[dev].state.key.cpu(), sims["cpu"].state.key)
        print(f"cycle {cycle}: " + ", ".join(f"{k} {gaps[k]:.3e}" for k in MAPS)
              + f"; keys {'equal' if keys else 'DIFFER'}", flush=True)
    print("first cycle past 1e-4: " + ", ".join(f"{k} {first.get(k, 'none')}" for k in MAPS))
    print("seconds: " + ", ".join(f"{d} {t:.1f}" for d, t in spent.items()))


if __name__ == "__main__":
    main()
