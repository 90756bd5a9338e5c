#!/usr/bin/env python3
"""The sharded erosion cycle on a 2-D mesh of cards, against one card.

    python3 scripts/sharded_cards.py [--ranks 4] [--res 2048] [--steps 3] [--device cuda]
                                     [--pool-group K]

Starts ``--ranks`` processes, one card each (NCCL; ``--device cpu`` runs
gloo ranks on the CPU, for a rehearsal at a small ``--res``).  Every rank
builds the Quickstart pipeline's height (fBm 13 octaves, Gauss-5 ×17, flow
×8) and runs ``ShardedErosionSim.step()`` (3 cycles, ``ErosionSettings()``
defaults) ``--steps`` times on the most-square mesh of the ranks; rank 0
then runs ``ErosionSim.step()`` on its card from the same height and key
and compares the first step's maps (the descent's event sums reassociate
across block borders: the largest difference is printed, and held to the
reference's 2e-6).  Then
``dryrun_multichip(--ranks)``.  Prints the card's name and power limit
first; times are host clock to ``torch.cuda.synchronize()`` and a barrier.
Rank 0 also counts the rounds of neighbour traffic (``halo._shift`` calls)
a cycle, all of them and the pool automata's.  ``--pool-group`` sets the
water steps a K5 window call runs between two exchanges of the pool
(``sharded_erosion.POOL_GROUP``) for the run, to compare schedules.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _height(res: int, device):
    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import FlowMapStage, NoiseStage, StageGaussianBlur

    pipe = Pipeline([NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
                     StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
                     FlowMapStage(iterations=8)], device=device)
    return pipe.run(GeneratorData(uuid="t00", resolution=res, xpos=0, zpos=0)).data


def _sync(device):
    import torch
    import torch.distributed as dist

    if device == "cuda":
        torch.cuda.synchronize()
    dist.barrier()


def _count_rounds():
    """Count ``halo._shift`` calls (one round of neighbour traffic each),
    all and those inside the sharded pool automata: a dict the counts land
    in."""
    from noize_tpu_torch.parallel import halo, sharded_erosion

    rounds = {"all": 0, "pool": 0}
    shift, pool_block = halo._shift, sharded_erosion._pool_block

    def counted_shift(*args, **kwargs):
        rounds["all"] += 1
        return shift(*args, **kwargs)

    def counted_pool_block(*args, **kwargs):
        before = rounds["all"]
        out = pool_block(*args, **kwargs)
        rounds["pool"] += rounds["all"] - before
        return out

    halo._shift = counted_shift
    sharded_erosion._pool_block = counted_pool_block
    return rounds


def _rank(rank: int, world: int, init: str, res: int, steps: int, device: str,
          pool_group=None):
    import torch
    import torch.distributed as dist

    from noize_tpu_torch.erosion.descent_cuda import descend_steps_window
    from noize_tpu_torch.erosion.pool_cuda import pool_automata_window
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.parallel import device_mesh as DM
    from noize_tpu_torch.parallel.distributed import initialize
    from noize_tpu_torch.parallel import sharded_erosion as SE
    from noize_tpu_torch.parallel.sharded_erosion import ShardedErosionSim

    if pool_group is not None:
        SE.POOL_GROUP = pool_group
    rounds = _count_rounds()
    initialize(f"file://{init}", world, rank, device=device)
    try:
        dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else "cpu"
        h = _height(res, dev)
        mesh = DM.spatial_mesh()
        sim = ShardedErosionSim(mesh, h)
        times = []
        for i in range(steps):
            _sync(device)
            t0 = time.perf_counter()
            sim.step()
            _sync(device)
            times.append((time.perf_counter() - t0) * 1e3)
            if i == 0:
                cycles = sim.settings.CYCLES
                per_cycle = {k: v / cycles for k, v in rounds.items()}
                first = {k: getattr(sim.state.world, k).full_tensor() for k in
                         ("height", "pool", "flow", "track")}
                first["drain"] = sim.state.drain_water.full_tensor()
                first_key = sim.state.key.clone()
        if rank == 0:
            block = tuple(sim.state.world.height.to_local().shape)
            print(f"ShardedErosionSim.step() {res}² on a {tuple(mesh.shape)} mesh of {world} "
                  f"{device} ranks (blocks {block}), 3 cycles: "
                  + ", ".join(f"{t:.3f}" for t in times) + " ms; K5 window launches on rank 0 "
                  f"{pool_automata_window.launches}, K7 window launches "
                  f"{descend_steps_window.launches}; pool group {SE.POOL_GROUP} water steps; "
                  f"rounds of neighbour traffic a cycle on rank 0: {per_cycle['all']:g}, of "
                  f"them the pool automata's {per_cycle['pool']:g}")
            single = ErosionSim(h)
            ones = []
            for i in range(steps):
                _sync_local(device)
                t0 = time.perf_counter()
                single.step()
                _sync_local(device)
                ones.append((time.perf_counter() - t0) * 1e3)
                if i == 0:
                    w = single.state.world
                    want = {"height": w.height, "pool": w.pool, "flow": w.flow,
                            "track": w.track, "drain": single.state.drain_water}
                    gaps = {k: float((first[k].double() - want[k].double()).abs().max())
                            for k in want}
                    keys_equal = bool(torch.equal(first_key, single.state.key))
            print(f"ErosionSim.step() {res}² on one {device}: "
                  + ", ".join(f"{t:.3f}" for t in ones) + " ms")
            print(f"first step, sharded vs one device: largest difference {gaps}; keys equal "
                  f"{keys_equal}")
            for k, v in first.items():
                if not bool(torch.isfinite(v).all()):
                    raise RuntimeError(f"sharded {k} not finite")
            if not keys_equal:
                raise RuntimeError("the sharded key differs from the single-device key")
            if max(gaps.values()) > 2e-6:
                raise RuntimeError(f"the sharded step is not within 2e-6 of one device: {gaps}")
        dist.barrier()
    finally:
        dist.destroy_process_group()


def _sync_local(device):
    import torch

    if device == "cuda":
        torch.cuda.synchronize()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--steps", type=int, default=3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--pool-group", type=int, default=None,
                    help="water steps a K5 window call runs (default: POOL_GROUP)")
    ap.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    ap.add_argument("--init", default=None, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.rank is not None:
        _rank(args.rank, args.ranks, args.init, args.res, args.steps, args.device,
              args.pool_group)
        return 0
    if args.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    env = dict(os.environ, OMP_NUM_THREADS="1")
    with tempfile.TemporaryDirectory() as d:
        init = os.path.join(d, "init")
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--rank", str(r),
                                   "--ranks", str(args.ranks), "--init", init, "--res",
                                   str(args.res), "--steps", str(args.steps), "--device",
                                   args.device]
                                  + ([] if args.pool_group is None
                                     else ["--pool-group", str(args.pool_group)]),
                                  cwd=ROOT, env=env)
                 for r in range(args.ranks)]
        try:
            rcs = [p.wait(timeout=900) for p in procs]
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    if any(rcs):
        print(f"ranks failed: {rcs}")
        return 1
    from noize_tpu_torch.app.dryrun import dryrun_multichip

    t0 = time.perf_counter()
    dryrun_multichip(args.ranks, device=args.device)
    print(f"dryrun_multichip({args.ranks}, device={args.device!r}): "
          f"{(time.perf_counter() - t0) * 1e3:.1f} ms")
    return 0


if __name__ == "__main__":
    sys.exit(main())
