#!/usr/bin/env python3
"""What the first erosion step of a fresh process pays once: the host time
of each first call on the erosion path (the kernel library's load, the
first K8 hash, spawn, the first K7 launch, the first event scatter, the
first 2048² sim step) beside the same call made again.

    python3 scripts/first_call_cost.py

Prints one line a call (first ms, second ms, host clock to a
``torch.cuda.synchronize()``) and the card's name and power limit.  Needs
one CUDA card and nvcc (the kernels build on first use, timed apart).
"""

from __future__ import annotations

import os
import subprocess
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def main():
    if not torch.cuda.is_available():
        raise SystemExit("first_call_cost: needs a CUDA device")
    from noize_tpu_torch import _cuda, prng
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.erosion.world import WorldState

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _, build_ms = timed(_cuda.build)
    _, load_ms = timed(_cuda.library)
    print(f"build {build_ms:.1f} ms, load {load_ms:.1f} ms")
    torch.zeros(1, device="cuda")
    res = 2048
    g = torch.Generator(device="cuda").manual_seed(0)
    height = torch.rand((res, res), generator=g, device="cuda") * 0.1 + 0.5
    world = WorldState.create(height)
    params = ErosionSettings().as_parameters()
    key = prng.PRNGKey(0, device="cuda")
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain

    small = torch.rand((64, 64), generator=g, device="cuda")
    n = torch.arange(4, dtype=torch.int64, device="cuda")
    calls = [
        ("K1 on 64² (the library's first launch)", lambda: gauss_chain(small, 5, 1.0, 1)),
        ("uint32 cast", lambda: n.to(torch.uint32)),
        ("K8 layout", lambda: prng._threefry_layout(key, n, n)),
        ("K8 hash", lambda: prng.threefry2x32(key, n, n)),
        ("K8 split", lambda: prng.split(key)),
        ("spawn (K8)", lambda: PA.spawn(key, 1000, res)),
        ("step_maps", lambda: PA.step_maps(world, params, 1000.0)),
    ]
    for name, fn in calls:
        _, first = timed(fn)
        _, second = timed(fn)
        print(f"{name}: first {first:.3f} ms, again {second:.3f} ms")
    parts = PA.spawn(key, 1000, res)
    maps = PA.step_maps(world, params, 1000.0)
    from noize_tpu_torch.erosion import descent_cuda as DC

    fn = lambda: DC.descend_steps(parts, maps, params, 1000.0, 1, res, 104)  # noqa: E731
    ev, first = timed(fn)
    _, second = timed(fn)
    print(f"K7 descend_steps: first {first:.3f} ms, again {second:.3f} ms")
    fn = lambda: PA.scatter_events(ev[1], ev[2:], res * res)  # noqa: E731
    _, first = timed(fn)
    _, second = timed(fn)
    print(f"scatter_events: first {first:.3f} ms, again {second:.3f} ms")
    sim = ErosionSim(height)
    _, first = timed(sim.step)
    _, second = timed(sim.step)
    print(f"ErosionSim.step 2048²: first {first:.3f} ms, again {second:.3f} ms")


if __name__ == "__main__":
    main()
