#!/usr/bin/env python3
"""What the threefry spawn costs an erosion step, on one NVIDIA GPU.

    python3 scripts/spawn_cost.py [--res 2048] [--pairs 5]

``ErosionSim.step()`` (3 cycles, ``ErosionSettings()`` defaults) on
blurred 13-octave noise draws its particles from the threefry key
(``noize_tpu_torch.prng``).  The same step with the same particles handed
in through the ``fresh`` hook (drawn before the clock starts) does
everything but the draws.  The two run in alternating pairs from the same
start state, so their difference is the draws' cost in the step.  Also
timed by CUDA events: one ``spawn`` of 1000 particles, one ``randint`` of
10⁶, and the replaced draw (two ``torch.randint`` calls).  Prints the card's
name and power limit first.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _events_ms(fn, reps=20):
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--res", type=int, default=2048)
    ap.add_argument("--pairs", type=int, default=5)
    args = ap.parse_args()

    import torch

    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion.particles import spawn
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.fractal import fractal

    if not torch.cuda.is_available():
        raise SystemExit("spawn_cost: no CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip())
    h = gauss_chain(fractal(args.res, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                            noise_size=1700.0, device="cuda"), 5, 1.0, 17)
    key = prng.PRNGKey(0, device="cuda")
    n, res = 1000, args.res

    def fresh_for(sim):
        """The particles each cycle of ``sim.step()`` will draw."""
        out, k = [], sim.state.key
        for _ in range(sim.settings.CYCLES):
            k1, k = prng.split(k)
            out.append(spawn(k1, n, res))
        return out

    keyed, hooked = [], []
    for i in range(args.pairs + 1):
        for label, runs in (("key", keyed), ("fresh", hooked))[:: 1 if i % 2 else -1]:
            sim = ErosionSim(h, seed=i)
            fresh = fresh_for(sim) if label == "fresh" else None
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            sim.step(fresh=fresh)
            torch.cuda.synchronize()
            if i:  # the first pair warms both up
                runs.append((time.perf_counter() - t0) * 1e3)
    print(f"ErosionSim.step {res}² (3 cycles): from the key {[round(t, 3) for t in keyed]} ms, "
          f"median {statistics.median(keyed):.3f}; with fresh {[round(t, 3) for t in hooked]} ms, "
          f"median {statistics.median(hooked):.3f}; difference of medians "
          f"{statistics.median(keyed) - statistics.median(hooked):.3f} ms")
    g = torch.Generator(device="cuda").manual_seed(0)
    print(f"spawn of {n}: {_events_ms(lambda: spawn(key, n, res)):.4f} ms; randint of 10^6: "
          f"{_events_ms(lambda: prng.randint(key, (1_000_000,), 0, res)):.4f} ms; the replaced "
          f"draw (two torch.randint of {n}): "
          f"{_events_ms(lambda: [torch.randint(0, res, (n,), generator=g, device='cuda') for _ in range(2)]):.4f} ms")


if __name__ == "__main__":
    main()
