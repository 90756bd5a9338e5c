"""The readings that the comparison's limits are set from, for one cell, on
many seeds in one process:

    python3 -m h100bench.calibrate --workload <name> --seeds 1,2,3 --seconds 2 [--control]

For each seed: the cell's set-up, a short window of its own traffic, and
the program's numbers against the reference (the lower readings); with
``--control``, also the reference computed with every map stored as
bfloat16 between stages, put in the program's place (the upper
readings).  One JSON line a seed on standard output.  The benchmark's own
runs never run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time

from . import core
from .reference.pipeline import to_bfloat16


def readings(name: str, seed: int, seconds: float, control: bool, *, device="cuda",
             bench=None, here=core.HERE) -> dict:
    import torch

    bench = bench or core.benchmark()
    wl = core.workload(bench, name)
    config, traffic = core.config(wl["config"], here), core.traffic(wl["traffic"], here)
    entry = core.entry(traffic["entry"])(config, traffic, seed, device)
    entry.warm()
    win = core.driver(traffic["driver"]).run(entry, traffic, seed, seconds, False)
    entry.finish()
    gc.collect()
    t0 = time.perf_counter()
    out = {"seed": seed, "failed": win.failed, "program": entry.numbers(device)}
    out["check_s"] = time.perf_counter() - t0
    if control:
        out["control"] = entry.numbers(device, cast=to_bfloat16)
    del entry
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--control", action="store_true")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100bench.calibrate: no CUDA card", file=sys.stderr)
        return 2
    for s in a.seeds.split(","):
        print(json.dumps(readings(a.workload, int(s), a.seconds, a.control)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
