"""Run one cell of the benchmark once.

    python3 -m h100bench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

Set-up (imports, the CUDA context, the kernels from the build cache, the
cell's inputs made from ``--seed``, the warm-up of the cell's own shapes)
is timed from the start of this module to the first timed call:
``setup_s``.  Then the traffic's driver measures for ``--seconds``.  With
``--trace 0`` the result line holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, read from a profile of the window's
last ``trace_seconds``.  After the window, the peak memory is read, the
program's state freed, and the sample the entry kept is compared with
the reference; each number compared is printed beside its limit as the
last lines of standard error and under ``"checks"``, the last key of the
result, which is the last line of standard output.

A run without a CUDA card, or with fewer than the cell asks for, or with
JAX or the JAX package loaded once the window has closed, exits with a
code other than 0 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from . import check, core  # noqa: E402
from .trace import Profiled, breakdown  # noqa: E402


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device="cuda",
             t_start: float = None, bench: dict = None, here=core.HERE, patch=None) -> dict:
    """One run of the cell ``name``; returns the result (``checks`` last).
    ``patch(entry)``, when given, runs on the entry after its set-up (the
    harness's own tests break the timed path with it)."""
    import torch

    t_start = T_START if t_start is None else t_start
    bench = bench or core.benchmark()
    wl = core.workload(bench, name)
    config, traffic = core.config(wl["config"], here), core.traffic(wl["traffic"], here)
    limits = core.cell(name, here)["limits"]
    cuda = torch.device(device).type == "cuda"

    make = core.entry(traffic["entry"])
    t_import = time.perf_counter()
    entry = make(config, traffic, seed, device)
    if patch is not None:
        patch(entry)
    t_inputs = time.perf_counter()
    entry.warm()
    setup_s = time.perf_counter() - t_start
    phases = {"import_s": t_import - t_start, "inputs_s": t_inputs - t_import,
              "warm_s": time.perf_counter() - t_inputs}
    if trace:
        with Profiled(device):
            pass  # the profiler's first start takes seconds: not inside the window
    win = core.driver(traffic["driver"]).run(entry, traffic, seed, seconds, trace)
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    entry.finish()
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    metrics = {}
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                   "count": wl["chips"], "memory_peak_bytes": int(peak)}
    out = {}
    if trace:
        tr = win.trace
        tr.cell, tr.config, tr.traffic = wl, config, traffic
        for m in core.per_layer_of(bench, name):
            v = core.metric_reader(m["name"], here).read(tr)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        device_info.update(busy_s=tr.busy_s(), window_s=tr.window_s)
        out["breakdown"] = breakdown(tr)
    else:
        values = dict(win.metrics, setup_s=setup_s)
        for m in core.end_to_end_of(bench, name):
            metrics[m["name"]] = {"value": values[m["name"]], "unit": m["unit"]}

    numbers = entry.numbers(device)
    ok, checks = check.judge(numbers, limits)
    result = {"correct": bool(ok and win.failed == 0), "attempted": win.attempted,
              "failed": win.failed, "metrics": metrics, "device": device_info}
    result.update(out)
    result["notes"] = dict(win.notes, setup=phases)
    result["checks"] = checks
    return result


def _power_limit() -> str:
    try:
        return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                               "--format=csv,noheader"], capture_output=True, text=True,
                              timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi not readable"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    # PyTorch's runtime-compiled kernels are cached at a fixed path inside
    # the checkout, so that only a checkout's first run compiles them
    os.environ["PYTORCH_KERNEL_CACHE_PATH"] = str(core.ROOT / "build" / "h100bench" / "torch_kernels")
    import torch

    bench = core.benchmark()
    chips = core.workload(bench, a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"h100bench: {a.workload} needs {chips} CUDA card(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found",
              file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace), bench=bench)
    found = core.forbidden_loaded()
    if found:
        print(f"h100bench: the run loaded {', '.join(found)}", file=sys.stderr)
        return 3
    print(f"card: {_power_limit()}", file=sys.stderr)
    print("run: " + json.dumps(result["notes"]), file=sys.stderr)
    for k, v in result["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
