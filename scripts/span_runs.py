"""Runs of an h100bench cell that read the program's spans
(``noize_tpu_torch.utils.tracking``), one run a process:

    python3 scripts/span_runs.py --workload live_2048 --seed 7 --seconds 51 --trace 1
    python3 scripts/span_runs.py --workload live_2048 --seed 7 --seconds 51 [--enable]

With ``--trace 1`` the run is the benchmark's traced run; the line adds the
device's idle gaps by the innermost span holding each one's middle
(``h100bench.spans.idle_by_span``, "no span" the remainder), the share of
the idle time inside some span, and the store's span and drop counts.
Without it the run measures the end-to-end metrics, with spans recorded
throughout when ``--enable`` calls ``tracking.enable()`` first (what
tracing costs when it is on).  Prints the card and its power limit, then
one JSON line.  Needs a CUDA card.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))


def main(argv=None) -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--enable", action="store_true")
    a = p.parse_args(argv)

    import torch

    from h100bench import run, spans, trace
    from noize_tpu_torch.utils import tracking

    if not torch.cuda.is_available():
        print("span_runs: needs a CUDA card", file=sys.stderr)
        return 2
    kept = []
    reduce = trace.Profiled.trace

    def keep(self, **kw):
        tr = reduce(self, **kw)
        kept.append(tr)
        return tr

    trace.Profiled.trace = keep
    if a.enable:
        tracking.enable()
    r = run.run_cell(a.workload, a.seed, a.seconds, bool(a.trace), t_start=T_START)
    out = {"workload": a.workload, "seed": a.seed, "trace": a.trace, "enable": a.enable,
           "correct": r["correct"], "failed": r["failed"],
           "metrics": {k: v["value"] for k, v in r["metrics"].items()},
           "device": r["device"], "notes": r["notes"],
           "spans_kept": len(tracking.spans()), "spans_dropped": tracking.dropped()}
    if kept:
        by = spans.idle_by_span(kept[-1])
        idle = sum(by.values())
        out["idle_ms_by_span"] = {k: v * 1e-3 for k, v in sorted(by.items(),
                                                                 key=lambda kv: -kv[1])}
        out["idle_in_spans_share"] = 1.0 - by.get("no span", 0.0) / idle if idle else None
        out["breakdown"] = r["breakdown"]
    print(f"card: {run._power_limit()}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
