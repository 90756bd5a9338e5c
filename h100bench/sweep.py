"""The highest rate a serving cell sustains, found once by a sweep on the
chip (the cell's traffic file then records 4/5 of it as its fixed rate):

    python3 -m h100bench.sweep --workload serve_1024 --rates 20,30,40 --seconds 10 --seed 1

One set-up, then one window of the cell's traffic at each rate, each
printed as a JSON line: the 95th percentile, the median, the 95th
percentiles of the first and second half of the orders (a backlog that
grows through the window shows as the second above the first) and the
tiles completed a second.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys

from . import core


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m h100bench.sweep")
    p.add_argument("--workload", required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--slow-ms", type=float, default=0.0,
                   help="also print each order slower than this: due s, ms, tile")
    a = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("h100bench.sweep: no CUDA card", file=sys.stderr)
        return 2
    wl = core.workload(core.benchmark(), a.workload)
    config, traffic = core.config(wl["config"]), core.traffic(wl["traffic"])
    entry = core.entry(traffic["entry"])(config, traffic, a.seed, "cuda")
    entry.warm()
    drive = core.driver(traffic["driver"])
    for rate in (float(r) for r in a.rates.split(",")):
        win = drive.run(entry, dict(traffic, rate=rate), a.seed, a.seconds, False)
        print(json.dumps(dict(rate=rate, failed=win.failed, **win.metrics, **win.notes)),
              flush=True)
        if a.slow_ms:
            print(json.dumps({"slow": [[round(d, 3), round(x), p] for d, x, p in win.detail
                                       if x > a.slow_ms]}), flush=True)
    entry.finish()
    return 0


if __name__ == "__main__":
    sys.exit(main())
