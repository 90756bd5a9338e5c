#!/usr/bin/env python3
"""K9, the in-order event scatter (noize_tpu_torch/csrc/scatter.cu), at the
shapes its callers give it, on one NVIDIA GPU.

    python3 scripts/k9_shapes.py [--root CHECKOUT] [--reps N] [--digit-bits B]

``--root`` names the checkout whose ``noize_tpu_torch`` is timed (default:
this one), so that two trees can be read by the same script in one run.
``--digit-bits`` sorts every call in passes of at most B bits, in place of
``scatter_cuda.sort_plan``'s choice (11, or 8 past 128 tiles): the reading
behind that choice.
The events are made from a seed with NumPy:

- the descent's: 104,000 events on 2048² (1000 particles × 104 steps),
  60% of them all-zero (dead particles), three maps, into fresh zeros;
- the vegetation's centre stamps: 65,536 plants on 2048², one map, into
  fresh zeros;
- the vegetation's neighbour stamps: the same plants' 8 neighbours each,
  524,288 events into one given map (``vegetation.splat_density``).

Each case is held bit-equal to the CPU's ``particles.scatter_events``, then
timed by CUDA events (``--reps`` calls, two rounds) and profiled: the
device operations a call and their µs.  Prints the card's name and power
limit first, then one line a case.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys

import numpy as np

RES = 2048


def cases(rng):
    """(label, cells i64, deltas [f32], given map or None)."""
    size = RES * RES
    n = 104_000
    cells = rng.integers(0, size, n)
    vals = rng.normal(0, 1, (3, n)).astype(np.float32)
    vals[:, rng.uniform(0, 1, n) < 0.6] = 0.0
    out = [("descent", cells, list(vals), None)]
    row, col = rng.integers(0, RES, 65_536), rng.integers(0, RES, 65_536)
    mag = rng.uniform(0.2, 1.0, 65_536).astype(np.float32)
    out.append(("centre stamps", row * RES + col, [mag], None))
    cells, values = [], []
    for w, offs in ((0.6, ((1, 0), (0, 1), (-1, 0), (0, -1))),
                    (0.4, ((1, 1), (-1, 1), (1, -1), (-1, -1)))):
        for dr, dc in offs:
            cells.append(np.clip(row + dr, 0, RES - 1) * RES + np.clip(col + dc, 0, RES - 1))
            values.append(mag * np.float32(w))
    base = rng.uniform(0, 1, size).astype(np.float32)
    out.append(("neighbour stamps", np.concatenate(cells), [np.concatenate(values)], base))
    return out


def time_ms(fn, reps):
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


def device_ops(fn, reps=10):
    """(name, device µs, count) a call of each device operation ``fn`` runs,
    under ``torch.profiler``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    return [(e.key, e.self_device_time_total / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--digit-bits", type=int, default=None)
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion import scatter_cuda as SCU

    if a.digit_bits:
        SCU.DIGIT_BITS = SCU.MANY_TILES_DIGIT_BITS = a.digit_bits
    if not torch.cuda.is_available():
        raise SystemExit("k9_shapes: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"noize_tpu_torch from {os.path.dirname(os.path.dirname(PA.__file__))}")
    for label, cells, vals, base in cases(np.random.default_rng(13)):
        c = torch.from_numpy(cells.astype(np.int64))
        v = [torch.from_numpy(np.ascontiguousarray(x)) for x in vals]
        size = RES * RES
        acc = None if base is None else [torch.from_numpy(base)]
        want = PA.scatter_events(c, v, size, None if acc is None else [acc[0].clone()])
        cc, vc = c.cuda(), [x.cuda() for x in v]
        accc = None if acc is None else [acc[0].cuda()]
        got = PA.scatter_events(cc, vc, size, None if accc is None else [accc[0].clone()])
        for g, w in zip(got, want):
            if not torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)):
                raise RuntimeError(f"K9 {label}: differs from the CPU's scatter_events")
        fn = (lambda: PA.scatter_events(cc, vc, size)) if accc is None \
            else (lambda: PA.scatter_events(cc, vc, size, accc))
        ms = [time_ms(fn, a.reps) for _ in range(2)]
        ops = device_ops(fn)
        plan = SCU.sort_plan(size, c.numel()) if hasattr(SCU, "sort_plan") else None
        print(f"K9 {label}: {c.numel()} events, {len(v)} map(s), "
              + ("" if plan is None else f"{plan[1]} passes of {plan[2]} bits, ") +
              f"{'fresh' if accc is None else 'given'}, bit-equal to the CPU; "
              f"{ms[0]:.4f}, {ms[1]:.4f} ms a call (CUDA events, {a.reps} calls); device "
              f"{sum(t for _, t, _ in ops):.1f} µs in {sum(n for _, _, n in ops):g} operations: "
              + "; ".join(f"{k[:40]} {t:.1f} ×{n:g}" for k, t, n in ops))


if __name__ == "__main__":
    main()
