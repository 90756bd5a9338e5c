#!/usr/bin/env python3
"""K1's filter calls (noize_tpu_torch/csrc/stencil.cu) and the paths around
them, on one NVIDIA GPU, for this tree or another checkout.

    python3 scripts/k1_filters.py [--root CHECKOUT] [--reps N] [--steps]

``--root`` names the checkout whose ``noize_tpu_torch`` is timed (default:
this one), so that two trees can be read by the same script in one run.
At 2048² on 13-octave blurred noise (``chip_smoke._inputs``):

- one row a call: each non-Gauss KernelFilterStage filter at one
  iteration through ``kernels.kernel_filter`` (Sobel3_2D included), the
  BasicDemo presets' Gauss9_S1 ×2 and Gauss3_S1 ×3, ``edge.edge_2d`` with
  Sobel's and Prewitt's taps, and row #2 of PERF.md, the flagship's
  Gauss-5 ×17 (``gauss_chain``).  Each is held bit-equal to its plain
  version (the series through ``separable_chain_plain``, the magnitudes
  through ``filters.root_sum_squares_tiles``), then read: ms a call by
  CUDA events (``--reps`` calls back to back, two rounds), its device
  operations and their µs a call (``torch.profiler``), the host µs to
  enqueue a call (no sync between calls), the same chain as cuDNN
  ``conv2d`` calls with replicate padding, and the bound (8 bytes a cell
  at 3.35e12 B/s, or the float32 operations at 33.5e12 a second);
- the ``Sobel`` and ``PerlinGenerator`` presets through ``Pipeline.run``
  and ``compose.fuse``, ms a run (five each), with the K1 launches of a run
  by the tree's own counters;
- with ``--steps``, the flagship step, the Quickstart ``ErosionSim.step()``
  and config 5's ``tile_batch`` (ms a tile), three runs each after a
  warm-up.

Prints the card's name and power limit first, then one line a reading.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 132 * 128 * 1.98e9


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


def host_us(fn, calls=50):
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def device_ops(fn, reps=20):
    """(name, device µs a call, calls a call) of each device operation."""
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


def wall_ms(fn, runs):
    import torch

    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(runs):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(round((time.perf_counter() - t0) * 1e3, 3))
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--steps", action="store_true")
    a = ap.parse_args()
    sys.path.insert(0, os.path.abspath(a.root))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("k1_filters: needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    import chip_smoke as CS
    from noize_tpu_torch.app import presets
    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.ops import edge as ED
    from noize_tpu_torch.ops import kernels as KE
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.filters import root_sum_squares_tiles
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.pipeline.compose import fuse
    from noize_tpu_torch.pipeline.driver import Pipeline

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    print(f"noize_tpu_torch from {os.path.dirname(os.path.dirname(KE.__file__))}")
    _, x, _ = CS._inputs(2048)
    cells = x.numel()
    pairs = {"SOBEL": [(KE._SOBEL3_HX, KE._SOBEL3_HZ), (KE._SOBEL3_VX, KE._SOBEL3_VZ)],
             "PREWITT": [(KE._PREWITT3_HX, KE._PREWITT3_HZ),
                         (KE._PREWITT3_VX, KE._PREWITT3_VZ)]}
    g5 = KE.gaussian_taps(1.0, 5)
    cases = [(f"{n} x1", n, 1) for n in CS.FILTERS]
    cases += [(f"{g} x{m}", g, m) for g, m in (("Gauss9_S1", 2), ("Gauss3_S1", 3))]
    cases += [("edge_2d SOBEL", "SOBEL", 1), ("edge_2d PREWITT", "PREWITT", 1),
              ("#2 Gauss-5 x17", "g5", 17)]
    for label, name, iters in cases:
        if name in ("Sobel3_2D", "SOBEL", "PREWITT"):
            pair = pairs["SOBEL" if name == "Sobel3_2D" else name]
            fn = ((lambda: KE.kernel_filter(x, "Sobel3_2D", 1)) if name == "Sobel3_2D"
                  else (lambda name=name: ED.edge_2d(x, name)))
            plain = lambda pair=pair: root_sum_squares_tiles(*(  # noqa: E731
                SC.separable_chain_plain(x, tx, 1, taps_z=tz) for tx, tz in pair))
            convs = [CS._conv_chain(tx, 1, tz) for tx, tz in pair]
            conv = lambda convs=convs: torch.sqrt(sum(c(x) ** 2 for c in convs))  # noqa: E731
            ops = 2 * 2 * 2 * 3 * cells + 4 * cells
        else:
            tx, tz, f = (g5, g5, 1.0) if name == "g5" else KE._SERIES_TABLE[name]
            fn = ((lambda: SC.gauss_chain(x, 5, 1.0, 17)) if name == "g5"
                  else (lambda name=name, iters=iters: KE.kernel_filter(x, name, iters)))
            plain = lambda tx=tx, tz=tz, f=f, iters=iters: (  # noqa: E731
                SC.separable_chain_plain(x, tx, iters, taps_z=tz, factor=f))
            conv = CS._conv_chain(tx, iters, tz, f)
            conv = (lambda conv=conv: conv(x))
            ops = iters * 2 * (2 * len(tx) + (f != 1.0)) * cells
        if not torch.equal(fn(), plain()):
            raise RuntimeError(f"k1_filters: {label} differs from its plain version")
        ms = [time_ms(fn, a.reps) for _ in range(2)]
        conv_ms = time_ms(conv, a.reps)
        dev = device_ops(fn)
        bound = max(8 * cells / PEAK_BYTES_PER_S, ops / PEAK_F32_OPS_PER_S) * 1e3
        print(f"{label}: bit-equal; {ms[0]:.4f}, {ms[1]:.4f} ms a call (CUDA events); device "
              f"{sum(t for _, t, _ in dev):.1f} µs in {sum(n for _, _, n in dev):g} operations ("
              + "; ".join(f"{k[:36]} {t:.1f} ×{n:g}" for k, t, n in dev)
              + f"); host enqueue {host_us(fn):.1f} µs a call; conv2d {conv_ms:.4f} ms; "
              f"bound {bound:.4f} ms")
    del x

    counters = [c for c in ("separable_chain", "tile_chain", "short_chain",
                            "root_sum_squares_chain") if hasattr(SC, c)]
    for n in ("Sobel", "PerlinGenerator"):
        stages = presets.ALL[n].stages
        data = (fractal(2048, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                        noise_size=1700.0, device="cuda") if n == "Sobel" else None)
        pipe, fused = Pipeline(list(stages)), fuse(stages, 2048)
        req = GeneratorData(uuid=n, resolution=2048, data=data)
        before = {c: getattr(SC, c).launches for c in counters}
        pipe.run(req)
        torch.cuda.synchronize()
        launches = {c: getattr(SC, c).launches - before[c] for c in counters}
        run_ms = wall_ms(lambda: pipe.run(req), 5)
        fuse_ms = wall_ms(lambda: fused(data, 0, 0), 5)
        print(f"preset {n} 2048²: run {run_ms} ms, fuse {fuse_ms} ms; K1 launches a run "
              f"{launches}")

    if not a.steps:
        return
    from noize_tpu_torch.app.flagship import default_settings, make_tile_step
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.parallel import tiled as TL
    from noize_tpu_torch.prng import PRNGKey, fold_in

    settings = default_settings()
    step, _, _ = make_tile_step(None, settings, device="cuda", erosion_cycles=settings.CYCLES)
    key, i = PRNGKey(0, device="cuda"), [0]

    def flagship():
        i[0] += 1
        step(float(i[0] * 100), 0.0, fold_in(key, i[0]))
    print(f"flagship step 2048²: {wall_ms(flagship, 3)} ms")
    sim = ErosionSim(CS._quickstart_heights())
    print(f"Quickstart ErosionSim.step() 2048²: {wall_ms(sim.step, 3)} ms")
    cfg, origins = CS.config5()
    tiles = [round(t / len(origins), 3) for t in wall_ms(lambda: TL.tile_batch(cfg, origins), 3)]
    print(f"config 5 tile_batch, 16 tiles of 1024²: {tiles} ms a tile")


if __name__ == "__main__":
    main()
