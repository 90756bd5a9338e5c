#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``noize_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: requires CUDA; prints the card's name and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the CUDA kernels K1-K4 from ``noize_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card at the
   flagship's shapes (2048²), with CUDA-event times of both; the expected
   result is bit-equality (tolerance 0);
4. the flagship tile step at 2048² (13 octaves, blur ×17, flow ×8, three
   erosion cycles of 1000 particles, mesh) through
   ``make_tile_step(device="cuda")``: every kernel's launch count is reset
   before the run and must be non-zero after it; outputs must be finite;
5. the port on the card against the port on the CPU at the
   ``__graft_entry__.entry()`` configuration, same particles.

Prints the per-kernel JSON line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# K1-K3 must reproduce their plain versions bit for bit: both round every
# float32 op on its own, in the reference's order.
KERNEL_TOL = 0.0
# Port on the card vs port on the CPU: the particle math calls atan/sin,
# whose CUDA and CPU implementations differ by an ulp; BASELINE.md's bar.
CROSS_DEVICE_RTOL = 1e-4


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _time_ms(fn, reps):
    import torch

    fn()  # warm-up
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _max_abs(a, b):
    return float((a.double() - b.double()).abs().max())


def device_phase():
    import torch

    _check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"count {torch.cuda.device_count()})")
    print(f"nvidia-smi: {smi}")
    # no TF32 anywhere: the plain versions are the float32 references
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase():
    from noize_tpu_torch import _cuda

    t0 = time.perf_counter()
    path = _cuda.build()
    _cuda.library()
    print(f"build: {path.relative_to(HERE)} in {time.perf_counter() - t0:.1f} s")


def kernel_phase():
    """Each kernel against its plain version at the flagship's shapes."""
    import torch

    from noize_tpu_torch.app.flagship import default_meta, default_settings
    from noize_tpu_torch.erosion import pool as PO
    from noize_tpu_torch.erosion.pool_cuda import pool_automata_cuda
    from noize_tpu_torch.ops import flow as FL
    from noize_tpu_torch.ops import thermal as TH
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.stencil import separable_chain, separable_chain_plain
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.ops.kernels import gaussian_taps

    dev = torch.device("cuda")
    meta, settings = default_meta(), default_settings()
    res = meta.generator_res
    hw_ratio = float(meta.tile_size) / float(meta.height)
    noise = fractal(res, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                    noise_size=1700.0, device=dev)
    taps = gaussian_taps(1.0, 5)
    blurred = separable_chain_plain(noise, taps, 17)
    rows = []

    def compare(name, source, replaces, kernel, plain, reps):
        got, want = kernel(), plain()
        torch.cuda.synchronize()
        err = max(_max_abs(g, w) for g, w in zip(got, want))
        ms = _time_ms(kernel, reps)
        plain_ms = _time_ms(plain, max(1, reps // 3))
        print(f"{name}: max_abs_err {err!r} (tol {KERNEL_TOL}), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
        _check(err <= KERNEL_TOL, f"{name} disagrees with its plain version: {err}")
        rows.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "max_abs_err": err, "ms": ms,
                     "plain_ms": plain_ms})
        return got

    compare("K1 separable_chain", "noize_tpu_torch/csrc/stencil.cu",
            "noize_tpu/ops/pallas/stencil.py:153",
            lambda: (separable_chain(noise, taps, 17),),
            lambda: (separable_chain_plain(noise, taps, 17),), 20)
    compare("K2 flow_map_fused", "noize_tpu_torch/csrc/flow.cu",
            "noize_tpu/ops/pallas/flow_pl.py:99",
            lambda: (flow_map_fused(blurred, 8),),
            lambda: (FL.flow_map(blurred, 8),), 20)
    compare("K3 thermal_erosion_fused", "noize_tpu_torch/csrc/thermal.cu",
            "noize_tpu/ops/pallas/thermal_pl.py:36",
            lambda: (thermal_erosion_fused(blurred, settings.TALUS, settings.THERMAL_STEP,
                                           hw_ratio, settings.THERMAL_CYCLES),),
            lambda: (TH.thermal_erosion(blurred, settings.TALUS, settings.THERMAL_STEP,
                                        hw_ratio, settings.THERMAL_CYCLES),), 20)

    # K4 on a wet grid: pool seeded above MIN_WATER on the blurred-noise
    # height, with dry cells between so drains fire
    g = torch.Generator(device=dev).manual_seed(0)
    seed = torch.rand((res, res), generator=g, device=dev)
    pool = torch.where(seed < 0.5, seed * 0.02, torch.zeros_like(seed))
    (wet_pool, wet_drains) = compare(
        "K4 pool_automata_cuda", "noize_tpu_torch/csrc/pool.cu",
        "noize_tpu/erosion/pool_pallas.py:568",
        lambda: pool_automata_cuda(blurred, pool, settings.WATER_STEPS, True),
        lambda: PO.pool_automata(blurred, pool, settings.WATER_STEPS, True), 10)
    n_drain = int((wet_drains > 0).sum())
    n_moved = int((wet_pool != pool).sum())
    print(f"K4 wet grid: {n_moved} cells changed, {n_drain} drain cells, "
          f"{int((pool >= PO.MIN_WATER).sum())} cells at the gate")
    _check(n_drain > 0 and n_moved > 0, "K4 wet grid ran no phase")
    # dry: the gate must return the pool unchanged and no drains
    dry = pool * (PO.MIN_WATER * 0.99 / float(pool.max()))
    wet_before = int(pool_automata_cuda.wet_calls.item())
    dp, dd = pool_automata_cuda(blurred, dry, settings.WATER_STEPS, True)
    torch.cuda.synchronize()
    _check(torch.equal(dp, dry) and not bool(dd.any()), "K4 dry gate is not a fixed point")
    _check(int(pool_automata_cuda.wet_calls.item()) == wet_before, "K4 dry gate flag raised")
    print("K4 dry grid: pool unchanged, drains zero, gate closed")
    del noise, blurred, pool, dry, wet_pool, wet_drains
    return rows


def flagship_phase(rows, steps=3):
    """The main path: the 2048² flagship through make_tile_step."""
    import torch

    from noize_tpu_torch.app.flagship import default_settings, make_tile_step
    from noize_tpu_torch.erosion.pool_cuda import pool_automata_cuda
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.stencil import separable_chain
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused

    settings = default_settings()
    step, meta, _ = make_tile_step(None, settings, device="cuda",
                                   erosion_cycles=settings.CYCLES)
    wrappers = {"K1 separable_chain": separable_chain,
                "K2 flow_map_fused": flow_map_fused,
                "K3 thermal_erosion_fused": thermal_erosion_fused,
                "K4 pool_automata_cuda": pool_automata_cuda}
    for w in wrappers.values():
        w.launches = 0
    pool_automata_cuda.wet_calls = None
    gen = torch.Generator(device="cuda").manual_seed(0)
    times = []
    for i in range(steps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(float(i * 100), 0.0, generator=gen)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = {name: w.launches for name, w in wrappers.items()}
    wet = int(pool_automata_cuda.wet_calls.item())
    res, r = meta.generator_res, meta.tile_res
    for k in ("height", "pool", "stream", "flow_velocity"):
        _check(tuple(out[k].shape) == (res, res), f"{k} shape {tuple(out[k].shape)}")
        _check(bool(torch.isfinite(out[k]).all()), f"{k} not finite")
    m = out["mesh"]
    _check(tuple(m.positions.shape) == ((r + 1) ** 2, 3), "mesh positions shape")
    _check(tuple(m.indices.shape) == (6 * r * r,), "mesh indices shape")
    for f in ("positions", "normals", "tangents", "uvs"):
        _check(bool(torch.isfinite(getattr(m, f)).all()), f"mesh {f} not finite")
    _check(float(out["stream"].abs().max()) > 0, "erosion left no stream")
    for name, n in counts.items():
        _check(n > 0, f"{name} was not launched on the main path")
    timed = times[1:]
    print(f"flagship 2048² (3 cycles, mesh): warm-up {times[0]:.1f} ms, steps "
          f"{[round(t, 3) for t in timed]} ms, median {sorted(timed)[len(timed) // 2]:.3f} ms/step")
    print(f"flagship launches {counts}; K4 gate open in {wet} of "
          f"{counts['K4 pool_automata_cuda']} calls; host syncs per step "
          f"{len(step.syncs)} ({', '.join(sorted(set(step.syncs)))})")
    for row in rows:
        row["launches"] = counts[row["name"]]
    return timed


def cross_device_phase():
    """Port on the card against the port on the CPU, entry() configuration."""
    import dataclasses

    import torch

    from noize_tpu_torch.app.flagship import default_meta, default_settings, make_tile_step
    from noize_tpu_torch.erosion.particles import spawn

    # __graft_entry__.entry(): a 240² tile with an 8-cell margin on a 256²
    # generator grid, 256 particles of age ≤ 16, 4 water steps
    meta = default_meta(generator_res=256, margin=8)
    settings = dataclasses.replace(default_settings(), PARTICLES_PER_CYCLE=256, MAXAGE=16,
                                   WATER_STEPS=4, CYCLES=1, PILING_RADIUS=8)
    kw = dict(octaves=8, blur_iterations=5, flow_iterations=4, erosion_cycles=1)
    fresh = spawn(torch.Generator().manual_seed(0), 256, meta.generator_res)
    outs = {}
    for dev in ("cpu", "cuda"):
        step, _, _ = make_tile_step(meta, settings, device=dev, **kw)
        parts = type(fresh)(*(t.to(dev) for t in fresh))
        outs[dev] = step(0.0, 0.0, fresh=[parts])
    torch.cuda.synchronize()
    gaps = {}
    for k in ("height", "pool", "stream", "flow_velocity"):
        a, b = outs["cuda"][k].cpu(), outs["cpu"][k]
        gaps[k] = _max_abs(a, b) / max(float(b.abs().max()), 1e-30)
    for f in ("positions", "tangents", "uvs"):
        a, b = getattr(outs["cuda"]["mesh"], f).cpu(), getattr(outs["cpu"]["mesh"], f)
        gaps[f"mesh.{f}"] = _max_abs(a, b) / max(float(b.abs().max()), 1e-30)
    print("card vs cpu (entry config), max gap relative to scale: "
          + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
    for k, v in gaps.items():
        _check(v <= CROSS_DEVICE_RTOL, f"card vs cpu {k} gap {v} > {CROSS_DEVICE_RTOL}")
    _check(torch.equal(outs["cuda"]["mesh"].indices.cpu(), outs["cpu"]["mesh"].indices),
           "mesh indices differ")


def main():
    import torch

    sys.path.insert(0, HERE)
    name = device_phase()
    build_phase()
    rows = kernel_phase()
    flagship_phase(rows)
    cross_device_phase()
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
