#!/usr/bin/env python3
"""Design readings of K7 (noize_tpu_torch/csrc/descent.cu) and K9
(csrc/scatter.cu) on one NVIDIA GPU.

    python3 scripts/descent_sweep.py [--reps N]

K7: builds one copy of ``descent.cu`` per (threads a block, prefetch) into
``build/descent_sweep/``, with those lines of the source rewritten (the
production source has no build options), one nvcc each, all started
together; the first is the production source unchanged.  "prefetch 0"
reloads each step's 5x5 records and waits for them, so the step's
arithmetic no longer overlaps its loads (128 threads without it is the
earlier design's block and wait, on the record table).  On the
Quickstart's state (the README pipeline at 2048², one ``ErosionSim.step()``,
then the next cycle's 1000 particles, MAXAGE 100, 104 steps) and on
config 5's tile 0 (1024², 250 particles, MAXAGE 32), it holds every copy's
K7 bit-equal to the plain version and times each with CUDA events in two
rounds (copies in order, then in reverse).

K9: on the Quickstart descent's events, the scatter into zeros (dead
slots' zero events skipped) against the same scatter into given zero maps
(nothing skipped), ``torch.sort`` of the keys alone (the library sort K9
once called), and the three ``index_put_`` calls K9 replaced, by CUDA
events; then the device time and the launches a call of each of K9's
device operations (and of K7's) under ``torch.profiler``.

Prints the card's name and power limit first, then one line a reading.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

# (threads a block, prefetch); the first is the production source
VARIANTS = [(32, 1), (16, 1), (64, 1), (128, 1), (32, 0), (128, 0)]
ENTRIES = ("noize_descent", "noize_descent_records")
# the lines a variant rewrites
THREADS_LINE = "constexpr int kThreads = 32;"
RELOAD_LINE = "const bool reload = da < -1 || da > 1 || db < -1 || db > 1;"


def variant_source(src: str, threads: int, prefetch: int) -> str:
    """``descent.cu`` with its block size replaced and, without the
    prefetch, every step reloading its 5x5 and waiting."""
    edits = [(THREADS_LINE, f"constexpr int kThreads = {threads};")]
    if not prefetch:
        edits.append((RELOAD_LINE, "const bool reload = true;"))
    for old, new in edits:
        if src.count(old) != 1:
            raise RuntimeError(f"descent.cu: expected one {old!r}")
        src = src.replace(old, new)
    return src


def build(variants):
    from noize_tpu_torch import _cuda

    out = os.path.join(ROOT, "build", "descent_sweep")
    os.makedirs(out, exist_ok=True)
    src = (_cuda.CSRC / "descent.cu").read_text()
    libs, cmds = [], []
    for threads, prefetch in variants:
        stem = os.path.join(out, f"descent_t{threads}_p{prefetch}")
        with open(stem + ".cu", "w") as fh:
            fh.write(variant_source(src, threads, prefetch))
        libs.append(stem + ".so")
        cmds.append([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v",
                     "-shared", "-o", stem + ".so", stem + ".cu"])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    loaded = []
    for v, cmd, proc, lib in zip(variants, cmds, procs, libs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        lines = err.splitlines()
        at = next(i for i, ln in enumerate(lines) if "descentEPK6float4" in ln)
        used = next(ln.strip() for ln in lines[at:] if "Used" in ln)
        print(f"K7 threads {v[0]}, prefetch {v[1]}: ptxas {used}")
        handle = ctypes.CDLL(lib)
        for name in ENTRIES:
            fn = getattr(handle, name)
            fn.argtypes = list(_cuda.SIGNATURES[name])
            fn.restype = ctypes.c_int
        loaded.append(handle)
    return loaded


def cases():
    """(label, world, particles, params, height scale, patch res, res)."""
    import torch

    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.erosion import sim as SIM
    from noize_tpu_torch.erosion.world import WorldState
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import FlowMapStage, NoiseStage, StageGaussianBlur
    from noize_tpu_torch import prng

    pipe = Pipeline([NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
                     StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
                     FlowMapStage(iterations=8)])
    height = pipe.run(GeneratorData(uuid="t00", resolution=2048, xpos=0, zpos=0)).data
    sim = SIM.ErosionSim(height)
    sim.step()
    st, meta = sim.state, sim.meta
    n, res = sim.settings.PARTICLES_PER_CYCLE, meta.generator_res
    parts, left, _ = SIM._spawn_with_drains(st.key, n, res, st.drain_water)
    world = dataclasses.replace(st.world, pool=st.world.pool + left)
    out = [("Quickstart", world, parts, sim.settings.as_parameters(), float(meta.height),
            meta.patch_res, res)]
    from chip_smoke import _stack_inputs, config5

    cfg, origins = config5()
    _, blurred = _stack_inputs()
    x, z = origins[0].tolist()
    key5 = prng.fold_in(prng.fold_in(prng.PRNGKey(0, device="cuda"), x), z)
    world5 = WorldState.create(blurred[0].contiguous())
    parts5, _, _ = SIM._spawn_with_drains(key5, cfg.erosion.PARTICLES_PER_CYCLE,
                                          cfg.meta.generator_res,
                                          torch.zeros_like(world5.height))
    out.append(("config 5", world5, parts5, cfg.erosion.as_parameters(),
                float(cfg.meta.height), cfg.meta.patch_res, cfg.meta.generator_res))
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


def device_us(fn, reps=10):
    """(device µs, launches) a call of each device operation ``fn`` runs,
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
    return {e.key: (e.self_device_time_total / reps, e.count / reps)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0}


def show(what, times):
    total = sum(t for t, _ in times.values())
    ops = sum(n for _, n in times.values())
    print(f"{what}: device {total:.1f} µs in {ops:g} device operations a call: " + "; ".join(
        f"{k[:50]} {t:.1f} ×{n:g}" for k, (t, n) in sorted(times.items(),
                                                         key=lambda kv: -kv[1][0])))


def same(a, b):
    import torch

    raw = (lambda t: t.view(torch.int32) if t.dtype == torch.float32 else t)  # noqa: E731
    return all(torch.equal(raw(x), raw(y)) for x, y in zip(a, b))


def main():
    import torch

    from noize_tpu_torch import _cuda
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion import scatter_cuda as SCU

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps
    if not torch.cuda.is_available():
        raise SystemExit("descent_sweep: needs a CUDA device")
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True).stdout.strip())
    _cuda.library()
    libs = build(VARIANTS)
    production = _cuda._LIB
    for label, world, parts, params, hs, pr, res in cases():
        steps = 8 * -(-(params.MAXAGE + 1) // 8)
        args = (params, hs, pr, res, steps)
        table = DC.descent_table(world, params, hs)
        want = PA.descend_steps_plain(parts, PA.step_maps(world, params, hs), *args)
        want = tuple(want[0]) + tuple(want[1:])
        times = {v: [] for v in VARIANTS}
        try:
            for order in (VARIANTS, VARIANTS[::-1]):
                for v in order:
                    _cuda._LIB = libs[VARIANTS.index(v)]
                    got = DC.descend_steps(parts, table, *args)
                    torch.cuda.synchronize()
                    if not same(tuple(got[0]) + tuple(got[1:]), want):
                        raise RuntimeError(f"K7 {v} ({label}) differs from its plain version")
                    times[v].append(time_ms(lambda: DC.descend_steps(parts, table, *args), reps))
        finally:
            _cuda._LIB = production
        for (threads, prefetch), t in times.items():
            print(f"K7 {label}, {parts.row.numel()} particles, {steps} steps: threads "
                  f"{threads}, prefetch {prefetch}: {t[0]:.4f} and {t[1]:.4f} ms "
                  f"({min(t) / steps * 1e3:.3f} µs a step), bit-equal")
        if label != "Quickstart":
            continue
        _, cells, *deltas = DC.descend_steps(parts, table, *args)
        size = res * res
        fresh = PA.scatter_events(cells, deltas, size)
        given = SCU.scatter_in_order(cells, deltas, size, [torch.zeros(size, device="cuda")
                                                           for _ in deltas])
        if not same(fresh, given):
            raise RuntimeError("K9 with and without skipping zeros differ")
        live = int(torch.stack([d != 0 for d in deltas]).any(0).sum())
        keys = cells.to(torch.int32)
        t_fresh = time_ms(lambda: PA.scatter_events(cells, deltas, size), reps)
        t_given = time_ms(lambda: SCU.scatter_in_order(
            cells, deltas, size, [torch.zeros(size, device="cuda") for _ in deltas]), reps)
        t_sort = time_ms(lambda: torch.sort(keys, stable=True), reps)
        t_put = time_ms(lambda: [torch.zeros(size, device="cuda").index_put_(
            (cells,), d, accumulate=True) for d in deltas], reps)
        print(f"K9 {label}, {cells.numel()} events ({live} with a nonzero delta): zero events "
              f"skipped {t_fresh:.4f} ms, none skipped {t_given:.4f} ms (same bits); the stable "
              f"torch.sort of {cells.numel()} int32 keys alone {t_sort:.4f} ms; three index_put_ "
              f"{t_put:.4f} ms")
        show("K9 zero events skipped", device_us(lambda: PA.scatter_events(cells, deltas, size)))
        show("K9 none skipped", device_us(lambda: SCU.scatter_in_order(
            cells, deltas, size, [torch.zeros(size, device="cuda") for _ in deltas])))
        show("three index_put_", device_us(lambda: [torch.zeros(size, device="cuda").index_put_(
            (cells,), d, accumulate=True) for d in deltas]))
        show("K7 (production)", device_us(lambda: DC.descend_steps(parts, table, *args)))
        show("descend_all", device_us(lambda: PA.descend_all(parts, world, params, hs, pr, res)))


if __name__ == "__main__":
    main()
