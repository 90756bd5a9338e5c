#!/usr/bin/env python3
"""Measurements and sweeps behind the design of K3 (``csrc/thermal.cu``) on
one NVIDIA GPU.

    python3 scripts/thermal_sweep.py [--reps N] [--json PATH]

1. The design K3 replaced (a device-to-device copy of the map, then one
   launch a phase updating 2x2 blocks in place), as a copy built here.  At
   2048² and 1025² on blurred noise: one phase launch, the copy alone and
   a whole call (m = 1) by CUDA events, the call's device time under
   ``torch.profiler``, and the host time to enqueue one call through the
   replaced wrapper (with and without its ``max_diff_value`` call) and
   through the current one.  They say how much of the replaced call was
   bytes, launches and host.
2. K3 along other plans (tile, threads, iterations a launch: runtime
   arguments of ``noize_thermal_erosion``) at 2048² and 1025² (m = 1) and
   for 32 iterations at 2048², and copies of ``thermal.cu`` (``VARIANTS``):
   the window loaded by plain loads and stores instead of cp.async, two
   anchors a loop trip, and the launch with no phase (loads and stores
   alone).

Every variant of 2 but the last is held against the plain version
(tolerance 0) and
timed with CUDA events in two rounds (in order, then in reverse), calling
the C entry directly.  Prints the card's name and power limit, one line
per reading, and the same as one JSON line, also written to ``PATH`` with
``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# The replaced design: a copy, then 4 * iterations launches of one thread a
# 2x2 anchor; sweep_old(which): 0 one phase (x0 = 1, z0 = 2) in place on
# `out`, 1 the copy alone, 2 the whole call.
OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include "common.cuh"
using namespace noize;

__device__ __forceinline__ void rectify(float& v1, float& v2, float max_diff, float inc) {
  const float diff = fabsf(sub(v1, v2));
  const float excess = mul(relu(sub(diff, max_diff)), inc);
  const float delta = v1 > v2 ? -excess : excess;
  const float n1 = add(v1, delta);
  const float n2 = sub(v2, delta);
  v1 = n1;
  v2 = n2;
}

__global__ void thermal_phase(float* d, int res, int x0, int z0, int zmax, float max_diff,
                              float inc) {
  const int ax = x0 + 2 * (blockIdx.x * blockDim.x + threadIdx.x);
  const int az = z0 + 2 * (blockIdx.y * blockDim.y + threadIdx.y);
  if (ax >= res - 1 || az > zmax) return;
  float* r0 = d + (size_t)az * res + ax;
  float* r1 = r0 + res;
  float v0 = r0[0], v1 = r0[1], v2 = r1[0], v3 = r1[1];
  rectify(v0, v1, max_diff, inc);
  rectify(v0, v2, max_diff, inc);
  rectify(v0, v3, max_diff, inc);
  rectify(v1, v2, max_diff, inc);
  rectify(v1, v3, max_diff, inc);
  rectify(v2, v3, max_diff, inc);
  r0[0] = v0;
  r0[1] = v1;
  r1[0] = v2;
  r1[1] = v3;
}

extern "C" int sweep_old(int which, const float* in, float* data, int res, int iterations,
                         float max_diff, float increment, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const int offsets[4][2] = {{1, 2}, {2, 2}, {1, 1}, {2, 1}};
  const dim3 block(32, 8);
  const dim3 grid(((res + 1) / 2 + 31) / 32, ((res + 1) / 2 + 7) / 8);
  if (which != 0)
    cudaMemcpyAsync(data, in, sizeof(float) * (size_t)res * res, cudaMemcpyDeviceToDevice,
                    stream);
  const int phases = which == 0 ? 1 : which == 1 ? 0 : 4 * iterations;
  for (int p = 0; p < phases; ++p) {
    const int x0 = offsets[p % 4][0], z0 = offsets[p % 4][1];
    thermal_phase<<<grid, block, 0, stream>>>(data, res, x0, z0, z0 == 2 ? res - 2 : res - 3,
                                              max_diff, increment);
  }
  return static_cast<int>(cudaGetLastError());
}
"""

# K3 variants of part 2: (tile rows, tile cols, threads); the first is the
# production plan.
PLANS = [(128, 128, 512), (128, 128, 256), (128, 128, 1024), (64, 128, 256), (64, 128, 512),
         (32, 128, 256), (64, 64, 256), (128, 64, 256), (32, 256, 256), (64, 256, 512),
         (256, 128, 1024)]
PER_LAUNCH = [4, 1, 2, 3, 6, 8]
TALUS, INC, HW_RATIO = 55.0, 0.6, 1.0

# Copies of thermal.cu, as (old, new) line rewrites: the window loaded by
# plain loads and stores; two anchors a loop trip (both blocks loaded
# before either is computed); and, not held against the plain version, the
# launch with no phase (its loads and stores alone).
LOOP = """      for (Items it(nax); it.chunk < naz; it.next()) {
        float* a = first + it.chunk * down + it.line;
        float* b = a + right;
        float v0 = a[0], v1 = b[0], v2 = a[lay.pitch], v3 = b[lay.pitch];
        rectify_block(v0, v1, v2, v3, max_diff, inc);
        a[0] = v0;
        b[0] = v1;
        a[lay.pitch] = v2;
        b[lay.pitch] = v3;
      }"""
TWO_ANCHORS = """      for (Items it(nax); it.chunk < naz; it.next()) {
        Items nx = it;
        nx.next();
        const bool two = nx.chunk < naz;
        float* a = first + it.chunk * down + it.line;
        float* b = a + right;
        float* c = two ? first + nx.chunk * down + nx.line : a;
        float* d = c + right;
        float v0 = a[0], v1 = b[0], v2 = a[lay.pitch], v3 = b[lay.pitch];
        float w0 = c[0], w1 = d[0], w2 = c[lay.pitch], w3 = d[lay.pitch];
        rectify_block(v0, v1, v2, v3, max_diff, inc);
        rectify_block(w0, w1, w2, w3, max_diff, inc);
        if (two) {
          c[0] = w0;
          d[0] = w1;
          c[lay.pitch] = w2;
          d[lay.pitch] = w3;
        }
        a[0] = v0;
        b[0] = v1;
        a[lay.pitch] = v2;
        b[lay.pitch] = v3;
        it = nx;
      }"""
# build name: (rewrites, held against the plain version)
VARIANTS = {
    "plain_loads": ([("noize::copy_async(window + word(z, x), in + (size_t)z * res + x, true);",
                      "window[word(z, x)] = in[(size_t)z * res + x];")], True),
    "two_anchors": ([(LOOP, TWO_ANCHORS)], True),
    "no_phases": ([("for (int j = 0; j < 4 * m; ++j) {",
                    "for (int j = 4 * m; j < 4 * m; ++j) {")], False),
}


def rewrite(src: str, name: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: expected one {old!r}")
        src = src.replace(old, new)
    return src


def build():
    """The replaced design and the copies of thermal.cu, one nvcc each,
    started together; prints ptxas's register and spill lines."""
    from noize_tpu_torch import _cuda

    out = os.path.join(ROOT, "build", "thermal_sweep")
    os.makedirs(out, exist_ok=True)
    src = (_cuda.CSRC / "thermal.cu").read_text()
    sources = {"old": OLD_SOURCE}
    for name, (pairs, _) in VARIANTS.items():
        sources[name] = rewrite(src, "thermal.cu", *pairs)
    cmds = []
    for name, text in sources.items():
        path = os.path.join(out, f"{name}.cu")
        with open(path, "w") as fh:
            fh.write(text)
        cmds.append([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC), "-Xptxas", "-v",
                     "-shared", "-o", os.path.join(out, f"{name}.so"), path])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    libs = {}
    for name, cmd, proc in zip(sources, cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name} ptxas: {' | '.join(regs)}")
        libs[name] = ctypes.CDLL(os.path.join(out, f"{name}.so"))
    return libs


def device_ms(fn):
    """Device time of one call of ``fn`` (kernels and copies) under
    ``torch.profiler``: the last of three calls, delimited by marker
    kernels; None if the trace lost a marker."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    marker = torch.zeros(1, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            marker.add_(1.0)
            fn()
            torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    marks = [i for i, e in enumerate(events) if "elementwise" in e.name]
    if len(marks) < 2:
        return None, []
    last = events[marks[-1] + 1:]
    return sum(e.self_device_time_total for e in last) / 1e3, [e.name[:40] for e in last]


def host_us(fn, n=200):
    """Host time to enqueue one call of ``fn``, µs, mean of ``n`` calls
    (no synchronise between them)."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    us = (time.perf_counter() - t0) / n * 1e6
    torch.cuda.synchronize()
    return us


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import _inputs, _max_abs, _time_ms
    from noize_tpu_torch import _cuda
    from noize_tpu_torch.ops import thermal as TH
    from noize_tpu_torch.ops.cuda import thermal as TC

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("thermal_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    _cuda.library()
    libs = build()
    old = libs["old"].sweep_old
    old.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                    ctypes.c_float, ctypes.c_float, ctypes.c_void_p]
    old.restype = ctypes.c_int
    rows = []
    heights = {res: _inputs(res)[1] for res in (2048, 1025)}

    # 1. the replaced design
    for res, h in heights.items():
        stream = _cuda.stream(h)
        md = TH.max_diff_value(TALUS, HW_RATIO, res)
        want = TH.thermal_erosion(h, TALUS, INC, HW_RATIO, 1)
        scratch = torch.empty_like(h)

        def run_old(which, h=h, scratch=scratch, res=res, md=md, stream=stream):
            rc = old(which, h.data_ptr(), scratch.data_ptr(), res, 1, md, INC, stream)
            if rc:
                raise RuntimeError(f"sweep_old: CUDA error {rc}")
            return scratch
        err = _max_abs(run_old(2), want)
        if err != 0.0:
            raise RuntimeError(f"replaced design at {res}²: max_abs_err {err}")
        reading = {"part": 1, "res": res, "max_abs_err": err}
        for which, what in ((0, "phase"), (1, "copy"), (2, "call")):
            reading[f"{what}_ms"] = [_time_ms(lambda w=which: run_old(w), args.reps)
                                     for _ in range(2)]
        reading["call_device_ms"], reading["call_device_ops"] = device_ms(lambda: run_old(2))

        def old_wrapper(with_max_diff, h=h, res=res, md=md, stream=stream):
            # the replaced ops/cuda/thermal.thermal_erosion_fused, host side
            _cuda.check_map(h, "thermal_erosion_fused")
            m = TH.max_diff_value(TALUS, HW_RATIO, res) if with_max_diff else md
            out = torch.empty_like(h)
            with torch.cuda.device(h.device):
                rc = old(2, h.data_ptr(), out.data_ptr(), res, 1, m, INC, _cuda.stream(h))
            if rc:
                raise RuntimeError(f"sweep_old: CUDA error {rc}")
            return out
        reading["host_us_replaced"] = host_us(lambda: old_wrapper(True))
        reading["host_us_replaced_no_max_diff"] = host_us(lambda: old_wrapper(False))
        reading["host_us_current"] = host_us(
            lambda h=h: TC.thermal_erosion_fused(h, TALUS, INC, HW_RATIO, 1))
        print(f"replaced design {res}²: phase {reading['phase_ms']} ms, copy "
              f"{reading['copy_ms']} ms, call {reading['call_ms']} ms (CUDA events), call "
              f"{reading['call_device_ms']} ms device time in {len(reading['call_device_ops'])} "
              f"device ops; host enqueue {reading['host_us_replaced']:.2f} µs "
              f"({reading['host_us_replaced_no_max_diff']:.2f} without max_diff_value; current "
              f"wrapper {reading['host_us_current']:.2f})")
        rows.append(reading)
        del scratch, want

    # 2. K3 along other plans
    def entry(dll):
        fn = dll.noize_thermal_erosion
        fn.argtypes = list(_cuda.SIGNATURES["noize_thermal_erosion"])
        fn.restype = ctypes.c_int
        return fn
    builds = {"production": (entry(_cuda.library()), True)}
    builds.update({name: (entry(libs[name]), held) for name, (_, held) in VARIANTS.items()})
    cases = []
    for res, iters in ((2048, 1), (1025, 1), (2048, 32)):
        for build_name, (fn, held) in builds.items():
            # the production build along every plan, the copies on the first
            plans = PLANS if build_name == "production" and iters == 1 else PLANS[:1]
            pers = PER_LAUNCH if build_name == "production" and iters > 1 else PER_LAUNCH[:1]
            for tz, tx, n in plans:
                for per in pers:
                    cases.append((res, iters, build_name, tz, tx, n, per, held, fn))
    wants = {}
    for res, iters in ((2048, 1), (1025, 1), (2048, 32)):
        wants[(res, iters)] = TH.thermal_erosion(heights[res], TALUS, INC, HW_RATIO, iters)

    def runner(res, iters, tz, tx, n, per, fn):
        h = heights[res]
        plan = TC.thermal_plan(iters, per_launch=per, tile=(tz, tx), threads=n)
        md = TH.max_diff_value(TALUS, HW_RATIO, res)
        out, tmp = torch.empty_like(h), torch.empty_like(h)
        per_launch = np.asarray(plan.launches, np.int32)
        stream = _cuda.stream(h)

        def run():
            rc = fn(h.data_ptr(), out.data_ptr(), tmp.data_ptr(), res, per_launch.ctypes.data,
                    len(per_launch), tz, tx, n, md, INC, stream)
            if rc:
                raise RuntimeError(f"noize_thermal_erosion: CUDA error {rc}")
            return out
        return plan, run
    runs = [runner(res, iters, tz, tx, n, per, fn)
            for res, iters, _, tz, tx, n, per, _, fn in cases]
    times = {}
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            res, iters = cases[i][:2]
            plan, run = runs[i]
            err = _max_abs(run(), wants[(res, iters)])
            if cases[i][7] and err != 0.0:
                raise RuntimeError(f"K3 variant {cases[i][:7]}: max_abs_err {err}")
            times.setdefault(i, []).append(_time_ms(run, args.reps))
    for i, ms in sorted(times.items()):
        res, iters, build_name, tz, tx, n, per, held = cases[i][:8]
        plan = runs[i][0]
        print(f"K3 {res}² ×{iters} {build_name} tile {tz}x{tx} threads {n} launches "
              f"{plan.launches}: {ms[0]:.4f} / {ms[1]:.4f} ms"
              + (", bit-equal" if held else " (not held)"))
        rows.append({"part": 2, "res": res, "iterations": iters, "build": build_name,
                     "tile": [tz, tx], "threads": n, "launches": list(plan.launches),
                     "ms": ms, "max_abs_err": 0.0 if held else None})
    result = {"device": smi, "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
