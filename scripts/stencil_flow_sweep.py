#!/usr/bin/env python3
"""Measurements and sweeps behind the designs of K1 (``csrc/stencil.cu``)
and K2 (``csrc/flow.cu``) on one NVIDIA GPU.

    python3 scripts/stencil_flow_sweep.py [--reps N] [--json PATH] [--parts 1234]

1. The design K1 and K2 replaced (one launch a pass or sub-step), as a copy
   built here with three variants: "full" as it was, "nomem" reading and
   writing no device memory (its arithmetic alone, on values made from the
   index), and, for K1, "k5" with the tap count fixed at compile time.
   Times one K1 X pass and one Z pass, one K2 flow step and one water step
   at 2048².  If "nomem" takes most of "full", issue bounds the design,
   not bytes.
2. K1 along other blocking plans (tile, halo, threads: runtime arguments
   of ``noize_separable_chain``) and, in copies of ``stencil.cu`` with the
   ``kSeg`` line rewritten, other outputs a thread computes from one
   register window, on Gauss-5 x17 at 2048².
3. K2 with other windows (copies of ``flow.cu`` with their ``kThreads`` and
   ``kSlotsX``/``kSlotsZ`` lines rewritten) and other iterations a launch,
   on flow x8 at 2048².
4. K1@short (``noize_series_chain``; tile, threads and strip are runtime
   arguments): (a) other tiles, threads and strips on the presets' chains
   (Sobel3Horizontal x1, Gauss3_S1 x3, Gauss9_S1 x2) at 2048²; (b) the
   route's threshold: K1@short on its default tile against ``chain_tile``
   on chains of total halo off*m from 1 to 16 (k = 3, 5, 9) and on the
   flagship's Gauss-5 x17 (halo 34), at 2048².

Every variant of 2, 3 and 4 is held against its plain version (tolerance 0)
and timed with CUDA events in two rounds (in order, then in reverse).
Prints the card's name and power limit, one line per variant, and the same
as one JSON line, also written to ``PATH`` with ``--json``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

# The replaced design's kernels (one launch a pass / sub-step), with the
# variants of part 1 selected by -DNOMEM and -DFIXED_K.
OLD_SOURCE = r"""
#include <cuda_runtime.h>
#include "common.cuh"
using namespace noize;
constexpr int kMaxTaps = 25;
struct Taps { float t[kMaxTaps]; };

#ifdef NOMEM
#define LOAD(p, i) ((float)(i) * 1e-7f)
#define STORE(p, i, v) if ((v) == 12345.0f) (p)[i] = (v)
#else
#define LOAD(p, i) ((p)[i])
#define STORE(p, i, v) (p)[i] = (v)
#endif
#ifdef FIXED_K
#define TAPS 5
#define GUARD(i) true
#else
#define TAPS kMaxTaps
#define GUARD(i) ((i) < k)
#endif

__global__ void conv_x_kernel(const float* __restrict__ a, float* __restrict__ out, int rows,
                              int cols, Taps taps, int k) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || z >= rows) return;
  const int off = (k - 1) / 2;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    if (GUARD(i)) {
      const int xi = clampi(x - off + i, 0, cols - 1);
      acc = add(acc, mul(taps.t[i], LOAD(a, (size_t)z * cols + xi)));
    }
  }
  STORE(out, (size_t)z * cols + x, acc);
}

__global__ void conv_z_kernel(const float* __restrict__ a, float* __restrict__ out, int rows,
                              int cols, Taps taps, int k) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= cols || z >= rows) return;
  const int off = (k - 1) / 2;
  float acc = 0.0f;
#pragma unroll
  for (int i = 0; i < TAPS; ++i) {
    if (GUARD(i)) {
      const int zi = clampi(z + off - i, 0, rows - 1);
      acc = add(acc, mul(taps.t[i], LOAD(a, (size_t)zi * cols + x)));
    }
  }
  STORE(out, (size_t)z * cols + x, acc);
}

__global__ void flow_step(const float* __restrict__ h, const float* __restrict__ water,
                          float* fw, float* fe, float* fs, float* fn, int res) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const size_t iw = (size_t)z * res + clampi(x - 1, 0, res - 1);
  const size_t ie = (size_t)z * res + clampi(x + 1, 0, res - 1);
  const size_t is = (size_t)clampi(z - 1, 0, res - 1) * res + x;
  const size_t in = (size_t)clampi(z + 1, 0, res - 1) * res + x;
  const float total = add(LOAD(h, i), LOAD(water, i));
  const float vw = relu(add(LOAD(fw, i), sub(total, add(LOAD(h, iw), LOAD(water, iw)))));
  const float ve = relu(add(LOAD(fe, i), sub(total, add(LOAD(h, ie), LOAD(water, ie)))));
  const float vs = relu(add(LOAD(fs, i), sub(total, add(LOAD(h, is), LOAD(water, is)))));
  const float vn = relu(add(LOAD(fn, i), sub(total, add(LOAD(h, in), LOAD(water, in)))));
  const float s = add(add(add(vw, ve), vs), vn);
  float k = 0.0f;
  if (s > 0.0f) k = fmin2(fmax2(divf(LOAD(water, i), mul(s, 0.2f)), 0.0f), 1.0f);
  STORE(fw, i, mul(vw, k));
  STORE(fe, i, mul(ve, k));
  STORE(fs, i, mul(vs, k));
  STORE(fn, i, mul(vn, k));
}

__global__ void water_step(float* water, const float* __restrict__ fw,
                           const float* __restrict__ fe, const float* __restrict__ fs,
                           const float* __restrict__ fn, int res) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int z = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= res || z >= res) return;
  const size_t i = (size_t)z * res + x;
  const size_t iw = (size_t)z * res + clampi(x - 1, 0, res - 1);
  const size_t ie = (size_t)z * res + clampi(x + 1, 0, res - 1);
  const size_t is = (size_t)clampi(z - 1, 0, res - 1) * res + x;
  const size_t in = (size_t)clampi(z + 1, 0, res - 1) * res + x;
  const float flow_out = add(add(add(LOAD(fw, i), LOAD(fe, i)), LOAD(fs, i)), LOAD(fn, i));
  const float flow_in = add(add(add(LOAD(fe, iw), LOAD(fw, ie)), LOAD(fn, is)), LOAD(fs, in));
  STORE(water, i, relu(add(LOAD(water, i), mul(sub(flow_in, flow_out), 0.2f))));
}

// which: 0 X pass, 1 Z pass, 2 flow step, 3 water step; p: six res^2 maps
extern "C" int sweep_old(int which, float* p0, float* p1, float* p2, float* p3, float* p4,
                         float* p5, int res, const float* taps_host, int k, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  Taps taps;
  for (int i = 0; i < kMaxTaps; ++i) taps.t[i] = i < k ? taps_host[i] : 0.0f;
  const dim3 block(32, 8);
  const dim3 grid = grid2d(res, res, block);
  if (which == 0) conv_x_kernel<<<grid, block, 0, stream>>>(p0, p1, res, res, taps, k);
  if (which == 1) conv_z_kernel<<<grid, block, 0, stream>>>(p0, p1, res, res, taps, k);
  if (which == 2) flow_step<<<grid, block, 0, stream>>>(p0, p1, p2, p3, p4, p5, res);
  if (which == 3) water_step<<<grid, block, 0, stream>>>(p1, p2, p3, p4, p5, res);
  return static_cast<int>(cudaGetLastError());
}
"""

OLD_VARIANTS = {"full": (), "nomem": ("-DNOMEM",), "k5": ("-DFIXED_K",)}

# K1 variants of part 2: (kSeg, tile rows, tile cols, halo, threads); the
# first is the production build and plan.  "plain loads" is the production
# build with the window loaded by plain loads and stores, not cp.async.
K1_PLANS = [(8, 128, 128, 10, 768), (8, 128, 128, 10, 512), (8, 64, 64, 10, 256), (8, 64, 64, 4, 256),
            (8, 64, 64, 6, 256), (8, 64, 64, 8, 256), (8, 64, 64, 12, 256), (8, 64, 64, 18, 256),
            (8, 64, 64, 34, 256), (8, 96, 96, 10, 256), (8, 96, 96, 10, 384),
            (8, 96, 96, 10, 512), (8, 96, 96, 12, 512), (8, 128, 64, 10, 256),
            (8, 128, 64, 10, 512), (8, 128, 128, 8, 512), (8, 128, 128, 12, 512),
            (8, 128, 128, 18, 512), (8, 128, 128, 10, 256),
            (8, 128, 128, 10, 1024), (4, 128, 128, 10, 512),
            (16, 128, 128, 10, 512), ("plain loads", 128, 128, 10, 512)]

# K1@short variants of part 4a: (tile rows, tile cols, threads, strip);
# short_plan's SHORT_ONE and SHORT_MANY are among them
SHORT_PLANS = [(32, 128, 128, 32), (32, 256, 256, 32), (64, 256, 512, 32), (64, 128, 256, 32),
               (64, 64, 128, 32), (32, 64, 64, 32), (16, 256, 256, 16), (32, 128, 256, 16),
               (64, 128, 128, 32), (32, 512, 512, 32)]
SHORT_CHAINS = [("Sobel3Horizontal", 1), ("Gauss3_S1", 3), ("Gauss9_S1", 2)]
# part 4b: (k, iterations) on K1@short and on chain_tile
THRESHOLD_CHAINS = ([(3, m) for m in (1, 2, 3, 4, 6, 8, 10, 12, 16)] + [(5, m) for m in range(1, 9)]
                    + [(9, m) for m in (1, 2, 3, 4)] + [(5, 17)])

# K2 windows of part 3: (threads, slots x, slots z) -> window side 32 * slots x;
# the first is the production build
K2_WINDOWS = [(1024, 3, 3), (768, 3, 4), (512, 2, 4), (1024, 2, 2)]
K2_PER_LAUNCH = [4, 2, 3, 8]


def flow_variant_source(src: str, threads: int, sx: int, sz: int) -> str:
    return rewrite(src, "flow.cu",
                   ("constexpr int kThreads = 1024;", f"constexpr int kThreads = {threads};"),
                   ("constexpr int kSlotsX = 3, kSlotsZ = 3;",
                    f"constexpr int kSlotsX = {sx}, kSlotsZ = {sz};"))


def rewrite(src: str, name: str, *pairs) -> str:
    for old, new in pairs:
        if src.count(old) != 1:
            raise RuntimeError(f"{name}: expected one {old!r}")
        src = src.replace(old, new)
    return src


def build():
    """The replaced design's three variants, the K1 kSeg copies and the K2
    windows, one nvcc each, all started together; prints ptxas's register
    and spill lines."""
    from noize_tpu_torch import _cuda

    out = os.path.join(ROOT, "build", "stencil_flow_sweep")
    os.makedirs(out, exist_ok=True)
    jobs = []
    old = os.path.join(out, "old.cu")
    with open(old, "w") as fh:
        fh.write(OLD_SOURCE)
    for name, flags in OLD_VARIANTS.items():
        jobs.append((f"old_{name}", old, flags))
    src = (_cuda.CSRC / "stencil.cu").read_text()
    for seg in {v[0] for v in K1_PLANS}:
        if seg == "plain loads":
            text = rewrite(src, "stencil.cu",
                           ("noize::copy_async(a + r * p + c, in + (size_t)(z0 + r) * cols + "
                            "(x0 + c), true);",
                            "a[r * p + c] = in[(size_t)(z0 + r) * cols + (x0 + c)];"))
        else:
            text = rewrite(src, "stencil.cu",
                           ("constexpr int kSeg = 8;", f"constexpr int kSeg = {seg};"))
        path = os.path.join(out, f"stencil_seg{seg}.cu".replace(" ", "_"))
        with open(path, "w") as fh:
            fh.write(text)
        jobs.append((f"stencil_seg{seg}", path, ()))
    src = (_cuda.CSRC / "flow.cu").read_text()
    for threads, sx, sz in K2_WINDOWS:
        path = os.path.join(out, f"flow_n{threads}_x{sx}_z{sz}.cu")
        with open(path, "w") as fh:
            fh.write(flow_variant_source(src, threads, sx, sz))
        jobs.append((f"flow_n{threads}_x{sx}_z{sz}", path, ()))
    cmds = [[_cuda._nvcc(), *_cuda.NVCC_FLAGS, *flags, "-I", str(_cuda.CSRC), "-Xptxas", "-v",
             "-shared", "-o", os.path.join(out, name.replace(" ", "_") + ".so"), path]
            for name, path, flags in jobs]
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    libs = {}
    for (name, _, _), cmd, proc in zip(jobs, cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"{name} ptxas: {' | '.join(regs)}")
        libs[name] = ctypes.CDLL(os.path.join(out, name.replace(" ", "_") + ".so"))
    return libs


def _rounds(runs, reps):
    """Each (key, run, want) held bit-equal, then timed in two rounds (in
    order, then in reverse): {index: [ms, ms]}."""
    from chip_smoke import _max_abs, _time_ms

    out = {}
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            key, run, want = runs[i]
            err = _max_abs(run(), want)
            if err != 0.0:
                raise RuntimeError(f"variant {key}: max_abs_err {err}")
            out.setdefault(i, []).append(_time_ms(run, reps))
    return out


def short_sweep(x, reps):
    """Part 4: K1@short along other blockings, then against chain_tile."""
    import ctypes

    import torch

    from noize_tpu_torch import _cuda
    from noize_tpu_torch.ops import kernels as KE
    from noize_tpu_torch.ops.blur import smooth_taps
    from noize_tpu_torch.ops.cuda import stencil as SC

    lib = _cuda.library()
    rows, cols = x.shape
    stream = _cuda.stream(x)
    out_rows = []

    def short(tx, tz, factor, m, plan):
        s = SC._series(len(tx), plan, [(tx, tz)], factor)

        def run():
            out = torch.empty_like(x)
            rc = lib.noize_series_chain(x.data_ptr(), out.data_ptr(), rows, cols, 1,
                                        ctypes.addressof(s), x.device.index, stream)
            if rc:
                raise RuntimeError(f"noize_series_chain: CUDA error {rc}")
            return out
        return run

    runs = []
    for name, m in SHORT_CHAINS:
        tx, tz, f = KE._SERIES_TABLE[name]
        want = SC.separable_chain_plain(x, tx, m, taps_z=tz, factor=f)
        for blocking in SHORT_PLANS:
            plan = SC.short_plan(len(tx), m, blocking, halo=None)
            runs.append(((name, m, *blocking), short(tx, tz, f, m, plan), want))
    for i, ms in sorted(_rounds(runs, reps).items()):
        (name, m, tzr, txr, n, strip), _, _ = runs[i]
        print(f"K1@short {name} x{m} tile {tzr}x{txr} threads {n} strip {strip}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms, bit-equal")
        out_rows.append({"part": "4a", "kernel": "K1@short", "chain": [name, m],
                         "tile": [tzr, txr], "threads": n, "strip": strip, "ms": ms})
    runs = []
    for k, m in THRESHOLD_CHAINS:
        t = smooth_taps(k) if k == 3 else KE.gaussian_taps(1.0, k)
        want = SC.separable_chain_plain(x, t, m)
        plan = SC.short_plan(k, m, halo=None)
        runs.append(((k, m, "short"), short(t, t, 1.0, m, plan), want))
        runs.append(((k, m, "tile"), lambda t=t, m=m: SC.tile_chain(x, t, m), want))
    timed = _rounds(runs, reps)
    for i in range(0, len(runs), 2):
        (k, m, _), _, _ = runs[i]
        s_ms, t_ms = timed[i], timed[i + 1]
        print(f"k {k} x{m} (halo {(k - 1) // 2 * m}): K1@short {s_ms[0]:.4f} / {s_ms[1]:.4f} ms, "
              f"chain_tile {t_ms[0]:.4f} / {t_ms[1]:.4f} ms "
              f"({len(SC.chain_plan(k, m).launches)} launches), bit-equal")
        out_rows.append({"part": "4b", "k": k, "iterations": m, "short_ms": s_ms,
                         "tile_ms": t_ms})
    return out_rows


def main():
    import numpy as np
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import _inputs, _max_abs, _time_ms
    from noize_tpu_torch import _cuda
    from noize_tpu_torch.ops import flow as FL
    from noize_tpu_torch.ops.cuda import flow as FC
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.kernels import gaussian_taps

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the results to this file")
    ap.add_argument("--parts", default="1234", help="the parts to run (default: all)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("stencil_flow_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    _cuda.library()
    libs = build() if set(args.parts) & set("123") else {}
    res = 2048
    noise, blurred, _ = _inputs(res)
    taps = gaussian_taps(1.0, 5)
    rows = []
    stream = _cuda.stream(noise)
    if "4" in args.parts:
        rows += short_sweep(blurred, args.reps)

    # 1. the replaced design, one launch of each kind
    maps = [torch.rand((res, res), device="cuda") for _ in range(6)] if "1" in args.parts else []
    for name in OLD_VARIANTS if "1" in args.parts else ():
        dll = libs[f"old_{name}"]
        dll.sweep_old.argtypes = [ctypes.c_int] + [ctypes.c_void_p] * 6 + [
            ctypes.c_int, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
        dll.sweep_old.restype = ctypes.c_int
        for which, what in enumerate(("K1 X pass", "K1 Z pass", "K2 flow step",
                                      "K2 water step")):
            if name == "k5" and which > 1:
                continue

            def run(dll=dll, which=which):
                rc = dll.sweep_old(which, *(m.data_ptr() for m in maps), res,
                                   taps.ctypes.data, len(taps), stream)
                if rc:
                    raise RuntimeError(f"sweep_old: CUDA error {rc}")
            ms = [_time_ms(run, args.reps * 5) for _ in range(2)]
            print(f"replaced design, {what}, {name}: {ms[0]:.4f} / {ms[1]:.4f} ms")
            rows.append({"part": 1, "kernel": what, "variant": name, "ms": ms})
    del maps

    # 2. K1 along other plans and kSeg copies
    want = SC.separable_chain_plain(noise, taps, 17)
    k1_runs = []
    for seg, tz, tx, h, n in K1_PLANS if "2" in args.parts else ():
        fn = libs[f"stencil_seg{seg}"].noize_separable_chain
        fn.argtypes = list(_cuda.SIGNATURES["noize_separable_chain"])
        fn.restype = ctypes.c_int
        plan = SC.chain_plan(5, 17, tile=(tz, tx), halo=h, threads=n)

        def run(fn=fn, plan=plan):
            # as ops/cuda/stencil.separable_chain calls it
            out, tmp = torch.empty_like(noise), torch.empty_like(noise)
            per_launch = np.asarray(plan.launches, np.int32)
            rc = fn(noise.data_ptr(), out.data_ptr(), tmp.data_ptr(), res, res, 1,
                    taps.ctypes.data, taps.ctypes.data, len(taps), 1.0,
                    per_launch.ctypes.data, len(per_launch),
                    plan.tile[0], plan.tile[1], plan.threads, stream)
            if rc:
                raise RuntimeError(f"noize_separable_chain: CUDA error {rc}")
            return out
        k1_runs.append(((seg, tz, tx, h, n, plan.launches), run))
    k1 = {}
    for order in (range(len(k1_runs)), reversed(range(len(k1_runs)))):
        for i in order:
            key, run = k1_runs[i]
            err = _max_abs(run(), want)
            if err != 0.0:
                raise RuntimeError(f"K1 variant {key}: max_abs_err {err}")
            k1.setdefault(i, []).append(_time_ms(run, args.reps))
    for i, ms in sorted(k1.items()):
        (seg, tz, tx, h, n, launches), _ = k1_runs[i]
        print(f"K1 kSeg {seg} tile {tz}x{tx} halo {h} threads {n} launches {launches}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms, bit-equal")
        rows.append({"part": 2, "kernel": "K1", "kseg": seg, "tile": [tz, tx], "halo": h,
                     "threads": n, "launches": list(launches), "ms": ms, "max_abs_err": 0.0})
    del want

    # 3. K2 with other windows and iterations a launch
    want = FL.flow_map(blurred, 8)
    lo, rng = FL.norm_params(-0.1, 0.1)
    runs = []
    for threads, sx, sz in K2_WINDOWS if "3" in args.parts else ():
        dll = libs[f"flow_n{threads}_x{sx}_z{sz}"]
        fn = dll.noize_flow_map
        fn.argtypes = list(_cuda.SIGNATURES["noize_flow_map"])
        fn.restype = ctypes.c_int
        region = 32 * sx
        for per in K2_PER_LAUNCH:
            try:
                plan = FC.flow_plan(8, per_launch=per, region=region)
            except ValueError:
                continue

            def run(fn=fn, plan=plan, region=region):
                out = torch.empty_like(blurred)
                n = len(plan.launches)
                carry = (torch.empty((min(2, n - 1), 5, res, res), device="cuda")
                         if n > 1 else None)
                per_launch = np.asarray(plan.launches, np.int32)
                rc = fn(blurred.data_ptr(), out.data_ptr(),
                        None if carry is None else carry.data_ptr(), res, 1,
                        per_launch.ctypes.data, n, region, float(lo), float(rng), stream)
                if rc:
                    raise RuntimeError(f"noize_flow_map: CUDA error {rc}")
                return out
            runs.append(((threads, sx, sz, per, plan.launches), run))
    k2 = {}
    for order in (range(len(runs)), reversed(range(len(runs)))):
        for i in order:
            key, run = runs[i]
            err = _max_abs(run(), want)
            if err != 0.0:
                raise RuntimeError(f"K2 variant {key}: max_abs_err {err}")
            k2.setdefault(i, []).append(_time_ms(run, args.reps))
    for i, ms in sorted(k2.items()):
        (threads, sx, sz, per, launches), _ = runs[i]
        print(f"K2 window {32 * sx} threads {threads} slots {sx}x{sz} launches {launches}: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms, bit-equal")
        rows.append({"part": 3, "kernel": "K2", "window": 32 * sx, "threads": threads,
                     "slots": [sx, sz], "launches": list(launches), "ms": ms,
                     "max_abs_err": 0.0})
    result = {"device": smi, "rows": rows}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
