#!/usr/bin/env python3
"""Tile sweep of the fused pool kernels K4 and K5 (noize_tpu_torch/csrc/pool.cu)
on one NVIDIA GPU.

    python3 scripts/pool_tile_sweep.py [--reps N] [--json PATH]

Builds one variant of ``pool.cu`` per (output tile side T, threads per
block, blocks an SM must hold, ablation): a copy of the source with its
``kTile``, ``kThreads`` and ``__launch_bounds__`` lines rewritten and an
occupancy query appended, written to ``build/pool_sweep/`` and compiled
there, one nvcc each, all started together.  The first variant is the
production build.  Two ablated copies of it compute no automata and are
timed, not compared: "memory" runs no phase (a launch's window loads and
tile stores alone), "compute" reads and writes no device memory (its
phases alone, on a zero-filled window).

Then, on ``chip_smoke.py``'s wet pool (blurred 13-octave noise, U(0, 0.02)
water on half the cells, 10 water steps), it holds every other variant's
K4 at 2048² and K5 at 2048² and 2049² against the plain versions
(tolerance 0), and times every variant with CUDA events, in two rounds
(variants in order, then in reverse).  Prints the card's name and power limit, one line
per variant and kernel, and the same as one JSON line, also written to
``PATH`` with ``--json``.
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

# (T, threads, blocks an SM must hold: a register cap, ablation); the
# first is the production build
VARIANTS = [(64, 512, 1, None), (64, 768, 2, None), (64, 1024, 2, None), (48, 512, 3, None),
            (40, 384, 4, None), (64, 512, 1, "memory"), (64, 512, 1, "compute")]

# the lines each ablation rewrites
ABLATIONS = {
    "memory": (("for (int p = 0; p < 4; ++p) {", "for (int p = 0; p < 0; ++p) {"),),
    "compute": (("copy_async(hs + i, height + g, in);", "copy_async(hs + i, height + g, false);"),
                ("copy_async(ps + i, src + g, in);", "copy_async(ps + i, src + g, false);"),
                ("(size_t)z * res + x : 0), in);", "(size_t)z * res + x : 0), false);"),
                ("if (z >= res || x >= res) continue;", "continue;")),
}

# appended to each variant: resident blocks of K4's step launch per SM
_OCCUPANCY = """
extern "C" int sweep_blocks_per_sm() {
  int blocks = 0;
  if (configure<Order::kPair>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, pool_step<Order::kPair>, kThreads,
                                                    Window::kBytes) != cudaSuccess)
    return -1;
  return blocks;
}
"""


def variant_source(src: str, tile: int, threads: int, min_blocks: int, ablation) -> str:
    """``pool.cu`` with its tile side, block size and register cap replaced,
    and an ablation's lines rewritten."""
    for old, new in (("constexpr int kTile = 64;", f"constexpr int kTile = {tile};"),
                     ("constexpr int kThreads = 512;", f"constexpr int kThreads = {threads};"),
                     ("__launch_bounds__(kThreads)",
                      f"__launch_bounds__(kThreads, {min_blocks})"),
                     *ABLATIONS.get(ablation, ())):
        if src.count(old) != 1:
            raise RuntimeError(f"pool.cu: expected one {old!r}")
        src = src.replace(old, new)
    return src + _OCCUPANCY


def build(variants):
    from noize_tpu_torch import _cuda

    out = os.path.join(ROOT, "build", "pool_sweep")
    os.makedirs(out, exist_ok=True)
    src = (_cuda.CSRC / "pool.cu").read_text()
    libs, cmds = [], []
    for t, n, b, a in variants:
        stem = os.path.join(out, f"pool_t{t}_n{n}_b{b}_{a or 'full'}")
        with open(stem + ".cu", "w") as fh:
            fh.write(variant_source(src, t, n, b, a))
        libs.append(stem + ".so")
        cmds.append([_cuda._nvcc(), *_cuda.NVCC_FLAGS, "-I", str(_cuda.CSRC),
                     "-Xptxas", "-v", "-shared", "-o", stem + ".so", stem + ".cu"])
    procs = [subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for c in cmds]
    for v, cmd, proc in zip(variants, cmds, procs):
        _, err = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed: {' '.join(cmd)}\n{err}")
        regs = [ln.strip() for ln in err.splitlines() if "registers" in ln or "spill" in ln]
        print(f"variant {v} ptxas: {' | '.join(regs)}")
    loaded = []
    for lib in libs:
        dll = ctypes.CDLL(lib)
        for name in ("noize_pool_automata", "noize_pool_automata_full"):
            fn = getattr(dll, name)
            fn.argtypes = list(_cuda.SIGNATURES[name])
            fn.restype = ctypes.c_int
        dll.sweep_blocks_per_sm.restype = ctypes.c_int
        loaded.append(dll)
    return loaded


def runner(dll, entry, height, pool, steps):
    """One call of ``entry`` from ``dll``, as erosion/pool_cuda._launch makes it."""
    import torch

    from noize_tpu_torch import _cuda

    res = height.shape[0]

    def run():
        out, drains, tmp = (torch.empty_like(pool) for _ in range(3))
        flag = torch.empty((1,), dtype=torch.int32, device=pool.device)
        rc = getattr(dll, entry)(height.data_ptr(), pool.data_ptr(), out.data_ptr(),
                                 drains.data_ptr(), flag.data_ptr(), tmp.data_ptr(), res,
                                 steps, 1, _cuda.stream(pool))
        if rc != 0:
            raise RuntimeError(f"{entry}: CUDA error {rc}")
        return out, drains
    return run


def main():
    import torch

    sys.path.insert(0, ROOT)
    from chip_smoke import _inputs, _max_abs, _time_ms
    from noize_tpu_torch.erosion import pool as PO

    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=20)
    ap.add_argument("--json", help="also write the results to this file")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("pool_tile_sweep: no CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(smi)
    dlls = build(VARIANTS)
    steps = 10
    cases = []
    for res in (2048, 2049):
        _, h, p = _inputs(res)
        if res % 2 == 0:
            cases.append(("K4", res, "noize_pool_automata", h, p,
                          PO.pool_automata(h, p, steps, True)))
        cases.append(("K5", res, "noize_pool_automata_full", h, p,
                      PO._pool_automata_fullgrid(h, p, steps, True)))

    def check(variant, label, got, want):
        err = max(_max_abs(u, v) for u, v in zip(got, want))
        if err != 0.0:
            raise RuntimeError(f"variant {variant} {label}: max_abs_err {err}")

    # small grids with ragged tiles
    for res, iters in ((66, 3), (130, 11), (129, 11)):
        gen = torch.Generator(device="cuda").manual_seed(res)
        h = torch.rand((res, res), generator=gen, device="cuda") * 0.5
        p = (torch.rand((res, res), generator=gen, device="cuda") * 0.1 - 0.05).clamp_min(0)
        even = res % 2 == 0
        want = (PO.pool_automata if even else PO._pool_automata_fullgrid)(h, p, iters, True)
        entry = "noize_pool_automata" if even else "noize_pool_automata_full"
        for dll, variant in zip(dlls, VARIANTS):
            if variant[3] is None:
                check(variant, f"{res}² x{iters}", runner(dll, entry, h, p, iters)(), want)
    print("every variant but the ablations bit-equal at 66² x3, 130² x11 (K4) and 129² x11 (K5)")
    rows = {}
    order = list(range(len(VARIANTS)))
    for idx in (order, order[::-1]):
        for i in idx:
            for key, res, entry, h, p, want in cases:
                run = runner(dlls[i], entry, h, p, steps)
                got = run()
                torch.cuda.synchronize()
                if VARIANTS[i][3] is None:
                    check(VARIANTS[i], f"{key} {res}²", got, want)
                rows.setdefault((i, key, res), []).append(_time_ms(run, args.reps))
    out = []
    for (i, key, res), ms in rows.items():
        t, n, b, a = VARIANTS[i]
        blocks = dlls[i].sweep_blocks_per_sm()
        what = f"{a} alone" if a else "bit-equal"
        print(f"T={t} threads={n} min_blocks={b} ({blocks} blocks/SM) {key} {res}²: "
              f"{ms[0]:.4f} / {ms[1]:.4f} ms (rounds 1 / 2), {what}")
        out.append({"tile": t, "threads": n, "min_blocks": b, "ablation": a,
                    "blocks_per_sm": blocks, "kernel": key, "res": res, "ms": ms,
                    "max_abs_err": None if a else 0.0})
    result = {"device": smi, "water_steps": steps, "rows": out}
    if args.json:
        with open(args.json, "w") as fh:
            json.dump(result, fh, indent=1)
    print(json.dumps(result))


if __name__ == "__main__":
    main()
