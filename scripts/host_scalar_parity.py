"""Exhaustive check of the port's host-scalar float32 exp2 and tan
(``noize_tpu_torch.ops.f32``) against the reference's XLA CPU runtime.

  * exp2: G = exp2(-hurst) for every float32 hurst in [0, 2] (NoiseStage's
    range, 1,073,741,825 values) against ``jnp.exp2``;
  * tan: every float32 angle ``(t / 90) · 3.14159 / 2`` gives for float32
    t in [0, 90] (ThermalStage's talus range; the angle in double, then
    rounded, as thermal_pl.py:113-122 computes it) against ``jnp.tan``,
    and ``ops.thermal.max_diff_value`` at the 90 integer talus values
    against the eager recipe and the ``ensure_compile_time_eval`` one;
  * the reference's own runtime-against-folded difference: the gain XLA
    folds for a constant hurst (``parallel/sharded_ops.py:50`` under
    ``jax.jit``) on the 0.001 hurst grid, and the tangent it folds at the
    integer talus values; beside it PyTorch's ``exp2`` and ``tan`` (the
    port's values before these helpers);
  * the reference's ``sharded_fractal`` run eagerly on a 2×2 mesh of
    virtual CPU devices against the port's ``fractal`` at gain-sensitive
    hurst values (slow: eager ``shard_map`` dispatches one op at a time).

Run on the CPU from the repo root (imports both packages; not a Tier-1
test):

    JAX_PLATFORMS=cpu python scripts/host_scalar_parity.py [--workers 4]
        [--sample N] [--skip-sharded]

``--sample N`` checks N random float32 values per range instead of all.
Prints one line per check and a JSON summary as the last line.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
os.environ.setdefault("JAX_PLATFORMS", "cpu")
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=4").strip()
sys.path.insert(0, ROOT)

import numpy as np  # noqa: E402

CHUNK = 1 << 22
HURST_HI = int(np.float32(2.0).view(np.int32))
TALUS_HI = int(np.float32(90.0).view(np.int32))


def _angles(t):
    return ((t.astype(np.float64) / 90.0) * 3.14159 / 2.0).astype(np.float32)


def _chunk(job):
    """(kind, lo, hi) bit patterns or (kind, seed, n) sample → mismatches."""
    import jax.numpy as jnp

    from noize_tpu_torch.ops import f32 as F

    kind, a, b, sample = job
    if sample:
        hi = 2.0 if kind == "exp2" else 90.0
        x = np.random.default_rng(a).uniform(0, hi, b).astype(np.float32)
    else:
        x = np.arange(a, b, dtype=np.int64).astype(np.int32).view(np.float32)
    if kind == "exp2":
        arg = -x
        got, want = F.exp2(arg), np.asarray(jnp.exp2(jnp.asarray(arg)))
    else:
        arg = _angles(x)
        got, want = F.tan(arg), np.asarray(jnp.tan(jnp.asarray(arg)))
    bad = got.view(np.int32) != want.view(np.int32)
    return int(bad.sum()), [float(v) for v in x[bad][:5]]


def _sweep(kind, hi_bits, workers, sample):
    import multiprocessing as mp

    if sample:
        jobs = [(kind, seed, min(CHUNK, sample - seed * CHUNK), True)
                for seed in range(-(-sample // CHUNK))]
        total = sample
    else:
        jobs = [(kind, lo, min(lo + CHUNK, hi_bits + 1), False)
                for lo in range(0, hi_bits + 1, CHUNK)]
        total = hi_bits + 1
    bad, first = 0, []
    with mp.get_context("spawn").Pool(workers) as pool:
        for n, xs in pool.imap_unordered(_chunk, jobs):
            bad += n
            first += xs
    return total, bad, sorted(first)[:5]


def _integer_talus():
    import jax
    import jax.numpy as jnp
    import torch

    from noize_tpu_torch.ops import f32 as F
    from noize_tpu_torch.ops import thermal as TT

    bad_md, folded_differs, torch_differs = [], [], []
    for t in range(1, 91):
        rad = (t / 90.0) * 3.14159 / 2.0
        for hwr, res in ((1.0, 64), (0.5, 128), (2.0, 100)):
            with jax.disable_jit():
                eager = np.float32((jnp.tan(rad) * hwr) / res)
            with jax.ensure_compile_time_eval():
                kernel = np.float32((jnp.tan(jnp.float32(rad)) * hwr) / res)
            got = np.float32(TT.max_diff_value(float(t), hwr, res))
            if not got == eager == kernel:
                bad_md.append((t, hwr, res))
        folded = np.float32(jax.jit(lambda r=np.float32(rad): jnp.tan(r))())
        if folded != F.tan(np.float32(rad)):
            folded_differs.append(t)
        if np.float32(torch.tan(torch.tensor(rad, dtype=torch.float32))) != F.tan(np.float32(rad)):
            torch_differs.append(t)
    return bad_md, folded_differs, torch_differs


def _folded_gain():
    import jax
    import jax.numpy as jnp
    import torch

    from noize_tpu_torch.ops import f32 as F

    grid = [i / 1000 for i in range(2001)]
    differs, torch_differs = [], []
    for h in grid:
        folded = np.float32(jax.jit(lambda: jnp.exp2(-jnp.float32(h)))())
        runtime = F.exp2(-np.float32(h))
        if folded != runtime:
            differs.append(h)
        if np.float32(torch.exp2(torch.tensor(-h, dtype=torch.float32))) != runtime:
            torch_differs.append(h)
    return len(grid), differs, torch_differs


def _sharded(hursts):
    import jax
    from jax.sharding import Mesh

    from noize_tpu.parallel import sharded_ops as JSO
    from noize_tpu_torch.ops.fractal import fractal

    mesh = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("x", "y"))
    out = {}
    for h in hursts:
        kw = dict(noise_type="Perlin", octaves=2, hurst=h, noise_size=90.0)
        want = np.asarray(JSO.sharded_fractal(mesh, 16, 31.0, -17.0, **kw))
        got = fractal(16, 31.0, -17.0, device="cpu", **kw).numpy()
        out[h] = int((got.view(np.int32) != want.view(np.int32)).sum())
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workers", type=int, default=min(4, os.cpu_count() or 1))
    ap.add_argument("--sample", type=int, default=0,
                    help="check this many random values per range instead of all")
    ap.add_argument("--skip-sharded", action="store_true")
    args = ap.parse_args()
    summary = {}
    for kind, hi in (("exp2", HURST_HI), ("tan", TALUS_HI)):
        t0 = time.perf_counter()
        n, bad, first = _sweep(kind, hi, args.workers, args.sample)
        secs = time.perf_counter() - t0
        what = "hurst" if kind == "exp2" else "talus"
        print(f"{kind}: {n} float32 {what} values, {bad} mismatches "
              f"{first if bad else ''}({secs:.1f} s)", flush=True)
        summary[kind] = dict(values=n, mismatches=bad, first=first,
                             exhaustive=not args.sample)
    bad_md, tan_folded, tan_torch = _integer_talus()
    print(f"max_diff_value at the 90 integer talus × 3 (ratio, res): {len(bad_md)} "
          f"mismatches; XLA's folded tan differs from its runtime tan at talus {tan_folded}, "
          f"torch.tan at {tan_torch}")
    summary["max_diff_integer_talus"] = dict(mismatches=len(bad_md), folded_differs=tan_folded,
                                             torch_differs=tan_torch)
    n, differs, torch_differs = _folded_gain()
    print(f"on the 0.001 hurst grid the folded gain differs from the runtime gain at "
          f"{len(differs)} of {n} values (first {differs[:8]}), torch.exp2 at "
          f"{len(torch_differs)} (first {torch_differs[:8]})")
    summary["folded_gain"] = dict(values=n, differs=len(differs), first=differs[:8],
                                  torch_differs=len(torch_differs))
    if not args.skip_sharded:
        hs = [0.123, 0.9]
        res = _sharded(hs)
        print(f"reference sharded_fractal (eager, 2×2) against the port's fractal, cells "
              f"that differ: {res}")
        summary["sharded_eager"] = {str(k): v for k, v in res.items()}
    print(json.dumps(summary))


if __name__ == "__main__":
    main()
