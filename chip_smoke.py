#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``noize_tpu_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (any failure raises and exits non-zero; nothing is caught):

1. device: requires CUDA; prints the card's name and
   ``nvidia-smi --query-gpu=name,power.limit``;
2. build: compiles the CUDA kernels K1-K12 (K1 with K1@short and K1@rss)
   from ``noize_tpu_torch/csrc``
   (K7 particle descent ``descent.cu``, K8 threefry ``threefry.cu``, K9 the
   in-order event scatter ``scatter.cu``, K10 the fBm ``fractal.cu``, K11
   the sediment write-back ``sediment.cu``, K12 the deposit's adds and the
   track/flow decay ``decay.cu``);
3. kernels: each kernel against its plain PyTorch version on the card at
   the flagship's shapes (2048², and 2049² for K5), with CUDA-event times
   of both, the card's least time for the same work (``bound_ms``) and,
   for K1, the cuDNN convolutions that compute the same chain; the
   expected result is bit-equality (tolerance 0);
4. entries: the JAX-signature entries of the ten TPU kernels and
   ``erosion.pool.pool_automata_quad`` (K4), each driven once at 2048²
   with every launch count reset before and read after, then held against
   its plain version (tolerance 0);
4b. fractal gain and K10: the 2048² fractal (13 Simplex octaves) on the
   card against the CPU at hurst 0.9 and 0.4, and 13 Perlin octaves, each
   max_abs_err 0.0, with the card's time; then K10 against its plain
   version on the card, bit-equal: each of the eight bases at 2048², 4
   octaves (timed), Simplex ×13 at hurst 0.9 and 0.4 (the kernels line's
   K10 row: the flagship's fBm), a detuned call with a non-2 stepdown, and
   a window away from the origin against the same slice of the whole tile;
4c. config 1 (``bench.py:244-253``): the 512² Perlin fBm, 13 octaves,
   through ``fractal`` (one K10 launch a call), timed, against its plain
   version on the card and the CPU (row K10@config1);
4d. config 6 (``bench.py:823-865``, the 8192² field): Simplex ×13 (K10),
   Gauss-5 ×17 (K1), thermal with ``ErosionSettings()``'s cycles, talus and
   step (K3), flow ×8 (K2), each kernel launched once and bit-equal to its
   plain version at 8192², each stage timed, the peak device memory, and
   256² windows of the fractal (a corner, an interior block) against
   ``fractal_window`` on the CPU (row K10@config6);
5. quickstart (the main path): README.md's Quickstart at 2048² through
   the port — buffer store, stage pipeline (K1, K2), ``ErosionSim.step()``
   with ``ErosionSettings()`` defaults (K3, K4), checkpoint and restore,
   mesh from the context buffer;
6. flagship: the 2048² tile step through ``make_tile_step(device="cuda")``;
7. odd grid: ``ErosionSim`` on a 1025² tile, one step (K3, K5), then K5
   against its plain version on the inputs of the step's last wet pool
   call, and K3 on the height the step leaves (tolerance 0);
8. the port on the card against the port on the CPU at the
   ``__graft_entry__.entry()`` configuration from the same seed (the same
   threefry spawn), and the mesh export round trip (OBJ, NPZ) at that
   size;
8b. descent: K7 (``descend_steps`` on its record table: every step of the
   1000 particles of the Quickstart's 2048² state after its step, MAXAGE
   100, spawned from the sim's key; and config 5's 250 particles on a 1024²
   tile) against its plain version on ``step_maps``, particles and events
   bit-equal; the record table (K7@records) against its plain builder; K9
   on K7's events against the CPU's ``scatter_events`` on CPU copies, and
   ``descend_all`` against the early-exit loop (a scatter a chunk), bit for
   bit; K7@window on the four windows of a 2×2 split of both, chunk of 8,
   owner masks, bit-equal; K8 on the spawns' hashes, and K8's draw entry
   against the CPU's ``randint(split(k))`` and ``spawn``; each timed against
   its plain version, K9 also against the three ``index_put_`` it replaced,
   the draw against the composition it replaced (rows K7, K7@window,
   K7@records, K8, K8@randint, K9), and K9's device operations a call by
   the profiler (one kernel, and the fill into fresh maps; at most three
   kernels besides the fill pass);
9. prng: the threefry PRNG on the card against the CPU, 10⁶ ``randint``
   draws (integers, exact), with the card's time for the draw, and K8
   against its plain version on the card (bit-equal);
10. kernel filters: K1@short with each non-Gauss filter's taps (distinct
   X and Z taps, Smooth3's factor) and the presets' Gauss9_S1 ×2 and
   Gauss3_S1 ×3, K1@rss as ``kernel_filter``'s Sobel3_2D and
   ``edge_2d``'s Prewitt magnitude, at 2048² against the plain versions
   (tolerance 0), with CUDA-event times, the bound, the same chain as
   ``conv2d`` calls with replicate padding, the device operations of one
   call (profiled: one kernel each, no elementwise pass after it) and the
   host enqueue of one call;
11. presets: the BasicDemo presets PerlinGenerator (K1@short), FlowMap (K2)
   and Sobel (K1@short, K1@rss) at 2048² through ``Pipeline.run`` and
   ``compose.fuse`` (equal; no ``chain_tile`` launch), and the Mesh preset
   on the PerlinGenerator output at the Quickstart's mesh size; every
   preset at 256² on the card against the port on the CPU (PerlinGenerator
   and Sobel equal, FlowMap within 1e-4);
12. tiles (this slice's main path): ``bench.py``'s config 5 (16 tiles of
   1024², 13 octaves, Gauss-5 ×17, one erosion cycle of 250 particles) as
   one ``tile_batch``, then with mesh planes, then the same grid's flow map
   (×8, no erosion), one K10 launch a batch; every tile equals
   ``generate_tile`` of it alone; then K10, K1 and K2 on the [16, 1024,
   1024] stack against their plain versions and the 2-D kernel on each tile
   (tolerance 0), with the times of both and of 16 2-D calls;
13. serve: ``TileServer(config 5, batch_size=4)`` serving the 16 tiles in a
   cold wave and a warm wave, each tile equal to ``tile_batch``'s;
14. CLI: ``demo --resolution 2048`` and ``erode --resolution 2048 --cycles
   3 --mesh --heightmap16`` into a temporary directory;
15. generator: ``DemoTileGenerator(...).start(1, 1)`` with 1024² tiles,
   ``step_erosion(1)``, ``StreamDrawer.export``, ``save_erosion_state``,
   ``TileDrawer.draw`` from a fresh store, ``MeshBakery`` of the 4 meshes;
16. continuous sim: ``ErosionSim`` at 2048² driven by ``update()`` until
   "completed";
17. vegetation: the Quickstart ``ErosionSim`` at 2048² with
   ``VEGETATION_FRICTION = 5`` on the density of 65,536 rooted plants after
   one growth cycle, one ``step()``; the same at 256² on the card and the
   CPU (1e-4 relative);
18. exact piles: K6 against its plain version at 256² with overlapping and
   border piles, radius 4 and 15 (tolerance 0); K6 and its table entry on
   64 disjoint piles at 2048² (all at once) and on a chain of 64 piles each
   overlapping the next (fully serial), bit-equal, timed; K6 at 2048² with
   64 of 100 tied piles (the kernels line's row), and how many of a sweep's
   visits that case walks before its pile is placed (read from the plain
   solve's inputs); a 2048² ``step()`` with ``EXACT_PILES`` (K6 one launch
   a cycle);
18b. sediment: K11 against ``write_sediment_map_plain`` at 2048², 1024² and
   1025², with piles on the corners and edges (the tent of radius 15) and
   without, bit for bit; the kernel timed beside its bound and the plain
   version (the kernels line's K11@2048, K11@1024 and K11@1025 rows), the
   device operations of one ``write_sediment_map`` call (one K11 kernel),
   and one ``ErosionSim`` step at each size (K11 once a cycle);
18c. decay: K12 against ``deposit_and_decay_plain`` at 2048², 1024² and
   1025², with the accumulators and without, with flow and track written
   in place, bit for bit; the kernel timed beside its bound (bytes) and
   the plain version (the kernels line's K12@2048 and K12@1024 rows), the
   device operations of one ``deposit_and_decay`` call (one K12 kernel),
   and one ``ErosionSim`` step at each size (K12 once a cycle);
19. native IO: the Quickstart state checkpointed synchronously and queued
   (``async_``, ``flush``), restored equal, a corrupted payload refused;
20. sharded: a one-rank NCCL group, ``spatial_mesh`` and ``batch_mesh`` of
   1, the five sharded field ops at 2048² equal to the local ops, and
   ``tile_batch(mesh=)`` of 4 of config 5's tiles equal to ``tile_batch``;
   then the sharded erosion path on that group: ``ShardedErosionSim`` on
   the Quickstart's 2048² height for 3 cycles against ``ErosionSim`` from
   the same state and key, one ``EXACT_PILES`` sharded cycle against
   ``erosion_cycle``, ``make_sharded_tile_step`` at the flagship's 2048²
   defaults against ``make_tile_step``, the sharded mesh of the Quickstart
   tile against ``heightmap_mesh_overshoot``, a ``ShardedCheckpoint`` of the
   six maps saved, flushed and loaded, a ``TileServer(mesh=batch_mesh())``
   wave of config 5's 16 tiles at batch 4 against the server without a
   mesh (each equal; each path with its launch counts), and
   ``dryrun_multichip(1)``; then K5 on windows (2×2 and 4×1 splits of a
   wet 2048² pool, 3×3 of 2049², the sharded pool's schedule: one call a
   window a group of water steps on a halo of 8 cells a step, the drains
   carried in, the block kept), stitched and bit-equal to K5 on the whole
   grid, and
   K6 on the pile table of 64 of 100 tied piles at radius 15, bit-equal to
   its plain version and, committed, to K6 on the map (the kernels line's
   rows K5@window and K6@table);
20b. examples: the user journeys ``examples/*_torch.py``, each loaded by
   path and its ``main`` run into a temporary directory with the launch
   counts reset just before it: at its full size on the card (wall time and
   the launches it made; the kernels of its path must all launch), then at
   its FAST size on the card and on the CPU from the same seeds.  Outputs
   checked as the JAX examples' tests and asserts check them (full_tile:
   the PNGs, the ``saves/`` checkpoint, the restore drawn; serving: both
   waves served, a non-empty OBJ; multichip: the sharded checkpoint
   restored bit-equal), and the card's FAST saved maps, served tile (its
   heights and mesh) and sharded fields, restored field included, within
   ``CROSS_DEVICE_RTOL`` of the CPU's.  The multichip example runs on the
   sharded phase's one-rank NCCL group; its CPU run starts and ends a
   one-rank gloo group of its own after that group is gone;
21. profile: after every timed phase, one more run of each step path
   under ``torch.profiler`` (device busy time, idle share): the Quickstart
   ``ErosionSim.step()``, the flagship step, the 1025² sim step, config 5's
   ``tile_batch``, a ``TileServer`` wave, the vegetation and
   ``EXACT_PILES`` steps (the sharded sim step is profiled inside its
   phase, where its process group lives), and one call each of K6 on the
   disjoint, the chained and the 64 of 100 piles and of K6's table entry
   (the device time of the kernel beside the pile selection's sort);
22. pool trace: one wet K4 call and one wet K5 call at 2048² under
   ``torch.profiler``; each must run ``1 + WATER_STEPS`` device kernels
   (the init kernel and one fused launch per water step);
23. plan trace: one K1 call (Gauss-5 ×17), one K2 call (flow ×8) and one
   K3 call (the sim's thermal, one iteration) at 2048², one K3 call at
   1025², and K1 and K2 on the config-5 stack, under ``torch.profiler``;
   each must run the device kernels its plan gives (one a launch, whatever
   the stack's depth), and prints its device time beside its CUDA-event
   time and its host enqueue time; one fractal call at 2048² must run one
   device operation, K10.

Each path phase resets every launch count just before it runs and fails
if a kernel of its path was not launched (the Quickstart and the flagship
launch K10 once a step, config 5 once a batch): every erosion path runs K7 (the
sharded one K7@window), its record table, K8, K8's draw entry and K9 (the
Quickstart also K11 and K12 once a cycle), and
prints its step time and host syncs; a Quickstart cycle draws with at most
two K8 launches.  Prints the per-kernel JSON
line, then as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))

# The kernels must reproduce their plain versions bit for bit: both round
# every float32 op on its own, in the reference's order.
KERNEL_TOL = 0.0
# Port on the card vs port on the CPU: the particle math calls atan/sin,
# whose CUDA and CPU implementations differ by an ulp; BASELINE.md's bar.
CROSS_DEVICE_RTOL = 1e-4

# NVIDIA H100 SXM at the 700 W limit: the data sheet's HBM rate, and the
# float32 issue rate outside the tensor cores, 132 SMs x 128 lanes x
# 1.98 GHz.  The data sheet's 67 TFLOP/s counts a fused multiply-add as two
# operations; the kernels are built with -fmad=false (bit-equality with the
# reference forbids contraction), so each add, multiply, compare or min/max
# counted below is one instruction, and the peak for them is half that.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_OPS_PER_S = 132 * 128 * 1.98e9
# 32-bit integer issue rate: 64 INT32 lanes an SM (the Hopper white paper)
PEAK_I32_OPS_PER_S = 132 * 64 * 1.98e9

# Float32 operations per cell (arithmetic, compares, min/max), counted
# from the plain versions' source:
#   K1: k multiplies and k adds per cell per pass, two passes per iteration;
#   K2: flow step 25 + water step 10 per iteration, velocity and
#       normalise 14 once;
#   K3: six rectify pairs of 8 ops per 2x2 block per phase, 4 phases;
#   K4/K5: per phase 98 per active cell (a quarter of the cells: keys,
#       eligibility, rank, 4 sub-steps, demux, drains) plus 5 adds per
#       cell in the apply; 4 phases per water step.  A call whose gate is
#       closed does none of it.
#   K7: about 200 per step of a live particle: the 8 quantised reads (24),
#       argmin (14), the friction terms and steering (14), the velocity
#       terms (2 x 8 and atan and sin twice, ~20 each), the velocity
#       update and the payouts (~50); a dead particle's step writes its
#       event and computes nothing.
#   K8: 20 rounds of an add, a rotate (2 shifts and an or) and a xor, 5
#       key injections of 3 adds: 115 32-bit integer ops a pair.
#   K8@randint: what randint(split(k)) needs, not what the kernel does (it
#       re-derives each output's leaf key, 5 hashes an output): 2 hashes
#       an output (randint's higher and lower bits) and the combine (8),
#       plus the 6 split hashes the outputs share (split(k), then each
#       half's split).
K2_OPS_PER_ITER, K2_OPS_ONCE = 35, 14
K3_OPS_PER_ITER = 48
POOL_OPS_PER_ITER = 4 * (98 / 4 + 5)
K7_OPS_PER_LIVE_STEP = 200
K8_OPS_PER_PAIR = 115
K8_OPS_PER_COMBINE, K8_RANDINT_SPLIT_HASHES = 8, 6


def _check(cond, msg):
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def _time_ms(fn, reps, warm=True):
    import torch

    if warm:
        fn()
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


def _bound(nbytes, ops, ops_per_s=PEAK_F32_OPS_PER_S):
    """(least ms the card needs, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def _counters():
    """Every kernel wrapper and entry with a launch count, by row key."""
    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import pool_cuda as PC
    from noize_tpu_torch.erosion import scatter_cuda as SCU
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.ops.cuda import flow as FC
    from noize_tpu_torch.ops.cuda import fractal as FK
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.cuda import thermal as TC

    return {
        "K1": SC.separable_chain, "K1@tile": SC.tile_chain, "K1@short": SC.short_chain,
        "K1@rss": SC.root_sum_squares_chain, "K2": FC.flow_map_fused,
        "K3": TC.thermal_erosion_fused, "K4": PC.pool_automata_cuda,
        "K5": PC.pool_automata_full_cuda, "K6": PL.exact_piles,
        "K5@window": PC.pool_automata_window, "K6@table": PL.solve_pile_table,
        "K7": DC.descend_steps, "K7@window": DC.descend_steps_window,
        "K7@records": DC.step_records, "K8": prng.threefry2x32,
        "K8@randint": prng._randint_cuda, "K9": SCU.scatter_in_order,
        "K10": FK.fractal_fused, "K11": SK.write_sediment_cuda,
        "K12": DK.deposit_and_decay_cuda,
        "#1": SC.fused_separable_chain, "#2": SC.fused_separable_chain_rows,
        "#3": FC.flow_map_pallas, "#6": PC.pool_automata_pallas,
        "#7": PC.pool_automata_pallas_pair, "#8": PC.pool_automata_pallas_quad,
        "#9": PC.pool_automata_pallas_pair_fused, "#10": PC.pool_automata_pallas_mega,
    }


def _reset_counts():
    from noize_tpu_torch.erosion import pool_cuda as PC
    from noize_tpu_torch.erosion import sediment_cuda as SK

    for w in _counters().values():
        w.launches = 0
    SK.write_sediment_cuda.tent_launches = 0
    PC.pool_automata_cuda.wet_calls = None
    PC.pool_automata_full_cuda.wet_calls = None
    PC.pool_automata_window.wet_calls = None


def _read_counts():
    return {k: w.launches for k, w in _counters().items()}


def device_phase():
    import torch

    _check(torch.cuda.is_available(), "no CUDA device")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"device: {name} (torch {torch.__version__}, cuda {torch.version.cuda}, "
          f"count {torch.cuda.device_count()})")
    print(smi)
    # no TF32 anywhere: the plain versions and the cuDNN yardstick are float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return name


def build_phase():
    """The CUDA kernels (one nvcc a source) and, beside them, the native IO
    runtime (g++), so no timed phase pays for a first-use build."""
    import concurrent.futures

    from noize_tpu_torch import _cuda, native

    t0 = time.perf_counter()
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        host = pool.submit(native.available)
        path = _cuda.build()
        _cuda.library()
        _check(host.result(), "the native IO runtime did not load")
    srcs = sorted(p.name for p in _cuda.CSRC.glob("*.cu"))
    _check({"descent.cu", "threefry.cu", "scatter.cu", "fractal.cu", "sediment.cu",
            "decay.cu"} <= set(srcs), f"K7, K8, K9, K10, K11 or K12 source missing: {srcs}")
    print(f"build: {path.relative_to(HERE)} ({len(srcs)} sources in parallel: "
          f"{', '.join(srcs)}; K7 descent.cu, K8 threefry.cu, K9 scatter.cu, K10 "
          "fractal.cu, K11 sediment.cu, K12 decay.cu) and "
          f"{native.library_path().relative_to(HERE)} in {time.perf_counter() - t0:.1f} s")


def _conv_chain(taps, iterations, taps_z=None, factor=1.0):
    """K1's yardstick: the same chain as cuDNN convolutions, one call per
    pass (2·iterations calls), replicate padding; ``factor`` is folded into
    the weights (the sums then round differently)."""
    import torch

    taps_z = taps if taps_z is None else taps_z
    k, kz = len(taps), len(taps_z)
    t = torch.as_tensor(taps, dtype=torch.float32, device="cuda") * factor
    tz = torch.as_tensor(taps_z, dtype=torch.float32, device="cuda") * factor
    cx = torch.nn.Conv2d(1, 1, (1, k), padding=(0, k // 2), padding_mode="replicate",
                         bias=False).cuda()
    cz = torch.nn.Conv2d(1, 1, (kz, 1), padding=(kz // 2, 0), padding_mode="replicate",
                         bias=False).cuda()
    with torch.no_grad():
        cx.weight.copy_(t.view(1, 1, 1, k))
        cz.weight.copy_(tz.flip(0).view(1, 1, kz, 1))  # conv_z's flipped taps

    def run(x):
        with torch.no_grad():
            y = x[:, None] if x.dim() == 3 else x[None, None]  # a stack is the batch
            for _ in range(iterations):
                y = cz(cx(y))
            return y[:, 0] if x.dim() == 3 else y[0, 0]
    return run


class Rows:
    """The kernels JSON line: one row per TPU kernel, K5 at 2049², K5 and
    K3 at 1025² (odd sizes), K1 with each filter's taps and the presets'
    Gauss chains (K1@short; Sobel3_2D on K1@rss), K1@rss on ``edge_2d``'s
    Prewitt magnitude, K1 and K2 on the
    config-5 stack, K6 (the exact pile solver, no TPU kernel's port), K5 on
    a window and K6 on a pile table (the sharded cycle's), and K7 (particle
    descent), K7 on a window, K7's record table, K8 (threefry), K8's draw
    entry and K9 (the in-order event scatter), K10 (the fBm: the
    flagship's, config 5's stack, configs 1 and 6), K11 (the sediment
    write-back) and K12 (the deposit's adds and the track/flow decay), none
    a TPU kernel's port, filled as the phases run."""

    def __init__(self):
        self.rows = {}
        self.launches = {}
        self._plain_ms = {}

    def compare(self, key, name, source, replaces, got, kernel, plain, plain_key,
                reps, nbytes, ops, library=None, ops_per_s=PEAK_F32_OPS_PER_S):
        """Hold ``got`` (the kernel's output) against the plain version's,
        then time the kernel, the plain version (once per ``plain_key``)
        and ``library``."""
        import torch

        want = plain()
        torch.cuda.synchronize()
        err = max(_max_abs(g, w) for g, w in zip(got, want))
        _check(err <= KERNEL_TOL, f"{name} disagrees with its plain version: {err}")
        ms = _time_ms(kernel, reps)
        if plain_key not in self._plain_ms:
            self._plain_ms[plain_key] = _time_ms(plain, max(1, reps // 5), warm=False)
        plain_ms = self._plain_ms[plain_key]
        library_ms = None if library is None else _time_ms(library, reps)
        bound_ms, bound_by = _bound(nbytes, ops, ops_per_s)
        print(f"{name}: max_abs_err {err!r} (tol {KERNEL_TOL}), kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})"
              + ("" if library_ms is None else f", library {library_ms:.4f} ms"))
        self.rows[key] = {"name": name, "route": "cuda", "source": source,
                          "replaces": replaces, "launches": None,
                          "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                          "bound_ms": bound_ms, "bound_by": bound_by,
                          "library_ms": library_ms}
        del want

    def set_launches(self, counts):
        """Launches of each row's kernel on the path that runs it."""
        self.launches.update(counts)

    def line(self):
        order = (["#1", "#2", "#3", "#4", "#5", "#6", "#7", "#8", "#9", "#10", "K5", "K5@1025",
                  "K3@1025"] + [f"K1:{f}" for f in FILTERS]
                 + [f"K1:{g}x{n}" for g, n in PRESET_CHAINS]
                 + ["K1@rss", "K1@stack", "K2@stack", "K6", "K5@window", "K6@table", "K7",
                    "K7@window", "K7@records", "K8", "K8@randint", "K9", "K10", "K10@stack",
                    "K10@config1", "K10@config6", "K11@2048", "K11@1024", "K11@1025", "K12@2048",
                    "K12@1024"])
        _check(set(self.rows) == set(order), f"rows {sorted(self.rows)}")
        for k in order:
            _check(self.launches.get(k, 0) > 0, f"{k} was launched on no path")
            self.rows[k]["launches"] = self.launches[k]
        return json.dumps({"kernels": [self.rows[k] for k in order]})


def _inputs(res):
    """Blurred 13-octave noise at ``res``² and a wet pool on it (seeded at
    U(0, 0.02) on half the cells, dry cells between so drains fire)."""
    import torch

    from noize_tpu_torch.ops.cuda.stencil import separable_chain_plain
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.ops.kernels import gaussian_taps

    noise = fractal(res, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                    noise_size=1700.0, device="cuda")
    blurred = separable_chain_plain(noise, gaussian_taps(1.0, 5), 17)
    g = torch.Generator(device="cuda").manual_seed(0)
    seed = torch.rand((res, res), generator=g, device="cuda")
    pool = torch.where(seed < 0.5, seed * 0.02, torch.zeros_like(seed))
    return noise, blurred, pool


#: the non-Gauss KernelFilterStage filters, each timed on K1 at 2048²
FILTERS = ("Smooth3", "Sobel3Horizontal", "Sobel3Vertical", "Sobel3_2D",
           "Prewitt3Horizontal", "Prewitt3Vertical")
#: the BasicDemo presets' Gauss calls (app/presets.py: GAUSS_LF, GAUSS_HF)
PRESET_CHAINS = (("Gauss9_S1", 2), ("Gauss3_S1", 3))

SRC = {
    "K1": "noize_tpu_torch/csrc/stencil.cu", "K2": "noize_tpu_torch/csrc/flow.cu",
    "K3": "noize_tpu_torch/csrc/thermal.cu", "K4": "noize_tpu_torch/csrc/pool.cu",
    "K5": "noize_tpu_torch/csrc/pool.cu", "K6": "noize_tpu_torch/csrc/piles.cu",
    "K7": "noize_tpu_torch/csrc/descent.cu", "K8": "noize_tpu_torch/csrc/threefry.cu",
    "K9": "noize_tpu_torch/csrc/scatter.cu", "K10": "noize_tpu_torch/csrc/fractal.cu",
    "K11": "noize_tpu_torch/csrc/sediment.cu", "K12": "noize_tpu_torch/csrc/decay.cu",
}
#: what K10 stands in for: no TPU kernel, the reference's XLA-fused fBm
FBM_REF = ("none: the fBm, noize_tpu/ops/fractal.py:106-155 with ops/noise.py's bases, "
           "XLA-fused on the TPU")
TPU = "noize_tpu/ops/pallas/"
POOL_TPU = "noize_tpu/erosion/pool_pallas.py"


def kernel_phase(rows):
    """The five kernels against their plain versions; entries of the ten
    TPU kernels driven once (the entries path) and held the same way."""
    import torch

    from noize_tpu_torch.app.flagship import default_meta, default_settings
    from noize_tpu_torch.erosion import pool as PO
    from noize_tpu_torch.erosion import pool_cuda as PC
    from noize_tpu_torch.ops import flow as FL
    from noize_tpu_torch.ops import thermal as TH
    from noize_tpu_torch.ops.cuda import flow as FC
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
    from noize_tpu_torch.ops.kernels import gaussian_taps

    meta, settings = default_meta(), default_settings()
    res = meta.generator_res
    cells = res * res
    steps = settings.WATER_STEPS
    hw_ratio = float(meta.tile_size) / float(meta.height)
    noise, blurred, pool = _inputs(res)
    taps = gaussian_taps(1.0, 5)
    k1_bytes, k1_ops = 8 * cells, 2 * 2 * len(taps) * 17 * cells
    k2_bytes, k2_ops = 8 * cells, (K2_OPS_PER_ITER * 8 + K2_OPS_ONCE) * cells
    pool_bytes, pool_ops = 16 * cells, POOL_OPS_PER_ITER * steps * cells
    _check(bool((pool >= PO.MIN_WATER).any()), "wet grid below the gate")
    conv = _conv_chain(taps, 17)
    library = lambda: (conv(noise),)  # noqa: E731
    lib_err = _max_abs(conv(noise), SC.separable_chain_plain(noise, taps, 17))
    print(f"K1 yardstick (cuDNN conv ×34) vs plain: max_abs_err {lib_err!r} (sum order differs)")

    # the entries path: every entry once, counts reset before, read after
    _reset_counts()
    got = {
        "#1": (SC.fused_separable_chain(noise, taps, 17),),
        "#3": (FC.flow_map_pallas(blurred, 8),),
        "#6": PC.pool_automata_pallas(blurred, pool, steps, True),
        "#7": PC.pool_automata_pallas_pair(blurred, pool, steps, True),
        "#8": PC.pool_automata_pallas_quad(blurred, pool, steps, True),
        "#9": PC.pool_automata_pallas_pair_fused(blurred, pool, steps, True),
    }
    k4_entries = PC.pool_automata_cuda.launches
    quad = PO.pool_automata_quad(blurred, pool, steps, True)
    torch.cuda.synchronize()
    counts = _read_counts()
    quad_k4 = counts["K4"] - k4_entries
    print(f"entries path launches {counts}; pool_automata_quad launched K4 {quad_k4} time(s)")
    for key in got:
        _check(counts[key] == 1, f"entry {key} launched {counts[key]} times")
    # #7, #8 and #9 run K4 once each, and the quadrant entry of erosion.pool
    _check(quad_k4 == 1 and counts["K4"] == 4, f"K4 launched {counts['K4']} times")
    rows.set_launches({k: counts[k] for k in got})
    rows.set_launches({"#8": counts["#8"] + quad_k4})

    plain_k1 = lambda: (SC.separable_chain_plain(noise, taps, 17),)  # noqa: E731
    plain_k2 = lambda: (FL.flow_map(blurred, 8),)  # noqa: E731
    plain_pair = lambda: PO.pool_automata(blurred, pool, steps, True)  # noqa: E731
    plain_full = lambda: PO._pool_automata_fullgrid(blurred, pool, steps, True)  # noqa: E731

    rows.compare("#1", "#1 fused_separable_chain (K1)", SRC["K1"], TPU + "stencil.py:66",
                 got["#1"], lambda: (SC.fused_separable_chain(noise, taps, 17),),
                 plain_k1, "k1", 20, k1_bytes, k1_ops, library)
    rows.compare("#2", "#2 fused_separable_chain_rows / gauss_chain (K1)", SRC["K1"],
                 TPU + "stencil.py:153", (SC.separable_chain(noise, taps, 17),),
                 lambda: (SC.separable_chain(noise, taps, 17),), plain_k1, "k1", 20,
                 k1_bytes, k1_ops, library)
    rows.compare("#3", "#3 flow_map_pallas (K2)", SRC["K2"], TPU + "flow_pl.py:31",
                 got["#3"], lambda: (FC.flow_map_pallas(blurred, 8),), plain_k2, "k2", 20,
                 k2_bytes, k2_ops)
    rows.compare("#4", "#4 flow_map_fused (K2)", SRC["K2"], TPU + "flow_pl.py:99",
                 (FC.flow_map_fused(blurred, 8),), lambda: (FC.flow_map_fused(blurred, 8),),
                 plain_k2, "k2", 20, k2_bytes, k2_ops)
    thermal = (blurred, settings.TALUS, settings.THERMAL_STEP, hw_ratio, settings.THERMAL_CYCLES)
    got_k3 = thermal_erosion_fused(*thermal)
    n_changed = int((got_k3 != blurred).sum())
    print(f"K3 2048²: {n_changed} of {cells} cells changed")
    _check(n_changed > 0, "K3 changed no cell")
    rows.compare("#5", "#5 thermal_erosion_fused (K3)", SRC["K3"], TPU + "thermal_pl.py:36",
                 (got_k3,), lambda: (thermal_erosion_fused(*thermal),),
                 lambda: (TH.thermal_erosion(*thermal),),
                 "k3", 20, 8 * cells, K3_OPS_PER_ITER * settings.THERMAL_CYCLES * cells)
    rows.compare("#6", "#6 pool_automata_pallas (K5, 2048² wet)", SRC["K5"],
                 POOL_TPU + ":30", got["#6"],
                 lambda: PC.pool_automata_pallas(blurred, pool, steps, True), plain_full,
                 "full2048", 10, pool_bytes, pool_ops)
    for key, name, line, fn in (
            ("#7", "pool_automata_pallas_pair", 94, PC.pool_automata_pallas_pair),
            ("#8", "pool_automata_pallas_quad / pool_automata_quad", 229,
             PC.pool_automata_pallas_quad),
            ("#9", "pool_automata_pallas_pair_fused", 324,
             PC.pool_automata_pallas_pair_fused)):
        rows.compare(key, f"{key} {name} (K4, wet)", SRC["K4"], f"{POOL_TPU}:{line}", got[key],
                     lambda fn=fn: fn(blurred, pool, steps, True), plain_pair, "pair", 10,
                     pool_bytes, pool_ops)
    quad_err = max(_max_abs(g, w) for g, w in zip(quad, plain_pair()))
    _check(quad_err <= KERNEL_TOL, f"pool_automata_quad disagrees with pool_automata: {quad_err}")
    quad_ms = _time_ms(lambda: PO.pool_automata_quad(blurred, pool, steps, True), 10)
    print(f"#8 pool_automata_quad (erosion.pool, K4, 2048² wet): max_abs_err {quad_err!r} "
          f"(tol {KERNEL_TOL}) against pool_automata, {quad_ms:.4f} ms")
    del quad
    mega = PC.pool_automata_pallas_mega(blurred, pool, steps, True)
    rows.compare("#10", "#10 pool_automata_pallas_mega / pool_automata_cuda (K4, wet)",
                 SRC["K4"], POOL_TPU + ":568", mega,
                 lambda: PC.pool_automata_cuda(blurred, pool, steps, True), plain_pair, "pair",
                 10, pool_bytes, pool_ops)
    wet_pool, wet_drains = mega
    n_drain = int((wet_drains > 0).sum())
    n_moved = int((wet_pool != pool).sum())
    print(f"K4 wet grid: {n_moved} cells changed, {n_drain} drain cells, "
          f"{int((pool >= PO.MIN_WATER).sum())} cells at the gate")
    _check(n_drain > 0 and n_moved > 0, "K4 wet grid ran no phase")

    # dry: the gates must return the pool unchanged and no drains
    dry = pool * (PO.MIN_WATER * 0.99 / float(pool.max()))
    for w in (PC.pool_automata_cuda, PC.pool_automata_full_cuda):
        before = _wet(w)
        dp, dd = w(blurred, dry, steps, True)
        torch.cuda.synchronize()
        _check(torch.equal(dp, dry) and not bool(dd.any()),
               f"{w.__name__} dry gate is not a fixed point")
        _check(_wet(w) == before, f"{w.__name__} dry gate flag raised")
    print("K4, K5 dry grid: pool unchanged, drains zero, gate closed")
    del noise, blurred, pool, dry, got, mega, wet_pool, wet_drains

    # K5 at an odd size: Unity's 2^n + 1 heightmaps
    res5 = res + 1
    _, blurred5, pool5 = _inputs(res5)
    got5 = PC.pool_automata_full_cuda(blurred5, pool5, steps, True)
    rows.compare("K5", "K5 pool_automata_full_cuda (2049² wet)", SRC["K5"], POOL_TPU + ":30",
                 got5, lambda: PC.pool_automata_full_cuda(blurred5, pool5, steps, True),
                 lambda: PO._pool_automata_fullgrid(blurred5, pool5, steps, True), "full2049",
                 10, 16 * res5 * res5, POOL_OPS_PER_ITER * steps * res5 * res5)
    _check(int((got5[1] > 0).sum()) > 0, "K5 wet grid ran no drain")
    del blurred5, pool5, got5


def _fbm_cost(cells, noise_type, octaves):
    """(bytes, f32 ops) of an fBm: the output written once (nothing is
    read), K10's counted operations a cell (``OPS_PER_OCTAVE``)."""
    from noize_tpu_torch.ops.cuda import fractal as FK

    return 4 * cells, cells * (FK.OPS_PER_OCTAVE[noise_type] * octaves + FK.OPS_PER_CELL)


def fractal_gain_phase(rows):
    """The fractal at 2048², 13 Simplex octaves, on the card against the
    CPU at hurst 0.9 (a gain PyTorch's exp2 rounds an ulp off the
    reference's; the port's host-scalar ``f32.exp2`` gives both devices the
    reference's) and at 0.4, and 13 Perlin octaves; CUDA-event times of the
    card's call.  Then K10 against its plain version on the card, bit for
    bit: every basis, the flagship's fBm (the kernels line's K10 row), a
    detuned call, a window."""
    import numpy as np

    from noize_tpu_torch.ops import f32 as F32
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import fractal as FK

    out = []
    for noise_type, hurst in (("Simplex", 0.9), ("Simplex", 0.4), ("Perlin", 0.4)):
        kw = dict(noise_type=noise_type, hurst=hurst, octaves=13, noise_size=1700.0)
        before = FK.fractal_fused.launches
        card = FR.fractal(2048, 0.0, 0.0, device="cuda", **kw)
        _check(FK.fractal_fused.launches == before + 1, "a fractal call is not one K10 launch")
        cpu = FR.fractal(2048, 0.0, 0.0, device="cpu", **kw)
        _check(card.shape == (2048, 2048) and bool(card.isfinite().all()),
               f"{noise_type} fractal at hurst {hurst} not finite")
        err = _max_abs(card.cpu(), cpu)
        _check(err <= KERNEL_TOL, f"{noise_type} fractal at hurst {hurst}: card against CPU "
               f"{err}")
        ms = _time_ms(lambda kw=kw: FR.fractal(2048, 0.0, 0.0, device="cuda", **kw), 20)
        out.append(f"{noise_type} hurst {hurst}: G {F32.exp2(-np.float32(hurst))}, card "
                   f"against CPU max_abs_err {err!r}, card {ms:.4f} ms")
    print("fractal 2048² ×13 — " + "; ".join(out))

    def held(what, window, origin, **kw):
        got = FR.fractal_window(*window, *origin, device="cuda", **kw)
        _same_bits(what, (got,), (FR.fractal_window_plain(*window, *origin, device="cuda",
                                                           **kw),))
        _check(bool(got.isfinite().all()) and float(got.max() - got.min()) > 0,
               f"{what}: not finite or constant")
        return got

    whole = (0, 0, 2048, 2048)
    bases = []
    for kind in FR.NOISE_TYPES:
        kw = dict(noise_type=kind, hurst=0.5, octaves=4, noise_size=300.0)
        held(f"K10 {kind}", whole, (1234.0, -777.0), **kw)
        ms = _time_ms(lambda kw=kw: FR.fractal(2048, 1234.0, -777.0, device="cuda", **kw), 10)
        bases.append(f"{kind} {ms:.4f} ms")
    print("K10 2048², 4 octaves, each basis bit-equal to its plain version: "
          + ", ".join(bases))
    flagship = dict(noise_type="Simplex", hurst=0.4, octaves=13, noise_size=1700.0)
    held("K10 Simplex ×13, hurst 0.9", whole, (0.0, 0.0), **{**flagship, "hurst": 0.9})
    held("K10 detuned Simplex ×13", whole, (5.0, 7.0), noise_type="Simplex", hurst=0.87,
         octaves=13, stepdown=1.9607, detune_rate=0.04, noise_size=187.0)
    tile = FR.fractal(2048, 10.0, 20.0, device="cuda", **flagship)
    win = held("K10 window", (300, 1000, 512, 768), (10.0, 20.0), **flagship)
    _same_bits("K10 window against the whole tile", (win,),
               (tile[300:812, 1000:1768].contiguous(),))
    print("K10: Simplex ×13 at hurst 0.9, a detuned call (stepdown 1.9607, detune 0.04) and "
          "a 512 × 768 window at (300, 1000) bit-equal to the plain version; the window equal "
          "to that slice of the whole tile")
    got = FR.fractal(2048, 0.0, 0.0, device="cuda", **flagship)
    nbytes, ops = _fbm_cost(2048 * 2048, "Simplex", 13)
    rows.compare("K10", "K10 fractal, 2048² Simplex ×13 (the flagship's fBm)", SRC["K10"],
                 FBM_REF, (got,),
                 lambda: (FR.fractal(2048, 0.0, 0.0, device="cuda", **flagship),),
                 lambda: (FR.fractal_window_plain(*whole, 0.0, 0.0, device="cuda",
                                                  **flagship),),
                 "k10", 20, nbytes, ops)


def config1_phase(rows):
    """``bench.py``'s config 1 (bench.py:244-253): the 512² Perlin fBm, 13
    octaves, hurst 0.4, noise size 1700, at a seeded origin, through
    ``fractal``: one K10 launch, against the plain version on the card
    (row K10@config1) and the CPU."""
    import numpy as np

    from noize_tpu_torch.ops import fractal as FR

    res = 512
    x = float(np.random.default_rng(1).integers(0, 1000))
    kw = dict(noise_type="Perlin", octaves=13, hurst=0.4, noise_size=1700.0)
    FR.fractal(res, x, 0.0, device="cuda", **kw)
    _reset_counts()
    h, wall_ms = _timed(lambda: FR.fractal(res, x, 0.0, device="cuda", **kw))
    counts = _read_counts()
    _check(counts["K10"] == 1 and sum(counts.values()) == 1,
           f"config 1 is not one K10 launch: {counts}")
    _check(tuple(h.shape) == (res, res) and bool(h.isfinite().all()),
           "config 1 misshapen or not finite")
    err = _max_abs(h.cpu(), FR.fractal(res, x, 0.0, device="cpu", **kw))
    _check(err <= KERNEL_TOL, f"config 1: card against CPU {err}")
    nbytes, ops = _fbm_cost(res * res, "Perlin", 13)
    rows.compare("K10@config1", f"K10 fractal, config 1: {res}² Perlin ×13 "
                 "(bench.py:244-253)", SRC["K10"], FBM_REF, (h,),
                 lambda: (FR.fractal(res, x, 0.0, device="cuda", **kw),),
                 lambda: (FR.fractal_window_plain(0, 0, res, res, x, 0.0, device="cuda",
                                                  **kw),),
                 "k10c1", 50, nbytes, ops)
    rows.set_launches({"K10@config1": counts["K10"]})
    ms = rows.rows["K10@config1"]["ms"]
    print(f"config 1: {res}² Perlin ×13 at x {x}: one K10 launch, {wall_ms:.3f} ms host to "
          f"sync, {ms:.4f} ms by CUDA events ({res * res / ms / 1e6:.3f} Gcells/s); card "
          f"against CPU max_abs_err {err!r}")


def config6_phase(rows):
    """``bench.py``'s config 6 (bench.py:823-865), the 8192² field on one
    card: Simplex ×13 (K10), Gauss-5 ×17 (K1), thermal at
    ``ErosionSettings()``'s cycles, talus and step (K3), flow ×8 (K2).  Each
    kernel launched once, each bit-equal to its plain version at 8192²,
    each stage timed, the peak device memory; 256² windows of the fractal
    against ``fractal_window`` on the CPU (no CPU run at 8192²)."""
    import numpy as np
    import torch

    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.ops import flow as FL
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops import thermal as TH
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
    from noize_tpu_torch.ops.kernels import gaussian_taps

    t0 = time.perf_counter()
    res, es = 8192, ErosionSettings()
    x = float(np.random.default_rng(6).integers(0, 1000))
    kw = dict(noise_type="Simplex", octaves=13, hurst=0.4, noise_size=1700.0)
    thermal = (es.TALUS, es.THERMAL_STEP, 1.0, es.THERMAL_CYCLES)

    def stages():
        h = FR.fractal(res, x, 0.0, device="cuda", **kw)
        b = SC.gauss_chain(h, 5, 1.0, 17)
        t = thermal_erosion_fused(b, *thermal)
        return h, b, t, flow_map_fused(t, iterations=8)

    stages()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_counts()
    (h, b, t, f), wall_ms = _timed(stages)
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    counts = _read_counts()
    for k in ("K10", "K1", "K3", "K2"):
        _check(counts[k] == 1, f"config 6 launched {k} {counts[k]} times")
    for name, v in (("fractal", h), ("blur", b), ("thermal", t), ("flow", f)):
        _check(tuple(v.shape) == (res, res) and bool(v.isfinite().all()),
               f"config 6 {name} misshapen or not finite")
    _check(int((t != b).sum()) > 0, "config 6: thermal changed no cell")
    pipe_ms = _time_ms(stages, 3)
    stage_ms = {
        "K10 fBm": _time_ms(lambda: FR.fractal(res, x, 0.0, device="cuda", **kw), 5),
        "K1 Gauss-5 ×17": _time_ms(lambda: SC.gauss_chain(h, 5, 1.0, 17), 5),
        "K3 thermal": _time_ms(lambda: thermal_erosion_fused(b, *thermal), 5),
        "K2 flow ×8": _time_ms(lambda: flow_map_fused(t, iterations=8), 5),
    }
    _same_bits("K1 at 8192²", (b,), (SC.separable_chain_plain(h, gaussian_taps(1.0, 5), 17),))
    _same_bits("K3 at 8192²", (t,), (TH.thermal_erosion(b, *thermal),))
    _same_bits("K2 at 8192²", (f,), (FL.flow_map(t, 8),))
    errs = []
    for r0, c0 in ((0, 0), (4000, 5000)):
        cpu = FR.fractal_window(r0, c0, 256, 256, x, 0.0, device="cpu", **kw)
        errs.append(_max_abs(h[r0:r0 + 256, c0:c0 + 256].cpu(), cpu))
        _check(errs[-1] <= KERNEL_TOL, f"config 6 window at {(r0, c0)}: card against CPU "
               f"{errs[-1]}")
    nbytes, ops = _fbm_cost(res * res, "Simplex", 13)
    rows.compare("K10@config6", f"K10 fractal, config 6: {res}² Simplex ×13 "
                 "(bench.py:823-865)", SRC["K10"], FBM_REF, (h,),
                 lambda: (FR.fractal(res, x, 0.0, device="cuda", **kw),),
                 lambda: (FR.fractal_window_plain(0, 0, res, res, x, 0.0, device="cuda",
                                                  **kw),),
                 "k10c6", 5, nbytes, ops)
    rows.set_launches({"K10@config6": counts["K10"]})
    print(f"config 6: {res}² at x {x}, noise13 + gauss5×17 + thermal + flow8: one launch each "
          f"of K10, K1, K3 and K2, each bit-equal to its plain version; host to sync "
          f"{wall_ms:.3f} ms (first timed run), {pipe_ms:.3f} ms by CUDA events "
          f"({res * res / pipe_ms / 1e6:.3f} Gcells/s); stages "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in stage_ms.items())
          + f"; peak device memory {peak_gb:.3f} GB; 256² windows at (0, 0) and (4000, 5000) "
          f"card against CPU max_abs_err {errs}; phase {time.perf_counter() - t0:.1f} s")
    del h, b, t, f


def quickstart_phase(rows):
    """README.md's Quickstart at 2048² through the port: the main path."""
    import torch

    from noize_tpu_torch.core.stageio import GeneratorData, MeshStageData
    from noize_tpu_torch.core.store import PipelineStateManager
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import (FlowMapStage, MeshTileReferenceDataStage,
                                                 NoiseStage, StageGaussianBlur,
                                                 WriteGeneratorContextStage)

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    with tempfile.TemporaryDirectory() as saves:
        _reset_counts()
        sm = PipelineStateManager(saves, "world", "v1")
        pipe = Pipeline([
            NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
            StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
            FlowMapStage(iterations=8),
            WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
        ], state_manager=sm)
        out, pipe_ms = timed(lambda: pipe.run(
            GeneratorData(uuid="t00", resolution=2048, xpos=0, zpos=0)))
        sim = ErosionSim(out.data, state_manager=sm)
        _, step_ms = timed(sim.step)
        _, save_ms = timed(sim.save_erosion_state)
        mesh_pipe = Pipeline([MeshTileReferenceDataStage("TERRAIN_HEIGHT")], state_manager=sm)
        r = 2016
        req = MeshStageData(uuid="t00", resolution=r, inputResolution=2048, marginPix=16,
                            tileHeight=1000, tileSize=float(r), xpos=0, zpos=0)
        mesh_out, mesh_ms = timed(lambda: mesh_pipe.run(req))
        counts = _read_counts()
        wet = _wet(_counters()["K4"])
        names = [sim._buffer_name(a) for a in
                 ("TERRAIN_HEIGHT", "PARTERO_WATERMAP_STREAM", "PARTERO_WATERMAP_POOL")]
        fresh = PipelineStateManager(saves, "world", "v1")
        for n in names:
            back = fresh.get_buffer(n)
            _check(back.device.type == "cuda" and back.dtype == torch.float32,
                   f"restored {n} on {back.device} as {back.dtype}")
            _check(torch.equal(back, sm.get_buffer(n)), f"restored {n} differs")
    for key in ("K1", "K2", "K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9", "K10",
                "K11", "K12"):
        _check(counts[key] > 0, f"{key} was not launched on the Quickstart path")
    _check(counts["K10"] == 1, f"the Quickstart's NoiseStage launched K10 {counts['K10']} times")
    cycles = sim.settings.CYCLES
    for key in ("K7", "K7@records", "K9", "K11", "K12"):
        _check(counts[key] == cycles, f"{key} launched {counts[key]} times in {cycles} cycles")
    _check(counts["K8"] + counts["K8@randint"] <= 2 * cycles,
           f"the spawn's draws took {counts['K8']} + {counts['K8@randint']} K8 launches in "
           f"{cycles} cycles (at most 2 a cycle)")
    _check(len(sim.syncs) == 2 * cycles and "descent.alive" not in sim.syncs,
           f"Quickstart step host syncs {sim.syncs}")
    for k, v in (("height", sim.height_map), ("pool", sim.pool_map), ("stream", sim.stream_map),
                 ("flow map", out.data)):
        _check(tuple(v.shape) == (2048, 2048), f"{k} shape {tuple(v.shape)}")
        _check(bool(torch.isfinite(v).all()), f"{k} not finite")
    _check(float(sim.stream_map.abs().max()) > 0, "erosion left no stream")
    m = mesh_out.mesh
    _check(tuple(m.positions.shape) == ((r + 1) ** 2, 3), "mesh positions shape")
    _check(tuple(m.indices.shape) == (6 * r * r,), "mesh indices shape")
    for f in ("positions", "normals", "tangents", "uvs"):
        _check(bool(torch.isfinite(getattr(m, f)).all()), f"mesh {f} not finite")
    syncs = len(sim.syncs)
    _, step2_ms = timed(sim.step)  # the first step pays the process's first uses
    _check(len(sim.syncs) == 2 * cycles, f"second Quickstart step host syncs {sim.syncs}")
    print(f"quickstart 2048²: pipeline {pipe_ms:.3f} ms, sim step (3 cycles) {step_ms:.3f} ms, "
          f"a second step {step2_ms:.3f} ms, save {save_ms:.3f} ms, mesh {mesh_ms:.3f} ms; "
          f"host syncs {syncs}; K4 gate open in {wet} of {counts['K4']} calls; checkpoint "
          "restored equal")
    print(f"quickstart launches {counts}")
    rows.set_launches({"#2": counts["K1"], "#4": counts["K2"], "#5": counts["K3"],
                       "#10": counts["K4"], "K7": counts["K7"], "K8": counts["K8"],
                       "K7@records": counts["K7@records"], "K8@randint": counts["K8@randint"],
                       "K9": counts["K9"]})
    PROFILES.append(("Quickstart ErosionSim.step() 2048² (3 cycles)", sim.step))
    return sim


def _raw(t):
    """A tensor's bits: float32 as int32 (signs of zero, NaN payloads)."""
    import torch

    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _flat(out):
    """K7's result (particles, cells, d_track, d_pool, d_sed) as one tuple."""
    return tuple(out[0]) + tuple(out[1:])


def _same_bits(what, got, want):
    import torch

    for i, (a, b) in enumerate(zip(got, want)):
        _check(a.dtype == b.dtype and a.shape == b.shape and torch.equal(_raw(a), _raw(b)),
               f"{what}: output {i} differs from its plain version")


def _k7_cost(parts, out, steps, plants):
    """(bytes, f32 ops) K7 needs for this run's data: each live step's table
    reads (11 floats, 12 with plants) and ~200 operations, every step's
    event written (20 bytes), the particle fields read and written."""
    live = int((out[0].age.long() - parts.age.long()).sum()) + int(parts.alive.sum())
    n = parts.row.numel()
    return live * 4 * (12 if plants else 11) + steps * n * 20 + 2 * 29 * n, \
        live * K7_OPS_PER_LIVE_STEP


def _k9_cost(n_events, size, maps=3):
    """(bytes, f32 ops) of the scatter into zeros: each event's cell (8
    bytes) and deltas read once, each map written once, an add an event and
    map."""
    return n_events * (8 + 4 * maps) + 4 * maps * size, n_events * maps


def _device_ops_of_last_call(fn, only=None, calls=8):
    """(name, device µs) of each device operation (kernel, fill, copy) of
    one of ``calls`` calls of ``fn`` — of those whose names contain one of
    ``only``, when given — in one ``torch.profiler`` trace: a host-to-device
    copy, which ``fn`` never makes, runs before each call and delimits it.
    The trace may miss what runs while it starts, and may drop records
    (markers included), so the call read is the last one whose operations
    another call of the trace ran too (the calls are the same); a trace
    with no two such calls is taken again, up to three times."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    one = torch.ones(1)
    mark = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for attempt in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                mark.copy_(one)
                fn()
                torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(ops) if "HtoD" in e.name]
        each = [ops[a + 1:b] for a, b in zip(marks, marks[1:] + [len(ops)])]
        names = [[e.name for e in c] for c in each]
        for c, n in zip(reversed(each), reversed(names)):
            if names.count(n) >= 2:
                return [(e.name, e.time_range.elapsed_us()) for e in c
                        if only is None or any(k in e.name for k in only)]
        print(f"profiler trace attempt {attempt + 1} saw no two calls of the same operations "
              f"({len(marks)} calls marked)")
    raise RuntimeError("chip_smoke: no complete profiler trace of a call in 3 attempts")


def _windows_2x2(maps, records, res, chunk):
    """The four windows of a 2×2 split of the table ``maps`` (and of K7's
    record table ``records``), each block extended by ``chunk`` cells
    (edge-clamped outside the grid: reads clamp to the grid first): (block
    origin, block side, window origin, window shape, window table, window
    records)."""
    import torch

    tiles = maps.reshape(-1, res, res)
    grid = records.reshape(res, res, 4)
    half = res // 2
    out = []
    for r0 in (0, half):
        for c0 in (0, half):
            origin, shape = (r0 - chunk, c0 - chunk), (half + 2 * chunk, half + 2 * chunk)
            r = torch.clamp(torch.arange(origin[0], origin[0] + shape[0], device=maps.device),
                            0, res - 1)
            c = torch.clamp(torch.arange(origin[1], origin[1] + shape[1], device=maps.device),
                            0, res - 1)
            table = torch.cat([t[r][:, c].reshape(-1) for t in tiles]).contiguous()
            window = grid[r][:, c].reshape(-1, 4).contiguous()
            out.append(((r0, c0), half, origin, shape, table, window))
    return out


def descent_phase(rows, sim):
    """K7 (on its record table), K7@window, K7@records, K8 (the hash), K8's
    draw entry and K9 (the in-order scatter) against their plain versions
    (bit-equal), timed: the Quickstart's 2048² state after its step with the
    next cycle's 1000 particles spawned from the sim's key (the rows), and
    config 5's tile 0 (1024², 250 particles, MAXAGE 32) as its erosion cycle
    starts.  K9 and K8's draw are held against the CPU's ``scatter_events``
    and ``randint`` on CPU copies, and ``descend_all`` against the early-exit
    loop, bit for bit."""
    import dataclasses

    import torch

    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion import sim as SIM
    from noize_tpu_torch.erosion.world import WorldState

    cases = []
    st, meta = sim.state, sim.meta
    n, res = sim.settings.PARTICLES_PER_CYCLE, meta.generator_res
    parts, left, _ = SIM._spawn_with_drains(st.key, n, res, st.drain_water)
    world = dataclasses.replace(st.world, pool=st.world.pool + left)
    cases.append(("Quickstart", world, parts, sim.settings.as_parameters(),
                  float(meta.height), meta.patch_res, res, prng.split(st.key)[0]))
    cfg, origins = config5()
    _, blurred = _stack_inputs()
    x, z = origins[0].tolist()
    key5 = prng.fold_in(prng.fold_in(prng.PRNGKey(0, device="cuda"), x), z)
    res5 = cfg.meta.generator_res
    world5 = WorldState.create(blurred[0].contiguous())
    del blurred
    n5 = cfg.erosion.PARTICLES_PER_CYCLE
    parts5, _, _ = SIM._spawn_with_drains(key5, n5, res5, torch.zeros_like(world5.height))
    cases.append(("config 5", world5, parts5, cfg.erosion.as_parameters(),
                  float(cfg.meta.height), cfg.meta.patch_res, res5, prng.split(key5)[0]))

    for label, world, parts, params, hs, pr, res, k1 in cases:
        n = parts.row.numel()
        cells = res * res
        plants = PA._with_plants(params)
        steps = 8 * -(-(params.MAXAGE + 1) // 8)
        maps = PA.step_maps(world, params, hs)
        table = DC.descent_table(world, params, hs)  # K7's records
        plain_records = lambda: (DC.step_records_plain(  # noqa: E731
            world.height, world.pool, world.flow, world.plants if plants else None, params, hs),)
        _same_bits(f"K7@records ({label})", (table,), plain_records())
        args = (params, hs, pr, res)
        got = DC.descend_steps(parts, table, *args, steps)
        want = PA.descend_steps_plain(parts, maps, *args, steps)
        torch.cuda.synchronize()
        _same_bits(f"K7 ({label})", _flat(got), _flat(want))
        _check(not bool(got[0].alive.any()), f"K7 ({label}): particles alive after {steps} steps")
        # K9: K7's events scattered in order, against the CPU's scatter_events
        ev_h = [t.cpu() for t in got[1:]]
        acc9 = PA.scatter_events(got[1], got[2:], cells)
        ref9 = PA.scatter_events(ev_h[0], ev_h[1:], cells)
        _same_bits(f"K9 ({label}) vs the CPU's scatter_events", [a.cpu() for a in acc9], ref9)
        acc = PA.descend_all(parts, world, *args)
        early = PA._descend_all_plain(parts, world, *args, params.MAXAGE + 1, 8)
        torch.cuda.synchronize()
        _same_bits(f"descend_all sums ({label})", [a.reshape(-1) for a in acc[1:]], acc9)
        _same_bits(f"descend_all particles ({label})", tuple(acc[0]), tuple(early[0]))
        _same_bits(f"descend_all vs the early-exit loop ({label})", acc[1:], early[1:])
        _check(float(acc[1].max()) > 0, f"descend_all ({label}) left no track")
        nbytes, ops = _k7_cost(parts, got, steps, plants)
        # K8: the spawn's hash on the general entry (randint(split(k1)): one
        # hash of both halves), and the spawn's draw on the draw entry
        keys = prng.split(prng.split(k1))
        hi, lo = prng._counters(n, "cuda")
        k8 = prng.threefry2x32(keys, hi, lo)
        _same_bits(f"K8 spawn hash ({label})", k8, prng._threefry2x32_plain(keys, hi, lo))
        pairs = k8[0].numel()
        k1_h = k1.cpu()
        draw = prng._randint_of_split(k1, (n,), 0, res, torch.float32)
        plain_draw = lambda: (prng._randint_composed(  # noqa: E731
            prng.split(k1_h), (n,), 0, res).to(torch.float32).cuda(),)
        _same_bits(f"K8@randint ({label}) vs the CPU's randint(split(k))", (draw,), plain_draw())
        _same_bits(f"spawn on the card vs the CPU ({label})",
                   [t.cpu() for t in PA.spawn(k1, n, res)], tuple(PA.spawn(k1_h, n, res)))
        # K7@window: the first chunk of 8 on each window of a 2×2 split
        wins = _windows_2x2(maps, table, res, 8)
        row_i = torch.clamp(torch.round(parts.row).to(torch.int32), 0, res - 1)
        col_i = torch.clamp(torch.round(parts.col).to(torch.int32), 0, res - 1)
        win_args = []
        for (r0, c0), side, origin, shape, wtable, wrecords in wins:
            owned = ((row_i >= r0) & (row_i < r0 + side) & (col_i >= c0) & (col_i < c0 + side))
            a = (parts, wrecords, *args, 8, origin, shape, owned)
            g = DC.descend_steps_window(*a)
            w = PA.descend_steps_plain(parts, wtable, *args, 8, window_origin=origin,
                                       window_shape=shape, owned=owned)
            torch.cuda.synchronize()
            _same_bits(f"K7@window ({label}, block {r0},{c0})", _flat(g), _flat(w))
            win_args.append((a, wtable, g))
        (a0, wt0, g0) = win_args[0]
        wbytes, wops = _k7_cost(parts, g0, 8, plants)
        if label == "Quickstart":
            rows.compare("K7", f"K7 descend_steps, {n} particles, {steps} steps on the "
                         f"Quickstart's {res}² state (MAXAGE {params.MAXAGE})", SRC["K7"],
                         "none: noize_tpu/erosion/particles.py:266 (descend_step in the "
                         "lax.scan/while_loop of descend_all, :445; no Pallas kernel)",
                         _flat(got), lambda: DC.descend_steps(parts, table, *args, steps),
                         lambda: _flat(PA.descend_steps_plain(parts, maps, *args, steps)),
                         "k7", 20, nbytes, ops)
            rows.compare("K7@window", f"K7 descend_steps_window, one chunk of 8 steps of {n} "
                         f"particles on the {wins[0][3][0]}² window of a 2×2 split of the "
                         f"Quickstart's {res}² state, owner mask", SRC["K7"],
                         "none: noize_tpu/parallel/sharded_erosion.py:185 (descend_step on "
                         "a rank's extended block; no Pallas kernel)", _flat(g0),
                         lambda: DC.descend_steps_window(*a0),
                         lambda: _flat(PA.descend_steps_plain(
                             a0[0], wt0, *a0[2:7], window_origin=a0[7], window_shape=a0[8],
                             owned=a0[9])),
                         "k7w", 20, wbytes, wops)
            rows.compare("K7@records", f"K7's record table of the Quickstart's {res}² state "
                         f"({cells} records of 16 bytes)", SRC["K7"],
                         "none: the descent's gather table, noize_tpu/erosion/particles.py:"
                         "306-311 (no Pallas kernel)", (table,),
                         lambda: (DC.descent_table(world, params, hs),), plain_records, "k7r",
                         20, (12 + (4 if plants else 0) + 16) * cells, 7 * cells)
            rows.compare("K8", f"K8 threefry2x32, the Quickstart spawn's hash ({pairs} "
                         "pairs: both coordinates' two halves)", SRC["K8"],
                         "none: JAX's threefry2x32 (an XLA computation), reached from "
                         "noize_tpu/erosion/particles.py:75 (spawn) and the vegetation draws",
                         k8, lambda: prng.threefry2x32(keys, hi, lo),
                         lambda: prng._threefry2x32_plain(keys, hi, lo), "k8", 50,
                         16 * hi.numel() + 16 * pairs, K8_OPS_PER_PAIR * pairs, None,
                         PEAK_I32_OPS_PER_S)
            rows.compare("K8@randint", f"K8's draw entry, the Quickstart spawn's "
                         f"randint(split(k), ({n},), 0, {res}) as float32 (2 × {n} draws)",
                         SRC["K8"],
                         "none: jax.random.randint of jax.random.split, "
                         "noize_tpu/erosion/particles.py:75-80 (spawn)", (draw,),
                         lambda: (prng._randint_of_split(k1, (n,), 0, res, torch.float32),),
                         plain_draw, "k8r", 50, 8 + 4 * 2 * n,
                         K8_RANDINT_SPLIT_HASHES * K8_OPS_PER_PAIR
                         + 2 * n * (2 * K8_OPS_PER_PAIR + K8_OPS_PER_COMBINE), None,
                         PEAK_I32_OPS_PER_S)
            k9_bytes, k9_ops = _k9_cost(got[1].numel(), cells)
            rows.compare("K9", f"K9 scatter_events, K7's {got[1].numel()} events of the "
                         f"Quickstart's descent into 3 maps of {res}² (each cell's events in "
                         "order)", SRC["K9"],
                         "none: the descent's event scatter-add, noize_tpu/erosion/"
                         "particles.py:445 (descend_all; no Pallas kernel)", acc9,
                         lambda: PA.scatter_events(got[1], got[2:], cells),
                         lambda: [a.cuda() for a in PA.scatter_events(ev_h[0], ev_h[1:], cells)],
                         "k9", 20, k9_bytes, k9_ops,
                         lambda: [torch.zeros(cells, device="cuda").index_put_(
                             (got[1],), d, accumulate=True) for d in got[2:]])
            # K9's device operations a call, into given maps and into fresh ones
            given = [torch.zeros(cells, device="cuda") for _ in got[2:]]
            ops_given = _device_ops_of_last_call(
                lambda: PA.scatter_events(got[1], got[2:], cells, given))
            ops_fresh = _device_ops_of_last_call(
                lambda: PA.scatter_events(got[1], got[2:], cells))
            _check(1 <= len(ops_given) <= 3 and len(ops_fresh) == len(ops_given) + 1,
                   f"K9 device operations a call: {ops_given} (given), {ops_fresh} (fresh)")
            live = int(torch.stack([d != 0 for d in got[2:]]).any(0).sum())
            print(f"K9 by the profiler, {got[1].numel()} events ({live} with a nonzero delta): "
                  f"into fresh maps {len(ops_fresh)} device operations, "
                  f"{sum(t for _, t in ops_fresh):.1f} µs ("
                  + "; ".join(f"{n[:40]} {t:.1f}" for n, t in ops_fresh)
                  + f"); into given maps {len(ops_given)}, "
                  f"{sum(t for _, t in ops_given):.1f} µs")
            del given
        records_ms = _time_ms(lambda: DC.descent_table(world, params, hs), 20)
        k7_ms = _time_ms(lambda: DC.descend_steps(parts, table, *args, steps), 20)
        k9_ms = _time_ms(lambda: PA.scatter_events(got[1], got[2:], cells), 20)
        put_ms = _time_ms(lambda: [torch.zeros(cells, device="cuda").index_put_(
            (got[1],), d, accumulate=True) for d in got[2:]], 20)
        all_ms = _time_ms(lambda: PA.descend_all(parts, world, *args), 20)
        plain_ms = _time_ms(lambda: PA.descend_steps_plain(parts, maps, *args, steps), 2)
        early_ms = _time_ms(lambda: PA._descend_all_plain(parts, world, *args,
                                                          params.MAXAGE + 1, 8), 2)
        win_ms = _time_ms(lambda: DC.descend_steps_window(*a0), 20)
        draw_ms = _time_ms(lambda: prng._randint_of_split(k1, (n,), 0, res, torch.float32), 50)
        composed_ms = _time_ms(lambda: prng._randint_composed(
            prng.split(k1), (n,), 0, res).to(torch.float32), 50)
        spawn_ms = _time_ms(lambda: PA.spawn(k1, n, res), 50)
        print(f"descent ({label}, {res}², {n} particles, {steps} steps): K7 (records), "
              f"K7@window (4 windows of a 2×2 split, a chunk of 8, owner masks), K7@records and "
              f"K8 (the spawn's hash, its draw entry) bit-equal to their plain versions; K9 "
              f"bit-equal to the CPU's scatter_events; descend_all bit-equal to the early-exit "
              f"loop; record table {records_ms:.4f} ms, K7 {k7_ms:.4f} ms "
              f"({k7_ms / steps * 1e3:.3f} µs a step), K9 {k9_ms:.4f} ms (three index_put_ "
              f"{put_ms:.4f} ms), descend_all (records + K7 + K9) {all_ms:.4f} ms, plain "
              f"fixed-step loop {plain_ms:.3f} ms, early-exit loop {early_ms:.3f} ms; "
              f"K7@window chunk {win_ms:.4f} ms; the spawn's draw {draw_ms:.4f} ms (K8's draw "
              f"entry; the composition of split, K8 hashes and int64 operations "
              f"{composed_ms:.4f} ms), spawn {spawn_ms:.4f} ms")
    del cases, maps, wins, win_args


def prng_phase():
    """The threefry PRNG on the card against the CPU: 10⁶ ``randint``
    draws and the keys, exact; the card's time for a draw and a spawn."""
    import torch

    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion.particles import spawn

    n = 1_000_000
    for seed in (0, 42, 2**31 - 1):
        kc, kh = prng.PRNGKey(seed, device="cuda"), prng.PRNGKey(seed, device="cpu")
        for lo, hi in ((0, 2048), (-1024, 1025)):
            got, want = prng.randint(kc, (n,), lo, hi), prng.randint(kh, (n,), lo, hi)
            _check(got.device.type == "cuda" and torch.equal(got.cpu(), want),
                   f"threefry randint on the card differs from the CPU (seed {seed})")
        for a, b in ((prng.split(kc, 3), prng.split(kh, 3)),
                     (prng.fold_in(kc, 7), prng.fold_in(kh, 7))):
            _check(torch.equal(a.cpu(), b), f"threefry keys differ on the card (seed {seed})")
    kc = prng.PRNGKey(0, device="cuda")
    keys, (hi, lo) = prng.split(prng.split(kc)), prng._counters(n, "cuda")
    _same_bits("K8 on 10^6 randint counters", prng.threefry2x32(keys, hi, lo),
               prng._threefry2x32_plain(keys, hi, lo))
    k8_ms = _time_ms(lambda: prng.threefry2x32(keys, hi, lo), 20)
    k8_plain_ms = _time_ms(lambda: prng._threefry2x32_plain(keys, hi, lo), 5)
    draw_ms = _time_ms(lambda: prng.randint(kc, (n,), 0, 2048), 20)
    spawn_ms = _time_ms(lambda: spawn(kc, 1000, 2048), 20)
    print(f"prng: threefry on the card equals the CPU (3 seeds x 2 ranges x {n} randint draws, "
          f"split, fold_in); K8 bit-equal to its plain version on the card; randint 10^6 "
          f"{draw_ms:.4f} ms (its hash: K8 {k8_ms:.4f} ms, plain {k8_plain_ms:.4f} ms), spawn "
          f"of 1000 particles {spawn_ms:.4f} ms")


def _host_us(fn, calls=20):
    """Host µs to enqueue one call of ``fn``: ``calls`` calls back to back,
    no sync between them."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    us = (time.perf_counter() - t0) * 1e6 / calls
    torch.cuda.synchronize()
    return us


def filter_phase(rows):
    """K1 with each non-Gauss KernelFilterStage filter's taps (one
    iteration) and the presets' Gauss9_S1 ×2 and Gauss3_S1 ×3 calls at
    2048², all on K1@short but Sobel3_2D (``kernel_filter``) and
    ``edge_2d``'s Prewitt magnitude (the K1@rss row), on K1@rss; each
    against its plain version (tolerance 0), with CUDA-event times, the
    bound, the same chain as cuDNN ``conv2d`` calls with replicate padding,
    the device operations of one call (profiled: one kernel, nothing
    after it) and the host enqueue of one call."""
    import torch

    from noize_tpu_torch.ops import edge as ED
    from noize_tpu_torch.ops import kernels as KE
    from noize_tpu_torch.ops.cuda import stencil as SC

    _, x, _ = _inputs(2048)
    cells = x.numel()
    pairs = {"SOBEL": [(KE._SOBEL3_HX, KE._SOBEL3_HZ), (KE._SOBEL3_VX, KE._SOBEL3_VZ)],
             "PREWITT": [(KE._PREWITT3_HX, KE._PREWITT3_HZ),
                         (KE._PREWITT3_VX, KE._PREWITT3_VZ)]}
    cases = [(f"K1:{n}", n, 1) for n in FILTERS]
    cases += [(f"K1:{g}x{m}", g, m) for g, m in PRESET_CHAINS] + [("K1@rss", "PREWITT", 1)]
    for key, name, iters in cases:
        if name in ("Sobel3_2D", "PREWITT"):
            pair = pairs["SOBEL" if name == "Sobel3_2D" else name]
            convs = [_conv_chain(tx, 1, tz) for tx, tz in pair]
            if name == "Sobel3_2D":
                kernel = lambda: (KE.kernel_filter(x, "Sobel3_2D", 1),)  # noqa: E731
                label = "K1 Sobel3_2D taps (kernel_filter, 1 iteration, 2048², K1@rss)"
            else:
                kernel = lambda: (ED.edge_2d(x, "PREWITT"),)  # noqa: E731
                label = "K1@rss edge_2d PREWITT (2048²)"
            plain = lambda pair=pair: (  # noqa: E731
                SC.root_sum_squares_chain_plain(x, *pair),)
            library = lambda convs=convs: (  # noqa: E731
                torch.sqrt(sum(c(x) ** 2 for c in convs)),)
            ops = 2 * 2 * 2 * 3 * cells + 4 * cells  # two series; squares, add, sqrt
        else:
            tx, tz, f = KE._SERIES_TABLE[name]
            conv = _conv_chain(tx, iters, tz, f)
            kernel = lambda name=name, iters=iters: (  # noqa: E731
                KE.kernel_filter(x, name, iters),)
            plain = lambda tx=tx, tz=tz, f=f, iters=iters: (  # noqa: E731
                SC.separable_chain_plain(x, tx, iters, taps_z=tz, factor=f),)
            library = lambda conv=conv: (conv(x),)  # noqa: E731
            ops = iters * 2 * (2 * len(tx) + (f != 1.0)) * cells
            label = (f"K1 {name} taps (kernel_filter, {iters} iteration"
                     f"{'s' if iters > 1 else ''}, 2048², K1@short)")
        got = kernel()
        torch.cuda.synchronize()
        _check(all(bool(torch.isfinite(g).all()) for g in got), f"{key} not finite")
        rows.compare(key, label, SRC["K1"], TPU + "stencil.py:153", got, kernel, plain,
                     f"filter:{key}", 20, 8 * cells, ops, library)
        ops_of_call = _device_ops_of_last_call(kernel)
        host_us = _host_us(kernel)
        device_us = sum(t for _, t in ops_of_call)
        print(f"{key} one call: {len(ops_of_call)} device operation(s) "
              f"({', '.join(n[:40] for n, _ in ops_of_call)}), {device_us:.1f} µs of device "
              f"time; host enqueue {host_us:.1f} µs a call")
        _check(len(ops_of_call) == 1 and "short_tile" in ops_of_call[0][0],
               f"{key} ran {[n for n, _ in ops_of_call]}, not one short_tile launch")
    del x


def presets_phase(rows):
    """The BasicDemo presets on the card: PerlinGenerator, FlowMap and
    Sobel at 2048² through ``Pipeline.run`` and ``compose.fuse`` (the main
    path, launch counts reset before), the Mesh preset on the
    PerlinGenerator output, then each preset at 256² against the port on
    the CPU."""
    import torch

    from noize_tpu_torch.app import presets
    from noize_tpu_torch.core.stageio import GeneratorData, MeshStageData
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.pipeline.compose import fuse
    from noize_tpu_torch.pipeline.driver import Pipeline

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    def sobel_input(res, device):
        return fractal(res, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                       noise_size=1700.0, device=device)

    res, r = 2048, 2016
    gens = ("PerlinGenerator", "FlowMap", "Sobel")
    inputs = {n: sobel_input(res, "cuda") if n == "Sobel" else None for n in gens}
    runs = {}
    for n in gens:
        stages = presets.ALL[n].stages
        runs[n] = (Pipeline(list(stages)), fuse(stages, res))
    torch.cuda.synchronize()
    _reset_counts()
    outs, per_preset = {}, {}
    for n in gens:
        pipe, fn = runs[n]
        before = _read_counts()
        run_out = pipe.run(GeneratorData(uuid=n, resolution=res, data=inputs[n])).data
        fused = fn(inputs[n], 0, 0)
        torch.cuda.synchronize()
        after = _read_counts()
        per_preset[n] = {k: after[k] - before[k] for k in ("K1", "K1@tile", "K1@short", "K1@rss",
                                                          "K2") if after[k] > before[k]}
        outs[n] = (run_out, fused)
    mesh_req = MeshStageData(uuid="m", resolution=r, inputResolution=res, marginPix=16,
                             tileHeight=1000, tileSize=float(r), xpos=0, zpos=0,
                             data=outs["PerlinGenerator"][0])
    mesh = Pipeline(list(presets.ALL["Mesh"].stages)).run(mesh_req).mesh
    torch.cuda.synchronize()
    counts = _read_counts()
    print(f"presets 2048² launches {per_preset} (total {counts})")
    _check(per_preset["PerlinGenerator"].get("K1@short", 0) > 0,
           "K1@short not launched by PerlinGenerator")
    _check(per_preset["Sobel"].get("K1@short", 0) > 0 and per_preset["Sobel"].get("K1@rss", 0) > 0,
           "K1@short or K1@rss not launched by Sobel")
    _check(per_preset["FlowMap"].get("K2", 0) > 0, "K2 not launched by FlowMap")
    _check(counts["K1@tile"] == 0, f"chain_tile ran on the presets path: {counts}")
    for n in ("PerlinGenerator", "Sobel"):  # a Pipeline.run and a fuse call each
        print(f"preset {n} launches a run: K1@short {per_preset[n].get('K1@short', 0) // 2}, "
              f"K1@rss {per_preset[n].get('K1@rss', 0) // 2}")
    for n, (run_out, fused) in outs.items():
        _check(tuple(run_out.shape) == (res, res), f"{n} shape {tuple(run_out.shape)}")
        _check(bool(torch.isfinite(run_out).all()), f"{n} not finite")
        _check(torch.equal(run_out, fused), f"{n}: fuse differs from run")
        _check(float(run_out.max() - run_out.min()) > 0.01, f"{n} is flat")
    _check(tuple(mesh.positions.shape) == ((r + 1) ** 2, 3), "Mesh preset positions shape")
    _check(tuple(mesh.indices.shape) == (6 * r * r,), "Mesh preset indices shape")
    for f in ("positions", "normals", "tangents", "uvs"):
        _check(bool(torch.isfinite(getattr(mesh, f)).all()), f"Mesh preset {f} not finite")
    rows.set_launches({f"K1:{f}": counts["K1@short"] for f in FILTERS})
    rows.set_launches({f"K1:{g}x{m}": counts["K1@short"] for g, m in PRESET_CHAINS})
    rows.set_launches({"K1:Sobel3_2D": counts["K1@rss"], "K1@rss": counts["K1@rss"]})

    times = {}
    for n in gens:
        pipe, fn = runs[n]
        req = GeneratorData(uuid=n, resolution=res, data=inputs[n])
        times[n] = ([round(timed(lambda: pipe.run(req))[1], 3) for _ in range(3)],
                    [round(timed(lambda: fn(inputs[n], 0, 0))[1], 3) for _ in range(3)])
    mesh_ms = [round(timed(lambda: Pipeline(list(presets.ALL["Mesh"].stages)).run(mesh_req))[1], 3)
               for _ in range(3)]
    for n, (run_ms, fuse_ms) in times.items():
        print(f"preset {n} 2048²: run {run_ms} ms, fuse {fuse_ms} ms; fuse equals run")
    print(f"preset Mesh {r}² of 2048²: {mesh_ms} ms")
    del outs, inputs, mesh

    gaps = {}
    for n in gens:
        stages = presets.ALL[n].stages
        got = {}
        for dev in ("cuda", "cpu"):
            data = sobel_input(256, dev) if n == "Sobel" else None
            got[dev] = Pipeline(list(stages), device=dev).run(
                GeneratorData(uuid=n, resolution=256, xpos=512, zpos=256, data=data)).data
        a, b = got["cuda"].cpu(), got["cpu"]
        gaps[n] = _max_abs(a, b) / max(float(b.abs().max()), 1e-30)
        limit = CROSS_DEVICE_RTOL if n == "FlowMap" else 0.0  # K1's presets: bit for bit
        _check(gaps[n] <= limit, f"preset {n} card vs cpu gap {gaps[n]}")
    print("presets 256², card vs cpu, max gap relative to scale: "
          + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))


def _timed(fn):
    """(fn(), host ms to the card's end of it)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, (time.perf_counter() - t0) * 1e3


def config5(**kw):
    """``bench.py``'s config 5 (bench.py:304-347): a 4 x 4 grid of 1024²
    tiles (992² meshed, 16-cell margin), 13 octaves, Gauss-5 ×17, one
    erosion cycle of 250 particles of age ≤ 32; ``kw`` overrides fields.
    Returns (config, origins)."""
    from noize_tpu_torch.core.tiles import TileSetMeta
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel import tiled as TL

    meta = TileSetMeta(tile_res=992, tile_size=992, generator_res=1024, height=1000,
                       margin=16).validate()
    es = ErosionSettings(PARTICLES_PER_CYCLE=250, MAXAGE=32, WATER_STEPS=4, CYCLES=1,
                         PILING_RADIUS=8)
    fields = dict(meta=meta, octaves=13, noise_size=1700.0, blur_iterations=17, erosion=es,
                  erosion_cycles=1)
    fields.update(kw)
    return TL.TilePipelineConfig(**fields), TL.grid_origins(meta, 4, 4)


def _stack_inputs():
    """Config 5's noise stack [16, 1024, 1024] and its Gauss-5 ×17 blur
    (plain version)."""
    from noize_tpu_torch.ops.cuda.stencil import separable_chain_plain
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.ops.kernels import gaussian_taps

    cfg, origins = config5()
    noise = fractal(cfg.meta.generator_res, origins[:, 0].astype("float32"),
                    origins[:, 1].astype("float32"), noise_type=cfg.noise_type,
                    hurst=cfg.hurst, octaves=cfg.octaves, noise_size=cfg.noise_size,
                    device="cuda")
    return noise, separable_chain_plain(noise, gaussian_taps(1.0, 5), 17)


def tiles_phase(rows):
    """Config 5 through ``tile_batch`` (the main path): the batch, the
    batch with mesh planes, the grid's flow map; every tile against
    ``generate_tile`` alone; then K1 and K2 on the stack against their
    plain versions and the 2-D kernel on each tile.  Returns the batch's
    heights."""
    import torch

    from noize_tpu_torch.ops import flow as FL
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import flow as FC
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.kernels import gaussian_taps
    from noize_tpu_torch.parallel import tiled as TL
    from noize_tpu_torch.prng import PRNGKey, fold_in

    cfg, origins = config5()
    cfg_mesh, _ = config5(emit_mesh=True)
    cfg_flow, _ = config5(erosion=None, erosion_cycles=0, flow_iterations=8)
    n, res, tr = len(origins), cfg.meta.generator_res, cfg.meta.tile_res
    for c in (cfg, cfg_mesh, cfg_flow):  # each kernel's first launch, outside the timing
        TL.tile_batch(c, origins[:1])
    _reset_counts()
    heights, batch_ms = _timed(lambda: TL.tile_batch(cfg, origins))
    meshed, mesh_ms = _timed(lambda: TL.tile_batch(cfg_mesh, origins))
    flow, flow_ms = _timed(lambda: TL.tile_batch(cfg_flow, origins))
    counts = _read_counts()
    print(f"config 5 tile_batch, 16 tiles of {res}²: {batch_ms:.3f} ms "
          f"({batch_ms / n:.3f} ms/tile); with mesh planes {mesh_ms:.3f} ms "
          f"({mesh_ms / n:.3f} ms/tile); flow map ×8, no erosion {flow_ms:.3f} ms "
          f"({flow_ms / n:.3f} ms/tile)")
    k1_plan = len(SC.chain_plan(5, cfg.blur_iterations).launches)
    print(f"tiles launches {counts}: K1 {counts['K1']} calls of {k1_plan} launches each "
          f"(Gauss-5 ×17 on the stack: {k1_plan} launches a batch, whatever its depth)")
    _check(counts["K1"] == 3 and k1_plan == 4, "K1 not one call of 4 launches a batch")
    _check(counts["K2"] == 1, "K2 not one call on the flow stack")
    _check(counts["K10"] == 3, f"K10 launched {counts['K10']} times in 3 batches (1 a batch)")
    _check(counts["K3"] == 2 * n and counts["K4"] == 2 * n, "erosion not once a tile")
    _check(all(counts[k] == 2 * n for k in ("K7", "K7@records", "K9")) and counts["K8"] > 0
           and counts["K8@randint"] > 0, f"descent not one K7 and one K9 launch a tile: {counts}")
    _check(tuple(heights.shape) == (n, res, res) and bool(torch.isfinite(heights).all()),
           "heights misshapen or not finite")
    _check(torch.equal(meshed["height"], heights), "mesh variant's heights differ")
    planes = meshed["mesh_planes"]
    _check(tuple(planes.shape) == (n, 12, tr + 1, tr + 1)
           and bool(torch.isfinite(planes).all()), "mesh planes misshapen or not finite")
    _check(tuple(flow.shape) == (n, res, res) and bool(torch.isfinite(flow).all()),
           "flow stack misshapen or not finite")
    del meshed, planes, flow
    for i, (x, z) in enumerate(origins.tolist()):
        key = fold_in(fold_in(PRNGKey(0, device="cuda"), x), z)  # tile_batch's, seed 0
        one = TL.generate_tile(cfg, float(x), float(z), key)
        _check(torch.equal(one, heights[i]), f"tile {i} differs from generate_tile alone")
    print(f"config 5: each of the {n} tiles equals generate_tile of it alone")
    rows.set_launches({"K1@stack": counts["K1"], "K2@stack": counts["K2"],
                       "K10@stack": counts["K10"]})
    PROFILES.append(("config 5 tile_batch, 16 tiles of 1024²",
                     lambda: TL.tile_batch(cfg, origins)))

    noise, blurred = _stack_inputs()
    cells = noise.numel()
    xs, zs = origins[:, 0].astype("float32"), origins[:, 1].astype("float32")
    fbm = dict(noise_type=cfg.noise_type, hurst=cfg.hurst, octaves=cfg.octaves,
               noise_size=cfg.noise_size)
    nbytes, ops = _fbm_cost(cells, cfg.noise_type, cfg.octaves)
    rows.compare("K10@stack", "K10 fractal on the config-5 stack [16, 1024, 1024] "
                 "(Simplex ×13, 16 origins)", SRC["K10"], FBM_REF, (noise,),
                 lambda: (FR.fractal(res, xs, zs, device="cuda", **fbm),),
                 lambda: (FR.fractal_window_plain(0, 0, res, res, xs, zs, device="cuda",
                                                  **fbm),),
                 "k10stack", 20, nbytes, ops)
    taps = gaussian_taps(1.0, 5)
    conv = _conv_chain(taps, 17)
    got1 = SC.separable_chain(noise, taps, 17)
    got2 = FC.flow_map_fused(blurred, 8)
    torch.cuda.synchronize()
    for i in range(n):
        _check(torch.equal(got1[i], SC.separable_chain(noise[i], taps, 17)),
               f"K1 stack tile {i} differs from the 2-D kernel")
        _check(torch.equal(got2[i], FC.flow_map_fused(blurred[i], 8)),
               f"K2 stack tile {i} differs from the 2-D kernel")
    rows.compare("K1@stack", "K1 separable_chain on the config-5 stack [16, 1024, 1024] "
                 "(Gauss-5 ×17)", SRC["K1"], TPU + "stencil.py:153", (got1,),
                 lambda: (SC.separable_chain(noise, taps, 17),),
                 lambda: (SC.separable_chain_plain(noise, taps, 17),), "k1stack", 20,
                 8 * cells, 2 * 2 * len(taps) * 17 * cells, lambda: (conv(noise),))
    rows.compare("K2@stack", "K2 flow_map_fused on the config-5 stack [16, 1024, 1024] "
                 "(flow ×8)", SRC["K2"], TPU + "flow_pl.py:99", (got2,),
                 lambda: (FC.flow_map_fused(blurred, 8),), lambda: (FL.flow_map(blurred, 8),),
                 "k2stack", 20, 8 * cells, (K2_OPS_PER_ITER * 8 + K2_OPS_ONCE) * cells)
    k1_2d = _time_ms(lambda: [SC.separable_chain(noise[i], taps, 17) for i in range(n)], 5)
    k2_2d = _time_ms(lambda: [FC.flow_map_fused(blurred[i], 8) for i in range(n)], 5)
    print(f"stack vs 16 2-D calls, CUDA events: K1 {rows.rows['K1@stack']['ms']:.4f} ms "
          f"vs {k1_2d:.4f} ms; K2 {rows.rows['K2@stack']['ms']:.4f} ms vs {k2_2d:.4f} ms; "
          "every tile bit-equal to its 2-D call")
    del noise, blurred, got1, got2
    return heights


def serve_phase(heights):
    """``TileServer(config 5, batch_size=4)`` serving the 16 tiles twice:
    a cold wave (the worker thread's first batches) and a warm wave."""
    import torch

    from noize_tpu_torch.app.server import TileServer

    cfg, origins = config5()
    poses = [(x // cfg.meta.tile_res, z // cfg.meta.tile_res) for x, z in origins.tolist()]
    _reset_counts()
    srv = TileServer(cfg, batch_size=4)
    waves = []
    try:
        srv.start()
        for wave in ("cold", "warm"):
            done, batches = {}, srv.batches
            t0 = time.perf_counter()
            for i, pos in enumerate(poses):
                srv.submit(f"{wave}{i}", pos, on_complete=lambda st: done.__setitem__(
                    st.request.uuid, st))
            _check(srv.drain(timeout=600), f"{wave} wave did not drain in 600 s")
            wall = (time.perf_counter() - t0) * 1e3
            waves.append((wave, wall, srv.batches - batches))
            _check(len(done) == len(poses) and not srv.errors, f"{wave} wave: {srv.errors}")
            for i in range(len(poses)):
                st = done[f"{wave}{i}"]
                _check(st.error is None and torch.equal(st.heights, heights[i]),
                       f"{wave} wave tile {i} differs from tile_batch's")
    finally:
        srv.stop()
    counts = _read_counts()
    for key in ("K1", "K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9", "K10"):
        _check(counts[key] > 0, f"{key} was not launched on the serving path")
    for wave, wall, batches in waves:
        print(f"TileServer {wave} wave: 16 tiles in {batches} batches of 4, {wall:.3f} ms "
              f"({wall / 16:.3f} ms/tile)")
    print(f"serve launches {counts}")

    def wave():
        srv = TileServer(cfg, batch_size=4)
        try:
            srv.start()
            for i, pos in enumerate(poses):
                srv.submit(f"p{i}", pos)
            _check(srv.drain(timeout=600), "profiled wave did not drain")
        finally:
            srv.stop()
    PROFILES.append(("TileServer wave, config 5's 16 tiles at batch 4 (cold server)", wave))


def cli_phase():
    """The port's CLI on the card: README example #1 at 2048², and erode
    at 2048² with the mesh and 16-bit heightmaps."""
    import numpy as np

    from noize_tpu_torch.app import cli

    with tempfile.TemporaryDirectory() as d:
        _reset_counts()
        _, demo_ms = _timed(lambda: cli.main(["demo", "--resolution", "2048", "-o", d]))
        counts = _read_counts()
        demo = np.load(os.path.join(d, "demo.npy"))
        _check(demo.shape == (2048, 2048) and np.isfinite(demo).all(), "demo.npy")
        _check(counts["K1"] == 1 and counts["K2"] == 1, f"demo launches {counts}")
        out = os.path.join(d, "erode")
        _reset_counts()
        _, erode_ms = _timed(lambda: cli.main(["erode", "--resolution", "2048", "--cycles", "3",
                                               "--mesh", "--heightmap16", "-o", out]))
        counts = _read_counts()
        for key in ("K1", "K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9", "K10"):
            _check(counts[key] > 0, f"{key} was not launched by the CLI's erode")
        _check(os.path.getsize(os.path.join(out, "eroded_height.raw")) == 2 * 2048 * 2048,
               "eroded_height.raw size")
        with np.load(os.path.join(out, "tile.npz")) as z:
            _check(z["positions"].shape == (2049 * 2049, 3)
                   and np.isfinite(z["positions"]).all(), "tile.npz positions")
        files = sorted(os.listdir(out))
    print(f"CLI on the card: demo 2048² {demo_ms:.1f} ms; erode 2048² (3 cycles, mesh, "
          f"16-bit) {erode_ms:.1f} ms, launches {counts}; wrote {files}")


def generator_phase():
    """``DemoTileGenerator.start(1, 1)`` with config 5's 1024² tiles, one
    erosion step, the drawers, a checkpoint restored in a fresh store, and
    the bakery of the four meshes."""
    import torch

    from noize_tpu_torch.app.bakery import MeshBakeOrder, MeshBakery
    from noize_tpu_torch.app.drawers import StreamDrawer, TileDrawer
    from noize_tpu_torch.app.tile_generator import DemoTileGenerator
    from noize_tpu_torch.core.store import PipelineStateManager
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import (NoiseStage, StageGaussianBlur,
                                                 WriteGeneratorContextStage)

    cfg, _ = config5()
    meta = cfg.meta
    with tempfile.TemporaryDirectory() as d:
        sm = PipelineStateManager(os.path.join(d, "saves"), "island", "v1")
        source = Pipeline([
            NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
            StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
            WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
        ], state_manager=sm, name="generator")
        _reset_counts()
        gen = DemoTileGenerator(source, meta=meta, state_manager=sm, erosion_settings=cfg.erosion)
        children, start_ms = _timed(lambda: gen.start(1, 1))
        _, step_ms = _timed(lambda: gen.step_erosion(1))
        counts = _read_counts()
        _check(len(children) == 4, f"{len(children)} children")
        for key in ("K1", "K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9", "K10"):
            _check(counts[key] > 0, f"{key} was not launched by the tile generator")
        t0 = time.perf_counter()
        pngs = []
        for child in children.values():
            child.erosion.save_erosion_state()
            pngs += StreamDrawer(child.erosion, meta).export(
                d, prefix=f"tile{child.request.pos}")
        drawn = TileDrawer(PipelineStateManager(os.path.join(d, "saves"), "island", "v1"),
                           meta, tile_pos=(0, 0)).draw(d, "restored_00")
        draw_ms = (time.perf_counter() - t0) * 1e3
        _check(len(pngs) == 8 and len(drawn) == 2, "drawer outputs")
        bakery = MeshBakery()
        for key, child in children.items():
            _check(bakery.enqueue(MeshBakeOrder(key, child.mesh)), f"bake {key} refused")
        baked, bake_ms = bakery.service()
        _check(baked == 4 and len(bakery.known) == 4, "bakery")
        for b in bakery.known.values():
            _check(b.positions.shape == ((meta.tile_res + 1) ** 2, 3), "baked positions shape")
            _check(bool(torch.isfinite(torch.from_numpy(b.normals)).all()), "baked normals")
    print(f"DemoTileGenerator 2 x 2 of 1024²: start {start_ms:.1f} ms, step_erosion(1) "
          f"{step_ms:.1f} ms, save + StreamDrawer.export + TileDrawer.draw {draw_ms:.1f} ms, "
          f"bakery of 4 meshes {bake_ms:.1f} ms; launches {counts}")


def continuous_phase():
    """``ErosionSim`` at 2048² in the continuous mode: ``update()`` until
    "completed"."""
    from noize_tpu_torch.erosion.sim import ErosionSim

    _, blurred, _ = _inputs(2048)
    sim = ErosionSim(blurred)
    _reset_counts()
    states = []
    t0 = time.perf_counter()
    while not states or states[-1] != "completed":
        states.append(sim.update())
        _check(time.perf_counter() - t0 < 300, f"no 'completed' in 300 s: {states[-5:]}")
    wall = (time.perf_counter() - t0) * 1e3
    counts = _read_counts()
    _check(states[0] == "triggered" and set(states[1:-1]) <= {"running"}, f"states {states[:5]}")
    _check(sim.cycle_count == sim.settings.CYCLES, f"{sim.cycle_count} cycles")
    for key in ("K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9"):
        _check(counts[key] > 0, f"{key} was not launched by the continuous sim")
    print(f"continuous ErosionSim 2048²: triggered, running ×{len(states) - 2}, completed in "
          f"{wall:.1f} ms ({sim.cycle_count} cycles, {len(sim.syncs)} host syncs before the "
          f"trigger returned); launches {counts}")


def _quickstart_heights():
    """The Quickstart pipeline's output at 2048² (no store): what its
    ``ErosionSim`` starts from."""
    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.pipeline.driver import Pipeline
    from noize_tpu_torch.pipeline.stages import FlowMapStage, NoiseStage, StageGaussianBlur

    pipe = Pipeline([NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
                     StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
                     FlowMapStage(iterations=8)])
    return pipe.run(GeneratorData(uuid="t00", resolution=2048, xpos=0, zpos=0)).data


def _plant_world(sim, n, key):
    """Root ``n`` plants on ``sim``'s world, one growth cycle, and their
    density as the sim's plant map.  ``PlantType()`` caps the 4-cross
    normal's y at 1, but at the Quickstart's patch_res of 1 it is 2·1² = 2
    everywhere, so nothing would root: the phase takes max_angle 2.
    Returns (plants, ms to root, ms to grow, ms to splat)."""
    from noize_tpu_torch.erosion import vegetation as V
    from noize_tpu_torch.prng import split

    ptype = V.PlantType(max_angle=2.0)
    world = sim.state.world
    hs, pr = float(sim.meta.height), sim.meta.patch_res
    k_root, k_grow = split(key)
    plants, root_ms = _timed(lambda: V.root_plants(k_root, ptype, world, n, hs, pr))
    plants, grow_ms = _timed(lambda: V.grow_cycle(k_grow, plants, world, ptype, hs, pr))
    dens, splat_ms = _timed(lambda: V.density_map(tuple(world.height.shape), plants, ptype))
    world.plants = dens
    return plants, root_ms, grow_ms, splat_ms


def _stamps_scatter(plants, plant_map):
    """K9 at the vegetation's shape: the density's neighbour stamps (8 a
    plant, ``vegetation.splat_density``'s second scatter, magnitude 1 on
    the live plants) into one given map, bit-equal to the CPU's
    ``scatter_events`` (three passes of 8 bits: 256 tiles); its
    CUDA-event time and its device operations a call (one kernel)."""
    import torch

    from noize_tpu_torch.erosion import particles as PA

    res, cols = plant_map.shape
    m = plants.alive.to(torch.float32)
    row, col = plants.row.long(), plants.col.long()
    cells, vals = [], []
    for w, offs in ((0.6, ((1, 0), (0, 1), (-1, 0), (0, -1))),
                    (0.4, ((1, 1), (-1, 1), (1, -1), (-1, -1)))):
        for dr, dc in offs:
            cells.append(torch.clamp(row + dr, 0, res - 1) * cols
                         + torch.clamp(col + dc, 0, res - 1))
            vals.append(m * w)
    cells, vals = torch.cat(cells), [torch.cat(vals)]
    base = plant_map.reshape(-1).contiguous()
    size = base.numel()
    got = PA.scatter_events(cells, vals, size, [base.clone()])
    want = PA.scatter_events(cells.cpu(), [vals[0].cpu()], size, [base.cpu()])
    _same_bits("K9 at the vegetation's neighbour stamps vs the CPU", [got[0].cpu()], want)
    acc = [base.clone()]
    ms = _time_ms(lambda: PA.scatter_events(cells, vals, size, acc), 20)
    ops = _device_ops_of_last_call(lambda: PA.scatter_events(cells, vals, size, acc))
    _check(len(ops) == 1 and "scatter_sort" in ops[0][0],
           f"K9 device operations a call at the stamps: {ops}")
    print(f"K9 at the vegetation's neighbour stamps: {cells.numel()} events into one given "
          f"{res}² map, bit-equal to the CPU; {ms:.4f} ms a call (CUDA events); "
          f"{len(ops)} device operations, {sum(t for _, t in ops):.1f} µs ("
          + "; ".join(f"{n[:40]} {t:.1f}" for n, t in ops) + ")")


def vegetation_phase():
    """The Quickstart 2048² ``ErosionSim`` with ``VEGETATION_FRICTION = 5``
    on a plant map from 65,536 rooted plants and one growth cycle, then one
    ``step()`` (3 cycles); then the same at 256² on the card and on the CPU
    (1e-4 relative, the descent's card-vs-CPU bar)."""
    import torch

    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.prng import PRNGKey

    settings = ErosionSettings(VEGETATION_FRICTION=5.0)
    h = _quickstart_heights()
    sim = ErosionSim(h, settings=settings)
    plants, root_ms, grow_ms, splat_ms = _plant_world(sim, 65536, PRNGKey(7, device="cuda"))
    alive = int(plants.alive.sum())
    _check(alive > 0 and float(sim.plant_map.max()) > 0, f"{alive} plants alive")
    _stamps_scatter(plants, sim.plant_map)
    _reset_counts()
    _, step_ms = _timed(sim.step)
    counts = _read_counts()
    for k, v in (("height", sim.height_map), ("pool", sim.pool_map), ("stream", sim.stream_map)):
        _check(bool(torch.isfinite(v).all()), f"vegetation sim {k} not finite")
    _check(all(counts[k] > 0 for k in ("K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9")),
           f"vegetation sim launches {counts}")
    small = h[::8, ::8].contiguous()
    out = {}
    for dev in ("cuda", "cpu"):
        s = ErosionSim(small.to(dev), settings=settings, device=dev)
        _plant_world(s, 4096, PRNGKey(7, device=dev))
        s.step()
        out[dev] = [m.cpu().double() for m in (s.height_map, s.pool_map, s.stream_map,
                                               s.plant_map)]
    for name, a, b in zip(("height", "pool", "stream", "plants"), out["cuda"], out["cpu"]):
        gap = float((a - b).abs().max())
        _check(gap <= CROSS_DEVICE_RTOL * max(float(b.abs().max()), 1e-30),
               f"vegetation 256² card vs CPU {name}: {gap}")
    print(f"vegetation 2048²: root 65536 plants {root_ms:.3f} ms ({alive} alive after a grow "
          f"cycle), grow {grow_ms:.3f} ms, density {splat_ms:.3f} ms; ErosionSim.step() with "
          f"VEGETATION_FRICTION=5 {step_ms:.3f} ms, {len(sim.syncs)} host syncs; 256² card "
          f"vs CPU within {CROSS_DEVICE_RTOL}")
    PROFILES.append(("vegetation ErosionSim.step() 2048², VEGETATION_FRICTION=5", sim.step))


def _pile_case(res, radius, seed, n_cand=None):
    """(height, pile map) on the card: smooth terrain, and either 8
    overlapping and border piles of up to 0.5 (``n_cand`` None), or
    ``n_cand`` piles in 4 tied volume levels."""
    import numpy as np
    import torch

    rng = np.random.default_rng(seed)
    h = rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)
    piles = np.zeros((res, res), np.float32)
    if n_cand is None:
        c = res // 2
        cells = [(c, c), (c + 1, c + 3), (c + 4, c - 2), (c - 1, c + 6), (0, 7),
                 (res - 1, res - 1), (c // 2, 0), (c + radius, c + radius)]
        for (r, q), v in zip(cells, (0.05, 0.3, 0.02, 0.12, 0.04, 0.2, 0.08, 0.5)):
            piles[r, q] = v
    else:
        flat = rng.choice(res * res, n_cand, replace=False)
        piles.reshape(-1)[flat] = np.float32(0.01) * rng.integers(1, 5, n_cand)
    return torch.from_numpy(h).cuda(), torch.from_numpy(piles).cuda()


def _pile_layout(kind):
    """(height, pile map) on the card at radius 15, whose slots reach 16
    cells: 64 piles 256 apart at 2048² (``disjoint``: every pile at once),
    or 64 piles 12 apart in a row of a 1024² grid (``chain``: each waits for
    the one before)."""
    import numpy as np
    import torch

    rng = np.random.default_rng(11)
    if kind == "disjoint":
        res, lo, hi = 2048, 0.01, 0.04
        cells = [(128 + 256 * i, 128 + 256 * j) for i in range(8) for j in range(8)]
    else:
        res, lo, hi = 1024, 0.1, 0.3
        cells = [(500, 20 + 12 * j) for j in range(64)]
    h = rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)
    piles = np.zeros((res, res), np.float32)
    for (r, c), v in zip(cells, rng.uniform(lo, hi, len(cells)).astype(np.float32)):
        piles[r, c] = v
    return torch.from_numpy(h).cuda(), torch.from_numpy(piles).cuda()


def _pile_table(h, piles, radius):
    """The sharded EXACT_PILES table at world size 1: (slot values, in-grid
    slots, volumes, clamped cells)."""
    import torch

    from noize_tpu_torch.erosion import sediment as SE

    res = h.shape[0]
    t = SE._pile_tables(radius)
    vols, idxs = SE.select_piles(piles)
    rows_ = (idxs // res)[:, None] + torch.from_numpy(t["off_r"]).to(h.device).long()[None]
    cols_ = (idxs % res)[:, None] + torch.from_numpy(t["off_c"]).to(h.device).long()[None]
    valid = (rows_ >= 0) & (cols_ >= 0) & (rows_ < res) & (cols_ < res)
    cid = rows_.clamp(0, res - 1) * res + cols_.clamp(0, res - 1)
    return h.reshape(-1)[cid], valid, vols, cid


def _sweep_walks(vals0, valid, amount, inc, radius):
    """Per sweep of one pile, from the plain solve's inputs: (visits walked
    until nothing is left to place, or all of them, visits that
    deposit)."""
    import numpy as np

    from noize_tpu_torch.erosion import sediment as SE

    f32 = np.float32
    vals, left, inc, walks = np.array(vals0, f32), f32(amount), f32(inc), []
    while left > 0:
        placed, walked, deposits = f32(0.0), 0, 0
        for rf, end in zip(map(f32, range(1, radius + 1)), SE._pile_tables(radius)["ends"]):
            for k in range(end):
                remaining = left - placed
                if not remaining > 0:
                    break
                walked += 1
                if valid[k] and vals[k] < vals[0] + inc * rf:
                    diff = min(inc, remaining)
                    vals[k], placed, deposits = vals[k] + diff, placed + diff, deposits + 1
            else:
                continue
            break
        walks.append((walked, deposits))
        if placed == 0:
            break
        left = left - placed
    return walks


#: what K11 stands in for: no TPU kernel, the reference's XLA-fused write-back
SEDIMENT_REF = ("none: the sediment write-back, noize_tpu/erosion/sediment.py "
                "write_sediment_map, XLA-fused on the TPU")


def _sediment_case(res, radius):
    """A smooth ``res``² height (cells at the breaker's edges among it) and
    sediment of both signs with piles on the corners, on each edge and
    inside, on the card."""
    import numpy as np
    import torch

    rng = np.random.default_rng(res)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / np.float32(res)
    h = (0.5 + 0.3 * np.sin(6.283 * 3 * x) * np.cos(6.283 * 2 * y)).astype(np.float32)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = np.float32(0.99999)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = np.float32(1e-6)
    sed = rng.normal(0.0, 1e-4, (res, res)).astype(np.float32)
    for r, c in [(0, 0), (0, res - 1), (res - 1, 0), (res - 1, res - 1), (0, res // 2),
                 (res // 2, 0), (res - 1, res // 3), (res // 3, res - 1), (1, 5),
                 (radius - 1, radius), (res // 2, res // 2)]:
        sed[r, c] = rng.uniform(0.005, 0.05)
    return torch.from_numpy(h).cuda(), torch.from_numpy(sed).cuda()


def sediment_phase(rows):
    """K11 (the sediment write-back) against ``write_sediment_map_plain`` on
    the card at 2048², 1024² and 1025² with piles on the corners and edges
    (the tent of radius 15 on), and without piles: bit for bit, timed (the
    kernels line's K11 rows: the launch alone, against the plain version's
    whole write-back); the device operations of one ``write_sediment_map``
    call; then one ErosionSim step at each size (K11 once a cycle)."""
    import torch

    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim

    params = ErosionSettings().as_parameters()
    radius = params.PILING_RADIUS
    thresh = float(torch.tensor(params.PILE_THRESHOLD / 1000.0, dtype=torch.float32))
    for res in (2048, 1024, 1025):
        h, sed = _sediment_case(res, radius)
        calm = torch.clamp(sed, max=0.0)  # no pile: the tent is off
        for what, s in (("piles", sed), ("no pile", calm)):
            got = SE.write_sediment_map(h, s, params, 1000.0)
            _same_bits(f"K11 {res}² ({what})", (got,),
                       (SE.write_sediment_map_plain(h, s, params, 1000.0),))
            _check(not torch.equal(got, h), f"K11 {res}² ({what}) changed nothing")
        key = f"K11@{res}"
        ops, nbytes = SK.cost(res, res, radius)
        rows.compare(key, f"K11 write_sediment_cuda, {res}² with piles (tent radius {radius})",
                     SRC["K11"], SEDIMENT_REF, (SK._launch(h, sed, thresh, radius),),
                     lambda: SK._launch(h, sed, thresh, radius),
                     lambda: (SE.write_sediment_map_plain(h, sed, params, 1000.0),), key, 20,
                     nbytes, ops)
        calm_ms = _time_ms(lambda: SK._launch(h, calm, thresh, 0), 20)
        whole_ms = _time_ms(lambda: SE.write_sediment_map(h, sed, params, 1000.0), 20)
        host_us = _host_us(lambda: SK._launch(h, sed, thresh, radius))
        dev = _device_ops_of_last_call(lambda: SE.write_sediment_map(h, sed, params, 1000.0))
        k11 = [us for name, us in dev if "sediment_tile" in name]
        _check(len(k11) == 1, f"write_sediment_map ran {len(k11)} K11 kernels: {dev}")
        bound_calm, by_calm = _bound(*reversed(SK.cost(res, res)))
        print(f"K11 {res}²: bit-equal to the plain version with piles and without; the kernel "
              f"{rows.rows[key]['ms']:.4f} ms with the tent (device {k11[0]:.1f} µs, host "
              f"enqueue {host_us:.1f} µs), {calm_ms:.4f} ms without (bound {bound_calm:.4f} ms, "
              f"{by_calm}); write_sediment_map with its sync {whole_ms:.4f} ms in "
              f"{len(dev)} device operations {[n[:40] for n, _ in dev]}")
        _reset_counts()
        sim = ErosionSim(h)
        sim.step()
        torch.cuda.synchronize()
        counts = _read_counts()
        _check(counts["K11"] == sim.settings.CYCLES,
               f"a {res}² step launched K11 {counts['K11']} times")
        rows.set_launches({key: counts["K11"]})
        print(f"K11 {res}² step: {counts['K11']} launches, "
              f"{SK.write_sediment_cuda.tent_launches} with the tent")


#: what K12 stands in for: no TPU kernel, the reference's XLA-fused deposit and decay
DECAY_REF = ("none: the deposit's adds and the track/flow decay, noize_tpu/erosion/sim.py's "
             "adds and world.py update_flow_from_track, XLA-fused on the TPU")


def decay_phase(rows):
    """K12 (the deposit's adds and the track/flow decay) against
    ``deposit_and_decay_plain`` on the card at 2048², 1024² and 1025²: with
    the accumulators, without them, and with flow and track written in
    place, bit for bit; timed at 2048² and 1024² (the kernels line's K12
    rows: the launch alone, bound by bytes, against the plain version's 19
    operations); the device operations of one call; then one ErosionSim
    step at each size (K12 once a cycle)."""
    from dataclasses import replace

    import torch

    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion import world as W
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim

    params = ErosionSettings().as_parameters()
    for res in (2048, 1024, 1025):
        g = torch.Generator(device="cuda").manual_seed(res)

        def rand(scale):
            return torch.rand((res, res), generator=g, device="cuda") * scale

        world = W.WorldState(height=rand(1.0), pool=rand(1e-4), flow=rand(0.3),
                             track=torch.where(rand(1.0) < 0.5, rand(1e-4), 0.0),
                             plants=torch.zeros((res, res), device="cuda"))
        track_acc, pool_acc = rand(1e-4), rand(1e-4)
        for what, accs in (("accumulators", (track_acc, pool_acc)), ("no spawn", (None, None))):
            want = W.deposit_and_decay_plain(world, *accs, params, 1000.0)
            got = W.deposit_and_decay(world, *accs, params, 1000.0)
            _same_bits(f"K12 {res}² ({what})", (got.pool, got.flow, got.track),
                       (want.pool, want.flow, want.track))
        into = replace(world, flow=world.flow.clone(), track=world.track.clone())
        got = W.deposit_and_decay(into, track_acc, pool_acc, params, 1000.0, out=into)
        want = W.deposit_and_decay_plain(world, track_acc, pool_acc, params, 1000.0)
        _check(got.flow is into.flow and got.track is into.track, "K12 out= not written")
        _same_bits(f"K12 {res}² (in place)", (got.pool, got.flow, got.track),
                   (want.pool, want.flow, want.track))
        key = f"K12@{res}"

        def kernel():
            return W.deposit_and_decay(world, track_acc, pool_acc, params, 1000.0)

        def plain():
            w = W.deposit_and_decay_plain(world, track_acc, pool_acc, params, 1000.0)
            return w.pool, w.flow, w.track

        if res != 1025:
            ops, nbytes = DK.cost(res, res)
            k = kernel()
            rows.compare(key, f"K12 deposit_and_decay_cuda, {res}² with the accumulators",
                         SRC["K12"], DECAY_REF, (k.pool, k.flow, k.track), kernel, plain, key,
                         50, nbytes, ops)
            host_us = _host_us(kernel)
            dev = _device_ops_of_last_call(kernel)
            k12 = [us for name, us in dev if "decay_cells" in name]
            _check(len(k12) == 1, f"deposit_and_decay ran {len(k12)} K12 kernels: {dev}")
            print(f"K12 {res}²: bit-equal to the plain version with the accumulators, without "
                  f"and in place; the kernel {rows.rows[key]['ms']:.4f} ms (device "
                  f"{k12[0]:.1f} µs, host enqueue {host_us:.1f} µs) in {len(dev)} device "
                  f"operations {[n[:40] for n, _ in dev]}")
        _reset_counts()
        sim = ErosionSim(world.height)
        sim.step()
        torch.cuda.synchronize()
        counts = _read_counts()
        _check(counts["K12"] == sim.settings.CYCLES,
               f"a {res}² step launched K12 {counts['K12']} times")
        if res != 1025:
            rows.set_launches({key: counts["K12"]})
        print(f"K12 {res}² step: {counts['K12']} launches")


def exact_piles_phase(rows):
    """K6 against its plain version (bit-equal) at 256² with overlapping
    and border piles, radius 4 and 15; K6 and its table entry on 64
    disjoint and on 64 chained piles (bit-equal, timed); K6 alone at 2048²
    with 64 of 100 tied candidates (timed, the kernels line's row) and the
    visits its sweeps walk; then a 2048² sim step with ``EXACT_PILES`` (K6
    one launch a cycle)."""
    import numpy as np
    import torch

    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim

    inc = SE.pile_increment(ErosionSettings().as_parameters(), 1000.0)
    for radius in (4, 15):
        h, piles = _pile_case(256, radius, radius)
        got = PL.exact_piles(h, piles, inc, radius)
        want = SE.exact_pile_deposit_plain(h, piles, inc, radius)
        torch.cuda.synchronize()
        _check(torch.equal(got, want), f"K6 disagrees with its plain version at radius {radius}")
        _check(not torch.equal(got, h), "K6 deposited nothing")
    radius = 15
    for kind in ("disjoint", "chain"):
        h, piles = _pile_layout(kind)
        table = _pile_table(h, piles, radius)
        got = PL.exact_piles(h, piles, inc, radius)
        got_t = PL.solve_pile_table(*table, inc, radius)
        want = SE.exact_pile_deposit_plain(h, piles, inc, radius)
        want_t = SE.solve_pile_table_plain(*table, inc, radius)
        torch.cuda.synchronize()
        _check(torch.equal(got, want) and not torch.equal(got, h),
               f"K6 disagrees with its plain version on the {kind} piles")
        _check(torch.equal(got_t[0], want_t[0]) and torch.equal(got_t[1], want_t[1]),
               f"K6's table entry disagrees with its plain version on the {kind} piles")
        ms = _time_ms(lambda: PL.exact_piles(h, piles, inc, radius), 20)
        table_ms = _time_ms(lambda: PL.solve_pile_table(*table, inc, radius), 20)
        print(f"K6 on 64 {kind} piles at radius {radius} ({h.shape[0]}²): bit-equal to the "
              f"plain versions; K6 {ms:.4f} ms, K6@table {table_ms:.4f} ms")
        PROFILES.append((f"K6 call, 64 {kind} piles ({h.shape[0]}²)",
                         lambda h=h, piles=piles: PL.exact_piles(h, piles, inc, radius)))
    res = 2048
    h, piles = _pile_case(res, radius, 3, n_cand=100)
    got = PL.exact_piles(h, piles, inc, radius)
    slots = len(SE._pile_tables(radius)["off_r"])
    visits = int(SE._pile_tables(radius)["ends"].sum())
    inputs, solve = [], SE._solve_pile
    SE._solve_pile = lambda *a: (inputs.append(a[:3]), solve(*a))[1]
    try:
        SE.exact_pile_deposit_plain(h, piles, inc, radius)
    finally:
        SE._solve_pile = solve
    PROFILES.append((f"K6 call, 64 of 100 piles ({res}²)",
                     lambda: PL.exact_piles(h, piles, inc, radius)))
    walks = [w for a in inputs for w in _sweep_walks(*a, inc, radius)]
    walked, deposits = np.array(walks).T
    print(f"K6 {res}² case: {len(inputs)} piles, {len(walks)} sweeps; a sweep walks "
          f"{walked.min()}-{walked.max()} (median {np.median(walked):g}) of its {visits} "
          f"visits before its pile is placed ({int((walked == visits).sum())} walk all), "
          f"{deposits.min()}-{deposits.max()} of them deposit")
    rows.compare(
        "K6", f"K6 exact PileSolver, 64 of 100 piles (4 tied levels), radius {radius} "
        f"({res}²)", SRC["K6"],
        "none: noize_tpu/erosion/sediment.py:178 (_solve_pile, an XLA while_loop of scans; "
        "no Pallas kernel)",
        (got,), lambda: PL.exact_piles(h, piles, inc, radius),
        lambda: (SE.exact_pile_deposit_plain(h, piles, inc, radius),), "K6", 20,
        # the height read and written and the pile map read; at least one
        # sweep of ~8 operations a visit for each of the 64 piles
        12 * res * res, 8 * visits * 64)
    print(f"K6 tables at radius {radius}: {slots} slots, {visits} visits a sweep")
    settings = ErosionSettings(EXACT_PILES=True)
    sim = ErosionSim(_quickstart_heights(), settings=settings)
    _reset_counts()
    _, step_ms = _timed(sim.step)
    counts = _read_counts()
    _check(counts["K6"] > 0, f"K6 was not launched by the EXACT_PILES step: {counts}")
    _check(all(counts[k] > 0 for k in ("K7", "K8", "K7@records", "K8@randint", "K9")),
           f"EXACT_PILES step launches {counts}")
    _check(counts["K6"] <= settings.CYCLES, f"K6 launched {counts['K6']} times in a step")
    _check(bool(torch.isfinite(sim.height_map).all()), "EXACT_PILES heights not finite")
    rows.set_launches({"K6": counts["K6"]})
    print(f"EXACT_PILES ErosionSim.step() 2048²: {step_ms:.3f} ms, launches {counts}, "
          f"{len(sim.syncs)} host syncs")
    PROFILES.append(("EXACT_PILES ErosionSim.step() 2048²", sim.step))


def native_io_phase(sim):
    """The Quickstart state at 2048² checkpointed through the native IO
    runtime: synchronously, then queued (``async_``) and flushed; restored
    equal in a fresh store; a corrupted payload byte refused; the
    Quickstart's mesh through the native OBJ writer."""
    import torch

    from noize_tpu_torch.app import mesh_export as ME
    from noize_tpu_torch.core.store import PipelineStateManager
    from noize_tpu_torch.ops.mesh import heightmap_mesh_overshoot

    maps = {"height": sim.height_map, "pool": sim.pool_map, "stream": sim.stream_map,
            "drain": sim.state.drain_water}
    with tempfile.TemporaryDirectory() as d:
        sm = PipelineStateManager(d, "world", "v1")
        for k, v in maps.items():
            sm.set_buffer(k, v)
        fails, sync_ms = _timed(lambda: sm.save_all(async_=False))
        _check(fails == {}, f"sync save failed: {fails}")
        t0 = time.perf_counter()
        for k in maps:
            sm.save_buffer_to_disk(k, async_=True)
        queue_ms = (time.perf_counter() - t0) * 1e3
        sm.serde.flush()
        async_ms = (time.perf_counter() - t0) * 1e3
        fresh = PipelineStateManager(d, "world", "v1")
        for k, v in maps.items():
            _check(torch.equal(fresh.get_buffer(k), v), f"restored {k} differs")
        _check(not [n for _, _, ns in os.walk(d) for n in ns if n.endswith(".tmp")],
               "a .tmp file was left behind")
        path = fresh.serde._path_for("height")
        at = os.path.getsize(path) // 2  # a payload byte
        with open(path, "r+b") as fh:
            fh.seek(at)
            b = fh.read(1)
            fh.seek(at)
            fh.write(bytes([b[0] ^ 0x10]))
        try:
            PipelineStateManager(d, "world", "v1").get_buffer("height")
            refused = False
        except OSError as e:
            refused = "checksum" in str(e)
        _check(refused, "a corrupted checkpoint was read")
        # the OBJ writer on the Quickstart's mesh, and byte-identical to the
        # NumPy writer on a 256² tile of it
        mesh = heightmap_mesh_overshoot(sim.height_map, 2016, 2048, 1000.0, 2016.0)
        obj = os.path.join(d, "tile.obj")
        _, obj_ms = _timed(lambda: ME.to_obj(obj, mesh))
        obj_mb = os.path.getsize(obj) / 1e6
        small = heightmap_mesh_overshoot(sim.height_map[:264, :264].contiguous(), 256, 264,
                                         1000.0, 256.0)
        ME.to_obj(os.path.join(d, "a.obj"), small)
        ME.to_obj_numpy(os.path.join(d, "b.obj"), small)
        with open(os.path.join(d, "a.obj"), "rb") as fa, open(os.path.join(d, "b.obj"),
                                                              "rb") as fb:
            _check(fa.read() == fb.read(), "the native OBJ differs from the NumPy writer's")
    mb = sum(v.numel() * 4 for v in maps.values()) / 1e6
    print(f"native IO 2048² ({len(maps)} maps, {mb:.1f} MB): save_all sync {sync_ms:.3f} ms; "
          f"async {queue_ms:.3f} ms to queue, {async_ms:.3f} ms with flush; restored equal, "
          f"corrupted payload refused; OBJ of {mesh.positions.shape[0]} vertices "
          f"({obj_mb:.1f} MB) {obj_ms:.1f} ms, 256² byte-identical to the NumPy writer's")


def sharded_phase(rows):
    """The field-level parallel layer on one card: a one-rank NCCL group,
    ``spatial_mesh`` and ``batch_mesh`` of 1, the five sharded field ops
    at 2048² against the local ops (bit-equal), and ``tile_batch(mesh=)``
    of 4 of config 5's tiles against ``tile_batch``; then the sharded
    erosion path and the multichip example on that group.  Returns the
    example's FAST run on the card."""
    import torch
    import torch.distributed as dist

    from noize_tpu_torch.ops.cuda.flow import flow_map_fused
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
    from noize_tpu_torch.ops.fractal import fractal
    from noize_tpu_torch.ops.kernels import kernel_filter
    from noize_tpu_torch.parallel import device_mesh as DM
    from noize_tpu_torch.parallel import distributed as D
    from noize_tpu_torch.parallel import sharded_ops as SO
    from noize_tpu_torch.parallel import tiled as TL

    noise, blurred, _ = _inputs(2048)
    fr = dict(noise_type="Simplex", hurst=0.4, octaves=13, noise_size=1700.0)
    with tempfile.TemporaryDirectory() as d:
        _check(D.initialize(f"file://{d}/init", 1, 0), "initialize returned False")
        try:
            sp, bm = DM.spatial_mesh(), DM.batch_mesh()
            _check(tuple(sp.shape) == (1, 1) and tuple(bm.shape) == (1,),
                   f"meshes {sp.shape} {bm.shape}")
            ops = {
                "fractal": (lambda: SO.sharded_fractal(sp, 2048, 0.0, 0.0, **fr),
                            lambda: fractal(2048, 0.0, 0.0, device="cuda", **fr)),
                "gauss_blur": (lambda: SO.sharded_gauss_blur(sp, noise, 5, 1.0, 17),
                               lambda: gauss_chain(noise, 5, 1.0, 17)),
                "kernel_filter": (lambda: SO.sharded_kernel_filter(sp, blurred, "Sobel3_2D"),
                                  lambda: kernel_filter(blurred, "Sobel3_2D")),
                "thermal": (lambda: SO.sharded_thermal_erosion(sp, blurred, 45.0, 0.5, 1.0),
                            lambda: thermal_erosion_fused(blurred, 45.0, 0.5, 1.0)),
                "flow_map": (lambda: SO.sharded_flow_map(sp, blurred, 8),
                             lambda: flow_map_fused(blurred, 8)),
            }
            _reset_counts()
            got = {k: _timed(f) for k, (f, _) in ops.items()}  # the first calls
            counts = _read_counts()
            for k, (sharded, local) in ops.items():
                _, warm_ms = _timed(sharded)
                want, local_ms = _timed(local)
                _check(torch.equal(got[k][0].full_tensor(), want),
                       f"sharded {k} differs from the local op")
                print(f"sharded {k} 2048² on a 1×1 mesh: first call {got[k][1]:.3f} ms, then "
                      f"{warm_ms:.3f} ms (local {local_ms:.3f} ms), equal")
            for key, n in (("K1", 1), ("K1@rss", 1), ("K2", 1), ("K3", 1)):
                _check(counts[key] == n, f"sharded ops launched {key} {counts[key]} times")
            cfg, origins = config5()
            tiles, mesh_ms = _timed(lambda: TL.tile_batch(cfg, origins[:4], mesh=bm))
            want, local_ms = _timed(lambda: TL.tile_batch(cfg, origins[:4]))
            _check(torch.equal(tiles.full_tensor(), want), "tile_batch(mesh=) differs")
            print(f"sharded launches {counts}; tile_batch(mesh=batch_mesh of 1) of 4 config-5 "
                  f"tiles {mesh_ms:.1f} ms (without mesh {local_ms:.1f} ms), equal")
            del tiles, want
            sharded_erosion_phase(sp, bm, rows)
            return multichip_example_phase()
        finally:
            dist.destroy_process_group()


def _equal_maps(what, got, want):
    """Check that the sharded state ``got`` equals ``want``; returns the
    largest gap (0.0)."""
    import torch

    gaps = {}
    for k in ("height", "pool", "flow", "track", "plants"):
        a, b = getattr(got.world, k).full_tensor(), getattr(want.world, k)
        gaps[k] = _max_abs(a, b)
        _check(torch.equal(a, b), f"{what}: {k} differs (gaps {gaps})")
    _check(torch.equal(got.drain_water.full_tensor(), want.drain_water), f"{what}: drains differ")
    _check(torch.equal(got.key, want.key), f"{what}: keys differ")
    return max(gaps.values())


def sharded_erosion_phase(sp, bm, rows):
    """The sharded erosion path on the one-rank group (``sp``: the 1×1
    spatial mesh, ``bm``: the batch mesh of 1), each piece against its
    single-device counterpart, bit-equal: sim steps, an ``EXACT_PILES``
    cycle, the flagship step, the mesh, the checkpoint, a server wave and
    the dry run.  Each path resets the launch counts just before it."""
    import dataclasses

    import torch

    from noize_tpu_torch.app.dryrun import dryrun_multichip
    from noize_tpu_torch.app.flagship import default_meta, make_tile_step
    from noize_tpu_torch.app.server import TileServer
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.erosion.sim import ErosionSim, erosion_cycle, init_state
    from noize_tpu_torch.ops.mesh import heightmap_mesh_overshoot
    from noize_tpu_torch.parallel import sharded_erosion as SE
    from noize_tpu_torch.parallel import sharded_mesh as SM
    from noize_tpu_torch.parallel.sharded_checkpoint import ShardedCheckpoint
    from noize_tpu_torch.prng import PRNGKey

    h = _quickstart_heights()
    # ShardedErosionSim against ErosionSim, defaults, 3 cycles a step, in
    # turns: single, sharded (checked equal), sharded, single
    single, sharded = ErosionSim(h), SE.ShardedErosionSim(sp, h)
    _, single_ms = _timed(single.step)
    _reset_counts()
    _, sharded_ms = _timed(sharded.step)
    counts = _read_counts()
    _equal_maps("ShardedErosionSim.step", sharded.state, single.state)
    chunks = -(-(sharded.settings.MAXAGE + 1) // 8)
    groups = -(-sharded.settings.WATER_STEPS // SE.POOL_GROUP)  # one K5 window call a group
    _check(counts["K3"] == 3 and counts["K5@window"] == 3 * groups
           and counts["K4"] == 0 and counts["K7@window"] == 3 * chunks and counts["K7"] == 0
           and counts["K8"] > 0 and counts["K8@randint"] > 0 and counts["K9"] > 0
           and counts["K7@records"] > 0, f"sharded sim launches {counts}")
    rows.set_launches({"K5@window": counts["K5@window"], "K7@window": counts["K7@window"]})
    _, sharded_ms2 = _timed(sharded.step)
    _, single_ms2 = _timed(single.step)
    print(f"ShardedErosionSim.step() 2048² (1×1 mesh, 3 cycles): {sharded_ms:.3f} and "
          f"{sharded_ms2:.3f} ms; ErosionSim.step() {single_ms:.3f} and {single_ms2:.3f} ms; "
          f"equal after the first step; launches {counts}")

    # one EXACT_PILES cycle on the same height
    settings = dataclasses.replace(ErosionSettings(), EXACT_PILES=True)
    meta = sharded.meta
    want, single_ex_ms = _timed(lambda: erosion_cycle(init_state(h, PRNGKey(0, device="cuda")),
                                                      settings, meta))
    start = init_state(SE.ShardedErosionSim(sp, h).original_height, PRNGKey(0, device="cuda"))
    _reset_counts()
    got, sharded_ex_ms = _timed(lambda: SE.sharded_erosion_cycle(sp, start, settings, meta))
    counts = _read_counts()
    _equal_maps("EXACT_PILES sharded cycle", got, want)
    _check(counts["K6@table"] == 1, f"EXACT_PILES sharded cycle launches {counts}")
    rows.set_launches({"K6@table": counts["K6@table"]})
    print(f"EXACT_PILES sharded_erosion_cycle 2048²: {sharded_ex_ms:.3f} ms (erosion_cycle "
          f"{single_ex_ms:.3f} ms), equal; launches {counts}")
    del want, got, start

    # the flagship step, sharded, at its 2048² defaults (one erosion cycle)
    fmeta = default_meta()
    step, _, _ = SE.make_sharded_tile_step(sp, fmeta, erosion_cycles=1)
    ref_step, _, _ = make_tile_step(fmeta, emit_mesh=False, device="cuda")
    want, ref_ms = _timed(lambda: ref_step(0.0, 0.0, PRNGKey(0, device="cuda")))
    _reset_counts()
    (state, flow_v), step_ms = _timed(lambda: step(0.0, 0.0, PRNGKey(0, device="cuda")))
    counts = _read_counts()
    for k, got in (("height", state.world.height), ("flow_velocity", flow_v),
                   ("pool", state.world.pool), ("stream", state.world.flow)):
        _check(torch.equal(got.full_tensor(), want[k]), f"sharded tile step: {k} differs")
    for k in ("K1", "K2", "K3", "K5@window", "K7@window", "K8", "K8@randint", "K9", "K10"):
        _check(counts[k] > 0, f"{k} not launched by the sharded tile step: {counts}")
    print(f"make_sharded_tile_step 2048² (1 cycle): {step_ms:.3f} ms (make_tile_step "
          f"{ref_ms:.3f} ms), equal; launches {counts}")
    del want, state, flow_v

    # the sharded mesh of the Quickstart tile (a 16-cell margin)
    height = sharded.state.world.height
    res = height.shape[0]
    tile = res - 32
    fields, mesh_ms = _timed(lambda: SM.sharded_heightmap_mesh(sp, height, tile, res, 1000.0,
                                                               float(tile)))
    got = SM.mesh_arrays_from_fields(fields, tile, res, (1, 1))
    want, ref_mesh_ms = _timed(lambda: heightmap_mesh_overshoot(height.full_tensor(), tile,
                                                                res, 1000.0, float(tile)))
    for f in ("positions", "normals", "tangents", "uvs", "indices"):
        _check(torch.equal(getattr(got, f), getattr(want, f)), f"sharded mesh: {f} differs")
    print(f"sharded_heightmap_mesh of the Quickstart tile ({tile + 1}² vertices): {mesh_ms:.3f} "
          f"ms (heightmap_mesh_overshoot {ref_mesh_ms:.3f} ms), equal")
    del fields, got, want

    # the six maps through a ShardedCheckpoint
    with tempfile.TemporaryDirectory() as d:
        ckpt = ShardedCheckpoint(d)
        arrays = [(sharded._buffer_name(a), arr) for a, _, arr in sharded._state_arrays()]

        def save():
            for name, arr in arrays:
                ckpt.save(name, arr, async_=True)
            ckpt.flush()
        _, save_ms = _timed(save)
        back, load_ms = _timed(lambda: [ShardedCheckpoint(d).load(n, sp) for n, _ in arrays])
        for (name, arr), b in zip(arrays, back):
            _check(torch.equal(b.full_tensor(), arr.full_tensor()), f"checkpoint {name} differs")
    mb = sum(arr.numel() * 4 for _, arr in arrays) / 1e6
    print(f"ShardedCheckpoint of the six maps ({mb:.1f} MB): save (queued) and flush "
          f"{save_ms:.3f} ms, load {load_ms:.3f} ms, equal")
    del back

    # a TileServer wave over the batch mesh against the server without one
    cfg, origins = config5()
    poses = [(x // cfg.meta.tile_res, z // cfg.meta.tile_res) for x, z in origins.tolist()]
    waves = {}
    for label, mesh in (("without mesh", None), ("mesh=batch_mesh()", bm)):
        srv = TileServer(cfg, batch_size=4, mesh=mesh)
        done = {}
        if label != "without mesh":
            _reset_counts()
        try:
            srv.start()
            t0 = time.perf_counter()
            for i, pos in enumerate(poses):
                srv.submit(f"t{i}", pos, on_complete=lambda st: done.__setitem__(
                    st.request.uuid, st))
            _check(srv.drain(timeout=600), f"TileServer {label}: the wave did not drain")
            waves[label] = ((time.perf_counter() - t0) * 1e3, srv.batches)
        finally:
            srv.stop()
        _check(len(done) == len(poses) and not srv.errors, f"TileServer {label}: {srv.errors}")
        waves[label] += ({k: st.heights for k, st in done.items()},)
    counts = _read_counts()
    for i in range(len(poses)):
        _check(torch.equal(waves["mesh=batch_mesh()"][2][f"t{i}"],
                           waves["without mesh"][2][f"t{i}"]),
               f"TileServer(mesh=) tile {i} differs from the server without a mesh")
    _check(counts["K1"] > 0 and counts["K3"] > 0, f"TileServer(mesh=) launches {counts}")
    for label, (wall, batches, _) in waves.items():
        print(f"TileServer({label}) wave: 16 config-5 tiles in {batches} batches of 4, "
              f"{wall:.3f} ms ({wall / 16:.3f} ms/tile)")
    del waves

    _, dry_ms = _timed(lambda: dryrun_multichip(1))
    print(f"dryrun_multichip(1): {dry_ms:.1f} ms (a child process with its own NCCL group)")
    # last in the group's life: the profiler slows what runs after it
    profile_path("ShardedErosionSim.step() 2048² (1×1 mesh, 3 cycles)", sharded.step)


def _pool_stitch(h, p, nx, ny, iters, group):
    """``iters`` water steps of the sharded pool's scheme on one card: each
    block of an nx × ny split extended 8 cells a step of a group toward its
    neighbours (an exchange, emulated), one call of K5's window entry a
    block a group of ``group`` steps with the block kept and its drains
    carried in, the blocks cropped and stitched."""
    import torch

    from noize_tpu_torch.erosion import pool_cuda as PC

    res = h.shape[0]
    lr, lc = res // nx, res // ny
    halo = 8 * group
    wins = []
    for i in range(nx):
        for j in range(ny):
            r0, c0 = i * lr, j * lc
            er0, ec0 = max(0, r0 - halo), max(0, c0 - halo)
            er1, ec1 = min(res, r0 + lr + halo), min(res, c0 + lc + halo)
            wins.append(((slice(er0, er1), slice(ec0, ec1)),
                         (slice(r0 - er0, r0 - er0 + lr), slice(c0 - ec0, c0 - ec0 + lc)),
                         (slice(r0, r0 + lr), slice(c0, c0 + lc))))
    p, d = p.clone(), torch.zeros_like(p)
    hw = [h[w].contiguous() for w, _, _ in wins]
    for done in range(0, iters, group):
        new_p, new_d = p.clone(), d.clone()
        for (w, core, block), hb in zip(wins, hw):
            op, od = PC.pool_automata_window(hb, p[w].contiguous(), d[w].contiguous(),
                                             min(group, iters - done), True,
                                             (w[0].start, w[1].start), res)
            new_p[block], new_d[block] = op[core], od[core]
        p, d = new_p, new_d
    return p, d


def window_kernels_phase(rows):
    """K5's window entry stitched over 2×2 and 4×1 splits of a wet 2048²
    pool and a 3×3 split of 2049², on the sharded pool's schedule (one call
    a block a group of ``POOL_GROUP`` water steps, 8 cells of halo a step),
    against K5 on the whole grid (the stitched pool and drains bit-equal),
    timed against the whole-grid call; the row K5@window: one call of the
    group's steps on the 2×2 split's first window, drains carried in,
    against its plain version on the cells it keeps.  Then K6 on the pile
    table of 64 of 100 tied piles at radius 15 against its plain version
    and, committed, against K6 on the map (the row K6@table)."""
    import torch

    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import pool as PO
    from noize_tpu_torch.erosion import pool_cuda as PC
    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion.params import ErosionSettings
    from noize_tpu_torch.parallel.sharded_erosion import POOL_GROUP

    steps = ErosionSettings().WATER_STEPS
    group = min(POOL_GROUP, steps)
    for size, splits in ((2048, ((2, 2), (4, 1))), (2049, ((3, 3),))):
        _, h, p = _inputs(size)
        res = h.shape[0]
        want_p, want_d = PC.pool_automata_full_cuda(h, p, steps, True)
        whole_ms = _time_ms(lambda: PC.pool_automata_full_cuda(h, p, steps, True), 10)
        for nx, ny in splits:
            got_p, got_d = _pool_stitch(h, p, nx, ny, steps, group)
            torch.cuda.synchronize()
            _check(torch.equal(got_p, want_p) and torch.equal(got_d, want_d),
                   f"K5 windows of a {nx}×{ny} split of {res}² differ from K5 on the grid: "
                   f"{_max_abs(got_p, want_p)}, {_max_abs(got_d, want_d)}")
            stitch_ms = _time_ms(lambda: _pool_stitch(h, p, nx, ny, steps, group), 10)
            print(f"K5 windows, {nx}×{ny} split of a wet {res}² pool: stitched over {steps} "
                  f"water steps in groups of {group} (halo {8 * group}), bit-equal to K5 on the "
                  f"grid; the stitched steps ({nx * ny * -(-steps // group)} calls, crops and "
                  f"stitch) {stitch_ms:.4f} ms, {stitch_ms / steps:.4f} ms a step; the "
                  f"whole-grid call {whole_ms:.4f} ms, {whole_ms / steps:.4f} ms a step")
        _check(not torch.equal(want_p, p), f"K5 ran no phase on the wet {res}² pool")
    # the row: the 2×2 split's first window, a group of water steps, drains
    # carried in, the block kept
    _, h, p = _inputs(2048)
    res = h.shape[0]
    half, side = res // 2, res // 2 + 8 * group
    _, d0 = PC.pool_automata_full_cuda(h, p, 1, True)
    win, core = (slice(0, side), slice(0, side)), (slice(0, half), slice(0, half))
    hw, pw, dw = h[win].contiguous(), p[win].contiguous(), d0[win].contiguous()
    got = PC.pool_automata_window(hw, pw, dw, group, True, (0, 0), res)
    _check(not torch.equal(got[1][core], dw[core]), "K5's window added no drains")
    # what step s leaves exact: the window less 8 (s + 1) at its inner edges
    needed = sum((side - 8 * (s + 1)) ** 2 for s in range(group))
    rows.compare("K5@window", f"K5 pool_automata_window, {group} water steps in one call on the "
                 f"{side}² window of a 2×2 split of a wet {res}² pool, drains carried in (the "
                 f"{half}² block kept; step s computes its tiles of the window less 8 (s + 1) at "
                 "the inner edges)", SRC["K5"], POOL_TPU + ":30", tuple(t[core] for t in got),
                 lambda: PC.pool_automata_window(hw, pw, dw, group, True, (0, 0), res),
                 lambda: tuple(t[core] for t in PO._pool_automata_window(hw, pw, dw, group, True,
                                                                          (0, 0), res)),
                 "window", 20, 20 * side * side, POOL_OPS_PER_ITER * needed)
    print(f"K5@window: {rows.rows['K5@window']['ms'] / group:.4f} ms a water step ({group} "
          "a call)")
    del h, p, want_p, want_d, got_p, got_d, d0, got

    # K6 on the pile table
    radius, inc = 15, SE.pile_increment(ErosionSettings().as_parameters(), 1000.0)
    h, piles = _pile_case(2048, radius, 3, n_cand=100)
    res = h.shape[0]
    t = SE._pile_tables(radius)
    vals0, valid, vols, cid = _pile_table(h, piles, radius)
    got = PL.solve_pile_table(vals0, valid, vols, cid, inc, radius)
    committed = h.clone().reshape(-1)
    for j in range(vols.numel()):
        committed[cid[j][got[1][j]]] = got[0][j][got[1][j]]
    _check(torch.equal(committed.reshape(res, res), PL.exact_piles(h, piles, inc, radius)),
           "K6's table solve, committed, differs from K6 on the map")
    k, s = vals0.shape
    visits = int(t["ends"].sum())
    rows.compare(
        "K6@table", f"K6 solve_pile_table, 64 of 100 piles (4 tied levels) at radius {radius}, "
        f"{k} × {s} slots", SRC["K6"],
        "none: noize_tpu/parallel/sharded_erosion.py:384 (the sharded _solve_pile fori_loop, "
        "an XLA loop; no Pallas kernel)",
        (got[0], got[1].float()), lambda: PL.solve_pile_table(vals0, valid, vols, cid, inc, radius),
        lambda: tuple(a.float() for a in SE.solve_pile_table_plain(vals0, valid, vols, cid, inc,
                                                                    radius)),
        "table", 20, 18 * k * s + 4 * k, 8 * visits * 64)
    print(f"K6 table: committed equal to K6 on the {res}² map")
    PROFILES.append((f"K6@table call, 64 of 100 piles ({res}²)",
                     lambda: PL.solve_pile_table(vals0, valid, vols, cid, inc, radius)))


#: (label, callable) of each step path, profiled once after every timed phase
PROFILES = []


def profile_path(label, fn):
    """One more run of ``fn`` under ``torch.profiler``: wall time, device
    busy time, idle share of the wall clock and the kernels that take it."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies, sets): an operator's own
    # entry also carries the device time of the kernels it launched
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA
              and e.self_device_time_total > 0]
    busy_ms = sum(e.self_device_time_total for e in events) / 1e3
    if busy_ms == 0:
        print(f"profiled {label}: wall {wall_ms:.3f} ms; device time not measured "
              "(the profiler saw no device activity)")
        return
    n_ops = sum(e.count for e in events)
    top = sorted(events, key=lambda e: -e.self_device_time_total)[:6]
    print(f"profiled {label}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms in {n_ops} "
          f"device ops, idle share {1 - busy_ms / wall_ms:.3f}")
    print("  top device time: " + "; ".join(
        f"{e.key[:60]} {e.self_device_time_total / 1e3:.3f} ms ×{e.count}" for e in top))


def pool_trace_phase():
    """One wet K4 call and one wet K5 call on the 2048² wet pool under
    ``torch.profiler``: the device kernels each runs (the init kernel and
    one fused launch per water step)."""
    from noize_tpu_torch.app.flagship import default_settings
    from noize_tpu_torch.erosion import pool_cuda as PC

    steps = default_settings().WATER_STEPS
    want = 1 + steps
    _, blurred, pool = _inputs(2048)
    for key, fn in (("K4", PC.pool_automata_cuda), ("K5", PC.pool_automata_full_cuda)):
        before = _wet(fn)
        fn(blurred, pool, steps, True)
        _check(_wet(fn) == before + 1, f"{key} call's gate stayed closed")
        kernels = _device_ops_of_last_call(lambda: fn(blurred, pool, steps, True),
                                           ("pool_init", "pool_step"))
        print(f"{key} wet call under torch.profiler: {len(kernels)} device kernels, "
              f"1 + {steps} = {want} expected; "
              f"{sum(t for _, t in kernels) / 1e3:.4f} ms of device time")
        _check(len(kernels) == want, f"{key} wet call ran {len(kernels)} device kernels, "
                                     f"not {want}")


def plan_trace_phase(rows):
    """One K1 call (Gauss-5 ×17), one K2 call (flow ×8) and one K3 call
    (the sim's thermal) at 2048², one K3 call at 1025², and K1 and K2 on
    config 5's [16, 1024, 1024] stack, under ``torch.profiler``: one device
    kernel a launch of the call's plan, whatever the stack's depth.
    Prints each call's device time beside the CUDA-event time of its
    kernels row, and the host time to enqueue one call (mean of 10 calls
    enqueued back to back).  Then one K10 call at 2048²: one device
    operation, the kernel."""
    import torch

    from noize_tpu_torch.app.flagship import default_meta, default_settings
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import flow as FC
    from noize_tpu_torch.ops.cuda import stencil as SC
    from noize_tpu_torch.ops.cuda import thermal as TC
    from noize_tpu_torch.ops.kernels import gaussian_taps

    _, blurred, _ = _inputs(2048)
    _, blurred_odd, _ = _inputs(1025)
    noise_stack, blurred_stack = _stack_inputs()
    taps = gaussian_taps(1.0, 5)
    s, meta = default_settings(), default_meta()
    hw_ratio = float(meta.tile_size) / float(meta.height)
    k3_launches = len(TC.thermal_plan(s.THERMAL_CYCLES).launches)

    def k3(h):
        return lambda: TC.thermal_erosion_fused(h, s.TALUS, s.THERMAL_STEP, hw_ratio,
                                                s.THERMAL_CYCLES)
    for key, row, name, fn, want in (
            ("K1", "#2", "chain_tile", lambda: SC.separable_chain(blurred, taps, 17),
             len(SC.chain_plan(len(taps), 17).launches)),
            ("K2", "#4", "flow_tile", lambda: FC.flow_map_fused(blurred, 8),
             len(FC.flow_plan(8).launches)),
            ("K3", "#5", "thermal_tile", k3(blurred), k3_launches),
            ("K3@1025", "K3@1025", "thermal_tile", k3(blurred_odd), k3_launches),
            ("K1@stack", "K1@stack", "chain_tile",
             lambda: SC.separable_chain(noise_stack, taps, 17),
             len(SC.chain_plan(len(taps), 17).launches)),
            ("K2@stack", "K2@stack", "flow_tile", lambda: FC.flow_map_fused(blurred_stack, 8),
             len(FC.flow_plan(8).launches))):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(10):
            fn()
        host_ms = (time.perf_counter() - t0) * 1e3 / 10
        torch.cuda.synchronize()
        kernels = _device_ops_of_last_call(fn, (name,))
        device_ms = sum(t for _, t in kernels) / 1e3
        print(f"{key} call under torch.profiler: {len(kernels)} device kernels, {want} "
              f"expected (its plan's launches); {device_ms:.4f} ms of device time, "
              f"{rows.rows[row]['ms']:.4f} ms by CUDA events ({row}), "
              f"{host_ms:.4f} ms host enqueue a call")
        _check(len(kernels) == want, f"{key} call ran {len(kernels)} device kernels, not {want}")
    # K10: a fractal call is one device operation, the kernel, and no plain noise op
    flagship = dict(noise_type="Simplex", hurst=0.4, octaves=13, noise_size=1700.0)
    fn = lambda: FR.fractal(2048, 0.0, 0.0, device="cuda", **flagship)  # noqa: E731
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(10):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3 / 10
    torch.cuda.synchronize()
    ops = _device_ops_of_last_call(fn)
    print(f"K10 call under torch.profiler (2048², Simplex ×13): {len(ops)} device operation(s) "
          f"{[n[:40] for n, _ in ops]}, {sum(t for _, t in ops) / 1e3:.4f} ms of device time, "
          f"{rows.rows['K10']['ms']:.4f} ms by CUDA events (K10), {host_ms:.4f} ms host "
          "enqueue a call")
    _check(len(ops) == 1 and "fractal" in ops[0][0],
           f"a fractal call ran {len(ops)} device operations, not K10 alone")


def _wet(wrapper):
    """Calls of ``wrapper`` whose gate was open since the last reset."""
    return 0 if wrapper.wet_calls is None else int(wrapper.wet_calls.item())


def flagship_phase(rows, steps=2):
    """The 2048² flagship through make_tile_step."""
    import torch

    from noize_tpu_torch.app.flagship import default_settings, make_tile_step
    from noize_tpu_torch.prng import PRNGKey, fold_in

    settings = default_settings()
    step, meta, _ = make_tile_step(None, settings, device="cuda",
                                   erosion_cycles=settings.CYCLES)
    key = PRNGKey(0, device="cuda")
    # the warm-up: the first call, eager, and the second, which captures the
    # erosion cycle's CUDA graphs
    warm = 2
    times = []
    _reset_counts()
    for i in range(steps + warm):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = step(float(i * 100), 0.0, fold_in(key, i))
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    counts = _read_counts()
    wet = _wet(_counters()["K4"])
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
    for key in ("K1", "K2", "K3", "K4", "K7", "K8", "K7@records", "K8@randint", "K9", "K10"):
        _check(counts[key] > 0, f"{key} was not launched on the flagship path")
    _check(counts["K10"] == steps + warm,
           f"the flagship launched K10 {counts['K10']} times in {steps + warm} steps (1 a step)")
    _check("descent.alive" not in step.syncs, f"flagship host syncs {step.syncs}")
    timed = times[warm:]
    print(f"flagship 2048² (3 cycles, mesh): warm-up {[round(t, 1) for t in times[:warm]]} ms, "
          f"steps {[round(t, 3) for t in timed]} ms, median "
          f"{sorted(timed)[len(timed) // 2]:.3f} ms/step")
    print(f"flagship launches over {steps + warm} steps {counts}; K4 gate open in {wet} of "
          f"{counts['K4']} calls; host syncs per step {len(step.syncs)}")
    rows.set_launches({"K10": counts["K10"] // (steps + warm)})
    PROFILES.append(("flagship step 2048² (3 cycles, mesh)",
                     lambda k=fold_in(PRNGKey(0, device="cuda"), steps + warm):
                     step(float(steps + warm) * 100, 0.0, k)))


def odd_grid_phase(rows):
    """ErosionSim on a 1025² blurred-noise tile: the odd-grid path (K3, K5).
    Then K5 and K3 against their plain versions on that path's inputs."""
    import torch

    from noize_tpu_torch.erosion import pool as PO
    from noize_tpu_torch.erosion import sim as SIM
    from noize_tpu_torch.erosion.pool_cuda import pool_automata_full_cuda
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.ops import thermal as TH
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
    from noize_tpu_torch.ops.fractal import fractal

    res = 1025
    h = gauss_chain(fractal(res, 0.0, 0.0, noise_type="Simplex", hurst=0.4, octaves=13,
                            noise_size=1700.0, device="cuda"), 5, 1.0, 17)
    sim = ErosionSim(h)
    # keep a copy of what each pool call on the path is given (two 4 MB
    # device copies a call), to hold K5 against its plain version on it
    pool_inputs, pool_call = [], SIM.pool_automata_cuda

    def recorded(height, pool, *args, **kwargs):
        pool_inputs.append((height.clone(), pool.clone()))
        return pool_call(height, pool, *args, **kwargs)

    SIM.pool_automata_cuda = recorded
    try:
        _reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sim.step()
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3
    finally:
        SIM.pool_automata_cuda = pool_call
    counts = _read_counts()
    wet = _wet(pool_automata_full_cuda)
    for key in ("K3", "K5", "K7", "K8", "K7@records", "K8@randint", "K9"):
        _check(counts[key] > 0, f"{key} was not launched on the odd-grid path")
    _check(counts["K4"] == 0, "K4 launched on an odd grid")
    for k, v in (("height", sim.height_map), ("pool", sim.pool_map), ("stream", sim.stream_map)):
        _check(tuple(v.shape) == (res, res) and bool(torch.isfinite(v).all()),
               f"odd-grid {k} not finite or misshapen")
    _check(float(sim.stream_map.abs().max()) > 0, "odd-grid erosion left no stream")
    print(f"odd grid 1025²: ErosionSim.step (3 cycles) {step_ms:.3f} ms; launches {counts}; "
          f"K5 gate open in {wet} of {counts['K5']} calls; host syncs {len(sim.syncs)}")
    rows.set_launches({"K5": counts["K5"], "K5@1025": counts["K5"], "K3@1025": counts["K3"]})
    PROFILES.append(("ErosionSim.step() 1025² (3 cycles)", sim.step))

    # K5 on the inputs of the step's last call whose gate was open
    s, cells = sim.settings, res * res
    wet_inputs = [hp for hp in pool_inputs if bool((hp[1] >= PO.MIN_WATER).any())]
    _check(len(pool_inputs) == counts["K5"] and len(wet_inputs) == wet,
           f"{len(wet_inputs)} of {len(pool_inputs)} recorded pool inputs wet, gate open {wet}")
    _check(wet > 0, "K5's gate stayed closed on the odd-grid path")
    height, pool = wet_inputs[-1]
    got = pool_automata_full_cuda(height, pool, s.WATER_STEPS, True)
    _check(bool((got[0] != pool).any()), "K5 ran no phase on the odd-grid pool")
    rows.compare("K5@1025", "K5 pool_automata_full_cuda (1025² ErosionSim pool)", SRC["K5"],
                 POOL_TPU + ":30", got,
                 lambda: pool_automata_full_cuda(height, pool, s.WATER_STEPS, True),
                 lambda: PO._pool_automata_fullgrid(height, pool, s.WATER_STEPS, True),
                 "full1025", 10, 16 * cells, POOL_OPS_PER_ITER * s.WATER_STEPS * cells)
    # K3 on the height the step leaves: the next cycle's K3 input
    hw_ratio = float(sim.meta.tile_size) / float(sim.meta.height)
    thermal = (sim.height_map, s.TALUS, s.THERMAL_STEP, hw_ratio, s.THERMAL_CYCLES)
    rows.compare("K3@1025", "K3 thermal_erosion_fused (1025² ErosionSim height)", SRC["K3"],
                 TPU + "thermal_pl.py:36", (thermal_erosion_fused(*thermal),),
                 lambda: (thermal_erosion_fused(*thermal),),
                 lambda: (TH.thermal_erosion(*thermal),), "k3_1025", 20,
                 8 * cells, K3_OPS_PER_ITER * s.THERMAL_CYCLES * cells)


def cross_device_phase():
    """Port on the card against the port on the CPU, entry() configuration,
    from the same seed, then the mesh export round trip at that size."""
    import dataclasses

    import torch

    from noize_tpu_torch.app import mesh_export
    from noize_tpu_torch.app.flagship import default_meta, default_settings, make_tile_step
    from noize_tpu_torch.prng import PRNGKey

    # __graft_entry__.entry(): a 240² tile with an 8-cell margin on a 256²
    # generator grid, 256 particles of age ≤ 16, 4 water steps
    meta = default_meta(generator_res=256, margin=8)
    settings = dataclasses.replace(default_settings(), PARTICLES_PER_CYCLE=256, MAXAGE=16,
                                   WATER_STEPS=4, CYCLES=1, PILING_RADIUS=8)
    kw = dict(octaves=8, blur_iterations=5, flow_iterations=4, erosion_cycles=1)
    outs = {}
    for dev in ("cpu", "cuda"):
        step, _, _ = make_tile_step(meta, settings, device=dev, **kw)
        outs[dev] = step(0.0, 0.0, PRNGKey(0, device=dev))  # the same threefry spawn
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

    mesh = outs["cuda"]["mesh"]
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        mesh_export.to_obj(os.path.join(d, "tile.obj"), mesh)
        mesh_export.to_npz(os.path.join(d, "tile.npz"), mesh)
        back = mesh_export.from_npz(os.path.join(d, "tile.npz"))
        export_ms = (time.perf_counter() - t0) * 1e3
        with open(os.path.join(d, "tile.obj")) as fh:
            lines = fh.read().splitlines()
    nv, nf = mesh.positions.shape[0], mesh.indices.shape[0] // 3
    _check(len(lines) == 1 + 3 * nv + nf, f"OBJ has {len(lines)} lines")
    _check(lines[1].startswith("v ") and lines[-1].startswith("f "), "OBJ layout")
    for f in ("positions", "normals", "tangents", "uvs", "indices"):
        _check(getattr(back, f).device.type == "cuda"
               and torch.equal(getattr(back, f), getattr(mesh, f)), f"NPZ round trip {f}")
    print(f"export {meta.generator_res}² (tile {meta.tile_res}²): OBJ {len(lines)} lines + NPZ "
          f"round trip equal in {export_ms:.1f} ms; {nv} vertices")


# --- the user journeys (examples/*_torch.py) ---------------------------------

#: kernels each example must launch at its full size on the card
EXAMPLE_KERNELS = {
    "full_tile_workflow_torch": ("K1", "K1@tile", "K3", "K4", "K7", "K7@records", "K8",
                                 "K8@randint", "K9", "K10"),
    "serving_tiles_torch": ("K1", "K3", "K4", "K7", "K7@records", "K8", "K8@randint", "K9",
                            "K10"),
    "multichip_field_torch": ("K1", "K2", "K3", "K5@window", "K7@window", "K7@records", "K8",
                              "K8@randint", "K9", "K10"),
}


def _example(name, fast):
    """``examples/<name>.py`` as a fresh module, with NOIZE_EXAMPLE_FAST set
    as asked while it is executed (the example reads it at import)."""
    import importlib.util

    old = os.environ.get("NOIZE_EXAMPLE_FAST")
    os.environ["NOIZE_EXAMPLE_FAST"] = "1" if fast else "0"
    try:
        spec = importlib.util.spec_from_file_location(
            f"examples_{name}", os.path.join(HERE, "examples", f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if old is None:
            del os.environ["NOIZE_EXAMPLE_FAST"]
        else:
            os.environ["NOIZE_EXAMPLE_FAST"] = old
    _check(mod.FAST == fast, f"{name}: FAST is {mod.FAST}")
    return mod


def _recording_server(mod, served):
    """Swap ``mod.TileServer`` for a subclass whose orders also hand each
    served tile to ``served`` (by tile id)."""
    base = mod.TileServer

    class Recording(base):
        def submit(self, tile_id, pos, on_complete=None):
            def done(st):
                served[tile_id] = st
                if on_complete is not None:
                    on_complete(st)
            super().submit(tile_id, pos, on_complete=done)

    mod.TileServer = Recording


def run_example(name, fast, device):
    """Run one example's ``main`` into a temporary directory on ``device``
    with every launch count reset just before it; check its outputs as the
    JAX example's test does and return (what the card is compared on, wall
    ms to the device's end, the launch counts)."""
    import torch

    from noize_tpu_torch.core.serde import SerdeManager
    from noize_tpu_torch.ops.mesh import MeshPlanes, grid_indices

    mod = _example(name, fast)
    served = {}
    if name == "serving_tiles_torch":
        _recording_server(mod, served)
    with tempfile.TemporaryDirectory() as d:
        out_dir = os.path.join(d, "out")
        _reset_counts()
        t0 = time.perf_counter()
        ret = mod.main(out_dir, device=device)
        if device == "cuda":
            torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
        counts = _read_counts()
        if name == "full_tile_workflow_torch":
            pngs = sorted(f for f in os.listdir(out_dir) if f.endswith(".png"))
            _check(len(pngs) == 10 and "restored_00_height.png" in pngs
                   and "restored_00_water.png" in pngs, f"full_tile PNGs {pngs}")
            data = os.path.join(out_dir, "saves", "save__island_v1", "data")
            names = sorted(f[:-len(".data")] for f in os.listdir(data))
            _check(len(names) == 13, f"full_tile saves {names}")
            sm = SerdeManager(os.path.join(out_dir, "saves"), "island", "v1")
            return {n: sm.load(n) for n in names}, wall, counts
        if name == "serving_tiles_torch":
            _check(len(served) == 16 and all(st.error is None for st in served.values()),
                   f"serving: {len(served)} tiles served, errors "
                   f"{[st.error for st in served.values() if st.error is not None]}")
            obj = os.path.join(out_dir, "tile_1_0.obj")
            _check(os.path.getsize(obj) > 0, "serving: empty OBJ")
            st = served["tile_1_0_warm"]
            planes = MeshPlanes(st.mesh_planes.cpu(),
                                grid_indices(st.mesh_planes.shape[-1] - 1, device="cpu"))
            return ({"heights": st.heights.cpu().numpy(),
                     **{f"mesh.{f}": getattr(planes, f).numpy()
                        for f in ("positions", "normals", "tangents", "uvs")}},
                    wall, counts)
    _check(bool((ret["restored"] == ret["eroded"]).all()),
           "multichip: the sharded checkpoint did not restore bit-equal")
    return ret, wall, counts


def _example_on_card(name):
    """``name`` at its full size on the card: print its wall time and the
    launches it made, and check the kernels of its path all launched."""
    _, wall, counts = run_example(name, False, "cuda")
    for key in EXAMPLE_KERNELS[name]:
        _check(counts[key] > 0, f"{key} was not launched by {name}: {counts}")
    launched = {k: n for k, n in counts.items() if n}
    print(f"example {name} (full size) on the card: {wall:.1f} ms; launches {launched}")


def _examples_agree(name, card, cpu):
    """The FAST outputs of ``name`` on the card against those on the CPU,
    each map relative to the CPU's largest magnitude."""
    import numpy as np

    gaps = {}
    for k, want in cpu.items():
        if k == "origins":
            _check(np.array_equal(card[k], want), f"{name}: origins differ")
            continue
        got = np.asarray(card[k], np.float64)
        want = np.asarray(want, np.float64)
        _check(got.shape == want.shape, f"{name}: {k} shape {got.shape} vs {want.shape}")
        gaps[k] = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    print(f"example {name} (FAST) card vs cpu, max gap relative to scale: "
          + ", ".join(f"{k} {v!r}" for k, v in gaps.items()))
    for k, v in gaps.items():
        _check(v <= CROSS_DEVICE_RTOL, f"{name}: card vs cpu {k} gap {v} > {CROSS_DEVICE_RTOL}")


def examples_phase():
    """The full-tile and serving journeys: each at its full size on the
    card, then at its FAST size on the card and on the CPU from the same
    seeds, the saved maps and the served tile within CROSS_DEVICE_RTOL."""
    t0 = time.perf_counter()
    for name in ("full_tile_workflow_torch", "serving_tiles_torch"):
        _example_on_card(name)
        card, _, _ = run_example(name, True, "cuda")
        cpu, _, _ = run_example(name, True, "cpu")
        _examples_agree(name, card, cpu)
    print(f"examples phase, full_tile and serving: {time.perf_counter() - t0:.1f} s")


def multichip_example_phase():
    """The multichip journey on the existing one-rank NCCL group: at its
    full size, then at its FAST size (returned, for the CPU to be held
    against once the group is gone)."""
    t0 = time.perf_counter()
    _example_on_card("multichip_field_torch")
    card, _, _ = run_example("multichip_field_torch", True, "cuda")
    print(f"examples phase, multichip on the card: {time.perf_counter() - t0:.1f} s")
    return card


def multichip_example_cpu_phase(card):
    """The multichip journey at its FAST size on the CPU (a one-rank gloo
    group the example starts and ends), against the card's run."""
    t0 = time.perf_counter()
    cpu, _, _ = run_example("multichip_field_torch", True, "cpu")
    _examples_agree("multichip_field_torch", card, cpu)
    print(f"examples phase, multichip on the CPU: {time.perf_counter() - t0:.1f} s")


def main():
    import torch

    sys.path.insert(0, HERE)
    t0 = time.perf_counter()
    name = device_phase()
    build_phase()
    rows = Rows()
    kernel_phase(rows)
    fractal_gain_phase(rows)
    config1_phase(rows)
    config6_phase(rows)
    sim = quickstart_phase(rows)
    flagship_phase(rows)
    odd_grid_phase(rows)
    cross_device_phase()
    descent_phase(rows, sim)
    prng_phase()
    filter_phase(rows)
    presets_phase(rows)
    heights = tiles_phase(rows)
    serve_phase(heights)
    del heights
    cli_phase()
    generator_phase()
    continuous_phase()
    vegetation_phase()
    exact_piles_phase(rows)
    sediment_phase(rows)
    decay_phase(rows)
    native_io_phase(sim)
    window_kernels_phase(rows)
    examples_phase()
    multichip_card = sharded_phase(rows)  # profiles the sharded sim step at its end
    multichip_example_cpu_phase(multichip_card)
    for label, fn in PROFILES:  # last: no timed phase runs after the profiler
        profile_path(label, fn)
    pool_trace_phase()
    plan_trace_phase(rows)
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t0:.1f} s")
    print(rows.line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
