"""CLI — port of ``noize_tpu.app.cli``: run pipelines from JSON configs
and dump PNG/NPY outputs, on the card by default:

    python -m noize_tpu_torch.app.cli run config.json -o out/
    python -m noize_tpu_torch.app.cli demo -o out/          # README example #1
    python -m noize_tpu_torch.app.cli erode config.json -o out/ --cycles 10
    python -m noize_tpu_torch.app.cli erode --input dem.npy --mesh --heightmap16

Every command takes ``--device`` (``cuda`` by default; ``cpu`` runs the
plain versions of the kernels).  Config format (mirrors the
ScriptableObject assets):

    {
      "resolution": 512, "xpos": 0, "zpos": 0,
      "stages": [
        {"stage": "NoiseStage", "noiseType": "Simplex", "octaves": 13,
         "hurst": 0.4, "noiseSize": 1700},
        {"stage": "StageGaussianBlur", "sigma": "s1d00", "width": 5,
         "iterations": 17},
        {"stage": "FlowMapStage", "iterations": 5}
      ]
    }
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from ..core.stageio import GeneratorData
from ..pipeline import stages as S
from ..pipeline.driver import Pipeline
from . import visualize as viz

STAGE_TYPES = {
    name: getattr(S, name)
    for name in (
        "NoiseStage", "KernelFilterStage", "StageGaussianBlur",
        "StageSmoothBlur", "StageThermalErosion", "ConstantStage",
        "CurveStage", "FlowMapStage", "WriteGeneratorContextStage",
        "ReadGeneratorContextStage",
    )
}


def build_pipeline(cfg: dict, state_manager=None, *, device="cuda") -> Pipeline:
    stages = []
    for sc in cfg["stages"]:
        sc = dict(sc)
        kind = sc.pop("stage")
        if kind not in STAGE_TYPES:
            raise SystemExit(
                f"unknown stage {kind!r}; available: {sorted(STAGE_TYPES)}"
            )
        if kind == "CurveStage" and "curve" in sc:
            sc["curve"] = tuple(float(v) for v in sc["curve"])
        stages.append(STAGE_TYPES[kind](**sc))
    return Pipeline(stages, state_manager=state_manager, name=cfg.get("name", "cli"),
                    device=device)


DEMO_CONFIG = {
    "name": "readme_example_1",
    "resolution": 512,
    "stages": [
        {"stage": "NoiseStage", "noiseType": "Simplex", "octaves": 13,
         "hurst": 0.4, "noiseSize": 1700},
        {"stage": "StageGaussianBlur", "sigma": "s1d00", "width": 5,
         "iterations": 17},
        {"stage": "FlowMapStage", "iterations": 5},
    ],
}


def _load_heightmap(path: str) -> np.ndarray:
    """Load an external heightmap for erosion: .npy/.npz arrays directly,
    Unity RAW16 (.raw/.r16), anything else through PIL as a grayscale
    image (gated — PIL is not a dependency).  Values are min-max
    normalized to the sim's [0, 1] convention; non-square inputs are
    center-cropped square (the sim operates on square tiles)."""
    if path.endswith(".npy"):
        arr = np.load(path)
    elif path.endswith(".npz"):
        z = np.load(path)
        arr = z[list(z.files)[0]]
    elif path.endswith((".raw", ".r16")):
        # Unity terrain RAW16 (bare little-endian uint16, bottom row
        # first — the layout to_raw16 writes); side inferred square
        if os.path.getsize(path) % 2:
            raise SystemExit(f"{path!r}: odd byte count, not uint16 samples")
        flat = np.fromfile(path, dtype="<u2")
        side = int(np.sqrt(flat.size))
        if flat.size == 0 or side * side != flat.size:
            raise SystemExit(
                f"{path!r}: {flat.size} uint16 samples is not a square"
                " heightmap")
        arr = flat.reshape(side, side)[::-1].astype(np.float32)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise SystemExit(
                f"reading {path!r} needs PIL (not installed); convert the"
                " heightmap to .npy instead") from e
        arr = np.asarray(Image.open(path).convert("F"))
    arr = np.asarray(arr, np.float32)
    if arr.ndim != 2:
        raise SystemExit(f"heightmap must be 2-D, got shape {arr.shape}")
    if arr.shape[0] != arr.shape[1]:
        s = min(arr.shape)
        r0 = (arr.shape[0] - s) // 2
        c0 = (arr.shape[1] - s) // 2
        arr = arr[r0:r0 + s, c0:c0 + s]
    lo, hi = float(arr.min()), float(arr.max())
    if hi > lo:
        arr = (arr - lo) / (hi - lo)
    return arr


def _run(cfg: dict, outdir: str, tag: str, *, device="cuda"):
    """Run ``cfg``'s pipeline; write ``tag``.npy and .png; return the map
    (on ``device``)."""
    os.makedirs(outdir, exist_ok=True)
    pipe = build_pipeline(cfg, device=device)
    t0 = time.perf_counter()
    out = pipe.run(GeneratorData(
        uuid=tag,
        resolution=int(cfg.get("resolution", 512)),
        xpos=int(cfg.get("xpos", 0)),
        zpos=int(cfg.get("zpos", 0)),
    ))
    dt = (time.perf_counter() - t0) * 1e3
    arr = out.data.cpu().numpy()
    npy = os.path.join(outdir, f"{tag}.npy")
    png = os.path.join(outdir, f"{tag}.png")
    np.save(npy, arr)
    viz.to_png(png, arr)
    print(f"{tag}: {arr.shape} in {dt:.1f}ms -> {npy}, {png}")
    return out.data


def main(argv=None):
    ap = argparse.ArgumentParser(prog="noize_tpu_torch", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = ap.add_subparsers(dest="cmd", required=True)

    runp = sub.add_parser("run", help="run a pipeline config")
    runp.add_argument("config")
    runp.add_argument("-o", "--outdir", default="out")

    demop = sub.add_parser("demo", help="run README example #1")
    demop.add_argument("-o", "--outdir", default="out")
    demop.add_argument("--resolution", type=int, default=512)

    erop = sub.add_parser("erode", help="generate then live-erode a tile")
    erop.add_argument("config", nargs="?")
    erop.add_argument("-o", "--outdir", default="out")
    erop.add_argument("--cycles", type=int, default=10)
    erop.add_argument("--resolution", type=int, default=256)
    erop.add_argument("--mesh", action="store_true",
                      help="also emit the eroded tile mesh as OBJ + NPZ")
    erop.add_argument("--input", metavar="HEIGHTMAP",
                      help="erode an existing heightmap (.npy/.npz, Unity"
                           " terrain .raw/.r16, or a grayscale image"
                           " readable by PIL if installed) instead of"
                           " generating one; values are min-max normalized"
                           " to [0, 1]")
    erop.add_argument("--heightmap16", action="store_true",
                      help="also export the eroded height as 16-bit"
                           " heightmaps: eroded_height.png16.png and"
                           " eroded_height.raw (Unity terrain RAW16,"
                           " little-endian, bottom row first)")
    for p in (runp, demop, erop):
        p.add_argument("--device", default="cuda",
                       help="torch device to run on (default: cuda; cpu runs the"
                            " kernels' plain versions)")

    args = ap.parse_args(argv)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device (pass --device cpu)")

    if args.cmd == "run":
        with open(args.config) as fh:
            cfg = json.load(fh)
        _run(cfg, args.outdir, cfg.get("name", "pipeline"), device=device)
    elif args.cmd == "demo":
        cfg = dict(DEMO_CONFIG, resolution=args.resolution)
        _run(cfg, args.outdir, "demo", device=device)
    elif args.cmd == "erode":
        from ..erosion.params import ErosionSettings
        from ..erosion.sim import ErosionSim

        if args.input:
            arr = _load_heightmap(args.input)
            cfg = {}
            os.makedirs(args.outdir, exist_ok=True)
            viz.to_png(os.path.join(args.outdir, "terrain.png"), arr)
            print(f"terrain: {arr.shape} loaded from {args.input}")
        elif args.config:
            with open(args.config) as fh:
                cfg = json.load(fh)
            arr = _run(cfg, args.outdir, "terrain", device=device)
        else:
            cfg = dict(DEMO_CONFIG, resolution=args.resolution)
            cfg["stages"] = cfg["stages"][:2]  # noise + blur, keep heights
            arr = _run(cfg, args.outdir, "terrain", device=device)
        es_kwargs = cfg.get("erosion", {})
        if "BEHAVIOR" in es_kwargs:
            from ..erosion.params import ErosionMode

            es_kwargs = dict(es_kwargs,
                             BEHAVIOR=ErosionMode[es_kwargs["BEHAVIOR"]])
        sim = ErosionSim(arr, settings=ErosionSettings(**es_kwargs), device=device)
        t0 = time.perf_counter()
        sim.step(args.cycles)
        h = sim.height_map.cpu().numpy()
        dt = (time.perf_counter() - t0) * 1e3
        print(f"erosion: {args.cycles} cycles in {dt:.1f}ms")
        for name, m in (
            ("eroded_height", sim.height_map),
            ("pool", sim.pool_map),
            ("stream", sim.stream_map),
        ):
            viz.to_png(os.path.join(args.outdir, f"{name}.png"), m)
        print(f"wrote eroded_height/pool/stream PNGs -> {args.outdir}")
        if args.heightmap16:
            viz.to_png16(
                os.path.join(args.outdir, "eroded_height.png16.png"), h)
            viz.to_raw16(os.path.join(args.outdir, "eroded_height.raw"), h)
            print(f"wrote 16-bit heightmaps (.png16.png / .raw) -> {args.outdir}")
        if args.mesh:
            from ..ops.mesh import heightmap_mesh_overshoot
            from . import mesh_export as ME

            res = int(sim.height_map.shape[0])
            marr = heightmap_mesh_overshoot(
                sim.height_map, sim.meta.tile_res, res,
                float(sim.meta.height), float(sim.meta.tile_size))
            ME.to_obj(os.path.join(args.outdir, "tile.obj"), marr)
            ME.to_npz(os.path.join(args.outdir, "tile.npz"), marr)
            print(f"wrote tile.obj / tile.npz -> {args.outdir}")


if __name__ == "__main__":
    main()
