"""Visualization / texture export — port of ``noize_tpu.app.visualize``
(the Unity texture jobs and the editor preview window).

Reference analogs:
  * ``SetRGBA32Job`` (MultiThreadErosionJob.cs:483-533): scale-clamp a map
    into one byte channel of an RGBA texture, center-cropped to TILE_RES;
  * ``CurvitureMapJob`` (:387-435): curvature → byte channel;
  * ``SetTextureBlackJob`` (:582-604);
  * the water/terrain control textures assembled in
    ``LiveErosion.TriggerQueuedBeyerMT`` (LiveErosion.cs:419-430);
  * ``VisualizePipelineWindow`` (Scripts/Editor/VisualizePipeline.cs) →
    ``render_pipeline`` + PNG export.

Byte channels are computed where the map lives (the card or the CPU);
textures and files are host NumPy, byte for byte the reference's.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..erosion.world import curvature_map


def _tensor(a) -> torch.Tensor:
    return a if isinstance(a, torch.Tensor) else torch.from_numpy(np.array(a, np.float32))


def _host(a) -> np.ndarray:
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def to_byte_channel(src, mesh_res: int, scale: float = 1.0):
    """SetRGBA32Job parity: center-crop src to mesh_res², scale, clamp to
    [0,1], quantize to uint8 (a tensor on ``src``'s device)."""
    src = _tensor(src)
    data_res = src.shape[0]
    off = (data_res - mesh_res) // 2
    window = src[off:off + mesh_res, off:off + mesh_res]
    return (torch.clamp(window * scale, 0.0, 1.0) * 255.0).to(torch.uint8)


def black_texture(res: int):
    """SetTextureBlackJob parity."""
    return np.zeros((res, res, 4), np.uint8)


def water_control_texture(pool, stream, tile_res: int):
    """LiveErosion.cs:419-423: R=wet (pool ×1000), G=puddle (pool ×1000),
    B=stream (×2), A=0."""
    tex = np.zeros((tile_res, tile_res, 4), np.uint8)
    tex[..., 0] = _host(to_byte_channel(pool, tile_res, 1000.0))
    tex[..., 1] = _host(to_byte_channel(pool, tile_res, 1000.0))
    tex[..., 2] = _host(to_byte_channel(stream, tile_res, 2.0))
    return tex


def terrain_control_texture(height, stream, tile_res: int, height_scale: float,
                            patch_res: float):
    """LiveErosion.cs:426-430: G=cavity (stream ×3 then curvature overwrite),
    A=erosion (stream ×1)."""
    tex = np.zeros((tile_res, tile_res, 4), np.uint8)
    tex[..., 1] = _host(to_byte_channel(stream, tile_res, 3.0))
    curv = curvature_map(_tensor(height), height_scale, patch_res)
    tex[..., 1] = _host(to_byte_channel(curv, tile_res, 1.0))
    tex[..., 3] = _host(to_byte_channel(stream, tile_res, 1.0))
    return tex


def _normalize01(a, scale: Optional[float]):
    if scale is None:
        lo, hi = float(a.min()), float(a.max())
        return (a - lo) / (hi - lo) if hi > lo else a * 0
    return np.clip(a * scale, 0.0, 1.0)


def _write_png(path: str, img: np.ndarray, bit_depth: int, color_type: int):
    """Assemble a PNG (filter 0 per row) from a prepared sample array —
    uint8, or big-endian uint16 for 16-bit grayscale.  Pure-python
    writer (no imaging dependency)."""
    import struct
    import zlib

    raw = b"".join(b"\x00" + img[i].tobytes() for i in range(img.shape[0]))
    h, w = img.shape[:2]

    def chunk(tag, data):
        out = struct.pack(">I", len(data)) + tag + data
        return out + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)

    hdr = struct.pack(">IIBBBBB", w, h, bit_depth, color_type, 0, 0, 0)
    with open(path, "wb") as fh:
        fh.write(b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", hdr)
                 + chunk(b"IDAT", zlib.compress(raw, 6))
                 + chunk(b"IEND", b""))
    return path


def to_png(path: str, array, scale: Optional[float] = None):
    """Grayscale (2-D float) or RGBA (3-D uint8) PNG export — the
    array→texture path of the editor visualizer, minus the editor."""
    a = _host(array)
    if a.ndim == 2:
        img = (_normalize01(a, scale) * 255).astype(np.uint8)
        return _write_png(path, img, 8, 0)
    if a.ndim == 3 and a.shape[2] == 4:
        return _write_png(path, a.astype(np.uint8), 8, 6)
    raise ValueError(f"unsupported array shape {a.shape}")


def to_png16(path: str, array, scale: Optional[float] = None):
    """16-bit grayscale PNG heightmap export — the precision game-engine
    terrain importers expect (8-bit quantization shows terracing on a
    1000 m height range; 16-bit is ~1.5 cm steps).

    ``scale=None`` min-max normalizes; otherwise values are ``a*scale``
    clipped to [0, 1].  PNG samples are big-endian."""
    a = np.asarray(_host(array), np.float64)
    if a.ndim != 2:
        raise ValueError(f"to_png16 writes 2-D heightmaps, got {a.shape}")
    img = (_normalize01(a, scale) * 65535.0 + 0.5).astype(np.uint16)
    return _write_png(path, img.astype(">u2"), 16, 0)


def to_raw16(path: str, array, scale: Optional[float] = None,
             flip_vertical: bool = True):
    """Unity-style RAW16 heightmap export: bare uint16 samples,
    little-endian ("Byte order: Windows" in Unity's terrain import
    dialog).  Unity reads the FIRST row as the BOTTOM of the terrain, so
    rows are flipped by default — import with resolution = array side,
    depth 16 bit.  ``scale`` as in ``to_png16``."""
    a = np.asarray(_host(array), np.float64)
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"to_raw16 writes square 2-D heightmaps, got {a.shape}")
    img = (_normalize01(a, scale) * 65535.0 + 0.5).astype("<u2")
    if flip_vertical:
        img = img[::-1]
    with open(path, "wb") as fh:
        fh.write(img.tobytes())
    return path


def render_pipeline(pipeline, resolution: int, xpos: int = 0, zpos: int = 0,
                    uuid: str = "viz"):
    """VisualizePipelineWindow.RunPipeline analog: run any pipeline at a
    chosen resolution/offset and return the resulting map (on the
    pipeline's device)."""
    from ..core.stageio import GeneratorData

    out = pipeline.run(
        GeneratorData(uuid=uuid, resolution=resolution, xpos=xpos, zpos=zpos)
    )
    return out.data
