"""Heightmap → mesh emission; port of ``noize_tpu.ops.mesh``: the
square-grid and overshoot emitters in both layouts (``MeshArrays``,
``MeshPlanes``), the flat water plane and its per-resolution cache.

Formula quirks kept from the reference: vertex x == 0 gets position
−(0.5·step) while x ≥ 1 gets x·step − 0.5; tangent = (−4·dx, 16, −4·dz, 0);
NormalStrength = 8; the overshoot uv denominator is Res − 0.5.

Index dtype: the reference emits uint16 indices for meshes up to 256²
vertices and uint32 above (PositionStream16/32); ``index_dtype`` and
``grid_indices`` keep that.  PyTorch's unsigned integer types support too
few operations, so the port's meshes carry their index list as int32 for
every size; every index is below (R+1)² < 2³¹, so the values are the
same.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..utils.tracking import span
from .f32 import recip, sqrt

NORMAL_STRENGTH = 8.0  # HeightMapMeshJob.cs:41


@dataclass
class MeshArrays:
    """SoA vertex/index streams."""

    positions: torch.Tensor  # f32[(R+1)², 3]
    normals: torch.Tensor    # f32[(R+1)², 3]
    tangents: torch.Tensor   # f32[(R+1)², 4]
    uvs: torch.Tensor        # f32[(R+1)², 2]
    indices: torch.Tensor    # i32[6·R²] flat triangle list

    @property
    def vertex_count(self):
        return self.positions.shape[0]

    @property
    def index_count(self):
        return self.indices.shape[0]


@dataclass
class MeshPlanes:
    """Component-major vertex streams: one f32[12, H, W] stack of planes
    [px, py, pz, nx, ny, nz, tx, ty, tz, tw, u, v] plus the triangle list."""

    planes: torch.Tensor   # f32[12, H, W]
    indices: torch.Tensor  # i32[6·R²]

    def _field(self, lo: int, hi: int):
        n = self.planes.shape[1] * self.planes.shape[2]
        return torch.movedim(self.planes[lo:hi], 0, -1).reshape(n, hi - lo)

    @property
    def positions(self):
        return self._field(0, 3)

    @property
    def normals(self):
        return self._field(3, 6)

    @property
    def tangents(self):
        return self._field(6, 10)

    @property
    def uvs(self):
        return self._field(10, 12)

    @property
    def vertex_count(self):
        return self.planes.shape[1] * self.planes.shape[2]

    @property
    def index_count(self):
        return self.indices.shape[0]

    def to_arrays(self) -> MeshArrays:
        return MeshArrays(self.positions, self.normals, self.tangents,
                          self.uvs, self.indices)


def index_dtype(resolution: int):
    """PositionStream16 caveat: 16-bit indices only up to 256² meshes."""
    return torch.uint16 if (resolution + 1) ** 2 <= 65536 else torch.uint32


def grid_indices(resolution: int, dtype=None, *, device="cuda") -> torch.Tensor:
    """Triangle index list (SquareGridHeightMap.cs:96-103): per cell
    (z≥1, x≥1) two triangles (vi−R−2, vi−1, vi−R−1), (vi−R−1, vi−1, vi),
    on ``device``; ``dtype=None`` is ``index_dtype(resolution)``, as the
    reference gives it (the port's meshes ask for int32)."""
    r = resolution
    ar = torch.arange(1, r + 1, dtype=torch.int32, device=device)
    z, x = torch.meshgrid(ar, ar, indexing="ij")
    vi = (r + 1) * z + x
    t0 = torch.stack([vi - r - 2, vi - 1, vi - r - 1], -1)
    t1 = torch.stack([vi - r - 1, vi - 1, vi], -1)
    tris = torch.stack([t0, t1], -2).reshape(-1)
    return tris.to(index_dtype(r) if dtype is None else dtype)


def _normalized(nx, ny, nz):
    """Unit normal: (n / |n|) with the left-associated square sum."""
    norm = sqrt((nx * nx + ny * ny) + nz * nz)
    return nx / norm, ny / norm, nz / norm


def vertex_plane_list(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom):
    """Per-vertex math as twelve component planes
    [px, py, pz, nx, ny, nz, tx, ty, tz, tw, u, v]."""
    px = torch.where(vx_f == 0.0, -(0.5 * step), vx_f * step - 0.5)
    py = t * height
    pz = vz_f * step - 0.5
    dx = (rgt - l) * 0.5
    dz = (u - d) * 0.5
    nx = (l - rgt) * 0.5 * NORMAL_STRENGTH
    ny = torch.full_like(dx, float(np.float32(2.0) / np.float32(height)))
    nz = dz * NORMAL_STRENGTH
    nx, ny, nz = _normalized(nx, ny, nz)
    inv_uv = recip(uv_denom)
    return [
        px, py, pz, nx, ny, nz,
        -4.0 * dx, torch.full_like(dx, 16.0), -4.0 * dz, torch.zeros_like(dx),
        vx_f * inv_uv, vz_f * inv_uv,
    ]


def vertex_fields(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom):
    """Trailing-axis layout of the vertex math: (pos[..,3], n[..,3],
    tan[..,4], uv[..,2])."""
    p = vertex_plane_list(t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom)
    return (torch.stack(p[0:3], -1), torch.stack(p[3:6], -1),
            torch.stack(p[6:10], -1), torch.stack(p[10:12], -1))


def _vertex_coords(resolution: int, tile_size, device):
    r = resolution
    step = float(np.float32(tile_size) / np.float32(r))
    vx = torch.arange(r + 1, dtype=torch.float32, device=device)
    vx_f = vx[None, :].expand(r + 1, r + 1)
    vz_f = vx[:, None].expand(r + 1, r + 1)
    return vx_f, vz_f, step


def _tap_slices(heights, r: int, off: int):
    """(center, left, right, up, down) height taps over the (r+1)² vertex
    grid from a pad-by-2 edge-extended input (on the last two axes)."""
    n = heights.shape[-1]
    idx = torch.arange(-2, n + 2, device=heights.device).clamp_(0, n - 1)
    ext = heights[..., idx, :][..., idx]
    b = off + 2
    t = ext[..., b:b + r + 1, b:b + r + 1]
    l_in = ext[..., b:b + r + 1, b - 1:b + r]
    r_in = ext[..., b:b + r + 1, b + 1:b + r + 2]
    u_in = ext[..., b - 1:b + r, b:b + r + 1]
    d_in = ext[..., b + 1:b + r + 2, b:b + r + 1]
    return t, l_in, r_in, u_in, d_in


def _interp_edge(a, b):
    """InterpolateEdge (SquareGridHeightMap.cs:36-38): a − (b − a)."""
    return a - (b - a)


def _assemble(r, t, l, rgt, u, d, tile_size, height, uv_denom, device):
    vx_f, vz_f, step = _vertex_coords(r, tile_size, device)
    pos, n, tan, uv = vertex_fields(t, l, rgt, u, d, vx_f, vz_f, step,
                                    height, uv_denom)
    nv = (r + 1) * (r + 1)
    return MeshArrays(pos.reshape(nv, 3), n.reshape(nv, 3),
                      tan.reshape(nv, 4), uv.reshape(nv, 2),
                      grid_indices(r, torch.int32, device=device))


def _assemble_planes(r, t, l, rgt, u, d, tile_size, height, uv_denom, device):
    vx_f, vz_f, step = _vertex_coords(r, tile_size, device)
    planes = torch.stack([p.expand(t.shape) for p in vertex_plane_list(
        t, l, rgt, u, d, vx_f, vz_f, step, height, uv_denom)], -3)
    return MeshPlanes(planes, grid_indices(r, torch.int32, device=device))


def _squaregrid_taps(heights, r: int, off: int):
    """SquareGridHeightMap taps: centre crop with the reference's
    ``InterpolateEdge`` on the last two columns and rows, verbatim."""
    t, l_in, r_in, u_in, d_in = _tap_slices(heights, r, off)
    ar = torch.arange(r + 1, device=heights.device)
    xg = ar[None, :]
    zg = ar[:, None]
    l = torch.where(xg > 0, l_in, _interp_edge(t, r_in))
    rgt = torch.where(xg < r - 1, r_in, _interp_edge(t, l_in))
    u = torch.where(zg > 0, u_in, _interp_edge(d_in, t))
    d = torch.where(zg < r - 1, d_in, _interp_edge(u_in, t))
    return t, l, rgt, u, d


def heightmap_mesh(heights, resolution: int, input_resolution: int, height,
                   tile_size) -> MeshArrays:
    """SquareGridHeightMap: center-crop ``heights`` to ``resolution``
    cells with edge-extrapolated neighbour taps (the reference's
    ``InterpolateEdge`` on the last two columns and rows, verbatim);
    returns ``MeshArrays`` of (resolution+1)² vertices."""
    r = resolution
    off = (input_resolution - r) // 2  # PixOffset (SquareGridHeightMap.cs:33)
    t, l, rgt, u, d = _squaregrid_taps(heights, r, off)
    return _assemble(r, t, l, rgt, u, d, tile_size, height, float(r + 1),
                     heights.device)


def heightmap_mesh_planes(heights, resolution: int, input_resolution: int, height,
                          tile_size) -> MeshPlanes:
    """``heightmap_mesh`` in the component-major ``MeshPlanes`` layout
    (same math)."""
    r = resolution
    off = (input_resolution - r) // 2
    t, l, rgt, u, d = _squaregrid_taps(heights, r, off)
    return _assemble_planes(r, t, l, rgt, u, d, tile_size, height, float(r + 1),
                            heights.device)


def heightmap_mesh_overshoot(heights, resolution: int, input_resolution: int,
                             height, tile_size) -> MeshArrays:
    """OvershootSquareGridHeightMap: center-crop ``heights`` to
    ``resolution`` cells, reading real margin samples for the neighbour
    taps; returns ``MeshArrays`` of (resolution+1)² vertices.  Recorded
    as the span ``mesh`` (``utils.tracking``)."""
    r = resolution
    off = (input_resolution - r) // 2
    with span("mesh"):
        t, l, rgt, u, d = _tap_slices(heights, r, off)
        return _assemble(r, t, l, rgt, u, d, tile_size, height, float(r) - 0.5,
                         heights.device)


def heightmap_mesh_overshoot_planes(heights, resolution: int,
                                    input_resolution: int, height,
                                    tile_size) -> MeshPlanes:
    """``heightmap_mesh_overshoot`` in the component-major ``MeshPlanes``
    layout (same math).  A stack of heights ``[T, n, n]`` gives planes
    ``[T, 12, r+1, r+1]``, each tile's those of its own call (the batch axis
    in front, as ``parallel.tiled`` emits them).  Recorded as the span
    ``mesh``."""
    r = resolution
    off = (input_resolution - r) // 2
    with span("mesh"):
        t, l, rgt, u, d = _tap_slices(heights, r, off)
        return _assemble_planes(r, t, l, rgt, u, d, tile_size, height, float(r) - 0.5,
                                heights.device)


def flat_water_mesh(resolution: int, *, device="cuda") -> MeshArrays:
    """The unit water plane (SharedSquareGridPosition) of
    (resolution+1)² vertices on ``device``: x = i/R − 0.5 with the x = 0
    column at −0.5, y = 0, normal (0, 0, −1), tangent (1, 0, 0, −1),
    uv = i/(R+1)."""
    r = resolution
    ramp = torch.arange(r + 1, dtype=torch.float32, device=device)
    xs = ramp / r - 0.5
    xs[0] = -0.5
    zs = ramp / r - 0.5
    nv = (r + 1) * (r + 1)
    pos = torch.stack([xs[None, :].expand(r + 1, r + 1),
                       torch.zeros((r + 1, r + 1), dtype=torch.float32, device=device),
                       zs[:, None].expand(r + 1, r + 1)], -1).reshape(nv, 3)
    n = torch.tensor([[0.0, 0.0, -1.0]], device=device).expand(nv, 3).contiguous()
    tan = torch.tensor([[1.0, 0.0, 0.0, -1.0]], device=device).expand(nv, 4).contiguous()
    iu = ramp / (r + 1)
    uv = torch.stack([iu[None, :].expand(r + 1, r + 1),
                      iu[:, None].expand(r + 1, r + 1)], -1).reshape(nv, 2)
    return MeshArrays(pos, n, tan, uv, grid_indices(r, torch.int32, device=device))


_WATER_MESH_CACHE = {}


def square_planar_mesh(resolution: int, *, device="cuda") -> MeshArrays:
    """MeshHelper.SquarePlanarMesh's per-resolution cache (Helper.cs:63-69),
    one per device."""
    key = (resolution, torch.device(device))
    if key not in _WATER_MESH_CACHE:
        _WATER_MESH_CACHE[key] = flat_water_mesh(resolution, device=device)
    return _WATER_MESH_CACHE[key]
