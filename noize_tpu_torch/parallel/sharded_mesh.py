"""Mesh emission from a sharded height field: per-rank vertex blocks with
global index offsets; port of ``noize_tpu.parallel.sharded_mesh``.

Layout: rank (i, j) of an (nx, ny) mesh over an R² field (blocks of
lr = R/nx rows, lc = R/ny columns) emits the (lr+1, lc+1) vertex block
covering vertices [i·lr, i·lr+lr] × [j·lc, j·lc+lc] of the global (r+1)²
grid — one row and column of overlap with the next rank, so a block holds
every vertex its own triangle cells need.  Vertex (vz, vx) anchors at
height cell (off + vz, off + vx), off = (input_res − r)/2; the taps come
from one clamp-border halo exchange of width off + 2, whose ghosts repeat
the border row at every depth, as the single-device mesher's depth-2 edge
padding does.  Vertices beyond the (r+1)² grid are zero.

The vertex math is ``ops.mesh.vertex_fields`` / ``vertex_plane_list`` on
the same taps and steps as ``ops.mesh.heightmap_mesh*``, so the
reassembled mesh (``mesh_arrays_from_fields``, ``mesh_planes_from_fields``)
equals the single-device one bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.distributed.tensor import DTensor, Replicate, Shard

from ..ops import mesh as _mesh
from .halo import _local_block, exchange_2d

_F32 = torch.float32


def _placements(mesh, row_dim: int):
    return [Shard(row_dim) if a == "x" else Shard(row_dim + 1) if a == "y" else Replicate()
            for a in mesh.mesh_dim_names]


def _as_global(block, mesh, row_dim: int, shape):
    stride = tuple(int(np.prod(shape[i + 1:])) for i in range(len(shape)))
    return DTensor.from_local(block.contiguous(), mesh, _placements(mesh, row_dim),
                              run_check=False, shape=torch.Size(shape), stride=stride)


def sharded_heightmap_mesh(mesh, heights, resolution: int, input_resolution: int, height,
                           tile_size, variant: str = "overshoot", layout: str = "arrays"):
    """Emit each rank's (lr+1, lc+1) vertex block (see the module's layout
    note) from a sharded ``heights`` field.

    ``variant``: "overshoot" reads real margin samples for the neighbour
    taps (``heightmap_mesh_overshoot``); "square" extrapolates at the
    vertex grid's border as ``heightmap_mesh`` does.  ``layout``:
    "arrays" returns {"positions", "normals", "tangents", "uvs"}, each a
    ``DTensor`` of shape (R + nx, R + ny, C) sharded on its first two
    dimensions; "planes" returns {"planes": f32[12, R + nx, R + ny]}
    sharded on its last two."""
    r = resolution
    off = (input_resolution - r) // 2
    if variant not in ("overshoot", "square"):
        raise ValueError(f"unknown mesh variant {variant!r}")
    if layout not in ("arrays", "planes"):
        raise ValueError(f"unknown mesh layout {layout!r}")
    halo = off + 2
    block, (rows, cols) = _local_block(heights, mesh)
    lr, lc = block.shape
    if halo > lr or halo > lc:
        raise ValueError(f"mesh halo {halo} (crop offset {off} + stencil) exceeds shard block "
                         f"{(lr, lc)}; use fewer shards or a smaller margin")
    nx, ny = rows // lr, cols // lc
    row0 = mesh.get_local_rank("x") * lr
    col0 = mesh.get_local_rank("y") * lc
    step = float(np.float32(tile_size) / np.float32(r))  # as ops.mesh._vertex_coords
    uv_denom = float(r) - 0.5 if variant == "overshoot" else float(r + 1)

    ext = exchange_2d(block, halo, mesh=mesh)
    b = off + halo
    nr, nc = lr + 1, lc + 1
    t = ext[b:b + nr, b:b + nc]
    l_in = ext[b:b + nr, b - 1:b - 1 + nc]
    r_in = ext[b:b + nr, b + 1:b + 1 + nc]
    u_in = ext[b - 1:b - 1 + nr, b:b + nc]
    d_in = ext[b + 1:b + 1 + nr, b:b + nc]
    dev = block.device
    vz = (torch.arange(nr, device=dev) + row0)[:, None].expand(nr, nc)
    vx = (torch.arange(nc, device=dev) + col0)[None, :].expand(nr, nc)
    if variant == "square":
        # the reference's call asymmetry: right and down switch at r − 1
        l = torch.where(vx > 0, l_in, _mesh._interp_edge(t, r_in))
        rgt = torch.where(vx < r - 1, r_in, _mesh._interp_edge(t, l_in))
        u = torch.where(vz > 0, u_in, _mesh._interp_edge(d_in, t))
        d = torch.where(vz < r - 1, d_in, _mesh._interp_edge(u_in, t))
    else:
        l, rgt, u, d = l_in, r_in, u_in, d_in
    valid = (vz <= r) & (vx <= r)
    args = (t, l, rgt, u, d, vx.to(_F32), vz.to(_F32), step, height, uv_denom)
    gshape = (rows + nx, cols + ny)
    if layout == "planes":
        planes = torch.stack([p.expand(t.shape) for p in _mesh.vertex_plane_list(*args)], 0)
        planes = torch.where(valid[None], planes, 0.0)
        return {"planes": _as_global(planes, mesh, 1, (12,) + gshape)}
    out = {}
    for name, v in zip(("positions", "normals", "tangents", "uvs"),
                       _mesh.vertex_fields(*args)):
        v = torch.where(valid[..., None], v, 0.0)
        out[name] = _as_global(v, mesh, 0, gshape + (v.shape[-1],))
    return out


def shard_vertex_window(resolution: int, input_resolution: int, mesh_shape, shard_rc):
    """The slice of rank (i, j)'s (lr+1, lc+1) block holding real vertices
    (≤ r), and the global (vz0, vx0) of its first vertex: ((row_slice,
    col_slice), (vz0, vx0))."""
    r = resolution
    nx, ny = mesh_shape
    i, j = shard_rc
    lr = input_resolution // nx
    lc = input_resolution // ny
    vz0, vx0 = i * lr, j * lc
    rs = slice(0, max(min(lr + 1, r + 1 - vz0), 0))
    cs = slice(0, max(min(lc + 1, r + 1 - vx0), 0))
    return (rs, cs), (vz0, vx0)


def shard_mesh_indices(resolution: int, input_resolution: int, mesh_shape,
                       local: bool = False):
    """Per-rank triangle lists (uint32).  Rank (i, j) owns the mesh cells
    (vz, vx) with vz ∈ (i·lr, i·lr+lr] and vx ∈ (j·lc, j·lc+lc] (∩ [1, r]),
    every vertex of which lies in its own block.  ``local=False`` indexes
    the global (r+1)² vertex grid, ``local=True`` the rank's own block.
    The global lists together are a permutation of
    ``ops.mesh.grid_indices``'s triangles."""
    r = resolution
    nx, ny = mesh_shape
    lr = input_resolution // nx
    lc = input_resolution // ny
    out = {}
    for i in range(nx):
        for j in range(ny):
            z_lo = max(i * lr + 1, 1)
            z_hi = min((i + 1) * lr, r) + 1
            x_lo = max(j * lc + 1, 1)
            x_hi = min((j + 1) * lc, r) + 1
            if z_hi <= z_lo or x_hi <= x_lo:
                out[(i, j)] = np.zeros((0,), np.uint32)
                continue
            z, x = np.meshgrid(np.arange(z_lo, z_hi), np.arange(x_lo, x_hi), indexing="ij")
            if local:
                stride = lc + 1
                vi = (z - i * lr) * stride + (x - j * lc)
            else:
                stride = r + 1
                vi = z * stride + x
            t0 = np.stack([vi - stride - 1, vi - 1, vi - stride], -1)
            t1 = np.stack([vi - stride, vi - 1, vi], -1)
            out[(i, j)] = np.stack([t0, t1], -2).reshape(-1).astype(np.uint32)
    return out


def _full(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def _reassemble_blocks(arr, resolution: int, input_resolution: int, mesh_shape,
                       grid_axis: int):
    """Place each rank's (lr+1, lc+1) vertex window into the (r+1)² grid;
    ``grid_axis`` is the vertex-row axis of ``arr`` (0 for the arrays
    layout, 1 for the planes layout).  Overlapping rows and columns are
    the same on both owners."""
    r = resolution
    nx, ny = mesh_shape
    lr = input_resolution // nx
    lc = input_resolution // ny
    shape = list(arr.shape)
    shape[grid_axis] = r + 1
    shape[grid_axis + 1] = r + 1
    full = arr.new_zeros(shape)
    pre = (slice(None),) * grid_axis
    for i in range(nx):
        for j in range(ny):
            blk = arr[pre + (slice(i * (lr + 1), (i + 1) * (lr + 1)),
                             slice(j * (lc + 1), (j + 1) * (lc + 1)))]
            (rs, cs), (vz0, vx0) = shard_vertex_window(r, input_resolution, mesh_shape,
                                                       (i, j))
            full[pre + (slice(vz0, vz0 + rs.stop), slice(vx0, vx0 + cs.stop))] = \
                blk[pre + (rs, cs)]
    return full


def mesh_arrays_from_fields(fields, resolution: int, input_resolution: int, mesh_shape):
    """The per-rank vertex blocks reassembled into one ``MeshArrays``
    (``full_tensor()`` gathers a ``DTensor`` field: every rank calls it)."""
    r = resolution
    nverts = (r + 1) * (r + 1)

    def assemble(chan, width):
        full = _reassemble_blocks(_full(chan), r, input_resolution, mesh_shape, grid_axis=0)
        return full.reshape(nverts, width)

    pos = assemble(fields["positions"], 3)
    return _mesh.MeshArrays(
        positions=pos, normals=assemble(fields["normals"], 3),
        tangents=assemble(fields["tangents"], 4), uvs=assemble(fields["uvs"], 2),
        indices=_mesh.grid_indices(r, torch.int32, device=pos.device))


def mesh_planes_from_fields(fields, resolution: int, input_resolution: int, mesh_shape):
    """``mesh_arrays_from_fields`` for the planes layout: one
    ``MeshPlanes``."""
    full = _reassemble_blocks(_full(fields["planes"]), resolution, input_resolution,
                              mesh_shape, grid_axis=1)
    return _mesh.MeshPlanes(full, _mesh.grid_indices(resolution, torch.int32,
                                                     device=full.device))
