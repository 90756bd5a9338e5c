"""Halo exchange for 2-D spatially sharded grids; port of
``noize_tpu.parallel.halo``.

Replaces the reference's margin-overlap recompute: neighbouring ranks
exchange edge strips (``dist.batch_isend_irecv`` on the mesh axis' group)
instead of every tile regenerating a margin band.  The functions that
communicate run on every rank of the axis, like the reference's inside
``shard_map``, and take the ``DeviceMesh`` as the keyword ``mesh`` (JAX
finds it in the enclosing ``shard_map``).

Boundary semantics: ``exchange_axis`` fills the ghost strips of a rank at
the global border with its own edge (``"clamp"``) or zeros (``"zero"``),
as the reference does.  The sharded ops extend a block only toward the
neighbours it has (``_extend_2d``), as far as their stencils reach, so a
local op's own edge clamp is the global clamp at the global border and the
block's core comes out bit-equal to the op on the whole grid.
"""

from __future__ import annotations

from typing import Callable

import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from .device_mesh import field_sharding


def _axis(mesh, axis_name: str):
    """(this rank's coordinate, the axis size, the axis group)."""
    size = mesh.size(mesh.mesh_dim_names.index(axis_name))
    return mesh.get_local_rank(axis_name), size, mesh.get_group(axis_name)


def _shift(mesh, axis_name: str, to_prev=None, to_next=None, prev_like=None,
           next_like=None):
    """One round of neighbour traffic along ``axis_name``: send ``to_prev``
    to coordinate − 1 and ``to_next`` to coordinate + 1, receive a tensor
    shaped like ``prev_like`` from coordinate − 1 and one like
    ``next_like`` from coordinate + 1 (None: no such message).  Returns
    (from_prev, from_next)."""
    i, _, group = _axis(mesh, axis_name)
    ops, from_prev, from_next = [], None, None
    if to_prev is not None:
        ops.append(dist.P2POp(dist.isend, to_prev.contiguous(),
                              dist.get_global_rank(group, i - 1), group))
    if to_next is not None:
        ops.append(dist.P2POp(dist.isend, to_next.contiguous(),
                              dist.get_global_rank(group, i + 1), group))
    if prev_like is not None:
        from_prev = torch.empty_like(prev_like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, from_prev, dist.get_global_rank(group, i - 1), group))
    if next_like is not None:
        from_next = torch.empty_like(next_like, memory_format=torch.contiguous_format)
        ops.append(dist.P2POp(dist.irecv, from_next, dist.get_global_rank(group, i + 1), group))
    if ops:
        for work in dist.batch_isend_irecv(ops):
            work.wait()
    return from_prev, from_next


def _edge_strip(block, dim: int, take: int, from_start: bool):
    return block.narrow(dim, 0 if from_start else block.shape[dim] - take, take)


def exchange_axis(block, halo: int, axis_name: str, dim: int,
                  border: str = "clamp", *, mesh):
    """Extend ``block`` by ``halo`` cells on both sides of ``dim`` with
    neighbour data along mesh axis ``axis_name`` (``halo`` at most the
    block's extent).

    ``border``: ghost content at the GLOBAL border — "clamp" replicates the
    rank's own edge (gather-stencil clamp semantics), "zero" fills zeros
    (scatter/adjoint semantics)."""
    if border not in ("clamp", "zero"):
        raise ValueError(f"unknown border {border!r}")
    if halo > block.shape[dim]:
        raise ValueError(f"halo {halo} exceeds the block's {block.shape[dim]} cells")
    i, n, _ = _axis(mesh, axis_name)
    send_to_next = _edge_strip(block, dim, halo, from_start=False)
    send_to_prev = _edge_strip(block, dim, halo, from_start=True)
    from_prev, from_next = _shift(
        mesh, axis_name,
        to_prev=send_to_prev if i > 0 else None,
        to_next=send_to_next if i < n - 1 else None,
        prev_like=send_to_next if i > 0 else None,
        next_like=send_to_prev if i < n - 1 else None)
    if from_prev is None:
        from_prev = (_edge_strip(block, dim, 1, True).expand_as(send_to_prev)
                     if border == "clamp" else torch.zeros_like(send_to_prev))
    if from_next is None:
        from_next = (_edge_strip(block, dim, 1, False).expand_as(send_to_next)
                     if border == "clamp" else torch.zeros_like(send_to_next))
    return torch.cat([from_prev, block, from_next], dim=dim)


def exchange_2d(block, halo: int, axis_row: str = "x", axis_col: str = "y",
                border: str = "clamp", *, mesh):
    """Full 2-D halo (rows then columns — the second pass carries the
    already-widened strips, so corners arrive correctly)."""
    block = exchange_axis(block, halo, axis_row, dim=0, border=border, mesh=mesh)
    return exchange_axis(block, halo, axis_col, dim=1, border=border, mesh=mesh)


def reclamp_ghosts(ext, grow, gcol, halo: int, lr: int, lc: int,
                   res_r: int, res_c: int):
    """Re-replicate GLOBAL-border ghost cells from their border row/col
    (``grow``/``gcol``: the global coordinates of the extended block's
    cells); a no-op on interior blocks."""
    ext = torch.where(grow < 0, ext[halo:halo + 1, :], ext)
    ext = torch.where(grow > res_r - 1, ext[halo + lr - 1:halo + lr, :], ext)
    ext = torch.where(gcol < 0, ext[:, halo:halo + 1], ext)
    ext = torch.where(gcol > res_c - 1, ext[:, halo + lc - 1:halo + lc], ext)
    return ext


def split_groups(total: int, k: int):
    """[k, k, ..., remainder] covering ``total`` items."""
    groups = []
    left = total
    while left > 0:
        groups.append(min(k, left))
        left -= groups[-1]
    return groups


def fold_axis(ext, halo: int, axis_name: str, dim: int, *, mesh):
    """Adjoint of ``exchange_axis`` for accumulators: fold the halo strips of
    an extended block back onto the owning neighbours' cores.  The low
    strip holds contributions to the previous rank's trailing cells, the
    high strip to the next rank's leading cells; global-border strips are
    dropped.  Returns the core block with the neighbours' contributions
    added (tail first, then head, as the reference adds them; a rank at
    the border adds zeros there)."""
    i, n, _ = _axis(mesh, axis_name)
    core_len = ext.shape[dim] - 2 * halo
    low = ext.narrow(dim, 0, halo)
    core = ext.narrow(dim, halo, core_len).clone()
    high = ext.narrow(dim, halo + core_len, halo)
    if n > 1:
        from_prev, from_next = _shift(
            mesh, axis_name,
            to_prev=low if i > 0 else None, to_next=high if i < n - 1 else None,
            prev_like=high if i > 0 else None, next_like=low if i < n - 1 else None)
        tail = core.narrow(dim, core_len - halo, halo)
        tail.copy_(tail + (from_next if from_next is not None else torch.zeros_like(tail)))
        head = core.narrow(dim, 0, halo)
        head.copy_(head + (from_prev if from_prev is not None else torch.zeros_like(head)))
    return core


def fold_2d(ext, halo: int, axis_row: str = "x", axis_col: str = "y", *, mesh):
    """Adjoint of ``exchange_2d``: fold columns first, then rows, so corner
    contributions route through the column neighbour exactly like the
    widened strips of the forward exchange."""
    ext = fold_axis(ext, halo, axis_col, dim=1, mesh=mesh)
    return fold_axis(ext, halo, axis_row, dim=0, mesh=mesh)


def _crop(block, halo: int):
    return block[halo:block.shape[0] - halo, halo:block.shape[1] - halo]


def _extend_axis(block, reach: int, axis_name: str, dim: int, *, mesh):
    """Extend ``block`` along ``dim`` by up to ``reach`` cells of the grid
    on each side that has neighbours, through as many of them as ``reach``
    spans (one round of traffic per neighbour block); a side at the global
    border is not extended.  Returns (extended block, cells added before,
    cells added after)."""
    i, n, _ = _axis(mesh, axis_name)
    length = block.shape[dim]
    rounds = min(-(-reach // length), n - 1) if reach > 0 else 0
    lo, hi = [], []
    fwd = bwd = block  # what this rank forwards: its own block, then what it received
    for r in range(1, rounds + 1):
        take = min(length, reach - (r - 1) * length)
        send_next = fwd.narrow(dim, fwd.shape[dim] - take, take) \
            if i + 1 < n and i >= r - 1 else None
        send_prev = bwd.narrow(dim, 0, take) if i >= 1 and i + r - 1 <= n - 1 else None
        like = block.narrow(dim, 0, take)
        from_prev, from_next = _shift(mesh, axis_name, to_prev=send_prev, to_next=send_next,
                                      prev_like=like if i >= r else None,
                                      next_like=like if i + r <= n - 1 else None)
        if from_prev is not None:
            lo.append(from_prev)
            fwd = from_prev
        if from_next is not None:
            hi.append(from_next)
            bwd = from_next
    ext = torch.cat(lo[::-1] + [block] + hi, dim=dim)
    return ext, sum(t.shape[dim] for t in lo), sum(t.shape[dim] for t in hi)


def _extend_2d(block, reach: int, axis_row: str = "x", axis_col: str = "y", *, mesh):
    """``_extend_axis`` over rows, then over the columns of the widened
    block (so the corners come with them).  Returns (extended block, rows
    added above, columns added to the left)."""
    ext, top, _ = _extend_axis(block, reach, axis_row, 0, mesh=mesh)
    ext, left, _ = _extend_axis(ext, reach, axis_col, 1, mesh=mesh)
    return ext, top, left


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _block_shape(mesh, shape, axis_row: str = "x", axis_col: str = "y"):
    """This rank's block of a (rows, cols) field: (row0, col0, lr, lc)."""
    (ix, nx, _), (iy, ny, _) = _axis(mesh, axis_row), _axis(mesh, axis_col)
    rows, cols = shape
    if rows % nx or cols % ny:
        raise ValueError(f"a {rows}×{cols} field does not divide over the {nx}×{ny} mesh")
    lr, lc = rows // nx, cols // ny
    return ix * lr, iy * lc, lr, lc


def _local_block(data, mesh, axis_row: str = "x", axis_col: str = "y"):
    """This rank's block of ``data``: a ``DTensor`` (redistributed to the
    field sharding if need be), or a plain tensor holding the whole grid on
    every rank.  Returns (block, global shape)."""
    if isinstance(data, DTensor):
        placements = field_sharding(mesh)
        if list(data.placements) != placements:
            data = data.redistribute(mesh, placements)
        return data.to_local().contiguous(), tuple(data.shape)
    row0, col0, lr, lc = _block_shape(mesh, tuple(data.shape), axis_row, axis_col)
    block = data[row0:row0 + lr, col0:col0 + lc].contiguous()
    return block.to(_mesh_device(mesh)), tuple(data.shape)


def _as_field(block, mesh, shape):
    """``block`` as this rank's shard of the (rows, cols) field ``DTensor``."""
    return DTensor.from_local(block, mesh, field_sharding(mesh), run_check=False,
                              shape=torch.Size(shape), stride=(shape[1], 1))


def sharded_stencil(fn: Callable, halo: int, mesh, axis_row: str = "x",
                    axis_col: str = "y"):
    """Lift a local stencil ``fn(extended_block) -> extended_block`` (edge
    semantics, receptive field ≤ halo) to a sharded field op: the wrapped
    function takes and returns an (H, W) field sharded over
    (``axis_row``, ``axis_col``)."""

    def wrapped(data):
        block, shape = _local_block(data, mesh, axis_row, axis_col)
        ext = exchange_2d(block, halo, axis_row, axis_col, mesh=mesh)
        return _as_field(_crop(fn(ext), halo).contiguous(), mesh, shape)

    return wrapped
