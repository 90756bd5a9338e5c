"""Spatially sharded (sp) field ops — noise, separable filters, thermal
erosion, flow map — over a 2-D (``x``, ``y``) mesh; port of
``noize_tpu.parallel.sharded_ops``.

Each rank extends its block toward the neighbours it has, as far as the
whole op reaches (``halo._extend_2d``, once a call), runs the
port's local op on the extended block — on the card K1 (blur and filters),
K3 (thermal) and K2 (flow map), one call each — and keeps its block.  At
the global border a block is not extended, so the local op's own edge
clamp is the global clamp; at an inner edge the extension is as deep as
the op's receptive field, so no cell of the block reads the extended
block's edge.  Every op rounds the same way on every block, so each
sharded op equals the port's local op on the whole grid bit for bit, on
any mesh that divides the grid.  (The reference re-clamps ghost cells
after each fused sub-step instead, and groups iterations to fit its
halos; K1, K2 and K3 run several iterations a launch and clamp at their
input's edge, so the port extends only where a neighbour exists.)

Ops take a ``DTensor`` field (or the whole grid as a plain tensor, the
same on every rank) and return a ``DTensor`` placed
``device_mesh.field_sharding(mesh)``.
"""

from __future__ import annotations

from ..ops import kernels as _k
from ..ops.blur import limit_width, sigma_value
from ..ops.cuda.flow import flow_map_fused
from ..ops.cuda.stencil import gauss_chain
from ..ops.cuda.thermal import thermal_erosion_window
from ..ops.fractal import fractal_window
from .halo import _as_field, _block_shape, _extend_2d, _local_block, _mesh_device


def sharded_fractal(mesh, resolution: int, xpos, zpos, **kw):
    """Fractal noise over a sharded ``resolution``² grid.  Noise is pure
    position math — each rank evaluates its own window, no communication —
    and equals ``ops.fractal.fractal`` exactly."""
    row0, col0, lr, lc = _block_shape(mesh, (resolution, resolution))
    block = fractal_window(row0, col0, lr, lc, xpos, zpos, device=_mesh_device(mesh), **kw)
    return _as_field(block, mesh, (resolution, resolution))


def _iterated(mesh, data, reach: int, local):
    """``local(extended block, (row, col) of its cell (0, 0), grid shape)``
    on this rank's block extended ``reach`` cells toward its neighbours;
    the block cropped back, as a field."""
    block, shape = _local_block(data, mesh)
    row0, col0, lr, lc = _block_shape(mesh, shape)
    ext, top, left = _extend_2d(block, reach, mesh=mesh)
    out = local(ext, (row0 - top, col0 - left), shape)
    return _as_field(out[top:top + lr, left:left + lc].contiguous(), mesh, shape)


def sharded_kernel_filter(mesh, data, filter_type: str, iterations: int = 1):
    """``ops.kernels.kernel_filter`` over a sharded field (K1 on the card):
    one extension of ``iterations`` × the filter's half-width."""
    if filter_type not in _k.KERNEL_FILTER_TYPES:
        raise ValueError(f"unknown filter {filter_type!r}")
    if filter_type == "Sobel3_2D":
        hw = 1
    else:
        tx, tz, _ = _k._SERIES_TABLE[filter_type]
        hw = (max(len(tx), len(tz)) - 1) // 2
    return _iterated(mesh, data, iterations * hw,
                     lambda ext, origin, shape: _k.kernel_filter(ext, filter_type, iterations))


def sharded_gauss_blur(mesh, data, width: int, sigma, iterations: int = 1):
    """The iterated Gaussian blur (``ops.cuda.stencil.gauss_chain``, K1 on
    the card) over a sharded field."""
    width = limit_width(width)
    sigma = sigma_value(sigma)
    return _iterated(mesh, data, iterations * ((width - 1) // 2),
                     lambda ext, origin, shape: gauss_chain(ext, width, sigma, iterations))


def sharded_thermal_erosion(mesh, data, talus, increment_ratio,
                            height_width_ratio, iterations: int = 1):
    """``thermal_erosion`` over a sharded square field (K3 on the card): the
    extended block runs with the grid's origin, parity, border and
    ``max_diff`` (``ops.cuda.thermal.thermal_erosion_window``); a phase
    moves what is exact by at most 2 cells, so the extension is 8 cells an
    iteration."""
    if data.shape[0] != data.shape[1]:
        raise ValueError(f"sharded_thermal_erosion: expected a square field, got "
                         f"{tuple(data.shape)}")

    def local(ext, origin, shape):
        return thermal_erosion_window(ext, talus, increment_ratio, height_width_ratio,
                                      iterations, origin, shape[0])

    return _iterated(mesh, data, 8 * iterations, local)


def sharded_flow_map(mesh, height, iterations: int = 5, norm_min=-0.1, norm_max=0.1):
    """``flow_map`` over a sharded field (K2 on the card), with one
    extension of 2·iterations + 1 cells: an iteration's flow and water
    steps each read the 4 neighbours, the velocity once more."""
    return _iterated(mesh, height, 2 * iterations + 1,
                     lambda ext, origin, shape: flow_map_fused(ext, iterations, norm_min,
                                                               norm_max))
