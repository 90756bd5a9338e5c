"""Mesh file export — port of ``noize_tpu.app.mesh_export``: Wavefront OBJ
(+ raw NPZ) writers for the emitted vertex/index streams.

OBJ carries positions, normals and uvs (tangents have no OBJ slot; NPZ
keeps all five streams).  ``to_obj`` writes through the native IO
runtime's buffered writer (``native.obj_write``), byte-identical to the
NumPy ``savetxt`` writer kept beside it as its plain version
(``to_obj_numpy``), and so to the reference's ``to_obj`` on either of its
routes.  Works with both emission layouts (``MeshArrays`` and
``MeshPlanes``).
"""

from __future__ import annotations

import numpy as np
import torch

from .. import native


def _np(t) -> np.ndarray:
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _streams(mesh):
    pos = _np(mesh.positions).astype(np.float32, copy=False)
    nrm = _np(mesh.normals).astype(np.float32, copy=False)
    uv = _np(mesh.uvs).astype(np.float32, copy=False)
    # widen before the 1-based shift: a uint16 stream tops out at 65535
    idx = _np(mesh.indices).astype(np.int64).reshape(-1, 3)
    return pos, nrm, uv, idx


def to_obj(path: str, mesh, name: str = "noize_tile") -> None:
    """Write a Wavefront OBJ with v/vt/vn streams and f v/vt/vn faces,
    winding as emitted (SquareGridHeightMap.cs:96-103), 1-based indices,
    one shared index per vertex; atomically, through the native writer."""
    pos, nrm, uv, idx = _streams(mesh)
    native.obj_write(path, name, pos, nrm, uv, idx)


def to_obj_numpy(path: str, mesh, name: str = "noize_tile") -> None:
    """``to_obj`` through NumPy's ``savetxt``: the plain version the tests
    hold the native writer to, byte for byte."""
    pos, nrm, uv, idx = _streams(mesh)
    faces = idx + 1
    with open(path, "w") as fh:
        fh.write(f"o {name}\n")
        np.savetxt(fh, pos, fmt="v %.7g %.7g %.7g")
        np.savetxt(fh, uv, fmt="vt %.7g %.7g")
        np.savetxt(fh, nrm, fmt="vn %.7g %.7g %.7g")
        # each corner repeats its id as position/uv/normal: f v/v/v ...
        np.savetxt(fh, np.repeat(faces, 3, axis=1),
                   fmt="f %d/%d/%d %d/%d/%d %d/%d/%d")


def to_npz(path: str, mesh) -> None:
    """Lossless dump of all five streams (positions/normals/tangents/uvs/
    indices)."""
    np.savez_compressed(
        path,
        positions=_np(mesh.positions),
        normals=_np(mesh.normals),
        tangents=_np(mesh.tangents),
        uvs=_np(mesh.uvs),
        indices=_np(mesh.indices),
    )


def from_npz(path: str, *, device="cuda"):
    """Load a ``to_npz`` dump (the port's or the reference's) into a
    ``MeshArrays`` on ``device``; indices come back as int32 (the port's
    index type)."""
    from ..ops.mesh import MeshArrays

    with np.load(path) as z:
        def t(k, dtype=None):
            a = z[k] if dtype is None else z[k].astype(dtype)
            return torch.from_numpy(np.array(a)).to(device)

        return MeshArrays(positions=t("positions"), normals=t("normals"),
                          tangents=t("tangents"), uvs=t("uvs"),
                          indices=t("indices", np.int32))
