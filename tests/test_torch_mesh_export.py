"""The port's mesh export (``noize_tpu_torch.app.mesh_export``) against
``noize_tpu.app.mesh_export``: the OBJ text is identical to the
reference's NumPy ``savetxt`` route on the same streams, and NPZ dumps
round-trip between the two packages.

Tolerance: exact (text and float32 bytes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu import native as JNative
from noize_tpu.app import mesh_export as JX
from noize_tpu.ops import mesh as JM
from noize_tpu_torch.app import mesh_export as TX
from noize_tpu_torch.ops import mesh as TM


@pytest.fixture
def meshes():
    h = np.random.default_rng(6).uniform(0, 1, (40, 40)).astype(np.float32)
    jm = JM.heightmap_mesh_overshoot(jnp.asarray(h), 32, 40, 1000.0, 32.0)
    tm = TM.MeshArrays(*(torch.from_numpy(np.array(getattr(jm, f))) for f in
                         ("positions", "normals", "tangents", "uvs")),
                       indices=torch.from_numpy(np.asarray(jm.indices).astype(np.int32)))
    own = TM.heightmap_mesh_overshoot(torch.from_numpy(h), 32, 40, 1000.0, 32.0)
    return jm, tm, own


def _no_native(*args, **kwargs):
    raise OSError("native writer disabled")


def test_obj_text_identical_to_reference_numpy_route(tmp_path, meshes, monkeypatch):
    jm, tm, own = meshes
    monkeypatch.setattr(JNative, "obj_write", _no_native)
    JX.to_obj(str(tmp_path / "j.obj"), jm)
    TX.to_obj(str(tmp_path / "t.obj"), tm)
    want = (tmp_path / "j.obj").read_text()
    assert (tmp_path / "t.obj").read_text() == want
    lines = want.splitlines()
    assert lines[0] == "o noize_tile" and len(lines) == 1 + 3 * 33 * 33 + 2 * 32 * 32
    # the port's own emission writes the same OBJ layout
    TX.to_obj(str(tmp_path / "own.obj"), own, name="t")
    own_lines = (tmp_path / "own.obj").read_text().splitlines()
    assert own_lines[0] == "o t" and len(own_lines) == len(lines)
    assert [ln.split()[0] for ln in own_lines] == [ln.split()[0] for ln in lines]


def test_planes_layout_exports_like_arrays(tmp_path, meshes):
    _, _, own = meshes
    h = np.random.default_rng(6).uniform(0, 1, (40, 40)).astype(np.float32)
    planes = TM.heightmap_mesh_overshoot_planes(torch.from_numpy(h), 32, 40, 1000.0, 32.0)
    TX.to_obj(str(tmp_path / "a.obj"), own)
    TX.to_obj(str(tmp_path / "p.obj"), planes)
    assert (tmp_path / "a.obj").read_text() == (tmp_path / "p.obj").read_text()


def test_npz_round_trip_between_packages(tmp_path, meshes):
    jm, tm, _ = meshes
    TX.to_npz(str(tmp_path / "t.npz"), tm)
    JX.to_npz(str(tmp_path / "j.npz"), jm)
    for path in ("t.npz", "j.npz"):
        back = TX.from_npz(str(tmp_path / path), device="cpu")
        for f in ("positions", "normals", "tangents", "uvs", "indices"):
            assert torch.equal(getattr(back, f), getattr(tm, f)), (path, f)
        assert back.indices.dtype == torch.int32
    jback = JX.from_npz(str(tmp_path / "t.npz"))
    for f in ("positions", "normals", "tangents", "uvs"):
        np.testing.assert_array_equal(np.asarray(getattr(jback, f)), np.asarray(getattr(jm, f)))
    np.testing.assert_array_equal(np.asarray(jback.indices).astype(np.int64),
                                  np.asarray(jm.indices).astype(np.int64))
