"""noize_tpu_torch mesh emission against noize_tpu on the same heights.

Tolerances: positions, tangents and uvs bit-exact against JAX evaluated
one primitive at a time (``jax.disable_jit()``); normals within 1 ulp-scale
(atol 1e-6 on unit vectors), because the reference takes |n| with
``jnp.linalg.norm`` (XLA's reduction) where the port sums the squares
left to right.  Against the compiled program, 1e-5 absolute on unit
vectors and 1e-4 relative elsewhere (XLA's CPU backend contracts
``x·step − 0.5`` into an FMA).

Index dtype mapping: the reference emits uint16 indices up to 256²
vertices and uint32 above; the port emits int32 on the device for every
size (PyTorch's unsigned types support too few ops).  Values are equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import mesh as JM
from noize_tpu_torch.ops import mesh as TM


def _heights(seed, n):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, n)).astype(np.float32)


@pytest.mark.parametrize("r", [3, 16, 255, 256])
def test_grid_indices_values_and_int32(r):
    got = TM.grid_indices(r, torch.int32, device="cpu")  # what the port's meshes carry
    want = JM.grid_indices(r)
    assert got.dtype == torch.int32
    assert want.dtype == (np.uint16 if (r + 1) ** 2 <= 65536 else np.uint32)
    np.testing.assert_array_equal(got.numpy().astype(np.int64), want.astype(np.int64))
    default = TM.grid_indices(r, device="cpu")  # the reference's dtype
    assert default.numpy().dtype == want.dtype
    np.testing.assert_array_equal(default.numpy(), want)


@pytest.mark.parametrize("res,inres,height,size", [(24, 32, 1000.0, 24.0),
                                                   (60, 64, 250.0, 120.0),
                                                   (16, 16, 1000.0, 16.0)])
def test_overshoot_arrays_match(res, inres, height, size):
    h = _heights(res, inres)
    with jax.disable_jit():
        want = JM.heightmap_mesh_overshoot(jnp.asarray(h), res, inres, height, size)
    jitted = JM.heightmap_mesh_overshoot(jnp.asarray(h), res, inres, height, size)
    got = TM.heightmap_mesh_overshoot(torch.from_numpy(h), res, inres, height, size)
    assert got.vertex_count == want.vertex_count == (res + 1) ** 2
    assert got.index_count == want.index_count
    for f in ("positions", "tangents", "uvs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(jitted, f)),
                                   rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=0, atol=1e-6)
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(jitted.normals), rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got.indices.numpy().astype(np.int64),
                                  np.asarray(want.indices).astype(np.int64))


def test_overshoot_planes_match_and_view_as_arrays():
    res, inres = 40, 48
    h = _heights(5, inres)
    with jax.disable_jit():
        want = JM.heightmap_mesh_overshoot_planes(jnp.asarray(h), res, inres, 1000.0, 40.0)
    got = TM.heightmap_mesh_overshoot_planes(torch.from_numpy(h), res, inres, 1000.0, 40.0)
    assert got.planes.shape == (12, res + 1, res + 1)
    idx = [0, 1, 2, 6, 7, 8, 9, 10, 11]
    np.testing.assert_array_equal(got.planes.numpy()[idx], np.asarray(want.planes)[idx])
    np.testing.assert_allclose(got.planes.numpy()[3:6], np.asarray(want.planes)[3:6],
                               rtol=0, atol=1e-6)
    arrays = TM.heightmap_mesh_overshoot(torch.from_numpy(h), res, inres, 1000.0, 40.0)
    view = got.to_arrays()
    for f in ("positions", "normals", "tangents", "uvs", "indices"):
        np.testing.assert_array_equal(getattr(view, f).numpy(), getattr(arrays, f).numpy())
    np.testing.assert_allclose(np.linalg.norm(view.normals.numpy(), axis=1), 1.0, atol=1e-6)
