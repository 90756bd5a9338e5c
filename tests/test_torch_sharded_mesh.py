"""The port's sharded mesh emission (``noize_tpu_torch.parallel.
sharded_mesh``) on 4 gloo ranks on the CPU, 2×2 and 4×1 meshes of a 64²
height field, against the port's single-device meshers and
``noize_tpu.parallel.sharded_mesh`` on ``jax.devices()[:4]``: both
variants (overshoot, square), both layouts (arrays, planes), margins 0, 1
and 8.

The ranks run as one launch of subprocesses (``tests/torch_ranks.py``,
suite ``mesh``), each bounded by a 120 s timeout.

Tolerances:
  * against the port's ``heightmap_mesh*`` on the whole field:
    bit-equality (the same taps, steps and vertex math on every block);
  * against the JAX sharded mesh, compiled (``jax.jit``): 1e-5 absolute
    (the normals' square root and division differ by a few ulp, and XLA's
    CPU backend contracts multiply-adds, ROADMAP.md §3); the indices
    equal;
  * the per-rank windows and triangle lists: equal to the reference's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from noize_tpu.parallel import sharded_mesh as JSM
from noize_tpu_torch.ops import mesh as MH
from noize_tpu_torch.parallel import sharded_mesh as SM

import torch_ranks as R
from torch_ranks import launch

INP = 64
CASES = [(m, g, v, lay) for m in R.MESHES for g in R.MESH_MARGINS for v in R.MESH_VARIANTS
         for lay in R.MESH_LAYOUTS]
IDS = ["-".join(map(str, c)) for c in CASES]
FIELDS = ("positions", "normals", "tangents", "uvs")


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("mesh", 4, tmp_path_factory.mktemp("mesh"))


def _single(margin, variant, layout, heights=None):
    r = INP - 2 * margin
    a = torch.from_numpy(R.mesh_height(INP) if heights is None else heights)
    fn = {("overshoot", "arrays"): MH.heightmap_mesh_overshoot,
          ("square", "arrays"): MH.heightmap_mesh,
          ("overshoot", "planes"): MH.heightmap_mesh_overshoot_planes,
          ("square", "planes"): MH.heightmap_mesh_planes}[(variant, layout)]
    return fn(a, r, INP, 500.0, float(r))


@pytest.mark.parametrize("mesh,margin,variant,layout", CASES, ids=IDS)
def test_vertices_bit_exact_against_single_device(results, mesh, margin, variant, layout):
    key = f"{mesh}/{margin}/{variant}/{layout}"
    want = _single(margin, variant, layout)
    nx, ny = R.MESHES[mesh]
    if layout == "planes":
        np.testing.assert_array_equal(results[f"{key}/planes"], want.planes.numpy())
        assert tuple(results[f"{key}/field_shape"]) == (12, INP + nx, INP + ny)
    else:
        for f in FIELDS:
            np.testing.assert_array_equal(results[f"{key}/{f}"], getattr(want, f).numpy(), f)
        assert tuple(results[f"{key}/field_shape"]) == (INP + nx, INP + ny, 3)
    np.testing.assert_array_equal(results[f"{key}/indices"], want.indices.numpy())


@pytest.mark.parametrize("mesh,margin,variant,layout", CASES, ids=IDS)
def test_matches_jax_sharded_mesh(results, mesh, margin, variant, layout):
    key = f"{mesh}/{margin}/{variant}/{layout}"
    r = INP - 2 * margin
    shape = R.MESHES[mesh]
    jmesh = Mesh(np.array(jax.devices()[:4]).reshape(shape), ("x", "y"))
    a = jax.device_put(jnp.asarray(R.mesh_height(INP)), NamedSharding(jmesh, P("x", "y")))
    fields = jax.jit(lambda x: JSM.sharded_heightmap_mesh(
        jmesh, x, r, INP, 500.0, float(r), variant=variant, layout=layout))(a)
    if layout == "planes":
        want = JSM.mesh_planes_from_fields(fields, r, INP, shape)
        np.testing.assert_allclose(results[f"{key}/planes"], np.asarray(want.planes),
                                   rtol=0, atol=1e-5)
    else:
        want = JSM.mesh_arrays_from_fields(fields, r, INP, shape)
        for f in FIELDS:
            np.testing.assert_allclose(results[f"{key}/{f}"], np.asarray(getattr(want, f)),
                                       rtol=0, atol=1e-5, err_msg=f)
    np.testing.assert_array_equal(results[f"{key}/indices"], np.asarray(want.indices))


@pytest.mark.parametrize("margin", R.MESH_MARGINS)
@pytest.mark.parametrize("shape", [(4, 2), (2, 2), (4, 1), (1, 1)])
def test_windows_and_triangle_lists_equal_the_reference(margin, shape):
    r = INP - 2 * margin
    for local in (False, True):
        got = SM.shard_mesh_indices(r, INP, shape, local=local)
        want = JSM.shard_mesh_indices(r, INP, shape, local=local)
        assert got.keys() == want.keys()
        for k in got:
            assert got[k].dtype == np.uint32
            np.testing.assert_array_equal(got[k], want[k])
    for i in range(shape[0]):
        for j in range(shape[1]):
            assert SM.shard_vertex_window(r, INP, shape, (i, j)) == \
                JSM.shard_vertex_window(r, INP, shape, (i, j))


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_sim_mesh_fields_equal_single_device_mesh(results, mesh):
    """``ShardedErosionSim.mesh_fields`` of the sim's height: the
    overshoot mesh of that height, in both layouts."""
    nx, ny = R.MESHES[mesh]
    h = results[f"{mesh}/sim/height"]
    pos = results[f"{mesh}/sim/positions"]
    assert pos.shape == (32 + nx, 32 + ny, 3)
    full = SM._reassemble_blocks(torch.from_numpy(pos), 32, 32, (nx, ny), grid_axis=0)
    want = MH.heightmap_mesh_overshoot(torch.from_numpy(h), 32, 32, 1000.0, 32.0)
    np.testing.assert_array_equal(full.reshape(-1, 3).numpy(), want.positions.numpy())
    planes = results[f"{mesh}/sim/planes"]
    assert planes.shape == (12, 32 + nx, 32 + ny) and np.isfinite(planes).all()
