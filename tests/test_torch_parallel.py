"""The port's sharded field layer (``noize_tpu_torch.parallel``: device
meshes, halo exchange, the five sharded field ops) on 4 gloo ranks on the
CPU, against the port's local ops and ``noize_tpu.parallel.sharded_ops`` on
a 4-device virtual mesh (``jax.devices()[:4]``).

The 4 ranks run as one launch of subprocesses (``tests/torch_ranks.py``,
every case of this file on a 2×2 and a 4×1 mesh), each bounded by a 120 s
timeout and the group by a 60 s one; they write their results for the
parametrised tests to read.

Tolerances:
  * against the port's local op on the whole grid: bit-equality (each
    rank's extended block clamps where the grid does, and every op rounds
    alike on every block);
  * against the JAX sharded op, as the local op's own test holds the
    compiled reference: blur, filters and flow atol 1e-6 of the map's
    scale, thermal atol 2e-7, noise 1e-4 relative (XLA's CPU backend
    contracts multiply-adds into FMAs; ROADMAP.md §3);
  * the halo exchange against the edge-padded global grid: exact; the fold
    as the exchange's adjoint, <E x, y> = <x, F y> in float64: 1e-12
    relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from noize_tpu.parallel import device_mesh as JDM
from noize_tpu.parallel import halo as JHA
from noize_tpu.parallel import sharded_ops as JSO
from noize_tpu_torch.ops.cuda.flow import flow_map_fused
from noize_tpu_torch.ops.cuda.stencil import gauss_chain
from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
from noize_tpu_torch.ops.fractal import fractal
from noize_tpu_torch.ops.kernels import kernel_filter, separable_series
from noize_tpu_torch.parallel import halo as HA

import torch_ranks as R
from torch_ranks import launch


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("fields", 4, tmp_path_factory.mktemp("fields"))


CASES = [(m, n) for m in R.MESHES for n in R.FIELD_CASES]


def local_op(name):
    """The port's local op on the whole grid (plain versions on the CPU)."""
    op, res, kw = R.FIELD_CASES[name]
    kw = dict(kw)
    if op == "fractal":
        return fractal(res, kw.pop("xpos"), kw.pop("zpos"), device="cpu", **kw)
    data = torch.from_numpy(R.field_input(name))
    if op == "blur":
        return gauss_chain(data, kw["width"], kw["sigma"], kw["iterations"])
    if op == "filter":
        return kernel_filter(data, kw["filter_type"], kw["iterations"])
    if op == "thermal":
        return thermal_erosion_fused(data, **kw)
    return flow_map_fused(data, **kw)


def jax_op(mesh_name, name):
    """The JAX sharded op, compiled as one program (``jax.jit``)."""
    op, res, kw = R.FIELD_CASES[name]
    kw = dict(kw)
    mesh = Mesh(np.array(jax.devices()[:4]).reshape(R.MESHES[mesh_name]), ("x", "y"))
    if op == "fractal":
        xpos, zpos = kw.pop("xpos"), kw.pop("zpos")
        return jax.jit(lambda: JSO.sharded_fractal(mesh, res, xpos, zpos, **kw))()
    fn = {"blur": JSO.sharded_gauss_blur, "filter": JSO.sharded_kernel_filter,
          "thermal": JSO.sharded_thermal_erosion, "flow": JSO.sharded_flow_map}[op]
    return jax.jit(lambda d: fn(mesh, d, **kw))(jnp.asarray(R.field_input(name)))


@pytest.mark.parametrize("mesh,name", CASES, ids=[f"{m}-{n}" for m, n in CASES])
def test_sharded_op_bit_equal_to_local(results, mesh, name):
    got = results[f"{mesh}/{name}"]
    res = R.FIELD_CASES[name][1]
    rows, cols = R.MESHES[mesh]
    np.testing.assert_array_equal(results[f"{mesh}/{name}/local_shape"],
                                  [res // rows, res // cols])
    np.testing.assert_array_equal(got, local_op(name).numpy())


@pytest.mark.parametrize("mesh,name", CASES, ids=[f"{m}-{n}" for m, n in CASES])
def test_sharded_op_matches_jax_sharded_op(results, mesh, name):
    got = results[f"{mesh}/{name}"].astype(np.float64)
    want = np.asarray(jax_op(mesh, name), np.float64)
    op = R.FIELD_CASES[name][0]
    scale = max(np.abs(want).max(), 1e-30)
    gap = np.abs(got - want).max()
    if op == "fractal":
        assert gap <= 1e-4 * scale, gap
    elif op == "thermal":
        assert gap <= 2e-7, gap
    else:
        assert gap <= 1e-6 * scale, gap


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_halo_exchange_and_fold_adjoint(results, mesh):
    e_x_y, x_f_y, ok = results[f"{mesh}/adjoint"]
    assert ok == 4.0  # every rank's clamp exchange equals the padded grid
    assert abs(e_x_y - x_f_y) <= 1e-12 * max(abs(e_x_y), 1.0)


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_dtensor_input_takes_the_same_path(results, mesh):
    src = results[f"{mesh}/blur-of-dtensor/input"]
    np.testing.assert_array_equal(src, fractal(64, 3.0, 5.0, octaves=2, device="cpu").numpy())
    np.testing.assert_array_equal(results[f"{mesh}/blur-of-dtensor"],
                                  gauss_chain(torch.from_numpy(src), 5, 1.0, 4).numpy())


def test_split2_and_mesh_shapes(results):
    np.testing.assert_array_equal(results["split2"], [JDM._split2(n) for n in range(1, 13)])
    devs = jax.devices()[:4]
    assert tuple(results["spatial_mesh"]) == JDM.spatial_mesh(devs).devices.shape
    assert tuple(results["hybrid_mesh"]) == JDM.hybrid_mesh(2, devs).devices.shape
    assert tuple(results["batch_mesh"]) == JDM.batch_mesh(devs).devices.shape


@pytest.mark.parametrize("mesh", list(R.MESHES))
def test_sharded_stencil_equals_local(results, mesh):
    taps = np.array([0.25, 0.5, 0.25], np.float32)
    g = torch.from_numpy(R.field_input("blur-g5x17"))
    np.testing.assert_array_equal(results[f"{mesh}/stencil"],
                                  separable_series(g, taps, taps).numpy())


def test_split_groups_and_reclamp_ghosts_match_reference():
    for total, k in ((17, 5), (4, 4), (1, 3), (9, 2)):
        assert HA.split_groups(total, k) == JHA.split_groups(total, k)
    rng = np.random.default_rng(3)
    halo, lr, lc, res = 3, 8, 6, 14
    ext = rng.normal(size=(lr + 2 * halo, lc + 2 * halo)).astype(np.float32)
    for row0, col0 in ((-halo, -halo), (res - lr - halo, 2), (2, res - lc - halo)):
        grow = (np.arange(lr + 2 * halo)[:, None] + row0) * np.ones((1, lc + 2 * halo), int)
        gcol = np.ones((lr + 2 * halo, 1), int) * (np.arange(lc + 2 * halo)[None, :] + col0)
        want = JHA.reclamp_ghosts(jnp.asarray(ext), jnp.asarray(grow), jnp.asarray(gcol),
                                  halo, lr, lc, res, res)
        got = HA.reclamp_ghosts(torch.from_numpy(ext), torch.from_numpy(grow),
                                torch.from_numpy(gcol), halo, lr, lc, res, res)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
