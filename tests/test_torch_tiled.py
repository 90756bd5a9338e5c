"""The port's ``parallel.tiled`` (``tile_batch``, ``generate_tile``) against
``noize_tpu.parallel.tiled`` on the CPU, at 32² tiles.

The reference vmaps ``fractal`` over float32 origins, blurs and flows the
stack, ``lax.map``s the erosion and vmaps the mesh planes; the port runs
the same stages on the stack (K1's and K2's plain versions here) and
erodes tile by tile.  References:

  * ``noize_tpu.parallel.tiled.tile_batch`` under ``jax.disable_jit()``
    (one primitive at a time, ``lax.map`` a loop): heights without erosion
    are bit-equal; with erosion, heights and mesh planes hold 1e-4 of each
    map's or plane's scale (BASELINE.md's bar; measured ≤ 3e-7 for heights
    and ≤ 1.2e-5 absolute for planes: the erosion's sums and tunables are
    f32 constants folded differently, ROADMAP §3);
  * the compiled call (XLA contracts multiply-adds into FMAs, ROADMAP §3):
    heights without erosion within 1e-6 absolute, the rest as above.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from noize_tpu.core.tiles import TileSetMeta
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.parallel import tiled as JT
from noize_tpu_torch import convert
from noize_tpu_torch import prng
from noize_tpu_torch.ops import flow as FL
from noize_tpu_torch.ops import mesh as TM
from noize_tpu_torch.ops.cuda.stencil import separable_chain_plain
from noize_tpu_torch.ops.fractal import fractal
from noize_tpu_torch.ops.kernels import gaussian_taps
from noize_tpu_torch.parallel import tiled as TT

META = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=100, margin=4)
EROSION = ErosionSettings(PARTICLES_PER_CYCLE=8, MAXAGE=4, WATER_STEPS=1, CYCLES=1,
                          PILING_RADIUS=4)


def configs(erosion=False, emit_mesh=False, **kw):
    """(JAX config, port config) of the same fields."""
    base = dict(noise_type="Perlin", octaves=3, noise_size=100.0, blur_iterations=2)
    base.update(kw)
    jcfg = JT.TilePipelineConfig(meta=META, erosion=EROSION if erosion else None,
                                 erosion_cycles=1 if erosion else 0, emit_mesh=emit_mesh,
                                 **base)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)}
    fields["meta"] = convert.meta_from_jax(dataclasses.asdict(META))
    if erosion:
        fields["erosion"] = convert.settings_from_jax(dataclasses.asdict(EROSION))
    return jcfg, TT.TilePipelineConfig(**fields)


def _key(x, z, seed):
    """The key ``tile_batch`` gives the tile at world origin (x, z)."""
    return prng.fold_in(prng.fold_in(prng.PRNGKey(seed, device="cpu"), x), z)


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, want, rtol=1e-4):
    got, want = np.asarray(_np(got), np.float64), np.asarray(_np(want), np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    gap = np.abs(got - want).max()
    assert gap <= rtol * max(np.abs(want).max(), 1e-30), gap


@pytest.fixture(scope="module")
def fields():
    """Field stages only (no erosion): four tiles, with and without flow."""
    out = {}
    origins = JT.grid_origins(META, 2, 2)
    for flow in (0, 2):
        jcfg, tcfg = configs(flow_iterations=flow)
        with jax.disable_jit():
            eager = np.asarray(JT.tile_batch(jcfg, origins, seed=3))
        compiled = np.asarray(JT.tile_batch(jcfg, origins, seed=3))
        got = TT.tile_batch(tcfg, origins, seed=3, device="cpu")
        out[flow] = (eager, compiled, got)
    return out


@pytest.mark.parametrize("flow", [0, 2])
def test_field_stages_bit_equal_to_eager_reference(fields, flow):
    eager, _, got = fields[flow]
    assert got.dtype == torch.float32 and tuple(got.shape) == (4, 32, 32)
    np.testing.assert_array_equal(got.numpy(), eager)


@pytest.mark.parametrize("flow", [0, 2])
def test_field_stages_match_compiled_reference(fields, flow):
    _, compiled, got = fields[flow]
    np.testing.assert_allclose(got.numpy(), compiled, rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def eroded():
    """Erosion and mesh planes: two tiles (the reference's lax.map runs its
    loop), eager and compiled reference, and the port."""
    jcfg, tcfg = configs(erosion=True, emit_mesh=True)
    origins = JT.grid_origins(META, 2, 1)
    with jax.disable_jit():
        eager = jax.device_get(JT.tile_batch(jcfg, origins, seed=3))
    compiled = jax.device_get(JT.tile_batch(jcfg, origins, seed=3))
    got = TT.tile_batch(tcfg, origins, seed=3, device="cpu")
    return tcfg, origins, eager, compiled, got


@pytest.mark.parametrize("ref", ["eager", "compiled"])
def test_eroded_heights_match_reference(eroded, ref):
    tcfg, origins, eager, compiled, got = eroded
    want = eager if ref == "eager" else compiled
    assert tuple(got["height"].shape) == (2, 32, 32)
    for i in range(2):
        _close(got["height"][i], want["height"][i])
    # the erosion ran: the heights left the uneroded field
    fields_only = TT.tile_batch(dataclasses.replace(tcfg, erosion=None, erosion_cycles=0,
                                                    emit_mesh=False), origins, seed=3,
                                device="cpu")
    assert not torch.equal(got["height"], fields_only)


@pytest.mark.parametrize("ref", ["eager", "compiled"])
def test_mesh_planes_match_reference(eroded, ref):
    _, _, eager, compiled, got = eroded
    want = eager if ref == "eager" else compiled
    planes = got["mesh_planes"]
    assert tuple(planes.shape) == (2, 12, 25, 25)
    for i in range(2):
        for c in range(12):
            _close(planes[i, c], want["mesh_planes"][i, c])


def test_mesh_planes_of_the_stack_equal_each_tiles_own(eroded):
    _, _, _, _, got = eroded
    for i in range(2):
        own = TM.heightmap_mesh_overshoot_planes(got["height"][i], 24, 32, 100.0, 24.0)
        assert torch.equal(got["mesh_planes"][i], own.planes)


def test_batch_equals_single_tiles(eroded):
    """Each tile of the batch is ``generate_tile`` of that tile alone, on
    the key ``tile_batch`` derives from its world position."""
    tcfg, origins, _, _, got = eroded
    for i in range(len(origins)):
        x, z = (int(v) for v in origins[i])
        one = TT.generate_tile(tcfg, float(x), float(z), _key(x, z, 3))
        assert torch.equal(one["height"], got["height"][i])
        assert torch.equal(one["mesh_planes"], got["mesh_planes"][i])


def test_tile_keys_match_reference_fold_in():
    base = jax.random.PRNGKey(7)
    for x, z in ((0, 0), (24, -48), (-32, 16)):
        want = jax.random.fold_in(jax.random.fold_in(base, np.int32(x)), np.int32(z))
        np.testing.assert_array_equal(_key(x, z, 7).numpy(), np.asarray(want))
    xs, zs = [0, 24, -32], [0, -48, 16]
    stack = prng.fold_in_stack(prng.fold_in_stack(prng.PRNGKey(7, device="cpu"), xs), zs)
    for i, (x, z) in enumerate(zip(xs, zs)):
        assert torch.equal(stack[i], _key(x, z, 7))


def test_tile_is_pure_function_of_origin_and_seed():
    """The same tile in another batch (another slot, other companions)
    reproduces bit for bit; another seed changes it."""
    _, tcfg = configs(erosion=True)
    origins = TT.grid_origins(tcfg.meta, 2, 2)
    a = TT.tile_batch(tcfg, origins[:3], seed=7, device="cpu")
    reordered = np.concatenate([origins[2:3], origins[3:4]])
    b = TT.tile_batch(tcfg, reordered, seed=7, device="cpu")
    assert torch.equal(a[2], b[0])
    c = TT.tile_batch(tcfg, reordered, seed=8, device="cpu")
    assert not torch.equal(b[0], c[0])


def test_seams_agree_across_batch_boundaries():
    """Tiles 1 and 2 of a row of four, served in two batches of two, agree
    on their overlap: noise is a function of world position."""
    _, tcfg = configs(noise_type="Simplex", octaves=4, noise_size=90.0, blur_iterations=0)
    origins = TT.grid_origins(tcfg.meta, 4, 1)
    first = TT.tile_batch(tcfg, origins[:2], device="cpu")
    second = TT.tile_batch(tcfg, origins[2:], device="cpu")
    overlap = tcfg.meta.generator_res - tcfg.meta.tile_res
    assert torch.equal(first[1][:, tcfg.meta.tile_res:], second[0][:, :overlap])
    assert torch.equal(first[0][:, tcfg.meta.tile_res:], first[1][:, :overlap])


@pytest.mark.parametrize("t", [1, 3])
def test_plain_kernels_on_a_stack_equal_each_map(t):
    """K1's and K2's plain versions, the fractal and the mesh planes on a
    stack give each map's own result bit for bit."""
    rng = np.random.default_rng(t)
    stack = torch.from_numpy(
        np.stack([rng.uniform(0, 1 + 9 * i, (20, 28)) for i in range(t)]).astype(np.float32))
    taps = gaussian_taps(1.0, 5)
    chain = separable_chain_plain(stack, taps, 3)
    square = stack[:, :20, :20].contiguous()
    flow = FL.flow_map(square, 3)
    xs, zs = [0.0, 24.0, -48.0][:t], [0.0, 0.0, 24.0][:t]
    noise = fractal(32, xs, zs, noise_type="Simplex", octaves=3, noise_size=90.0,
                    device="cpu")
    planes = TM.heightmap_mesh_overshoot_planes(noise, 24, 32, 100.0, 24.0).planes
    assert tuple(planes.shape) == (t, 12, 25, 25)
    for i in range(t):
        assert torch.equal(chain[i], separable_chain_plain(stack[i], taps, 3))
        assert torch.equal(flow[i], FL.flow_map(square[i], 3))
        one = fractal(32, xs[i], zs[i], noise_type="Simplex", octaves=3, noise_size=90.0,
                      device="cpu")
        assert torch.equal(noise[i], one)
        assert torch.equal(planes[i],
                           TM.heightmap_mesh_overshoot_planes(one, 24, 32, 100.0, 24.0).planes)


def test_grid_origins_and_refusals(tmp_path):
    """Origins as the reference's; ``mesh=`` (once refused here) runs the
    sharded batch: on a one-rank gloo ``batch`` mesh, a ``DTensor`` equal
    to the unsharded batch (tests/test_torch_distributed.py runs 2 ranks)."""
    from torch.distributed.tensor import DTensor

    from noize_tpu_torch.parallel import device_mesh as DM

    _, tcfg = configs()
    np.testing.assert_array_equal(TT.grid_origins(tcfg.meta, 3, 2),
                                  JT.grid_origins(META, 3, 2))
    origins = TT.grid_origins(tcfg.meta, 2, 1)
    torch.distributed.init_process_group("gloo", init_method=f"file://{tmp_path / 'init'}",
                                         world_size=1, rank=0)
    try:
        got = TT.tile_batch(tcfg, origins, mesh=DM.batch_mesh(device="cpu"))
        assert isinstance(got, DTensor) and tuple(got.shape) == (2, 32, 32)
        assert torch.equal(got.full_tensor(), TT.tile_batch(tcfg, origins, device="cpu"))
    finally:
        torch.distributed.destroy_process_group()
    neg = np.asarray([[-32, -16], [16, -48]], np.int32)
    assert bool(torch.isfinite(TT.tile_batch(tcfg, neg, seed=3, device="cpu")).all())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.tile_batch(tcfg, neg)
