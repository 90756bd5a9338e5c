"""The port's filter ops (``noize_tpu_torch.ops.filters``), its copy of
the AnimationCurve evaluator (``utils.anim_curve``) and the mesh additions
against ``noize_tpu``, on the CPU.  Every op here is bit-exact against the
reference (elementwise ops, one rounding each; the square roots are
correctly rounded in both), and the curve LUTs are equal."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.app import presets as JP
from noize_tpu.ops import filters as JF
from noize_tpu.ops import mesh as JM
from noize_tpu.utils import anim_curve as JA
from noize_tpu_torch.ops import filters as TF
from noize_tpu_torch.ops import mesh as TM
from noize_tpu_torch.utils import anim_curve as TA


def _map(seed, shape=(24, 24), lo=-0.5, hi=1.5):
    return np.random.default_rng(seed).uniform(lo, hi, shape).astype(np.float32)


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("op", sorted(JF.CONSTANT_OPS))
@pytest.mark.parametrize("value", [0.0, 0.37, 0.5, 1.0])
def test_constant_ops(op, value):
    a = _map(1)
    a[0, :4] = value  # ties of BINARIZE's >=
    _eq(TF.CONSTANT_OPS[op](torch.from_numpy(a), value),
        JF.CONSTANT_OPS[op](jnp.asarray(a), value))


@pytest.mark.parametrize("op", sorted(JF.REDUCTION_OPS))
def test_reduction_ops(op):
    a, b = _map(2), _map(3)
    with jax.disable_jit():
        want = JF.REDUCTION_OPS[op](jnp.asarray(a), jnp.asarray(b))
    _eq(TF.REDUCTION_OPS[op](torch.from_numpy(a), torch.from_numpy(b)), want)


@pytest.mark.parametrize("lims", [(), (-1.0, 2.0), (0.2, 0.3)])
def test_map_range_and_normalize(lims):
    a = _map(4)
    t, j = torch.from_numpy(a), jnp.asarray(a)
    _eq(TF.map_range(t, *lims), JF.map_range(j, *lims))
    with jax.disable_jit():
        want = JF.normalize(j, *lims)
    _eq(TF.normalize(t, *lims), want)


def test_normalize_map_flat_quirk():
    """A range below 1e-12 zeroes the value, then still divides by it."""
    a = np.full((8, 8), 0.25, np.float32)
    for args in (np.array([0.25, 0.25, 0.0], np.float32),
                 np.array([0.1, 0.1, 1e-13], np.float32),
                 np.array([0.0, 1.0, 1.0], np.float32)):
        with np.errstate(all="ignore"):
            want = np.asarray(JF.normalize_map(jnp.asarray(a), jnp.asarray(args)))
        got = TF.normalize_map(torch.from_numpy(a), torch.from_numpy(args)).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", ["INVERT", "CURVE_BOOST_CONTRAST"])
def test_curve_apply_and_preset_luts(name):
    keys = getattr(JP, f"{name}_KEYS")
    lut = TA.sample_lut(keys)
    assert lut == JA.sample_lut(keys) and len(lut) == 256
    a = _map(5)
    a[0, :6] = [0.0, 1.0, 0.5, -0.25, 1.25, 255 / 256]  # both ends, the v == 1 quirk
    got = TF.curve_apply(torch.from_numpy(a), torch.tensor(lut, dtype=torch.float32))
    with jax.disable_jit():
        want = JF.curve_apply(jnp.asarray(a), jnp.asarray(lut, jnp.float32))
    _eq(got, want)


def test_anim_curve_evaluate_and_parse():
    keys = JP.INVERT_KEYS
    ts = np.linspace(-0.2, 1.2, 301)
    np.testing.assert_array_equal(TA.evaluate(keys, ts), JA.evaluate(keys, ts))
    weighted = (TA.Keyframe(0.0, 0.0, 1.0, 1.0, 2, 0.3, 0.6),
                TA.Keyframe(1.0, 1.0, 0.5, math.inf, 1, 0.2, 0.3))
    jweighted = tuple(JA.Keyframe(*k.__dict__.values()) for k in weighted)
    assert TA.sample_lut(weighted, 64) == JA.sample_lut(jweighted, 64)
    text = ("serializedVersion: 3\n time: 0\n value: 0\n inSlope: 0\n outSlope: 1\n"
            " tangentMode: 0\n weightedMode: 0\n inWeight: 0\n outWeight: 0.33333334\n")
    assert [k.__dict__ for k in TA.parse_unity_curve(text)] == \
        [k.__dict__ for k in JA.parse_unity_curve(text)]


def test_sample_curve_crop_fill():
    fn = lambda v: v * v  # noqa: E731
    _eq(TF.sample_curve(fn, 64, device="cpu"), JF.sample_curve(fn, 64))
    a = _map(6, (40, 40))
    for out, off in ((32, 0), (32, 4), (40, 0)):
        _eq(TF.crop(torch.from_numpy(a), out, off), JF.crop(jnp.asarray(a), out, off))
    _eq(TF.fill((5, 7), 0.3, device="cpu"), JF.fill((5, 7), 0.3))


@pytest.mark.parametrize("r", [3, 255, 256])
def test_index_dtype_and_grid_indices(r):
    want = JM.grid_indices(r)
    assert TM.index_dtype(r) == {np.dtype(np.uint16): torch.uint16,
                                 np.dtype(np.uint32): torch.uint32}[np.dtype(JM.index_dtype(r))]
    got = TM.grid_indices(r, device="cpu")
    assert got.numpy().dtype == want.dtype
    np.testing.assert_array_equal(got.numpy(), want)
    got32 = TM.grid_indices(r, torch.uint32, device="cpu")
    np.testing.assert_array_equal(got32.numpy(), JM.grid_indices(r, np.uint32))


@pytest.mark.parametrize("res,inres", [(24, 32), (16, 16)])
def test_heightmap_mesh_planes(res, inres):
    h = _map(7, (inres, inres), 0.0, 1.0)
    got = TM.heightmap_mesh_planes(torch.from_numpy(h), res, inres, 500.0, float(res))
    with jax.disable_jit():
        want = JM.heightmap_mesh_planes(jnp.asarray(h), res, inres, 500.0, float(res))
    np.testing.assert_array_equal(got.planes.numpy(), np.asarray(want.planes))
    np.testing.assert_array_equal(got.indices.numpy().astype(np.int64),
                                  np.asarray(want.indices).astype(np.int64))
    arrays = TM.heightmap_mesh(torch.from_numpy(h), res, inres, 500.0, float(res))
    for f in ("positions", "normals", "tangents", "uvs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(arrays, f).numpy())


@pytest.mark.parametrize("r", [1, 16, 100])
def test_flat_water_mesh_and_cache(r):
    got = TM.flat_water_mesh(r, device="cpu")
    want = JM.flat_water_mesh(r)
    for f in ("positions", "normals", "tangents", "uvs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_array_equal(got.indices.numpy().astype(np.int64),
                                  np.asarray(want.indices).astype(np.int64))
    assert TM.square_planar_mesh(r, device="cpu") is TM.square_planar_mesh(r, device="cpu")
