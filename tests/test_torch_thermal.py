"""noize_tpu_torch thermal erosion (ops/thermal, K3's module
ops/cuda/thermal) against noize_tpu on the same inputs.

Tolerances:
  * bit-exact against JAX evaluated one primitive at a time
    (``jax.disable_jit()``), given the same ``max_diff``;
  * ``max_diff`` itself: the port takes the TPU kernel's recipe (angle in
    double, float32 tan as XLA's runtime evaluates it, ``ops.f32.tan``).
    It equals the eager reference's value and the one
    ``ensure_compile_time_eval`` gives (thermal_pl.py:120) at every integer
    talus.  XLA's constant folder rounds the tangent otherwise, so a
    compiled program with a constant angle (a compiled ``erosion_cycle``)
    differs by an ulp at talus 21, 56 and 90 and agrees elsewhere.  Called
    with a traced talus, the reference computes the angle in float32 and
    lands up to 2 ulp away (ROADMAP.md §3);
  * against the Pallas kernel in interpret mode, atol 2e-7 — the bound
    tests/test_pallas.py holds that kernel to.
Here, on the CPU, the wrapper runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from noize_tpu.ops import thermal as JT
from noize_tpu.ops.pallas import thermal_pl as JP
from noize_tpu_torch.ops import thermal as TT
from noize_tpu_torch.ops.cuda import thermal as TC


def _field(seed, res):
    return np.random.default_rng(seed).uniform(0, 1, (res, res)).astype(np.float32)


def _ulps(a, b):
    return abs(int(np.float32(a).view(np.int32)) - int(np.float32(b).view(np.int32)))


@pytest.mark.parametrize("talus,hwr,res", [(55.0, 1.0, 64), (45.0, 0.5, 128),
                                           (30.0, 2.0, 100)])
def test_max_diff_matches_reference(talus, hwr, res):
    got = TT.max_diff_value(talus, hwr, res)
    with jax.disable_jit():
        talus_rad = (talus / 90.0) * 3.14159 / 2.0
        eager = np.float32((jnp.tan(talus_rad) * hwr) / res)
    traced = np.float32(jax.jit(
        lambda t: (jnp.tan((t / 90.0) * 3.14159 / 2.0) * hwr) / res)(jnp.float32(talus)))
    assert np.float32(got) == eager
    assert _ulps(got, traced) <= 2


@pytest.mark.parametrize("talus", range(1, 91))
def test_max_diff_equals_tpu_kernel_recipe_at_every_integer_talus(talus):
    """Tolerance 0 against the eager recipe and thermal_pl's
    ``ensure_compile_time_eval`` one, at ThermalStage's whole integer range
    [1, 90] (PyTorch's tan is an ulp off at 21, 56 and 90)."""
    talus_rad = (talus / 90.0) * 3.14159 / 2.0
    for hwr, res in ((1.0, 64), (0.5, 128), (2.0, 100)):
        with jax.disable_jit():
            eager = np.float32((jnp.tan(talus_rad) * hwr) / res)
        with jax.ensure_compile_time_eval():
            kernel = np.float32((jnp.tan(jnp.float32(talus_rad)) * hwr) / res)
        got = np.float32(TT.max_diff_value(float(talus), hwr, res))
        assert got == eager == kernel, (hwr, res, got, eager, kernel)


@pytest.mark.parametrize("res,talus,inc,hwr,iters", [
    (64, 45.0, 0.5, 1.0, 1), (128, 55.0, 0.6, 1.0, 2), (63, 30.0, 0.6, 2.0, 2),
])
def test_thermal_erosion_fused_bit_exact_vs_eager(res, talus, inc, hwr, iters):
    h = _field(res, res)
    with jax.disable_jit():
        want = np.asarray(JT.thermal_erosion(jnp.asarray(h), talus, inc, hwr,
                                             iterations=iters))
    before = TC.thermal_erosion_fused.launches
    got = TC.thermal_erosion_fused(torch.from_numpy(h), talus, inc, hwr, iters).numpy()
    assert TC.thermal_erosion_fused.launches == before
    np.testing.assert_array_equal(got, want)
    assert not np.array_equal(got, h)


@pytest.mark.parametrize("talus", [45.0, 55.0])
def test_thermal_bit_exact_vs_jitted_constant_talus(talus):
    h = _field(9, 64)
    want = np.asarray(jax.jit(
        lambda x: JT.thermal_erosion(x, talus, 0.6, 1.0, iterations=1))(h))
    got = TC.thermal_erosion_fused(torch.from_numpy(h), talus, 0.6, 1.0, 1).numpy()
    np.testing.assert_array_equal(got, want)


def test_thermal_matches_pallas_interpret():
    h = _field(7, 64)
    with pltpu.force_tpu_interpret_mode():
        pallas = np.asarray(JP.thermal_erosion_fused(
            jnp.asarray(h), 45.0, 0.5, 1.0, iterations=2, block=32, unroll=False))
    got = TC.thermal_erosion_fused(torch.from_numpy(h), 45.0, 0.5, 1.0, 2).numpy()
    np.testing.assert_allclose(got, pallas, rtol=0, atol=2e-7)


@pytest.mark.parametrize("x0,z0", JT._PHASE_OFFSETS)
def test_phase_masked_bit_exact(x0, z0):
    h = _field(8, 33)
    with jax.disable_jit():
        want = np.asarray(JT.thermal_phase_masked(jnp.asarray(h), x0, z0, 0, 0, 33,
                                                  jnp.float32(0.01), 0.5))
    got = TT.thermal_phase_masked(torch.from_numpy(h), x0, z0, 0, 0, 33, 0.01, 0.5)
    np.testing.assert_array_equal(got.numpy(), want)
    assert TT._PHASE_OFFSETS == JT._PHASE_OFFSETS and TT._PAIRS == JT._PAIRS
