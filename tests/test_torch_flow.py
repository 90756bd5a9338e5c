"""noize_tpu_torch flow map (ops/flow, K2's module ops/cuda/flow) against
noize_tpu on the same inputs.

Tolerances:
  * bit-exact against JAX evaluated one primitive at a time
    (``jax.disable_jit()``) — the reference's separately rounded float32
    arithmetic, which K2 (built with -fmad=false) also keeps;
  * against the jitted CPU program and the Pallas kernel in interpret
    mode (which runs as a jitted CPU program), atol 1e-6 on a map in
    [0, 1]-ish: XLA's CPU backend contracts ``water + d·Δt`` and
    ``vx² + vy²`` into FMAs (ROADMAP.md §3).
Here, on the CPU, the wrapper runs the plain version.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from noize_tpu.ops import flow as JF
from noize_tpu.ops.pallas import flow_pl as JP
from noize_tpu_torch.ops import flow as TF
from noize_tpu_torch.ops.cuda import flow as TC


def _field(seed, res):
    return np.random.default_rng(seed).uniform(0, 1, (res, res)).astype(np.float32)


@pytest.mark.parametrize("dz,dx", [(0, 1), (0, -1), (1, 0), (-1, 0), (2, -3), (0, 0)])
def test_shift_clamped_identical(dz, dx):
    a = _field(0, 16)
    np.testing.assert_array_equal(TF.shift_clamped(torch.from_numpy(a), dz, dx).numpy(),
                                  np.asarray(JF.shift_clamped(jnp.asarray(a), dz, dx)))


def test_step_functions_bit_exact():
    rng = np.random.default_rng(1)
    h, w, a, b, c, d = (rng.uniform(0, 1, (32, 32)).astype(np.float32) for _ in range(6))
    t = [torch.from_numpy(x) for x in (h, w, a, b, c, d)]
    with jax.disable_jit():
        jf = JF.compute_flow_step(*map(jnp.asarray, (h, w, a, b, c, d)))
        jw = JF.update_water_step(*map(jnp.asarray, (w, a, b, c, d)))
        jv = JF.velocity_field(*map(jnp.asarray, (a, b, c, d)))
    for got, want in zip(TF.compute_flow_step(*t), jf):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(TF.update_water_step(*t[1:]).numpy(), np.asarray(jw))
    np.testing.assert_array_equal(TF.velocity_field(*t[2:]).numpy(), np.asarray(jv))


@pytest.mark.parametrize("res,iters", [(64, 4), (128, 8)])
def test_flow_map_fused_matches_reference(res, iters):
    h = _field(2, res)
    with jax.disable_jit():
        eager = np.asarray(JF.flow_map(jnp.asarray(h), iterations=iters))
    jitted = np.asarray(JF.flow_map(jnp.asarray(h), iterations=iters))
    before = TC.flow_map_fused.launches
    got = TC.flow_map_fused(torch.from_numpy(h), iters).numpy()
    assert TC.flow_map_fused.launches == before
    np.testing.assert_array_equal(got, eager)
    np.testing.assert_allclose(got, jitted, rtol=0, atol=1e-6)
    assert np.abs(got - 0.5).max() > 1e-3  # the map is not flat


def test_flow_map_fused_matches_pallas_interpret():
    h = _field(3, 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.flow_map_fused(jnp.asarray(h), iterations=3, block=32))
    got = TC.flow_map_fused(torch.from_numpy(h), 3).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_flow_map_norm_guard_and_custom_range():
    h = _field(4, 32)
    with jax.disable_jit():
        want = np.asarray(JF.flow_map(jnp.asarray(h), 3, -0.2, 0.3))
        zero = np.asarray(JF.flow_map(jnp.asarray(h), 3, 0.1, 0.1))
    np.testing.assert_array_equal(TF.flow_map(torch.from_numpy(h), 3, -0.2, 0.3).numpy(), want)
    got = TF.flow_map(torch.from_numpy(h), 3, 0.1, 0.1).numpy()
    # rng == 0: both take the guard and divide 0 − norm_min by 0
    np.testing.assert_array_equal(np.isfinite(got), np.isfinite(zero))
    assert TF.TIMESTEP == JF.TIMESTEP and TF.WATER_INIT == JF.WATER_INIT


def test_flow_map_pallas_entry_matches_interpret():
    """The port's entry of TPU kernel #3 (``_iteration_call``, one launch
    per iteration) against the JAX entry in interpret mode."""
    h = _field(5, 64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(JP.flow_map_pallas(jnp.asarray(h), iterations=3, block=32))
    before = TC.flow_map_pallas.launches
    got = TC.flow_map_pallas(torch.from_numpy(h), 3, block=32).numpy()
    assert TC.flow_map_pallas.launches == before
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got, TF.flow_map(torch.from_numpy(h), 3).numpy())
