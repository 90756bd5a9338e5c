"""``kernel_filter`` for every ``KERNEL_FILTER_TYPES`` entry, the edge
filters and the min filters of the port against ``noize_tpu``, on the
CPU (where the port runs K1's plain version, ``separable_series``).

Tolerances: bit-exact against JAX evaluated one primitive at a time
(``jax.disable_jit()``); against the compiled program, whose
multiply-adds XLA contracts into FMAs (ROADMAP.md §3), 1e-6 of the
output's scale (as the blur is held: atol 1e-6 on maps of order 1; the
Sobel/Prewitt outputs grow with each iteration).  The min filters are
exact against both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import edge as JE
from noize_tpu.ops import kernels as JK
from noize_tpu_torch.ops import edge as TE
from noize_tpu_torch.ops import kernels as TK
from noize_tpu_torch.ops.cuda import stencil as SC


def _map(seed, shape=(40, 52)):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


def _check(got, eager, compiled):
    np.testing.assert_array_equal(got, eager)
    scale = max(1.0, float(np.abs(compiled).max()))
    np.testing.assert_allclose(got, compiled, rtol=0, atol=1e-6 * scale)


def test_tables_match_reference():
    assert TK.KERNEL_FILTER_TYPES == JK.KERNEL_FILTER_TYPES
    assert set(TK._SERIES_TABLE) == set(JK._SERIES_TABLE)
    for name, (tx, tz, f) in TK._SERIES_TABLE.items():
        jx, jz, jf = JK._SERIES_TABLE[name]
        np.testing.assert_array_equal(tx, jx)
        np.testing.assert_array_equal(tz, jz)
        assert np.float32(f) == np.float32(jf)


@pytest.mark.parametrize("filter_type", JK.KERNEL_FILTER_TYPES)
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_kernel_filter_matches_reference(filter_type, iterations):
    a = _map(iterations)
    got = TK.kernel_filter(torch.from_numpy(a), filter_type, iterations).numpy()
    with jax.disable_jit():
        eager = np.asarray(JK.kernel_filter(jnp.asarray(a), filter_type, iterations))
    compiled = np.asarray(jax.jit(JK.kernel_filter, static_argnums=(1, 2))(
        jnp.asarray(a), filter_type, iterations))
    _check(got, eager, compiled)


def test_kernel_filter_rejects_unknown():
    with pytest.raises(ValueError):
        TK.kernel_filter(torch.zeros(4, 4), "Gauss11_S1")


@pytest.mark.parametrize("taps_x,taps_z,factor", [
    (TK._SOBEL3_HX, TK._SOBEL3_HZ, 1.0),
    (TK._PREWITT3_VX, TK._PREWITT3_VZ, 1.0),
    (TK._SMOOTH3, TK._SMOOTH3, TK._SMOOTH3_FACTOR),
    (TK.gaussian_taps(1.0, 5), TK._SOBEL3_HZ, 0.5),
])
def test_separable_chain_distinct_taps_and_factor(taps_x, taps_z, factor):
    """K1's wrapper on a CPU tensor: its plain version, the reference's
    series iterated (distinct X/Z taps, a factor, unequal lengths)."""
    a = _map(9)
    got = SC.separable_chain(torch.from_numpy(a), taps_x, 3, taps_z=taps_z,
                             factor=factor).numpy()
    want = jnp.asarray(a)
    with jax.disable_jit():
        for _ in range(3):
            want = JK.separable_series(want, taps_x, taps_z, factor)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_chain_plan_takes_the_larger_half_width():
    """A shorter tap list is centred in zeros: the plan is the longer
    list's, and on a finite map the zero taps add exact zeros."""
    a = torch.from_numpy(_map(10))
    g5, s3 = TK.gaussian_taps(1.0, 5), TK._SOBEL3_HZ
    padded = np.pad(s3, 1)
    np.testing.assert_array_equal(
        SC.separable_chain_plain(a, g5, 2, taps_z=s3).numpy(),
        SC.separable_chain_plain(a, g5, 2, taps_z=padded).numpy())


@pytest.mark.parametrize("algorithm", JE.EDGE_ALGORITHMS)
def test_edges_match_reference(algorithm):
    a = _map(11)
    with jax.disable_jit():
        for direction in JE.EDGE_DIRECTIONS:
            want = np.asarray(JE.edge_1d(jnp.asarray(a), algorithm, direction))
            got = TE.edge_1d(torch.from_numpy(a), algorithm, direction).numpy()
            np.testing.assert_array_equal(got, want)
        want2 = np.asarray(JE.edge_2d(jnp.asarray(a), algorithm))
    got2 = TE.edge_2d(torch.from_numpy(a), algorithm).numpy()
    _check(got2, want2, np.asarray(jax.jit(JE.edge_2d, static_argnums=1)(jnp.asarray(a),
                                                                           algorithm)))
    with pytest.raises(ValueError):
        TE.edge_1d(torch.from_numpy(a), algorithm, "DIAGONAL")


@pytest.mark.parametrize("size", [1, 3, 5, 8])
def test_min_filters_and_value_erosion(size):
    a = _map(12 + size)
    t = torch.from_numpy(a)
    for tf, jf in ((TK.min_x, JK.min_x), (TK.min_z, JK.min_z),
                   (TK.value_erosion, JK.value_erosion)):
        np.testing.assert_array_equal(tf(t, size).numpy(), np.asarray(jf(jnp.asarray(a), size)))
