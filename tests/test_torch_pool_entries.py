"""The port's entries of the five TPU pool kernels (``erosion/pool_cuda``)
against ``noize_tpu.erosion.pool_pallas``'s, and K5's plain version (the
full-grid automata) against ``noize_tpu.erosion.pool``.

Here, on the CPU, each entry runs its plain version; the JAX entries run
their Pallas kernels in interpret mode (``pltpu.force_tpu_interpret_mode``)
at 32², 1-2 water steps, as tests/test_pallas.py does.

Tolerance: bit-equality.  The full-grid and pair automata do the same f32
ops in the same order in both packages; tests/test_pallas.py holds the
TPU kernels bit-exact (quad) or to 1e-7 (full grid) against the XLA path.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from jax.experimental.pallas import tpu as pltpu

from noize_tpu.erosion import pool as JP
from noize_tpu.erosion import pool_pallas as JPP
from noize_tpu_torch.erosion import pool as TP
from noize_tpu_torch.erosion import pool_cuda as PC


def _wet(res, seed, hi=0.05):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = rng.uniform(-hi, hi, (res, res)).clip(0).astype(np.float32)
    return h, p


# (port entry, JAX entry, JAX TPU-layout arguments, water steps); the
# pair-fused kernel takes one water step, which halves its interpret-mode
# compile time and still crosses its launch once
ENTRIES = [
    (PC.pool_automata_pallas, JPP.pool_automata_pallas, dict(block=16), 2),
    (PC.pool_automata_pallas_pair, JPP.pool_automata_pallas_pair, dict(block=8), 2),
    (PC.pool_automata_pallas_quad, JPP.pool_automata_pallas_quad,
     dict(block=8, phases_per_launch=4), 2),
    (PC.pool_automata_pallas_pair_fused, JPP.pool_automata_pallas_pair_fused,
     dict(block=8, phases_per_launch=4), 1),
]


def _both(port, ref, kw, h, p, iters, drain=True):
    with pltpu.force_tpu_interpret_mode():
        wp, wd = ref(jnp.asarray(h), jnp.asarray(p), iterations=iters,
                     drain_particles=drain, **kw)
    gp, gd = port(torch.from_numpy(h), torch.from_numpy(p), iters, drain, **kw)
    return (gp.numpy(), gd.numpy()), (np.asarray(wp), np.asarray(wd))


@pytest.mark.parametrize("port,ref,kw,iters", ENTRIES,
                         ids=lambda v: getattr(v, "__name__", ""))
def test_entry_matches_pallas_interpret(port, ref, kw, iters):
    h, p = _wet(32, 21)
    before = port.launches
    (gp, gd), (wp, wd) = _both(port, ref, kw, h, p, iters)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    assert not np.array_equal(gp, p) and (wd > 0).any()
    assert port.launches == before  # the CPU runs the plain version


@pytest.mark.parametrize("idx", [1, 2])
def test_pair_quad_gate_between_zero_and_min_water(idx):
    """The reference's pair and quad entries gate each step on
    ``any(pool > 0)``, the port's K4 on ``MIN_WATER``; with the maximum
    between the two both are fixed points, so the outputs are equal."""
    port, ref, kw, iters = ENTRIES[idx]
    rng = np.random.default_rng(5)
    h = rng.uniform(0, 0.5, (32, 32)).astype(np.float32)
    p = rng.uniform(0, JP.MIN_WATER * 0.9, (32, 32)).astype(np.float32)
    (gp, gd), (wp, wd) = _both(port, ref, kw, h, p, iters)
    np.testing.assert_array_equal(gp, wp)
    np.testing.assert_array_equal(gd, wd)
    np.testing.assert_array_equal(gp, p)
    assert not gd.any()


@pytest.mark.parametrize("res,drain", [(33, True), (33, False), (25, True)])
def test_full_grid_plain_matches_reference_at_odd_sizes(res, drain):
    h, p = _wet(res, res)
    wp, wd = JP.pool_automata(jnp.asarray(h), jnp.asarray(p), iterations=3,
                              drain_particles=drain)
    gp, gd = PC.pool_automata_full_cuda(torch.from_numpy(h), torch.from_numpy(p), 3, drain)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))
    assert not np.array_equal(gp.numpy(), p)
    # pool_automata_cuda takes the full-grid path at odd sizes, as the reference does
    cp, cd = PC.pool_automata_cuda(torch.from_numpy(h), torch.from_numpy(p), 3, drain)
    np.testing.assert_array_equal(cp.numpy(), gp.numpy())
    np.testing.assert_array_equal(cd.numpy(), gd.numpy())


def test_full_grid_plain_matches_reference_at_even_size():
    h, p = _wet(32, 7)
    wp, wd = JP._pool_automata_fullgrid(jnp.asarray(h), jnp.asarray(p), 2, True)
    gp, gd = TP._pool_automata_fullgrid(torch.from_numpy(h), torch.from_numpy(p), 2, True)
    np.testing.assert_array_equal(gp.numpy(), np.asarray(wp))
    np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


def test_mega_entry_is_the_pair_path():
    """``pool_automata_pallas_mega``'s entry runs K4, whose plain version
    test_torch_pool.py holds bit-exact against the JAX mega kernel in
    interpret mode (one more interpret compile here would cost ~20 s)."""
    h, p = _wet(32, 21)
    gp, gd = PC.pool_automata_pallas_mega(torch.from_numpy(h), torch.from_numpy(p), 2, True,
                                          block=8, phases_per_launch=4)
    wp, wd = TP.pool_automata(torch.from_numpy(h), torch.from_numpy(p), 2, True)
    assert torch.equal(gp, wp) and torch.equal(gd, wd)


def test_pair_and_quad_entries_refuse_odd_grids():
    h, p = _wet(17, 3)
    for port in (PC.pool_automata_pallas_pair, PC.pool_automata_pallas_quad,
                 PC.pool_automata_pallas_pair_fused, PC.pool_automata_pallas_mega):
        with pytest.raises(ValueError, match="even"):
            port(torch.from_numpy(h), torch.from_numpy(p), 1, True)
