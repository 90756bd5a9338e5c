"""The port's counterparts of the eleven JAX entries that reach a TPU kernel
(the ten TPU kernels' entries and ``gauss_chain``) against the JAX
entries' signatures, and their TPU layout arguments on the CPU.

The parameter names and defaults must be the JAX entry's, so a JAX caller's
keywords work unchanged.  The layout arguments (``block``, ``interpret``,
``unroll``, ``phases_per_launch``, ``iterations_per_launch``) choose how
the TPU runs a kernel, not what it computes: each port entry accepts them
and, on the CPU, returns its plain version's result bit for bit.
"""

import inspect

import numpy as np
import pytest
import torch

from noize_tpu.erosion import pool_pallas as JPP
from noize_tpu.ops.pallas import flow_pl as JF
from noize_tpu.ops.pallas import stencil as JS
from noize_tpu.ops.pallas import thermal_pl as JT
from noize_tpu_torch.erosion import pool as TP
from noize_tpu_torch.erosion import pool_cuda as PC
from noize_tpu_torch.ops import flow as TF
from noize_tpu_torch.ops import thermal as TT
from noize_tpu_torch.ops.cuda import flow as FC
from noize_tpu_torch.ops.cuda import stencil as SC
from noize_tpu_torch.ops.cuda import thermal as TC
from noize_tpu_torch.ops.kernels import gaussian_taps

_TAPS = gaussian_taps(1.0, 5)


def _map(seed, res=32):
    return torch.from_numpy(
        np.random.default_rng(seed).uniform(0, 1, (res, res)).astype(np.float32))


def _pool(seed, res=32):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0, 0.5, (res, res)).astype(np.float32)
    p = rng.uniform(-0.05, 0.05, (res, res)).clip(0).astype(np.float32)
    return torch.from_numpy(h), torch.from_numpy(p)


# name: (JAX module, port module, port call with layout arguments, plain call)
ENTRIES = {
    "fused_separable_chain": (
        JS, SC, lambda: SC.fused_separable_chain(_map(1), _TAPS, 3, block=16),
        lambda: SC.separable_chain_plain(_map(1), _TAPS, 3)),
    "fused_separable_chain_rows": (
        JS, SC, lambda: SC.fused_separable_chain_rows(_map(2), _TAPS, 3, block=8,
                                                      iterations_per_launch=2),
        lambda: SC.separable_chain_plain(_map(2), _TAPS, 3)),
    "gauss_chain": (
        JS, SC, lambda: SC.gauss_chain(_map(3), 5, 1.0, 3, block=8, interpret=True),
        lambda: SC.separable_chain_plain(_map(3), _TAPS, 3)),
    "flow_map_pallas": (
        JF, FC, lambda: FC.flow_map_pallas(_map(4), 3, block=8),
        lambda: TF.flow_map(_map(4), 3)),
    "flow_map_fused": (
        JF, FC, lambda: FC.flow_map_fused(_map(5), 3, block=8),
        lambda: TF.flow_map(_map(5), 3)),
    "thermal_erosion_fused": (
        JT, TC, lambda: TC.thermal_erosion_fused(_map(6), 45.0, 0.5, 1.0, 2, block=16,
                                                 unroll=False),
        lambda: TT.thermal_erosion(_map(6), 45.0, 0.5, 1.0, 2)),
    "pool_automata_pallas": (
        JPP, PC, lambda: PC.pool_automata_pallas(*_pool(7), 2, True, block=16),
        lambda: TP._pool_automata_fullgrid(*_pool(7), 2, True)),
    "pool_automata_pallas_pair": (
        JPP, PC, lambda: PC.pool_automata_pallas_pair(*_pool(8), 2, True, block=8),
        lambda: TP.pool_automata(*_pool(8), 2, True)),
    "pool_automata_pallas_quad": (
        JPP, PC, lambda: PC.pool_automata_pallas_quad(*_pool(9), 2, True, block=8,
                                                      phases_per_launch=4, unroll=False),
        lambda: TP.pool_automata(*_pool(9), 2, True)),
    "pool_automata_pallas_pair_fused": (
        JPP, PC, lambda: PC.pool_automata_pallas_pair_fused(*_pool(10), 2, True, block=8,
                                                            phases_per_launch=4,
                                                            unroll=False),
        lambda: TP.pool_automata(*_pool(10), 2, True)),
    "pool_automata_pallas_mega": (
        JPP, PC, lambda: PC.pool_automata_pallas_mega(*_pool(11), 2, True, block=8,
                                                      phases_per_launch=4),
        lambda: TP.pool_automata(*_pool(11), 2, True)),
}


def _params(fn):
    return [(p.name, p.default) for p in inspect.signature(fn).parameters.values()]


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_signature_matches_jax(name):
    jax_module, port_module, _, _ = ENTRIES[name]
    assert _params(getattr(port_module, name)) == _params(getattr(jax_module, name))


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_entry_layout_arguments_give_the_plain_result(name):
    _, _, port, plain = ENTRIES[name]
    got, want = port(), plain()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.device.type == "cpu"
        np.testing.assert_array_equal(g.numpy(), w.numpy())
