"""Two processes of the port's ``parallel.distributed`` on the CPU with
gloo, in the spirit of tests/test_distributed_2proc.py: ``initialize``
from a coordinator address, the multi-host meshes, a sum across the
process boundary, and ``tile_batch(mesh=...)`` over a 2-rank ``batch``
mesh against the unsharded batch.

Both ranks run as one launch of subprocesses (``tests/torch_ranks.py``,
suite ``batch``), each bounded by a 120 s timeout.

Tolerance: exact — each rank runs its whole tiles through the one-device
path, with keys from the tiles' world positions.
"""

import dataclasses

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from noize_tpu.core.tiles import TileSetMeta as JMeta
from noize_tpu.parallel import tiled as JT
from noize_tpu_torch.parallel import distributed as D
from noize_tpu_torch.parallel import tiled as TT

import torch_ranks as R
from torch_ranks import launch


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("batch", 2, tmp_path_factory.mktemp("batch"))


def test_initialize_meshes_and_psum(results):
    assert bool(results["primary"][0])  # rank 0 wrote the results
    assert tuple(results["multihost_tile_mesh"]) == (2, 1)
    assert tuple(results["multihost_spatial_mesh"]) == (2, 1, 1)
    assert float(results["psum"][0]) == 3.0


def test_initialize_without_coordinator_is_a_no_op(monkeypatch):
    monkeypatch.delenv("MASTER_ADDR", raising=False)
    assert D.initialize() is False
    assert D.is_primary()


@pytest.mark.parametrize("erosion,emit", [(False, False), (True, True)])
def test_tile_batch_over_mesh_equals_unsharded(results, erosion, emit):
    cfg = R.tile_config(erosion, emit)
    want = TT.tile_batch(cfg, R.tile_origins(), seed=5, device="cpu")
    want = want if isinstance(want, dict) else {"height": want}
    for k, v in want.items():
        got = results[f"tiles/{int(erosion)}{int(emit)}/{k}"]
        np.testing.assert_array_equal(got, v.numpy())
        assert tuple(results[f"tiles/{int(erosion)}{int(emit)}/{k}/local"]) == \
            (2, *v.shape[1:])  # whole tiles, two a rank


def test_tile_batch_refuses_uneven_split_as_reference(results):
    cfg = R.tile_config(False, False)
    jcfg = JT.TilePipelineConfig(**{**{f.name: getattr(cfg, f.name)
                                       for f in dataclasses.fields(cfg)},
                                    "meta": JMeta(**dataclasses.asdict(cfg.meta))})
    mesh = Mesh(np.array(jax.devices()[:2]), ("batch",))
    with pytest.raises(ValueError) as want:
        JT.tile_batch(jcfg, R.tile_origins()[:3], mesh=mesh)
    assert str(results["refusal"][0]) == str(want.value)
