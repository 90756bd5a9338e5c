"""``TileServer(mesh=)`` on 2 gloo ranks and ``dryrun_multichip`` on 4, on
the CPU.

The server's ranks run as one launch of subprocesses
(``tests/torch_ranks.py``, suite ``server``), each bounded by a 120 s
timeout: the controller (rank 0) takes 6 orders at batch 4, both ranks run
each batch as ``tile_batch(mesh=batch_mesh())``.  The dry run starts its
own 4 gloo ranks (``noize_tpu_torch.app.dryrun``).

Tolerance: exact — every tile is a pure function of its origin and the
seed, whichever batch and rank run it.
"""

import numpy as np
import pytest
import torch

from noize_tpu_torch.app import dryrun as DR
from noize_tpu_torch.app.server import TileServer

import torch_ranks as R
from torch_ranks import launch


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    return launch("server", 2, tmp_path_factory.mktemp("server"))


def _unsharded(erosion):
    done = {}
    srv = TileServer(R.tile_config(erosion, False), batch_size=4, seed=5, device="cpu")
    for i, pos in enumerate(R.SERVER_ORDERS):
        srv.submit(f"t{i}", pos, on_complete=lambda st: done.__setitem__(st.request.uuid, st))
    try:
        srv.start()
        assert srv.drain(timeout=90.0)
    finally:
        srv.stop()
    return done


@pytest.mark.parametrize("erosion", [False, True])
def test_sharded_server_equals_unsharded_server(results, erosion):
    want = _unsharded(erosion)
    e = int(erosion)
    assert int(results[f"{e}/served"][0]) == len(R.SERVER_ORDERS)
    assert int(results[f"{e}/batches/0"][0]) >= 2  # 6 orders at batch 4
    for i in range(len(R.SERVER_ORDERS)):
        np.testing.assert_array_equal(results[f"{e}/t{i}"], want[f"t{i}"].heights.numpy())
    assert tuple(results["drained"]) == (2.0, 2.0)  # both ranks ended their waves


def test_sharded_server_refuses_an_uneven_batch_per_order(results):
    assert "do not divide" in str(results["uneven"][0])


def test_dryrun_multichip_on_four_cpu_ranks():
    DR.dryrun_multichip(4, device="cpu")


def test_dryrun_multichip_needs_its_cards():
    if torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA devices"):
            DR.dryrun_multichip(torch.cuda.device_count() + 1)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            DR.dryrun_multichip(1)
