"""The port's stage pipeline (``noize_tpu_torch.pipeline``, with the
buffer store) against ``noize_tpu.pipeline`` on the same requests.

The Quickstart pipeline (README.md: Simplex fBm 13 octaves, Gauss-5 ×17,
flow map ×8, write to the context buffer) at 128².  Tolerances:
  * bit-exact against JAX evaluated one primitive at a time
    (``jax.disable_jit()``), as the noise, blur and flow tests are;
  * against the compiled JAX pipeline, 1e-4 relative to the map's scale
    (BASELINE.md's bar): XLA's CPU backend contracts multiply-adds into
    FMAs in the noise and blur (ROADMAP.md §3).
Mesh stages: positions, tangents and uvs bit-exact against eager JAX on
the same heights; normals to 1e-6 (the port normalises with a
left-associated square sum, ROADMAP.md §3).
Here, on the CPU, every kernel wrapper runs its plain version.
"""

import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.core.stageio import GeneratorData as JGD
from noize_tpu.core.stageio import MeshStageData as JMSD
from noize_tpu.core.store import PipelineStateManager as JStore
from noize_tpu.pipeline import driver as JD
from noize_tpu.pipeline import stages as JS
from noize_tpu_torch.core.stageio import GeneratorData, MeshStageData
from noize_tpu_torch.core.store import PipelineStateManager
from noize_tpu_torch.pipeline import driver as TD
from noize_tpu_torch.pipeline import stages as TS
from noize_tpu_torch.pipeline.stage import RequirementError

RES = 128


def _quickstart(S):
    return [
        S.NoiseStage(noiseType="Simplex", hurst=0.4, octaves=13, noiseSize=1700),
        S.StageGaussianBlur(sigma="s1d00", width=5, iterations=17),
        S.FlowMapStage(iterations=8),
        S.WriteGeneratorContextStage(contextAlias="TERRAIN_HEIGHT"),
    ]


@pytest.fixture(scope="module")
def quickstart():
    req = dict(uuid="t00", resolution=RES, xpos=64, zpos=-32)
    jsm = JStore()
    with jax.disable_jit():
        eager = np.asarray(JD.Pipeline(_quickstart(JS), state_manager=jsm)
                           .run(JGD(**req)).data)
    jitted = np.asarray(JD.Pipeline(_quickstart(JS), state_manager=JStore())
                        .run(JGD(**req)).data)
    sm = PipelineStateManager(device="cpu")
    out = TD.Pipeline(_quickstart(TS), state_manager=sm, device="cpu").run(GeneratorData(**req))
    return req, sm, out, eager, jitted, jsm


def test_quickstart_matches_reference(quickstart):
    _, _, out, eager, jitted, _ = quickstart
    got = out.data.numpy()
    assert got.shape == (RES, RES) and got.dtype == np.float32
    np.testing.assert_array_equal(got, eager)
    gap = np.abs(got.astype(np.float64) - jitted).max()
    assert gap <= 1e-4 * np.abs(jitted).max(), gap
    assert np.abs(got - 0.5).max() > 1e-3  # the flow map is not flat


def test_context_buffer_written_and_read(quickstart):
    req, sm, out, _, _, jsm = quickstart
    name = f"{req['xpos']}_{req['zpos']}__{RES}__TERRAIN_HEIGHT"
    assert sm.names() == jsm.names() == [name]
    assert sm.get_buffer(name) is out.data
    assert not sm.is_locked(name)  # the write stage released its lock
    back = TD.Pipeline([TS.ReadGeneratorContextStage("TERRAIN_HEIGHT")], state_manager=sm,
                       device="cpu").run(GeneratorData(**req))
    assert back.data is out.data


def test_locks_and_dependency_hell():
    """Async executor: a read of a missing buffer parks in dependency hell
    and completes once the buffer appears; a write to a locked buffer waits
    for the unlock."""
    sm = PipelineStateManager(device="cpu")
    pipe = TD.Pipeline([TS.ReadGeneratorContextStage("CTX")], state_manager=sm,
                       device="cpu").start()
    writer = TD.Pipeline([TS.WriteGeneratorContextStage("LOCKED")], state_manager=sm,
                         device="cpu").start()
    done = {}
    events = {k: threading.Event() for k in ("read", "write")}

    def finish(key):
        def cb(payload):
            done[key] = payload
            events[key].set()
        return cb

    try:
        req = GeneratorData(uuid="r", resolution=8, xpos=1, zpos=2)
        pipe.enqueue(req, on_complete=finish("read"))
        token = object()
        assert sm.try_set_lock("1_2__8__LOCKED", token)
        writer.enqueue(req.with_(data=torch.ones(8, 8)), on_complete=finish("write"))
        assert not events["read"].wait(0.3) and not events["write"].wait(0.1)
        assert len(pipe.dependency_hell) == 1 and len(writer.dependency_hell) == 1
        assert not sm.try_set_lock("1_2__8__LOCKED", object())
        sm.set_buffer("1_2__8__CTX", torch.full((8, 8), 3.0))
        sm.unlock("1_2__8__LOCKED", token)
        assert events["read"].wait(10) and events["write"].wait(10)
    finally:
        pipe.stop()
        writer.stop()
    assert float(done["read"].data[0, 0]) == 3.0
    assert torch.equal(sm.get_buffer("1_2__8__LOCKED"), torch.ones(8, 8))
    assert pipe.drain(1.0) and writer.drain(1.0) and not pipe._thread.is_alive()


def test_requirement_error_on_wrong_payload():
    mesh_req = MeshStageData(uuid="m", resolution=8, inputResolution=12)
    with pytest.raises(RequirementError, match="NoiseStage requires GeneratorData"):
        TD.Pipeline([TS.NoiseStage(noiseType="Simplex")], device="cpu").run(mesh_req)
    with pytest.raises(RequirementError, match="MeshTileStage requires MeshStageData"):
        TD.Pipeline([TS.MeshTileStage()], device="cpu").run(GeneratorData(resolution=8))
    with pytest.raises(ValueError, match="noiseType"):
        TS.NoiseStage(noiseType="Bogus")


def test_cuda_pipeline_and_store_refuse_without_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the refusal path cannot be exercised")
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.Pipeline([])
    with pytest.raises(RuntimeError, match="CUDA"):
        PipelineStateManager()


@pytest.mark.parametrize("jstage,tstage", [
    (JS.StageSmoothBlur(width=5, iterations=3), TS.StageSmoothBlur(width=5, iterations=3)),
    (JS.StageGaussianBlurFused("s2d00", 9, 2), TS.StageGaussianBlurFused("s2d00", 9, 2)),
    (JS.StageThermalErosion(iterations=2, talus=30), TS.StageThermalErosion(iterations=2,
                                                                            talus=30)),
    (JS.FlowMapStage(iterations=3, normMin=-0.2, normMax=0.3),
     TS.FlowMapStage(iterations=3, normMin=-0.2, normMax=0.3)),
], ids=["smooth", "gauss_fused", "thermal", "flow"])
def test_filter_stages_bit_exact(jstage, tstage):
    a = np.random.default_rng(3).uniform(0, 1, (48, 48)).astype(np.float32)
    with jax.disable_jit():
        want = np.asarray(JD.Pipeline([jstage]).run(JGD(resolution=48, data=jnp.asarray(a))).data)
    got = TD.Pipeline([tstage], device="cpu").run(GeneratorData(resolution=48,
                                                                data=torch.from_numpy(a)))
    np.testing.assert_array_equal(got.data.numpy(), want)
    assert not np.array_equal(want, a)


@pytest.mark.parametrize("overshoot", [False, True])
def test_mesh_stages_match_reference(overshoot):
    h = np.random.default_rng(4).uniform(0, 1, (40, 40)).astype(np.float32)
    req = dict(uuid="m", resolution=32, inputResolution=40, marginPix=4, tileHeight=1000,
               tileSize=32.0, xpos=0, zpos=0)
    jsm = JStore()
    jsm.set_buffer("0_0__40__TERRAIN_HEIGHT", jnp.asarray(h))
    sm = PipelineStateManager(device="cpu")
    sm.set_buffer("0_0__40__TERRAIN_HEIGHT", torch.from_numpy(h))
    with jax.disable_jit():
        jm = JD.Pipeline([JS.MeshTileReferenceDataStage(overshoot=overshoot), JS.MeshBakeStage()],
                         state_manager=jsm).run(JMSD(**req)).mesh
        jt = JD.Pipeline([JS.MeshTileStage(overshoot=overshoot)]).run(
            JMSD(**req, data=jnp.asarray(h))).mesh
    tm = TD.Pipeline([TS.MeshTileReferenceDataStage(overshoot=overshoot), TS.MeshBakeStage()],
                     state_manager=sm, device="cpu").run(MeshStageData(**req)).mesh
    tt = TD.Pipeline([TS.MeshTileStage(overshoot=overshoot)], device="cpu").run(
        MeshStageData(**req, data=torch.from_numpy(h))).mesh
    for got, want in ((tm, jm), (tt, jt)):
        for f in ("positions", "tangents", "uvs"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
        np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(got.indices.numpy().astype(np.int64),
                                      np.asarray(want.indices).astype(np.int64))
