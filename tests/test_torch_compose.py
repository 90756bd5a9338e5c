"""The port's five filter stages, ``pipeline/compose`` and the BasicDemo
presets (``app/presets``) against ``noize_tpu``, on the CPU (every kernel
wrapper runs its plain version here).

Tolerances: the stages bit-exact against JAX evaluated one primitive at a
time (``jax.disable_jit()``); ``fuse`` equal to ``run_stages`` and to the
port's ``Pipeline.run``.  The generator presets are bit-exact against the
reference's ``Pipeline(list(pd.stages)).run(...)`` under
``jax.disable_jit()``; against its compiled stages (XLA contracts
multiply-adds into FMAs; ROADMAP.md §3) PerlinGenerator and Sobel are
within 1e-4 relative to the output's scale.  FlowMap is held to 5e-3 of
its scale there: its FlowMapStage normalises velocities by normMax = 0.005
(×200), which amplifies the noise's ulp drift, and the compiled reference
departs from its own eager run by as much (measured at 96²: 1.01e-4
absolute on outputs of scale 0.04).  The Mesh preset's positions,
tangents and uvs are bit-exact on the same heights, normals to 1e-6.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.app import presets as JP
from noize_tpu.core.stageio import DownsampleData as JDD
from noize_tpu.core.stageio import GeneratorData as JGD
from noize_tpu.core.stageio import MeshStageData as JMSD
from noize_tpu.pipeline import compose as JC
from noize_tpu.pipeline import driver as JD
from noize_tpu.pipeline import stages as JS
from noize_tpu.pipeline.stage import PipelineWorkItem as JWI
from noize_tpu_torch.app import presets as TP
from noize_tpu_torch.core.stageio import DownsampleData, GeneratorData, MeshStageData
from noize_tpu_torch.pipeline import compose as TC
from noize_tpu_torch.pipeline import driver as TD
from noize_tpu_torch.pipeline import stages as TS
from noize_tpu_torch.pipeline.stage import PipelineWorkItem, RequirementError


def _map(seed, res=48):
    return np.random.default_rng(seed).uniform(0, 1, (res, res)).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape and np.isfinite(got).all()
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-30)


def _run_one(S, stage, data, res):
    return D(S).Pipeline([stage], **({} if S is JS else {"device": "cpu"})).run(
        (JGD if S is JS else GeneratorData)(uuid="u", resolution=res, data=data))


def D(S):
    return JD if S is JS else TD


STAGES = [
    ("KernelFilterStage", dict(filter="Sobel3_2D", iterations=2)),
    ("KernelFilterStage", dict(filter="Prewitt3Vertical", iterations=3)),
    ("KernelFilterStage", dict()),
    ("ConstantStage", dict(operation="MULTIPLY", value=0.3)),
    ("ConstantStage", dict(operation="BINARIZE", value=0.5)),
    ("CurveStage", "from_function"),
    ("CurveStage", "from_keyframes"),
]


def _make(S, name, kw):
    cls = getattr(S, name)
    if kw == "from_function":
        return cls.from_function(lambda v: 1.0 - v * v, samples=128)
    if kw == "from_keyframes":
        keys = JP.CURVE_BOOST_CONTRAST_KEYS if S is JS else TP.CURVE_BOOST_CONTRAST_KEYS
        return cls.from_keyframes(keys)
    return cls(**kw)


@pytest.mark.parametrize("name,kw", STAGES)
def test_array_stage_matches_reference(name, kw):
    a = _map(1)
    got = _run_one(TS, _make(TS, name, kw), torch.from_numpy(a), 48).data
    with jax.disable_jit():
        want = _run_one(JS, _make(JS, name, kw), jnp.asarray(a), 48).data
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert _make(TS, name, kw).fusable


@pytest.mark.parametrize("op", ["SUBTRACT", "MULTIPLY", "ROOTSUMSQUARES", "MAX", "MIN"])
def test_reduce_pipeline_and_stage(op):
    left = [TS.NoiseStage(noiseType="Perlin", octaves=2, noiseSize=40)]
    right = [TS.NoiseStage(noiseType="Cellular", octaves=2, noiseSize=30),
             TS.ConstantStage(value=0.7)]
    jleft = [JS.NoiseStage(noiseType="Perlin", octaves=2, noiseSize=40)]
    jright = [JS.NoiseStage(noiseType="Cellular", octaves=2, noiseSize=30),
              JS.ConstantStage(value=0.7)]
    seen = []
    rp = TC.ReducePipeline(left, right, TS.ReduceStage(op), post=[TS.ConstantStage(value=2.0)])
    got = rp.run(PipelineWorkItem(data=GeneratorData(uuid="r", resolution=40, xpos=3, zpos=9),
                                  on_complete=seen.append, device="cpu")).data
    with jax.disable_jit():
        want = JC.ReducePipeline(jleft, jright, JS.ReduceStage(op),
                                 post=[JS.ConstantStage(value=2.0)]).run(
            JWI(data=JGD(uuid="r", resolution=40, xpos=3, zpos=9))).data
    assert isinstance(got, GeneratorData) and got.xpos == 3 and seen == [got]
    np.testing.assert_array_equal(got.data.numpy(), np.asarray(want.data))
    assert not TS.ReduceStage(op).fusable
    with pytest.raises(RequirementError):
        TD.Pipeline([TS.ReduceStage(op)], device="cpu").run(GeneratorData(resolution=4))


@pytest.mark.parametrize("offset", [0, 4])
def test_crop_stage(offset):
    a = _map(2, 40)
    got = TD.Pipeline([TS.CropStage(offset)], device="cpu").run(
        DownsampleData(uuid="c", resolution=32, inputResolution=40,
                       inputData=torch.from_numpy(a))).data
    want = JD.Pipeline([JS.CropStage(offset)]).run(
        JDD(uuid="c", resolution=32, inputResolution=40, inputData=jnp.asarray(a))).data
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not TS.CropStage().fusable


def test_stage_mask_and_definition():
    pd = TP.PERLIN_GENERATOR
    masked = pd.masked(TC.StageMask(disabled=(1, 3)))
    assert masked.name == pd.name and masked.stages == (pd.stages[0], pd.stages[2])
    assert TC.StageMask().enabled_stages(pd.stages) == list(pd.stages)
    jmasked = JP.PERLIN_GENERATOR.masked(JC.StageMask(disabled=(1, 3)))
    assert [type(s).__name__ for s in masked.stages] == \
        [type(s).__name__ for s in jmasked.stages]


def test_run_stages_callbacks_in_order():
    events = []

    class Probe(TS.ConstantStage):
        def on_complete(self, work):
            events.append(("complete", self.value))

    stages = [Probe(value=0.5), Probe(value=2.0)]
    work = PipelineWorkItem(data=GeneratorData(uuid="p", resolution=8,
                                               data=torch.ones(8, 8)),
                            on_scheduled=lambda d: events.append(("scheduled", float(d.data[0, 0]))),
                            on_complete=lambda d: events.append(("done", float(d.data[0, 0]))),
                            device="cpu")
    out = TC.run_stages(stages, work)
    assert float(out.data.data[0, 0]) == 1.0
    assert events == [("scheduled", 0.5), ("scheduled", 1.0), ("complete", 0.5),
                      ("complete", 2.0), ("done", 1.0)]


@pytest.mark.parametrize("name", ["PerlinGenerator", "FlowMap", "Sobel"])
def test_fuse_equals_run_stages(name):
    stages = TP.ALL[name].stages
    res = 48
    data = None if name != "Sobel" else torch.from_numpy(_map(3, res))
    fn = TC.fuse(stages, res, device="cpu")
    fused = fn(data, 16, -8)
    work = TC.run_stages(stages, PipelineWorkItem(
        data=GeneratorData(uuid="f", resolution=res, xpos=16, zpos=-8, data=data), device="cpu"))
    piped = TD.Pipeline(list(stages), device="cpu").run(
        GeneratorData(uuid="f", resolution=res, xpos=16, zpos=-8, data=data))
    assert fused.device.type == "cpu"
    np.testing.assert_array_equal(fused.numpy(), work.data.data.numpy())
    np.testing.assert_array_equal(fused.numpy(), piped.data.numpy())


def test_fuse_rejects_context_stages_and_needs_a_device():
    with pytest.raises(ValueError, match="not fusable"):
        TC.fuse([TS.NoiseStage(), TS.WriteGeneratorContextStage("X")], 16, device="cpu")
    with pytest.raises(ValueError, match="not fusable"):
        TC.fuse([TS.MeshTileStage()], 16, device="cpu")
    if not torch.cuda.is_available():  # data None and the default device: the card
        with pytest.raises(RuntimeError, match="CUDA"):
            TC.fuse([TS.NoiseStage()], 16)(None, 0, 0)
    # with data, the noise lands on the data's device whatever the default
    out = TC.fuse([TS.NoiseStage()], 16)(torch.zeros(16, 16), 0, 0)
    assert out.device.type == "cpu"


@pytest.fixture(scope="module")
def preset_runs():
    """Each generator preset through both packages' ``Pipeline.run``: the
    port's, the reference's compiled and eager."""
    out = {}
    for name, res in (("PerlinGenerator", 128), ("FlowMap", 96), ("Sobel", 64)):
        data = _map(4, res) if name == "Sobel" else None
        req = dict(uuid=name, resolution=res, xpos=256, zpos=-128)

        def jrun():
            return np.asarray(JD.Pipeline(list(JP.ALL[name].stages)).run(
                JGD(**req, data=None if data is None else jnp.asarray(data))).data)
        with jax.disable_jit():
            eager = jrun()
        got = TD.Pipeline(list(TP.ALL[name].stages), device="cpu").run(
            GeneratorData(**req, data=None if data is None else torch.from_numpy(data))).data
        out[name] = (got.numpy(), jrun(), eager)
    return out


@pytest.mark.parametrize("name,rtol", [("PerlinGenerator", 1e-4), ("FlowMap", 5e-3),
                                       ("Sobel", 1e-4)])
def test_generator_preset_matches_reference(preset_runs, name, rtol):
    got, compiled, eager = preset_runs[name]
    np.testing.assert_array_equal(got, eager)
    assert _rel(got, compiled) <= rtol
    assert np.ptp(got) > 0.03  # a map, not a constant


def test_mesh_preset_matches_reference():
    h = _map(5, 64)
    req = dict(uuid="m", resolution=60, inputResolution=64, marginPix=2, tileHeight=300,
               tileSize=60.0, xpos=0, zpos=0)
    got = TD.Pipeline(list(TP.ALL["Mesh"].stages), device="cpu").run(
        MeshStageData(**req, data=torch.from_numpy(h))).mesh
    with jax.disable_jit():
        want = JD.Pipeline(list(JP.ALL["Mesh"].stages)).run(
            JMSD(**req, data=jnp.asarray(h))).mesh
    for f in ("positions", "tangents", "uvs"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    np.testing.assert_allclose(got.normals.numpy(), np.asarray(want.normals), rtol=0, atol=1e-6)
    np.testing.assert_array_equal(got.indices.numpy().astype(np.int64),
                                  np.asarray(want.indices).astype(np.int64))


def test_presets_mirror_reference():
    assert list(TP.ALL) == list(JP.ALL)
    for name, pd in TP.ALL.items():
        jpd = JP.ALL[name]
        assert pd.name == jpd.name and len(pd.stages) == len(jpd.stages)
        for s, j in zip(pd.stages, jpd.stages):
            assert type(s).__name__ == type(j).__name__
            assert {k: v for k, v in s.__dict__.items()} == \
                {k: v for k, v in j.__dict__.items()}
