"""The port's ``utils.tracking``, ``utils.stats``, ``utils.helpers`` and the
continuous erosion mode (``ErosionSim.trigger``/``update``) against
``noize_tpu``'s, on the CPU.

Tolerance: the statistics within 1e-6 relative (float32 reductions in
another order); the state sequence of the continuous mode exactly; the
sims' maps after it within 1e-4 of each map's scale (BASELINE.md's bar, as
tests/test_torch_sim.py holds ``ErosionSim``).
"""

import dataclasses
import json
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.erosion import sim as JS
from noize_tpu.erosion.params import ErosionSettings
from noize_tpu.utils import helpers as JH
from noize_tpu.utils import stats as JST
from noize_tpu_torch import convert
from noize_tpu_torch.erosion import sim as TS
from noize_tpu_torch.ops import kernels as TK
from noize_tpu_torch.utils import helpers as TH
from noize_tpu_torch.utils import stats as TST
from noize_tpu_torch.utils import tracking as TR

RNG = np.random.default_rng(11)


@pytest.mark.parametrize("name", ["mean", "sum_square_difference", "compute_sxy",
                                  "mean_square_error", "predict_log", "fit_log"])
def test_stats_match_reference(name):
    xs = RNG.uniform(1.0, 50.0, 64).astype(np.float32)
    ys = (2.0 + 3.0 * np.log(xs) + RNG.normal(0, 0.1, 64)).astype(np.float32)
    args = {"mean": (xs,), "sum_square_difference": (xs,), "compute_sxy": (xs, ys),
            "mean_square_error": (xs, ys), "predict_log": (xs, 1.5, 0.25),
            "fit_log": (xs, ys)}[name]
    want = getattr(JST, name)(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                               for a in args))
    got = getattr(TST, name)(*(torch.from_numpy(a) if isinstance(a, np.ndarray) else a
                              for a in args))
    for g, w in zip(np.atleast_1d(got) if name != "fit_log" else got,
                    np.atleast_1d(want) if name != "fit_log" else want):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=1e-6)
    if name == "fit_log":
        assert abs(float(got[1]) - 3.0) < 0.1


def test_fill_and_copy_props_match_reference():
    a, b = torch.zeros(8), np.zeros(8, np.float32)
    assert TH.fill(a, 5, 2.5) is a
    JH.fill(b, 5, 2.5)
    np.testing.assert_array_equal(a.numpy(), b)

    @dataclasses.dataclass(frozen=True)
    class Cfg:
        x: int = 1
        y: float = 2.0

    class Bag:
        def __init__(self):
            self.x, self.z, self._hidden = 10, 3, 0

    assert TH.copy_props(Bag(), Cfg()) == JH.copy_props(Bag(), Cfg()) == Cfg(x=10, y=2.0)
    for mod in (TH, JH):
        with pytest.raises(AttributeError):
            mod.copy_props(Bag(), Cfg(), only_shared=False)
        dst = Bag()
        dst.x = 0
        src = Cfg(x=7)
        assert mod.copy_props(src, dst).x == 7 and dst.z == 3


def test_job_handler_on_cpu_tensors():
    h = TR.StandAloneJobHandler()
    assert not h.job_complete() and not h.is_running
    state = {"a": torch.ones(4), "b": [torch.zeros(2), (torch.arange(3),)]}
    assert h.track_job(state) and h.is_running
    assert len(list(TR._tensors(state))) == 3
    assert h.job_complete()  # CPU work is done once enqueued
    assert h.close_job() and not h.is_running
    assert not h.close_job()
    h.track_job(state)
    assert h.wait() is state and not h.is_running


def test_array_stats_and_stage_timer_log(caplog):
    a = torch.tensor([1.0, float("nan"), 3.0, float("inf")])
    with caplog.at_level(logging.WARNING, logger="noize_tpu_torch"):
        s = TR.array_stats("t", a)
    assert (s["min"], s["max"], s["mean"], s["nonfinite"], s["shape"]) == (1.0, 3.0, 2.0, 2,
                                                                           (4,))
    assert any("non-finite" in r.message for r in caplog.records)
    assert TR.array_stats("n", np.ones((2, 3)), warn_nonfinite=False)["shape"] == (2, 3)
    caplog.clear()
    with caplog.at_level(logging.INFO, logger="noize_tpu_torch"):
        out = torch.ones(3)
        with TR.stage_timer("stage", sync=True, result=out):
            out = out * 2
        with TR.stage_timer("other"):
            pass
    msgs = [r.message for r in caplog.records]
    assert any("stage scheduled in" in m and "completed in" in m for m in msgs)
    assert any(m.startswith("other scheduled in") for m in msgs)


def test_stage_cost_keys_and_counts():
    x = torch.ones((64, 64))
    c = TR.stage_cost(lambda a: TK.sobel2d(a), x)
    assert set(c) == {"flops", "bytes_accessed", "arithmetic_intensity"}
    assert c["flops"] > 64 * 64 and c["bytes_accessed"] > 4 * 64 * 64
    assert c["arithmetic_intensity"] == pytest.approx(c["flops"] / c["bytes_accessed"])
    # one elementwise add of two 8x8 maps: 64 elements, 3 x 256 bytes
    add = TR.stage_cost(torch.add, torch.ones((8, 8)), torch.ones((8, 8)))
    assert (add["flops"], add["bytes_accessed"]) == (64.0, 768.0)
    # a matmul counts flop_counter's 2·m·n·k
    mm = TR.stage_cost(torch.mm, torch.ones((4, 5)), torch.ones((5, 6)))
    assert mm["flops"] == 2 * 4 * 5 * 6


def test_device_trace_writes_a_trace(tmp_path):
    outdir = str(tmp_path / "trace")
    with TR.device_trace(outdir):
        TK.sobel2d(torch.ones((32, 32)))
    files = os.listdir(outdir)
    assert files == ["trace.json"]
    with open(os.path.join(outdir, "trace.json")) as fh:
        trace = json.load(fh)
    assert trace["traceEvents"]


# --- the continuous mode: trigger / update ----------------------------------

RES = 32
SETTINGS = ErosionSettings(CYCLES=2, PARTICLES_PER_CYCLE=32, MAXAGE=8, WATER_STEPS=2,
                           PILING_RADIUS=4)
#: (method, argument) calls of one session, the same for both packages
CALLS = [("update", True), ("update", True), ("trigger", None), ("update", True),
         ("update", True), ("trigger", None), ("trigger", None), ("update", False),
         ("update", False), ("update", True), ("running", None), ("update", True)]


def _session(sim, ready):
    """Each call's return value; ``ready`` waits for the sim's work before
    each call (the reference dispatches asynchronously), and "running"
    holds the job in flight for one ``update``."""
    out = []
    for method, arg in CALLS:
        ready(sim)
        if method == "running":
            job, real = sim._job, sim._job.job_complete
            job.job_complete = lambda: False
            out.append(sim.update())
            job.job_complete = real
        elif method == "trigger":
            out.append(sim.trigger())
        else:
            out.append(sim.update(continuous=arg))
    return out


def test_continuous_mode_states_match_reference():
    h = RNG.uniform(0, 1, (RES, RES)).astype(np.float32)
    jsim = JS.ErosionSim(jnp.asarray(h), settings=SETTINGS, seed=2)
    tsim = TS.ErosionSim(h, settings=convert.settings_from_jax(dataclasses.asdict(SETTINGS)),
                         seed=2, device="cpu")
    want = _session(jsim, lambda s: jax.block_until_ready(s.state))
    got = _session(tsim, lambda s: None)
    assert got == want
    assert want.count("triggered") >= 3 and "running" in want and "idle" in want
    assert tsim.cycle_count == jsim.cycle_count
    for m in ("height_map", "pool_map", "stream_map"):
        g, w = getattr(tsim, m).numpy().astype(np.float64), np.asarray(getattr(jsim, m),
                                                                        np.float64)
        assert np.abs(g - w).max() <= 1e-4 * max(np.abs(w).max(), 1e-30), m
    assert not tsim._job.is_running and tsim.syncs
