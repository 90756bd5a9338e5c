"""The port's spans (``noize_tpu_torch.utils.tracking``): when they are
recorded, how they nest, the threads and the server's orders they follow,
the store's bound, the erosion cycle's phases and host syncs, the clock
they share with ``torch.profiler``'s events, the Chrome trace they join,
and that recording them changes nothing the device or the profiler sees.

CPU tests, but for one at the end that needs a CUDA card and skips without
one; run it on the card with:

    python -m pytest --noconftest tests/test_torch_tracing.py -q -s -k card
"""

import json
import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from noize_tpu_torch.app import flagship as TF
from noize_tpu_torch.app import server as TSV
from noize_tpu_torch.core.tiles import TileSetMeta
from noize_tpu_torch.erosion import sim as TS
from noize_tpu_torch.erosion.params import ErosionSettings
from noize_tpu_torch.erosion.particles import spawn
from noize_tpu_torch.parallel import tiled as TT
from noize_tpu_torch.prng import PRNGKey
from noize_tpu_torch.utils import tracking as TR

PHASES = ("erosion.thermal", "erosion.spawn", "erosion.descent", "erosion.deposit",
          "erosion.flow", "erosion.pool")
SETTINGS = ErosionSettings(CYCLES=2, PARTICLES_PER_CYCLE=128, MAXAGE=24, WATER_STEPS=3,
                           PILING_RADIUS=6)
RES = 64


@pytest.fixture(autouse=True)
def fresh_store():
    TR.disable()
    TR.clear()
    yield
    TR.disable()
    TR.clear()


def _terrain(seed=8, res=RES):
    rng = np.random.default_rng(seed)
    h = torch.from_numpy(rng.uniform(0, 1, (res, res)).astype(np.float32))
    for _ in range(4):  # a smooth field, so particles run downhill for a while
        h = torch.nn.functional.avg_pool2d(h[None, None], 5, 1, 2, count_include_pad=False)[0, 0]
    return h.contiguous()


def _names(spans):
    return [s.name for s in spans]


# --- when spans are recorded ------------------------------------------------

def test_the_profiler_flag_spans_read():
    """``span`` reads torch's process-wide ``_is_profiler_enabled``: a torch
    that moves or renames it fails here."""
    flag = torch.autograd.profiler
    assert flag._is_profiler_enabled is False
    with profile(activities=[ProfilerActivity.CPU]):
        assert flag._is_profiler_enabled is True
        seen = []
        t = threading.Thread(target=lambda: seen.append(flag._is_profiler_enabled))
        t.start()
        t.join(10)
        assert not t.is_alive() and seen == [True]
    assert flag._is_profiler_enabled is False


def test_off_records_nothing_reads_no_clock_and_shares_one_context(monkeypatch):
    def no_clock():
        raise AssertionError("an off span read the clock")

    monkeypatch.setattr(TR.time, "time_ns", no_clock)
    a, b = TR.span("a"), TR.span("b", order="x")
    assert a is b  # one shared context: nothing made a span
    with a, b:
        pass
    assert TR.open_span("q", order="x") is None
    TR.close_span(None, batch=1)
    monkeypatch.undo()
    assert TR.spans() == [] and TR.dropped() == 0


def test_a_span_entered_before_the_profiler_starts_is_not_recorded():
    with TR.span("before"):
        with profile(activities=[ProfilerActivity.CPU]):
            with TR.span("inside"):
                pass
    assert _names(TR.spans()) == ["inside"]


def test_on_under_enable_and_under_a_running_profiler_and_off_after():
    TR.enable()
    with TR.span("enabled"):
        pass
    TR.disable()
    with TR.span("disabled"):
        pass
    with profile(activities=[ProfilerActivity.CPU]):
        with TR.span("profiled"):
            pass
    with TR.span("after"):
        pass
    assert _names(TR.spans()) == ["enabled", "profiled"]
    s = TR.spans()[0]
    assert s.start_ns <= s.end_ns and s.thread == threading.get_native_id()
    assert s.attrs is None and s.is_async is False


def test_parent_ids_nest():
    TR.enable()
    with TR.span("outer"):
        with TR.span("mid", batch=3):
            with TR.span("inner"):
                pass
        with TR.span("second"):
            pass
    with TR.span("top"):
        pass
    got = {s.name: s for s in TR.spans()}
    assert got["outer"].parent is None and got["top"].parent is None
    assert got["mid"].parent == got["outer"].id
    assert got["inner"].parent == got["mid"].id
    assert got["second"].parent == got["outer"].id
    assert got["mid"].attrs == {"batch": 3}
    assert len({s.id for s in got.values()}) == 5
    assert got["outer"].start_ns <= got["mid"].start_ns <= got["inner"].start_ns
    assert got["inner"].end_ns <= got["mid"].end_ns <= got["second"].start_ns
    assert got["second"].end_ns <= got["outer"].end_ns


def test_a_worker_threads_spans_are_recorded_with_its_thread_id():
    TR.enable()
    tids = []

    def work():
        tids.append(threading.get_native_id())
        with TR.span("worker.outer"):
            with TR.span("worker.inner"):
                pass

    with TR.span("main"):
        t = threading.Thread(target=work)
        t.start()
        t.join(10)
    assert not t.is_alive()
    got = {s.name: s for s in TR.spans()}
    assert got["worker.outer"].thread == got["worker.inner"].thread == tids[0]
    assert got["main"].thread == threading.get_native_id() != tids[0]
    # a thread's stack is its own: the worker's top span has no parent
    assert got["worker.outer"].parent is None
    assert got["worker.inner"].parent == got["worker.outer"].id


def test_an_async_span_ends_on_another_thread():
    TR.enable()
    token = TR.open_span("serve.queue", order="o1")
    t = threading.Thread(target=TR.close_span, args=(token,), kwargs={"batch": 7})
    t.start()
    t.join(10)
    assert not t.is_alive()
    (s,) = TR.spans()
    assert s.is_async and s.parent is None and s.thread == threading.get_native_id()
    assert s.attrs == {"order": "o1", "batch": 7} and s.start_ns <= s.end_ns


def test_the_store_is_bounded_and_counts_what_it_drops(monkeypatch):
    monkeypatch.setattr(TR, "SPAN_CAPACITY", 5)
    TR.enable()
    for i in range(8):
        with TR.span(f"s{i}"):
            pass
    TR.close_span(TR.open_span("late"))
    assert _names(TR.spans()) == [f"s{i}" for i in range(5)]
    assert TR.dropped() == 4
    TR.clear()
    assert TR.spans() == [] and TR.dropped() == 0


# --- span sites ---------------------------------------------------------------

def test_a_sim_step_records_each_phase_once_a_cycle_and_a_span_a_sync():
    sim = TS.ErosionSim(_terrain(), settings=SETTINGS, seed=3, device="cpu")
    TR.enable()
    sim.step()
    got = TR.spans()
    by_id = {s.id: s for s in got}
    (step,) = [s for s in got if s.name == "sim.step"]
    cycles = [s for s in got if s.name == "erosion.cycle"]
    assert len(cycles) == SETTINGS.CYCLES
    assert all(c.parent == step.id for c in cycles)
    for c in cycles:
        phases = [s.name for s in got if s.parent == c.id]
        assert phases == list(PHASES)
    syncs = [s for s in got if s.name.startswith("sync.")]
    assert [s.name for s in sorted(syncs, key=lambda s: s.start_ns)] == \
        ["sync." + x for x in sim.syncs]
    owner = {"sync.spawn.drains": "erosion.spawn", "sync.descent.alive": "erosion.descent",
             "sync.sediment.piles": "erosion.deposit"}
    for s in syncs:
        assert by_id[s.parent].name == owner[s.name]
    assert {"spawn.drains", "descent.alive", "sediment.piles"} <= set(sim.syncs)


def test_the_flagship_step_records_its_stages():
    meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=1000,
                       margin=4).validate()
    step, _, _ = TF.make_tile_step(meta, ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4,
                                                         WATER_STEPS=1),
                                   device="cpu", octaves=3, blur_iterations=2,
                                   flow_iterations=2, erosion_cycles=2)
    TR.enable()
    step(5.0, 7.0, PRNGKey(1, device="cpu"))
    got = TR.spans()
    (top,) = [s for s in got if s.name == "step"]
    children = [s.name for s in sorted(got, key=lambda s: s.start_ns) if s.parent == top.id]
    assert children == ["field.fractal", "field.blur", "field.flow", "erosion.cycle",
                        "erosion.cycle", "mesh"]


def test_a_tile_batch_records_its_stages_and_each_tiles_erosion():
    meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=1000,
                       margin=4).validate()
    cfg = TT.TilePipelineConfig(meta=meta, octaves=2, noise_size=64.0, blur_iterations=1,
                                erosion=ErosionSettings(PARTICLES_PER_CYCLE=16, MAXAGE=4,
                                                        WATER_STEPS=1),
                                erosion_cycles=1, emit_mesh=True)
    TR.enable()
    TT.tile_batch(cfg, TT.grid_origins(meta, 3, 1), seed=2, device="cpu")
    got = TR.spans()
    (top,) = [s for s in got if s.name == "tile_batch"]
    children = [s.name for s in sorted(got, key=lambda s: s.start_ns) if s.parent == top.id]
    assert children == ["field.fractal", "field.blur"] + ["tile.erode"] * 3 + ["mesh"]
    for t in (s for s in got if s.name == "tile.erode"):
        assert [s.name for s in got if s.parent == t.id] == ["erosion.cycle"]


def test_the_server_records_each_orders_wait_with_its_batch():
    meta = TileSetMeta(tile_res=24, tile_size=24, generator_res=32, height=1000,
                       margin=4).validate()
    cfg = TT.TilePipelineConfig(meta=meta, octaves=2, noise_size=64.0, blur_iterations=1)
    srv = TSV.TileServer(cfg, batch_size=2, max_wait_ms=50.0, seed=1, device="cpu")
    served = {}
    TR.enable()
    try:
        srv.start()
        t_submit = {}
        for i in range(5):
            t_submit[f"o{i}"] = time.time_ns()
            srv.submit(f"o{i}", (i, 0), on_complete=lambda st: served.update(
                {st.request.uuid: st.batch_id}))
        assert srv.drain(timeout=120)
    finally:
        srv.stop()
    got = TR.spans()
    queued = {s.attrs["order"]: s for s in got if s.name == "serve.queue"}
    batches = {s.attrs["batch"]: s for s in got if s.name == "serve.batch"}
    assert set(queued) == set(served) == set(t_submit)
    worker = {s.thread for s in got if s.name == "serve.batch"}
    assert len(worker) == 1 and threading.get_native_id() not in worker
    for order, q in queued.items():
        assert q.is_async and q.thread == threading.get_native_id()
        assert q.attrs["batch"] == served[order]
        assert q.start_ns >= t_submit[order]
        assert q.end_ns <= batches[q.attrs["batch"]].start_ns
    assert set(batches) == set(served.values()) and len(batches) == srv.batches
    deliver = {s.attrs["batch"] for s in got if s.name == "serve.deliver"}
    assert deliver == set(batches)
    assert any(s.name == "serve.collect" for s in got)
    for b in batches.values():
        assert [s.name for s in got if s.parent == b.id] == ["tile_batch"]


# --- the profiler's clock and events -------------------------------------------

def _cpu_events(prof):
    return [e for e in prof.profiler.kineto_results.events()
            if e.device_type() == torch.autograd.DeviceType.CPU]


def test_a_span_holds_the_profiler_event_of_its_op():
    x = torch.ones(1 << 16)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with TR.span("add"):
            x.add(1.0)
    (s,) = TR.spans()
    (ev,) = [e for e in _cpu_events(prof) if e.name() == "aten::add"]
    assert s.start_ns <= ev.start_ns() <= ev.end_ns() <= s.end_ns


def _cycle_ops(state, fresh):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        TS.erosion_cycle(state, SETTINGS, TileSetMeta(tile_res=RES, tile_size=RES,
                                                      generator_res=RES, height=1000,
                                                      margin=0), fresh=fresh)
    return [e.name() for e in _cpu_events(prof)]


def test_recording_spans_adds_no_operator_and_no_profiler_event(monkeypatch):
    state = TS.init_state(_terrain(), PRNGKey(4, device="cpu"))
    fresh = spawn(PRNGKey(9, device="cpu"), SETTINGS.PARTICLES_PER_CYCLE, RES)
    on = _cycle_ops(state, fresh)
    assert "erosion.cycle" in _names(TR.spans())
    TR.clear()
    # spans off under the same profiler: the flag they read says no profiler
    monkeypatch.setattr(TR, "_profiler", types.SimpleNamespace(_is_profiler_enabled=False))
    off = _cycle_ops(state, fresh)
    assert TR.spans() == []
    assert on == off and len(on) > 100
    assert not [n for n in on if n.startswith(("erosion.", "sync.", "sim."))]


def test_device_trace_writes_the_spans_around_their_operators(tmp_path):
    x = torch.ones(1 << 16)
    with TR.device_trace(str(tmp_path)):
        with TR.span("outer", batch=2):
            x.add(1.0)
            with TR.span("inner"):
                x.mul(2.0)
        TR.close_span(TR.open_span("queued", order="o"))
    trace = json.loads((tmp_path / "trace.json").read_text())
    ev = trace["traceEvents"]
    ops = {e["name"]: e for e in ev if e.get("cat") == "cpu_op"}
    mine = {e["name"]: e for e in ev if e.get("cat") == "span" and e["ph"] == "X"}
    assert set(mine) == {"outer", "inner"}
    assert {e["pid"] for e in mine.values()} == {TR.SPAN_TRACKS_PID}
    assert mine["outer"]["args"]["batch"] == 2
    assert mine["inner"]["args"]["parent"] == mine["outer"]["args"]["span_id"]

    def holds(span, op):
        return span["ts"] <= op["ts"] and op["ts"] + op["dur"] <= span["ts"] + span["dur"]

    assert holds(mine["outer"], ops["aten::add"]) and holds(mine["outer"], ops["aten::mul"])
    assert holds(mine["inner"], ops["aten::mul"]) and not holds(mine["inner"], ops["aten::add"])
    q = [e for e in ev if e.get("cat") == "span" and e["name"] == "queued"]
    assert sorted(e["ph"] for e in q) == ["b", "e"] and q[0]["args"]["order"] == "o"
    names = {e["args"]["name"] for e in ev if e["ph"] == "M" and e["pid"] == TR.SPAN_TRACKS_PID}
    assert f"spans of thread {threading.get_native_id()}" in names


# --- on the card ----------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_card_spans_and_device_events_share_the_profilers_clock(cuda):
    """A span around one kernel's launch holds the launch's
    ``cudaLaunchKernel`` event; a span closed by ``torch.cuda.synchronize()``
    ends after the kernel's device end.  Prints the offsets (µs)."""
    x = torch.ones(1 << 24, device=cuda)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        x.mul_(1.0)  # the context, the kernel's module and the profiler's first start
        torch.cuda.synchronize()
    TR.clear()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        with TR.span("launch"):
            x.mul_(1.0001)
        with TR.span("until_sync"):
            torch.cuda.synchronize()
    got = {s.name: s for s in TR.spans()}
    events = list(prof.profiler.kineto_results.events())
    (launch,) = [e for e in events if e.name() == "cudaLaunchKernel"
                 and e.device_type() == torch.autograd.DeviceType.CPU]
    (kernel,) = [e for e in events if e.device_type() == torch.autograd.DeviceType.CUDA]
    (op,) = [e for e in events if e.name() == "aten::mul_"]
    s, w = got["launch"], got["until_sync"]
    print(f"\nspan start -> aten::mul_ start {(op.start_ns() - s.start_ns) / 1e3:.3f} µs, "
          f"span start -> cudaLaunchKernel start {(launch.start_ns() - s.start_ns) / 1e3:.3f} µs, "
          f"cudaLaunchKernel end -> span end {(s.end_ns - launch.end_ns()) / 1e3:.3f} µs, "
          f"kernel device end -> synchronised span end {(w.end_ns - kernel.end_ns()) / 1e3:.3f} µs, "
          f"kernel {kernel.name()} {(kernel.end_ns() - kernel.start_ns()) / 1e3:.3f} µs")
    assert s.start_ns <= op.start_ns() <= launch.start_ns() <= launch.end_ns() <= s.end_ns
    assert kernel.start_ns() >= s.start_ns
    assert kernel.end_ns() <= w.end_ns
