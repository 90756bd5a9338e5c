"""``h100bench/spans.py`` and the per-layer readers of the program's spans
(``h100bench/metrics/``) on a synthetic ``Trace`` and synthetic spans
whose gaps, lengths and nesting give known values, exactly."""

import numpy as np
import pytest

from h100bench import core, spans
from h100bench.trace import Trace
from noize_tpu_torch.utils import tracking as TR

MAIN, WORKER = 11, 22
PHASES = ("thermal", "spawn", "descent", "deposit", "flow", "pool")


def _span(name, a, b, sid, parent=None, attrs=None, thread=MAIN, is_async=False):
    """A program span from µs ``a`` to ``b``."""
    return TR.Span(name, int(a * 1000), int(b * 1000), thread, sid, parent, attrs, is_async)


def _trace(device, host=(("h", 0.0, 1000.0),)):
    return Trace(device_ops=sorted(device, key=lambda r: r[1]), host_ops=list(host),
                 window_s=1e-3)


#: busy 0-100, 150-300, 400-500, 700-800, 900-1000 µs: gaps of 50, 100,
#: 200 and 100 µs, their middles at 125, 350, 600 and 850
DEVICE = [("k", 0.0, 100.0), ("k", 150.0, 300.0), ("k", 400.0, 500.0), ("k", 700.0, 800.0),
          ("k", 900.0, 1000.0)]

#: two cycles in a step: the first gap's middle in thermal, the second in a
#: sync inside spawn, the third in descent, the fourth in pool; an async
#: span over them all, and two spans outside the window
CYCLES = [
    _span("sim.step", 0, 1000, 1),
    _span("erosion.cycle", 50, 450, 2, 1),
    _span("erosion.thermal", 60, 140, 3, 2),
    _span("erosion.spawn", 140, 380, 4, 2),
    _span("sync.spawn.drains", 320, 370, 5, 4),
    _span("erosion.cycle", 460, 880, 6, 1),
    _span("erosion.descent", 470, 650, 7, 6),
    _span("erosion.pool", 820, 870, 8, 6),
    _span("serve.queue", 100, 900, 9, attrs={"order": "o"}, is_async=True),
    _span("erosion.cycle", 1500, 1600, 10),
    _span("sync.spawn.drains", -10, 20, 11),
]


@pytest.fixture
def program(monkeypatch):
    """``program(spans)``: the program's store reads ``spans``."""
    def set_spans(recs):
        monkeypatch.setattr(TR, "spans", lambda: list(recs))
    return set_spans


def _read(name, tr):
    return core.metric_reader(name).read(tr)


def test_of_keeps_the_window_in_microseconds(program):
    program(CYCLES)
    got = spans.of(_trace(DEVICE))
    assert [s.id for s in got] == list(range(1, 10))
    assert got[1] == spans.Span("erosion.cycle", 50.0, 450.0, MAIN, 2, 1, None, False)


def test_of_drops_a_tree_whose_root_began_before_the_window(program):
    """A step that began before the first event takes its cycle and sync
    with it; a span whose parent was never recorded stands alone."""
    program([_span("sim.step", -5, 400, 1), _span("erosion.cycle", 10, 400, 2, 1),
             _span("sync.spawn.drains", 20, 30, 3, 2),
             _span("erosion.cycle", 450, 900, 4, 99), _span("sync.sediment.piles", 500, 510, 5, 4)])
    tr = _trace(DEVICE)
    assert [s.id for s in spans.of(tr)] == [4, 5]
    assert _read("erosion.syncs_per_cycle.step", tr) == 1.0


def test_gaps_go_to_the_innermost_span_and_never_to_an_async_one(program):
    program(CYCLES)
    tr = _trace(DEVICE)
    assert spans.idle_by_span(tr) == {"erosion.thermal": 50.0, "sync.spawn.drains": 100.0,
                                      "erosion.descent": 200.0, "erosion.pool": 100.0}
    program([s for s in CYCLES if s.name != "erosion.pool"])
    assert spans.idle_by_span(tr)["erosion.cycle"] == 100.0
    program([s for s in CYCLES if s.id in (9, 2)])
    assert spans.idle_by_span(tr) == {"erosion.cycle": 150.0, "no span": 300.0}


def test_the_erosion_readers(program):
    program(CYCLES)
    tr = _trace(DEVICE)
    assert _read("erosion.host_ms_per_cycle.step", tr) == pytest.approx(0.41, abs=1e-12)
    assert _read("erosion.sync_ms_per_cycle.step", tr) == pytest.approx(0.025, abs=1e-12)
    assert _read("erosion.syncs_per_cycle.step", tr) == 0.5
    want = {"thermal": 0.025, "spawn": 0.05, "descent": 0.1, "deposit": 0.0, "flow": 0.0,
            "pool": 0.05}
    for ph in PHASES:
        got = _read(f"erosion.{ph}.idle_ms_per_cycle.step", tr)
        assert got == pytest.approx(want[ph], abs=1e-12), ph


def test_the_graph_share_reader(program, monkeypatch):
    """The share of cycles that hold an ``erosion.graph`` span; a graph span
    outside a cycle counts for none; a program without the cycle's graphs
    gives None."""
    program([
        _span("sim.step", 0, 1000, 1),
        _span("erosion.cycle", 0, 300, 2, 1),
        _span("sync.spawn.drains", 0, 10, 3, 2),
        _span("erosion.graph", 10, 300, 4, 2),
        _span("erosion.cycle", 300, 600, 5, 1),
        _span("erosion.spawn", 310, 400, 6, 5),
        _span("erosion.cycle", 600, 900, 7, 1),
        _span("erosion.graph", 610, 890, 8, 7),
        _span("erosion.cycle", 900, 990, 9, 1),
        _span("erosion.graph", 995, 999, 10, 1),
    ])
    tr = _trace(DEVICE)
    assert _read("erosion.graph_share.step", tr) == 50.0
    import importlib.util

    find = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec", lambda name, *a: None if
                        name == "noize_tpu_torch.erosion.graphs" else find(name, *a))
    assert _read("erosion.graph_share.step", tr) is None


def test_the_field_and_mesh_readers(program):
    program([
        _span("step", 0, 520, 1),
        _span("field.fractal", 0, 130, 2, 1),      # gap 1 (50 µs)
        _span("field.blur", 130, 140, 3, 1),
        _span("erosion.cycle", 140, 500, 4, 1),    # gap 2 (100 µs)
        _span("step", 520, 1000, 5),
        _span("field.flow", 520, 620, 6, 5),       # gap 3 (200 µs)
        _span("mesh", 830, 1000, 7, 5),            # gap 4 (100 µs)
    ])
    tr = _trace(DEVICE)
    assert _read("field.idle_ms_per_step.tile", tr) == pytest.approx(0.125, abs=1e-12)
    assert _read("mesh.idle_ms_per_step.tile", tr) == pytest.approx(0.05, abs=1e-12)


def test_the_serving_readers(program):
    queued = [_span("serve.queue", 10 * i, 10 * i + 1000 * (i + 1), 100 + i,
                    attrs={"order": f"o{i}", "batch": 1 + i // 4}, is_async=True)
              for i in range(20)]
    batches = [_span("serve.batch", a, a + 200, 1 + i, attrs={"batch": 1 + i}, thread=WORKER)
               for i, a in enumerate((0, 400, 800))]
    program(queued + batches)
    tr = _trace(DEVICE, host=(("h", 0.0, 30000.0),))
    # waits of 1, 2, ... 20 ms: the 95th percentile 19 + 0.05
    assert _read("serve.queue_wait_p95_ms", tr) == pytest.approx(19.05, abs=1e-9)
    assert _read("serve.batch_ms", tr) == pytest.approx(0.2, abs=1e-12)
    # busy in the batches 150 + 100 + 100 of 600 µs
    assert _read("serve.batch_idle_share", tr) == pytest.approx(100.0 * 250.0 / 600.0,
                                                                abs=1e-9)


def test_busy_share_clips_at_the_spans_edges():
    tr = _trace(DEVICE)
    s = [spans.Span("b", 50.0, 175.0, MAIN, 1, None, None, False),
         spans.Span("b", 950.0, 1200.0, MAIN, 2, None, None, False)]
    assert spans.busy_share(tr, s) == pytest.approx((50.0 + 25.0 + 50.0) / 375.0)
    assert spans.busy_share(tr, []) is None


NEW = ["erosion.host_ms_per_cycle.step", "erosion.sync_ms_per_cycle.step",
       "erosion.syncs_per_cycle.step", "field.idle_ms_per_step.tile",
       "mesh.idle_ms_per_step.tile", "serve.queue_wait_p95_ms", "serve.batch_ms",
       "serve.batch_idle_share", "erosion.graph_share.step"] + \
    [f"erosion.{p}.idle_ms_per_cycle.step" for p in PHASES]


@pytest.mark.parametrize("name", NEW)
def test_a_reader_gives_none_without_the_spans_it_needs(program, monkeypatch, name):
    tr = _trace(DEVICE)
    program([])
    assert _read(name, tr) is None
    monkeypatch.delattr(TR, "spans")   # a program that keeps no spans
    assert _read(name, tr) is None
    assert _read(name, _trace([], host=())) is None


def test_every_new_reader_is_listed_with_its_cells():
    b = core.benchmark()
    listed = {m["name"]: m for m in b["per_layer"]}
    for name in NEW:
        m = listed[name]
        assert m["source"] in ("program_span", "program_counter")
        want = ({"serve_1024"} if name.startswith("serve.") else
                {"tile_2048"} if name.endswith(".tile") else {"live_2048", "tile_2048"})
        assert set(m["workloads"]) == want
    assert np.isin(NEW, list(listed)).all()
