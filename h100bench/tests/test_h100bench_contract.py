"""``BENCHMARK.json`` and the files the harness finds by name: names,
units, keys and limits as the benchmark's contract states them; every
cell's files present; the cost functions; what the harness imports."""

from __future__ import annotations

import ast
import json
import re
import subprocess
import sys

import pytest

from h100bench import core, peaks
from h100bench.costs import k1, k2, k10

B = core.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_.\-/]{1,200}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|state|projection|head|expansion")


def _line(s: str) -> bool:
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(B) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert (core.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert isinstance(B["run_seconds"], int) and 1 <= B["run_seconds"] <= 51
    assert 1 <= len(B["command"]) <= 32 and all(_line(w) for w in B["command"])
    assert 1 <= len(B["paths"]) <= 16
    for p in B["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p.split("/")
        assert not p.endswith("_torch") and (core.ROOT / p).is_dir()


def test_configs():
    assert 1 <= len(B["configs"]) <= 24
    used = {w["config"] for w in B["workloads"]}
    files = set()
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith(B["paths"][0] + "/") and c["file"] not in files
        files.add(c["file"])
        body = json.loads((core.ROOT / c["file"]).read_text())
        assert body["source"] == c["source"] and body["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        assert all(NAME.match(k) and not WIDTH.search(k) for k in c["reduced"])


def test_workloads():
    ws = B["workloads"]
    assert 1 <= len(ws) <= 24
    assert len({w["name"] for w in ws}) == len(ws)
    assert len({(w["config"], w["traffic"]) for w in ws}) == len(ws)
    names = {c["name"] for c in B["configs"]}
    for w in ws:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["config"] in names
        assert w["chips"] in (1, 4) and _line(w["why"])
    assert sum(w["chips"] == 4 for w in ws) <= max(1, len(ws) // 4)


def test_metrics():
    e2e, pl = B["end_to_end"], B["per_layer"]
    assert 1 <= len(e2e) <= 16 and 1 <= len(pl) <= 128
    names = [m["name"] for m in e2e + pl]
    assert len(set(names)) == len(names) and all(NAME.match(n) for n in names)
    cells = {w["name"] for w in B["workloads"]}
    for m in e2e:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0 < m["bound"] <= 0.25
        assert set(m.get("workloads", cells)) <= cells
    assert any(m["name"] == "setup_s" and "workloads" not in m for m in e2e)
    for m in pl:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert _line(m["layer"])
        for c in m.get("workloads", cells):
            assert m["moves"] in {x["name"] for x in core.end_to_end_of(B, c)}
    for m in e2e + pl:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for c in cells:
        got = {m["name"] for m in core.end_to_end_of(B, c)}
        assert "setup_s" in got and len(got) >= 2 and core.per_layer_of(B, c)


def test_every_cell_finds_its_files_by_name():
    for w in B["workloads"]:
        traffic = core.traffic(w["traffic"])
        assert core.config(w["config"])["tile"]["generator_res"] > 0
        assert core.cell(w["name"])["limits"]
        assert hasattr(core.driver(traffic["driver"]), "run")
        assert callable(core.entry(traffic["entry"]))
    for m in B["per_layer"]:
        assert callable(core.metric_reader(m["name"]).read)


def test_roofline_shares_are_named_for_their_kernel():
    for m in B["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^[a-z0-9]+_roofline(\.|$)", m["name"]) and m["unit"] == "%"


def test_cost_functions_repeat_exactly():
    cases = [(k10.cost, (2048 * 2048, "Simplex", 13)), (k10.cost, (16 << 20, "Cellular", 13)),
             (k1.cost, (16 << 20, 5, 17)), (k2.cost, (16 << 20, 8))]
    for fn, args in cases:
        assert fn(*args) == fn(*args)
    # PERF.md's bounds, NVIDIA H100 at 700 W: K10 2048² Simplex ×13 0.2753 ms,
    # K1@stack 0.1705 ms, K2@stack 0.1474 ms
    assert peaks.bound_s(*k10.cost(2048 * 2048, "Simplex", 13)) * 1e3 == pytest.approx(0.2753, abs=1e-4)
    assert peaks.bound_s(*k1.cost(16 << 20, 5, 17)) * 1e3 == pytest.approx(0.1705, abs=1e-4)
    assert peaks.bound_s(*k2.cost(16 << 20, 8)) * 1e3 == pytest.approx(0.1474, abs=1e-4)


def _imports(path) -> set:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_the_jax_package():
    for path in core.HERE.rglob("*.py"):
        assert not _imports(path) & set(core.FORBIDDEN), path


def test_the_reference_imports_nothing_of_the_port():
    for path in (core.HERE / "reference").rglob("*.py"):
        assert "noize_tpu_torch" not in _imports(path), path
    code = ("import sys, h100bench.reference.pipeline; "
            "print(sorted({n.split('.')[0] for n in sys.modules}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=core.ROOT, capture_output=True,
                         text=True, check=True).stdout
    loaded = set(ast.literal_eval(out.strip()))
    assert not loaded & ({"noize_tpu_torch"} | set(core.FORBIDDEN))
