"""Whole runs of the harness on the CPU at small sizes, past its look for a
card: the timed path broken underneath turns ``correct`` false; the
control fails the cells' limits; a cell and a per-layer metric added as
files are picked up; and the command itself refuses to run without a card.
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch

from h100bench import calibrate, core, run

CPU = "cpu"
SEED = 2 ** 31 + 12345


def _run(name, here, patch=None, trace=False, bench=None):
    return run.run_cell(name, SEED, 1.0, trace, device=CPU, t_start=time.perf_counter(),
                        bench=bench, here=here, patch=patch)


@pytest.mark.parametrize("name", [w["name"] for w in core.benchmark()["workloads"]])
def test_a_sound_run_is_correct(small_here, name):
    r = _run(name, small_here)
    assert r["correct"] and r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(core.cell(name, small_here)["limits"])
    assert {m["name"] for m in core.end_to_end_of(core.benchmark(), name)} == set(r["metrics"])


def _unchanged_step(entry):
    entry.sim.step = lambda *a, **k: entry.sim.state


def _half_batch(entry):
    run_ = entry._run

    def half(i):
        out = run_(i)
        n = out["height"].shape[0] // 2
        return {k: torch.cat([v[:n], v[:n]]) for k, v in out.items()}

    entry._run = half


def _altered_tile(entry):
    step = entry.step

    def altered(*a, **k):
        out = step(*a, **k)
        out["height"] = out["height"].clone()
        out["height"][7, 9] += 1e-2
        return out

    entry.step = altered


def _altered_served(entry):
    run_batch = entry.server._run_batch

    def altered(origins):
        h, planes = run_batch(origins)
        h = h.clone()
        h[0, 5, 5] += 1e-2
        return h, planes

    entry.server._run_batch = altered


def _half_served(entry):
    run_batch = entry.server._run_batch

    def half(origins):
        h, planes = run_batch(origins)
        n = h.shape[0] // 2
        return torch.cat([h[:n], h[:n]]), torch.cat([planes[:n], planes[:n]])

    entry.server._run_batch = half


@pytest.mark.parametrize("name, fault", [
    ("live_2048", _unchanged_step),
    ("bake_1024", _half_batch),
    ("tile_2048", _altered_tile),
    ("serve_1024", _altered_served),
    ("serve_1024", _half_served),
])
def test_a_broken_timed_path_is_not_correct(small_here, name, fault):
    r = _run(name, small_here, patch=fault)
    assert r["correct"] is False
    assert any(c["value"] > c["limit"] for c in r["checks"].values())


@pytest.mark.parametrize("name", [w["name"] for w in core.benchmark()["workloads"]])
def test_the_control_fails_the_limits(small_here, name):
    out = calibrate.readings(name, SEED, 1.0, True, device=CPU, here=small_here)
    limits = core.cell(name, small_here)["limits"]
    assert all(out["program"][k] <= v for k, v in limits.items())
    assert any(out["control"][k] > v for k, v in limits.items())


def _digest(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in root.rglob("*") if p.is_file() and "__pycache__" not in p.parts}


def test_a_cell_and_a_metric_added_as_files(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(core.HERE, root / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(core.ROOT / "BENCHMARK.json", root / "BENCHMARK.json")
    here = root / "h100bench"
    from h100bench.tests.conftest import shrink

    shrink(here)
    before = _digest(here)
    # the new files: a configuration, a traffic mix, a cell and a reader
    cfg = json.loads((here / "configs" / "example2_1024.json").read_text())
    cfg["field"]["noise_type"] = "Perlin"
    (here / "configs" / "perlin_64.json").write_text(json.dumps(cfg))
    traffic = json.loads((here / "traffic" / "bake.json").read_text())
    traffic["block"] = 2
    (here / "traffic" / "bake_small.json").write_text(json.dumps(traffic))
    (here / "cells" / "perlin_bake.json").write_text(json.dumps({"limits": {"height": 1e-4}}))
    (here / "metrics" / "calls_traced.bake_small.py").write_text(
        "def read(tr):\n    return float(tr.calls) if tr.calls else None\n")
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "perlin_64", "source": "a test", "reduced": [],
                             "file": "h100bench/configs/perlin_64.json", "why": "a test"})
    bench["workloads"].append({"name": "perlin_bake", "config": "perlin_64",
                               "traffic": "bake_small", "chips": 1, "why": "a test"})
    for m in bench["end_to_end"]:
        if m["name"] == "tiles_per_s":
            m["workloads"].append("perlin_bake")
    bench["per_layer"].append({"name": "calls_traced.bake_small", "unit": "calls",
                               "better": "higher", "source": "host_clock", "layer": "serving",
                               "moves": "tiles_per_s", "workloads": ["perlin_bake"]})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    after = _digest(here)
    assert all(after[p] == d for p, d in before.items()), "a file that was there changed"

    code = ("import json, sys, time; from h100bench import core, run; "
            "b = core.benchmark(); "
            "r0 = run.run_cell('perlin_bake', 3, 1.0, False, device='cpu', bench=b, "
            "t_start=time.perf_counter()); "
            "r1 = run.run_cell('perlin_bake', 3, 1.0, True, device='cpu', bench=b, "
            "t_start=time.perf_counter()); print(json.dumps([r0, r1]))")
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([str(root), str(core.ROOT)]))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, env=env, capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-2000:]
    r0, r1 = json.loads(out.stdout.strip().splitlines()[-1])
    assert r0["correct"] and r1["correct"]
    assert set(r0["metrics"]) == {"tiles_per_s", "setup_s"}
    assert r1["metrics"]["calls_traced.bake_small"]["unit"] == "calls"
    assert r0["attempted"] % 4 == 0


def _command(cwd, env=None):
    return subprocess.run([sys.executable, "-m", "h100bench.run", "--workload", "live_2048",
                           "--seed", str(SEED), "--seconds", "1", "--trace", "0"],
                          cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_a_run_without_a_card_fails_and_prints_no_result():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _command(core.ROOT, env)
    assert out.returncode != 0 and out.stdout == ""


def test_a_run_with_only_the_benchmark_fails(tmp_path):
    shutil.copytree(core.HERE, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(core.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _command(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""


@pytest.mark.card
def test_a_short_run_on_the_card(card):
    r = run.run_cell("bake_1024", SEED, 2.0, False, device="cuda",
                     t_start=time.perf_counter())
    assert r["correct"] and r["device"]["platform"] == "gpu"
    assert r["device"]["kind"] == torch.cuda.get_device_name(0)
