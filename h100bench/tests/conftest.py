"""Fixtures of the harness's own tests (``python3 -m pytest h100bench/tests``).

``small_here`` is a copy of the cell files whose configurations are cut to
a size the CPU runs in seconds (a 64² generator tile, 4 octaves, 40
particles of age 12, 2 cycles); the traffic and the limits are the
benchmark's own.  ``card`` skips a test where there is no CUDA card,
deciding when the test runs, never when the module is imported.
"""

from __future__ import annotations

import json
import shutil

import pytest

from h100bench import core


def pytest_configure(config):
    config.addinivalue_line("markers", "card: needs a CUDA card; skipped without one")


def shrink(here):
    """Cut the configurations and traffic under ``here`` to CPU size."""
    for f in (here / "configs").glob("*.json"):
        c = json.loads(f.read_text())
        c["tile"] = {"tile_res": 56, "tile_size": 56, "generator_res": 64, "height": 1000,
                     "margin": 4}
        c["erosion"].update(PARTICLES_PER_CYCLE=40, MAXAGE=12, CYCLES=2, WATER_STEPS=3)
        c["field"]["octaves"] = 4
        f.write_text(json.dumps(c))
    for f in (here / "traffic").glob("*.json"):
        t = json.loads(f.read_text())
        if t.get("erosion_cycles"):
            t["erosion_cycles"] = 1
        if "rate" in t:
            t.update(rate=20.0, region=5)
        f.write_text(json.dumps(t))


@pytest.fixture
def small_here(tmp_path):
    here = tmp_path / "h100bench"
    for d in ("configs", "traffic", "cells", "metrics"):
        shutil.copytree(core.HERE / d, here / d)
    shrink(here)
    return here


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")
