"""Finding a cell's files by name, and the checks every run makes.

``BENCHMARK.json`` (at the checkout's root) names each workload's
configuration and traffic and lists the metrics; everything else is a
file of its own under this folder, found by name:

  configs/<config>.json     the deployment: field, tile, erosion, mesh
  traffic/<traffic>.json    the driver, the entry and their parameters
  cells/<workload>.json     the comparison's limits for the cell
  metrics/<metric>.py       a per-layer reader: ``read(trace) -> float | None``
  costs/<kernel>.py         a kernel's operations and bytes
  drivers/<driver>.py       a traffic driver (closed_step, closed_batch, open_serve)
  entries/<entry>.py        a program entry (erosion_sim, tile_step, tile_batch, tile_server)
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import pathlib
import sys

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent

#: top-level module names that no run may have loaded: JAX and the JAX
#: package this port was made from (``noize_tpu_torch`` is the port and is
#: another name)
FORBIDDEN = ("jax", "jaxlib", "flax", "noize_tpu")


def benchmark(root: pathlib.Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def workload(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"h100bench: no workload {name!r} in BENCHMARK.json")


def _json(kind: str, name: str, here: pathlib.Path = HERE) -> dict:
    return json.loads((here / kind / f"{name}.json").read_text())


def config(name: str, here: pathlib.Path = HERE) -> dict:
    return _json("configs", name, here)


def traffic(name: str, here: pathlib.Path = HERE) -> dict:
    return _json("traffic", name, here)


def cell(name: str, here: pathlib.Path = HERE) -> dict:
    return _json("cells", name, here)


def metric_reader(name: str, here: pathlib.Path = HERE):
    """The module ``metrics/<name>.py`` (its name may hold dots)."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"h100bench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(name: str):
    return importlib.import_module(f"h100bench.drivers.{name}")


def entry(name: str):
    return importlib.import_module(f"h100bench.entries.{name}").Entry


def end_to_end_of(bench: dict, cell_name: str) -> list:
    """The end-to-end metrics the cell reports."""
    return [m for m in bench["end_to_end"] if cell_name in m.get("workloads", [cell_name])]


def per_layer_of(bench: dict, cell_name: str) -> list:
    """The per-layer metrics the cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    moves = {m["name"] for m in end_to_end_of(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m else m["moves"] in moves)]


def forbidden_loaded() -> list:
    return sorted({n.split(".")[0] for n in sys.modules} & set(FORBIDDEN))
