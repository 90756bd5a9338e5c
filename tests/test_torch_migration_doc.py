"""The port's cookbook and API reference cannot rot.

``docs/MIGRATION_torch.md``: every ```python fence runs verbatim, in order,
in one namespace, on the CPU (``NOIZE_DEVICE=cpu``), in a subprocess of its
own, so that §8's process group never outlives the snippet in a test
worker; the artefacts checked are those ``tests/test_migration_doc.py``
checks for ``docs/MIGRATION.md``.

``docs/API_torch.md``: every dotted name in the first column of its tables
resolves in ``noize_tpu_torch`` (import, then ``getattr``).
"""

import importlib
import json
import os
import pathlib
import re
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]
DOC = REPO / "docs" / "MIGRATION_torch.md"
API = REPO / "docs" / "API_torch.md"

#: runs the fences of the document argv[1] in one namespace; prints a JSON
#: line of what the test checks
RUNNER = r'''
import json, re, sys
import torch.distributed as dist
text = open(sys.argv[1]).read()
snippets = re.findall(r"```python\n(.*?)```", text, re.S)
ns = {}
for i, code in enumerate(snippets):
    try:
        exec(compile(code, f"MIGRATION_torch.md#snippet{i + 1}", "exec"), ns)
    except Exception as e:
        raise SystemExit(f"MIGRATION_torch.md snippet {i + 1} failed: "
                         f"{type(e).__name__}: {e}\n--- snippet ---\n{code}")
sim = ns["sim"]
print(json.dumps({
    "snippets": len(snippets),
    "sim_height": sim.height_map is not None,
    "device": str(sim.height_map.device),
    "heightmap": [str(ns["heightmap"].device), list(ns["heightmap"].shape)],
    "served": len(ns["done"]),
    "group_left": dist.is_initialized(),
}))
'''


def test_migration_torch_snippets_run(tmp_path):
    os.makedirs(tmp_path / "out")
    env = dict(os.environ, NOIZE_DEVICE="cpu", OMP_NUM_THREADS="4",
               PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", RUNNER, str(DOC)], cwd=tmp_path, env=env,
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, (proc.stdout[-3000:], proc.stderr[-6000:])
    got = json.loads(proc.stdout.strip().splitlines()[-1])
    assert got["snippets"] >= 9, f"expected the cookbook's snippets, got {got['snippets']}"
    # the artefacts the doc claims, as tests/test_migration_doc.py checks them
    assert (tmp_path / "out" / "tile.obj").stat().st_size > 0
    assert (tmp_path / "out" / "tile.npz").stat().st_size > 0
    assert got["sim_height"]
    # on the device the snippets were given, and §8 ended its group
    assert got["device"] == "cpu" and got["heightmap"] == ["cpu", [512, 512]]
    assert got["served"] == 4
    assert not got["group_left"]


def _api_names():
    """(row, dotted name) of every name in the first column of the API
    tables: a name with a dot is under ``noize_tpu_torch``, one without is
    in the module of the row's last dotted name; ``a / b`` lists siblings,
    a call's arguments are dropped."""
    out = []
    for line in API.read_text().splitlines():
        if not line.startswith("| `"):
            continue
        first = line.split(" | ")[0]
        parent = None
        for span in re.findall(r"`([^`]+)`", first):
            for part in span.split(" / "):
                name = part.split("(")[0].strip()
                if "." in name:
                    parent = name.rsplit(".", 1)[0]
                else:
                    assert parent is not None, line
                    name = f"{parent}.{name}"
                out.append((first, name))
    return out


def _resolve(dotted):
    parts = dotted.split(".")
    for i in range(len(parts), 0, -1):
        try:
            obj = importlib.import_module(".".join(["noize_tpu_torch", *parts[:i]]))
        except ModuleNotFoundError:
            continue
        for attr in parts[i:]:
            obj = getattr(obj, attr)
        return obj
    raise ModuleNotFoundError(dotted)


def test_api_torch_lists_the_port_kernels():
    names = {n for _, n in _api_names()}
    for n in ("ops.cuda.stencil", "ops.cuda.flow", "ops.cuda.thermal",
              "erosion.pool_cuda.pool_automata_cuda", "erosion.descent_cuda.descend_steps",
              "prng.threefry2x32", "erosion.scatter_cuda.scatter_in_order",
              "erosion.pile_cuda.exact_piles", "convert.key_from_jax",
              "app.dryrun.dryrun_multichip"):
        assert n in names, n
    assert not any("pallas" in n.split(".")[:2] or n.endswith("pick_block") for n in names)
    assert len(names) >= 80, len(names)


@pytest.mark.parametrize("row,name", [pytest.param(r, n, id=n) for r, n in _api_names()])
def test_api_torch_name_resolves(row, name):
    assert _resolve(name) is not None, row
