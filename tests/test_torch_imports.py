"""The port stands alone: importing any ``noize_tpu_torch`` module never
loads JAX nor any module of the JAX package ``noize_tpu``, neither does
``chip_smoke.py``, and ``chip_smoke.py`` refuses to run without a GPU."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent


def _modules():
    pkg = REPO / "noize_tpu_torch"
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in pkg.rglob("*.py"))


def test_every_module_is_listed():
    mods = _modules()
    assert "noize_tpu_torch.app.flagship" in mods and "noize_tpu_torch._cuda" in mods
    assert len(mods) >= 20


def test_slice_modules_are_listed():
    """The BasicDemo preset slice and the PRNG are among the modules
    imported below."""
    mods = set(_modules())
    for m in ("prng", "ops.noise", "ops.kernels", "ops.edge", "ops.filters", "ops.mesh",
              "utils.anim_curve", "pipeline.stage", "pipeline.stages", "pipeline.compose",
              "app.presets"):
        assert f"noize_tpu_torch.{m}" in mods, m


def test_serving_slice_modules_are_listed():
    """The tile-serving and app slice is among the modules imported
    below."""
    mods = set(_modules())
    for m in ("parallel.tiled", "app.server", "app.cli", "app.tile_generator", "app.visualize",
              "app.bakery", "app.drawers", "utils.tracking", "utils.stats", "utils.helpers"):
        assert f"noize_tpu_torch.{m}" in mods, m


def test_last_single_device_and_parallel_modules_are_listed():
    """Vegetation, the exact pile kernel's wrapper, the native IO runtime and
    the field-level parallel layer are among the modules imported below."""
    mods = set(_modules())
    for m in ("erosion.vegetation", "erosion.pile_cuda", "native", "parallel",
              "parallel.device_mesh", "parallel.distributed", "parallel.halo",
              "parallel.sharded_ops"):
        assert f"noize_tpu_torch.{m}" in mods, m


def test_sharded_slice_modules_are_listed():
    """The sharded erosion cycle, the sharded mesh and checkpoint and the
    multi-device dry run are among the modules imported below."""
    mods = set(_modules())
    for m in ("parallel.sharded_erosion", "parallel.sharded_mesh",
              "parallel.sharded_checkpoint", "app.dryrun"):
        assert f"noize_tpu_torch.{m}" in mods, m


def test_descent_and_threefry_kernel_modules_are_listed():
    """K7's wrapper module and the kernels' sources (K7, K8) are part of the
    port: the import check below covers the wrapper."""
    mods = set(_modules())
    assert "noize_tpu_torch.erosion.descent_cuda" in mods
    for src in ("descent.cu", "threefry.cu"):
        assert (REPO / "noize_tpu_torch" / "csrc" / src).exists(), src


def test_scatter_kernel_module_is_listed():
    """K9's wrapper module and source are part of the port: the import check
    below covers the wrapper."""
    assert "noize_tpu_torch.erosion.scatter_cuda" in set(_modules())
    assert (REPO / "noize_tpu_torch" / "csrc" / "scatter.cu").exists()


def test_port_imports_no_jax():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "roots = ('jax', 'jaxlib', 'noize_tpu')\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in roots)\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def _run_smoke(cwd):
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=dict(os.environ, PYTHONPATH=""),
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a GPU is present; chip_smoke.py runs for real there")
    proc = _run_smoke(REPO)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_alone_fails(tmp_path):
    """Without the rest of the repository the script must fail, on any
    machine."""
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run_smoke(tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def _imported_modules(path):
    """Every module name an ``import`` or ``from ... import`` names in the
    file (at any depth: chip_smoke.py imports inside its phases)."""
    tree = ast.parse(path.read_text(), filename=str(path))
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module)
    return names


def test_chip_smoke_imports_no_jax_package():
    names = _imported_modules(REPO / "chip_smoke.py")
    assert any(n.startswith("noize_tpu_torch") for n in names)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "noize_tpu"))
    assert not bad, bad


@pytest.mark.parametrize("name", ["full_tile_workflow_torch", "serving_tiles_torch",
                                  "multichip_field_torch"])
def test_torch_examples_import_no_jax_package(name):
    """The port's user journeys import ``noize_tpu_torch``, never ``jax``
    nor any ``noize_tpu`` module."""
    names = _imported_modules(REPO / "examples" / f"{name}.py")
    assert any(n.startswith("noize_tpu_torch") for n in names)
    bad = sorted(n for n in names if n.split(".")[0] in ("jax", "jaxlib", "noize_tpu"))
    assert not bad, bad
