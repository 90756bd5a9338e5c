"""Every public function and class method of each ported module against the
JAX package's: parameter names, order and defaults must be the reference's,
so a caller written for ``noize_tpu`` works unchanged.

A port module's counterpart is the ``noize_tpu`` module of the same path.
The port may add one parameter a callable: a trailing keyword-only
``device`` (the port's entries default to the card).  Besides it, the
port keeps a few keyword-only test and instrumentation hooks, listed in
``HOOKS``; and a few reference functions are not ported yet, listed with
their reason in ``NOT_PORTED``.
"""

import enum
import importlib
import inspect
import pathlib

import pytest

REPO = pathlib.Path(__file__).resolve().parent.parent

#: keyword-only parameters the port adds beyond ``device``: ``fresh``
#: replaces a cycle's spawn with given particles (a test hook), ``syncs``
#: records the host syncs of an eager step (PERF.md's counter), and the
#: halo functions that communicate take their ``DeviceMesh`` as ``mesh``
#: (the reference finds its mesh in the enclosing ``shard_map``)
HOOKS = {
    ("erosion.sim", "erosion_cycle"): ("fresh", "syncs"),
    ("erosion.sim", "ErosionSim.step"): ("fresh",),
    ("erosion.particles", "descend_all"): ("syncs",),
    ("erosion.sediment", "write_sediment_map"): ("syncs",),
    **{("parallel.halo", name): ("mesh",)
       for name in ("exchange_axis", "exchange_2d", "fold_axis", "fold_2d")},
}

#: reference callables the port does not have yet, and why
NOT_PORTED = {
    ("ops.mesh", "MeshArrays.tree_flatten"): "JAX pytree protocol",
    ("ops.mesh", "MeshArrays.tree_unflatten"): "JAX pytree protocol",
    ("ops.mesh", "MeshPlanes.tree_flatten"): "JAX pytree protocol",
    ("ops.mesh", "MeshPlanes.tree_unflatten"): "JAX pytree protocol",
    ("utils.helpers", "match_vma"): "casts shard_map varying axes: no meaning without "
                                    "JAX's manual mesh",
}


def _port_modules():
    out = []
    for p in sorted((REPO / "noize_tpu_torch").rglob("*.py")):
        rel = ".".join(p.relative_to(REPO / "noize_tpu_torch").with_suffix("").parts)
        rel = rel.removesuffix("__init__").rstrip(".")
        ref = REPO / "noize_tpu" / p.relative_to(REPO / "noize_tpu_torch")
        if rel and ref.exists():
            out.append(rel)
    return out


MODULES = _port_modules()


def _own(obj, module):
    target = getattr(obj, "__wrapped__", obj)
    return getattr(target, "__module__", None) == module.__name__


def _callables(module):
    """Public functions and the public methods (and ``__init__``) of
    public classes defined in ``module``, by dotted name."""
    out = {}
    for name, obj in vars(module).items():
        if name.startswith("_") or not _own(obj, module):
            continue
        if inspect.isclass(obj):
            if issubclass(obj, enum.Enum):
                continue
            for mname in dir(obj):
                if mname.startswith("_") and mname != "__init__":
                    continue
                raw = inspect.getattr_static(obj, mname)
                fn = raw.__func__ if isinstance(raw, (classmethod, staticmethod)) else raw
                if inspect.isfunction(fn) and not fn.__module__.startswith("builtins"):
                    if mname == "__init__" and fn is object.__init__:
                        continue
                    out[f"{name}.{mname}"] = fn
        elif callable(obj):
            out[name] = obj
    return out


def _default(v):
    if v is inspect.Parameter.empty:
        return "<required>"
    if isinstance(v, enum.Enum):
        return f"{type(v).__name__}.{v.name}"
    return repr(v)


def _params(fn):
    return [(p.name, _default(p.default), p.kind)
            for p in inspect.signature(fn).parameters.values()]


def _pairs(rel):
    port = importlib.import_module(f"noize_tpu_torch.{rel}")
    ref = importlib.import_module(f"noize_tpu.{rel}")
    return _callables(port), _callables(ref)


def test_modules_found():
    assert {"ops.noise", "ops.kernels", "ops.filters", "ops.edge", "ops.mesh",
            "pipeline.compose", "pipeline.stages", "app.presets", "core.store",
            "utils.anim_curve", "erosion.sim", "parallel.tiled", "app.server", "app.cli",
            "app.tile_generator", "utils.tracking", "utils.stats", "utils.helpers",
            "app.visualize", "app.bakery", "app.drawers", "erosion.vegetation", "native",
            "parallel.device_mesh", "parallel.distributed", "parallel.halo",
            "parallel.sharded_ops", "parallel.sharded_erosion", "parallel.sharded_mesh",
            "parallel.sharded_checkpoint"} <= set(MODULES)


@pytest.mark.parametrize("rel", MODULES)
def test_signatures_match_reference(rel):
    port, ref = _pairs(rel)
    bad = []
    for name in sorted(set(port) & set(ref)):
        got, want = _params(port[name]), _params(ref[name])
        extra = list(HOOKS.get((rel, name), ())) + ["device"]
        while got and got[-1][0] in extra and got[-1][2] is inspect.Parameter.KEYWORD_ONLY \
                and len(got) > len(want):
            extra.remove(got[-1][0])
            got = got[:-1]
        if [(n, d) for n, d, _ in got] != [(n, d) for n, d, _ in want]:
            bad.append(f"{name}: port {got} != reference {want}")
    assert not bad, "\n".join(bad)


@pytest.mark.parametrize("rel", MODULES)
def test_reference_callables_are_ported(rel):
    port, ref = _pairs(rel)
    missing = sorted(n for n in set(ref) - set(port) if (rel, n) not in NOT_PORTED)
    assert not missing, missing


def test_listed_exceptions_still_apply():
    for (rel, name), _ in NOT_PORTED.items():
        port, ref = _pairs(rel)
        assert name in ref and name not in port, (rel, name)
    for (rel, name), hooks in HOOKS.items():
        port, _ = _pairs(rel)
        params = inspect.signature(port[name]).parameters
        assert all(params[h].kind is inspect.Parameter.KEYWORD_ONLY for h in hooks)


def test_flagship_step_signature():
    """``make_tile_step``'s step takes the reference's (xpos, zpos, key)."""
    from noize_tpu.app import flagship as JF
    from noize_tpu_torch.app import flagship as TF
    from noize_tpu_torch.core.tiles import TileSetMeta

    meta = TileSetMeta(tile_res=8, tile_size=8, generator_res=16, height=1000, margin=4)
    step, _, _ = TF.make_tile_step(meta.validate(), device="cpu")
    got = [(p.name, p.kind) for p in inspect.signature(step).parameters.values()]
    assert got[:3] == [(n, inspect.Parameter.POSITIONAL_OR_KEYWORD)
                       for n in ("xpos", "zpos", "key")]
    assert got[3:] == [("fresh", inspect.Parameter.KEYWORD_ONLY)]
    jstep, _, _ = JF.make_tile_step()
    assert list(inspect.signature(jstep).parameters) == ["xpos", "zpos", "key"]


def test_dryrun_multichip_signature():
    """``app.dryrun.dryrun_multichip`` takes ``__graft_entry__``'s
    (n_devices) and a trailing keyword-only ``device``."""
    import __graft_entry__ as GE
    from noize_tpu_torch.app import dryrun as DR

    got = _params(DR.dryrun_multichip)
    assert got[-1][0] == "device" and got[-1][2] is inspect.Parameter.KEYWORD_ONLY
    assert [(n, d) for n, d, _ in got[:-1]] == [(n, d) for n, d, _ in _params(GE.dryrun_multichip)]
