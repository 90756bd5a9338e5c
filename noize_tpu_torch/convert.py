"""State that crosses between the JAX reference and the port.

The system has no weights; what crosses is the erosion state — the five
``WorldState`` maps, the queued drain water and the threefry key (uint32[2]
in both packages) — particle buffers, plant sets, the
configuration dataclasses and the buffer store's save directories.
Arrays travel as numpy: float32 stays float32, int32 stays int32, bool
stays bool.  The JAX dataclasses travel as plain dicts
(``dataclasses.asdict``), so the port never imports them.  Tensors land on
the card unless ``device`` says otherwise.
"""

from __future__ import annotations

import numpy as np
import torch

from .core.store import PipelineStateManager
from .core.tiles import TileSetMeta
from .erosion.params import ErosionMode, ErosionSettings
from .erosion.particles import Particles
from .erosion.sim import SimState
from .erosion.vegetation import Plants, PlantType
from .erosion.world import WorldState
from .prng import PRNGKey

WORLD_MAPS = ("height", "pool", "flow", "track", "plants")

_DTYPES = {
    np.dtype(np.float32): torch.float32,
    np.dtype(np.int32): torch.int32,
    np.dtype(np.bool_): torch.bool,
}


def _to_tensor(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype not in _DTYPES:
        raise TypeError(f"unsupported dtype {a.dtype}; expected float32, int32 or bool")
    # a writable copy: arrays from JAX are read-only views
    return torch.from_numpy(np.array(a)).to(device=device)


def key_from_jax(key, device="cuda") -> torch.Tensor:
    """A ``jax.random`` threefry key (``np.asarray(key)``: uint32[2]) as
    the port's key (``prng.PRNGKey``) on ``device``."""
    key = np.asarray(key)
    if key.shape != (2,) or key.dtype != np.uint32:
        raise TypeError(f"expected a uint32[2] threefry key, got {key.dtype}{key.shape}")
    return torch.from_numpy(np.array(key)).to(device=device)


def sim_state_from_numpy(world: dict, drain_water, device="cuda", key=None) -> SimState:
    """SimState from the five world maps (``world[name]`` for name in
    WORLD_MAPS), the drain-water map and a JAX key (``np.asarray`` of the
    reference's ``SimState.key``; ``None`` is ``PRNGKey(0)``)."""
    maps = {k: _to_tensor(world[k], device) for k in WORLD_MAPS}
    return SimState(world=WorldState(**maps),
                    drain_water=_to_tensor(drain_water, device),
                    key=PRNGKey(0, device) if key is None else key_from_jax(key, device))


def sharded_state_from_numpy(world: dict, drain_water, mesh, key=None) -> SimState:
    """``sim_state_from_numpy`` placed on a spatial mesh: every map a
    ``DTensor`` placed ``Shard(0)``, ``Shard(1)`` (this rank's block of the
    whole grid given on every rank), the key replicated, all on the mesh's
    device — the state ``parallel.sharded_erosion`` takes."""
    from .parallel.halo import _as_field, _local_block, _mesh_device

    def field(a):
        block, shape = _local_block(_to_tensor(a, "cpu"), mesh)
        return _as_field(block, mesh, shape)

    device = _mesh_device(mesh)
    return SimState(world=WorldState(**{k: field(world[k]) for k in WORLD_MAPS}),
                    drain_water=field(drain_water),
                    key=PRNGKey(0, device) if key is None else key_from_jax(key, device))


def _host(t):
    return (t.full_tensor() if hasattr(t, "full_tensor") else t).cpu().numpy()


def sim_state_to_numpy(state: SimState):
    """(world dict, drain_water) as numpy arrays (a sharded state's maps
    gathered: every rank calls it); the key is ``state.key.cpu().numpy()``,
    the reference's uint32[2]."""
    world = {k: _host(getattr(state.world, k)) for k in WORLD_MAPS}
    return world, _host(state.drain_water)


def particles_from_numpy(parts: dict, device="cuda") -> Particles:
    """Particles from a dict (or any mapping / NamedTuple ``_asdict()``)
    of the eight particle fields."""
    return Particles(**{k: _to_tensor(parts[k], device) for k in Particles._fields})


def particles_to_numpy(p: Particles) -> dict:
    return {k: getattr(p, k).cpu().numpy() for k in Particles._fields}


def plants_from_jax(plants, device="cuda") -> Plants:
    """The port's ``Plants`` from the reference's (a NamedTuple of arrays,
    or any mapping of the six fields): int32, float32 and bool as they
    are."""
    fields = plants._asdict() if hasattr(plants, "_asdict") else plants
    return Plants(**{k: _to_tensor(fields[k], device) for k in Plants._fields})


def plant_type_from_jax(ptype: dict) -> PlantType:
    """The port's ``PlantType`` from ``asdict`` of the reference's."""
    return PlantType(**ptype)


def meta_from_jax(meta: dict) -> TileSetMeta:
    """The port's ``TileSetMeta`` from ``asdict`` of the reference's."""
    return TileSetMeta(**meta)


def settings_from_jax(settings: dict) -> ErosionSettings:
    """The port's ``ErosionSettings`` from ``asdict`` of the reference's;
    ``BEHAVIOR`` may be the reference's enum member or its name."""
    fields = dict(settings)
    if "BEHAVIOR" in fields:
        mode = fields["BEHAVIOR"]
        fields["BEHAVIOR"] = ErosionMode[getattr(mode, "name", mode)]
    return ErosionSettings(**fields)


def load_jax_store(save_dir: str, save_name: str = "default", version: str = "0",
                   device="cuda") -> PipelineStateManager:
    """The port's store over a save directory written by the reference's
    ``PipelineStateManager``, with every buffer of its manifest restored
    onto ``device``.  The files are read as they are: both packages write
    the same format."""
    sm = PipelineStateManager(save_dir, save_name, version, device=device)
    for name in sm.serde.directory.entries:
        sm.get_buffer(name)
    return sm
