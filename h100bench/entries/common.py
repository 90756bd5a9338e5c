"""What the entries share: the seed's draws and the port's objects for a
configuration."""

from __future__ import annotations

import numpy as np

#: tile coordinates a seed may start from, each way from the origin
SPREAD = 256


def rng_of(seed: int) -> np.random.Generator:
    """Every draw of a run comes from this generator: any whole number,
    negative or past 64 bits, is a seed."""
    return np.random.default_rng(seed % (1 << 64))


def start_tile(rng) -> tuple:
    return tuple(int(v) for v in rng.integers(-SPREAD, SPREAD, 2))


def sub_seed(rng) -> int:
    """A seed for the program's own ``PRNGKey``."""
    return int(rng.integers(0, 1 << 31))


def port_meta(config: dict):
    from noize_tpu_torch.core.tiles import TileSetMeta

    return TileSetMeta(**config["tile"]).validate()


def port_settings(config: dict):
    from noize_tpu_torch.erosion.params import ErosionSettings

    return ErosionSettings(**config["erosion"])


def pipeline_config(config: dict, *, erosion_cycles: int, emit_mesh: bool):
    """``parallel.tiled.TilePipelineConfig`` of a configuration."""
    from noize_tpu_torch.parallel.tiled import TilePipelineConfig

    f = config["field"]
    return TilePipelineConfig(
        meta=port_meta(config), noise_type=f["noise_type"], hurst=f["hurst"],
        octaves=f["octaves"], noise_size=f["noise_size"], blur_width=f["blur_width"],
        blur_sigma=f["blur_sigma"], blur_iterations=f["blur_iterations"],
        flow_iterations=f["flow_iterations"], erosion=port_settings(config),
        erosion_cycles=erosion_cycles, emit_mesh=emit_mesh)


def sync(device):
    import torch

    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
