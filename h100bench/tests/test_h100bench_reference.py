"""The reference (``h100bench/reference``) against the port's plain versions
on the CPU, at small sizes: every stage the cells' comparison covers gives
the same bits."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from h100bench.entries.common import pipeline_config, port_meta, port_settings
from h100bench.reference import pipeline as ref

CPU = torch.device("cpu")


@pytest.fixture
def configs(small_here):
    import json

    return {f.stem: json.loads(f.read_text()) for f in (small_here / "configs").glob("*.json")}


def _port_field(config, x, z):
    from noize_tpu_torch.ops.cuda.stencil import gauss_chain
    from noize_tpu_torch.ops.fractal import fractal

    f = config["field"]
    h = fractal(config["tile"]["generator_res"], x, z, noise_type=f["noise_type"],
                hurst=f["hurst"], octaves=f["octaves"], noise_size=f["noise_size"], device=CPU)
    return gauss_chain(h, f["blur_width"], f["blur_sigma"], f["blur_iterations"])


@pytest.mark.parametrize("name", ["example1_2048", "example2_1024"])
def test_field_and_flow(configs, name):
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused

    c = configs[name]
    got = _port_field(c, 1984, -3968)
    want = ref.field(c, 1984, -3968, device=CPU)
    assert torch.equal(got, want)
    assert torch.equal(flow_map_fused(got, c["field"]["flow_iterations"]), ref.flow(c, want))


def test_live_steps(configs):
    from noize_tpu_torch.erosion.sim import ErosionSim
    from noize_tpu_torch.ops.cuda.flow import flow_map_fused

    c = configs["example1_2048"]
    h = flow_map_fused(_port_field(c, 0, 0), c["field"]["flow_iterations"])
    sim = ErosionSim(h, settings=port_settings(c), meta=port_meta(c), seed=77, device=CPU)
    state = ref.sim_start(c, 0, 0, 77, device=CPU)
    assert torch.equal(sim.state.world.height, state.world.height)
    for _ in range(2):
        sim.step()
        state = ref.erode(state, c, sim.settings.CYCLES, tuned=True)
        for m in ("height", "pool", "flow", "track"):
            assert torch.equal(getattr(sim.state.world, m), getattr(state.world, m)), m
        assert torch.equal(sim.state.key, state.key)


def test_tile_step(configs):
    from noize_tpu_torch.app.flagship import make_tile_step
    from noize_tpu_torch.prng import PRNGKey, fold_in

    c = configs["example1_2048"]
    f = c["field"]
    step, meta, _ = make_tile_step(port_meta(c), port_settings(c), octaves=f["octaves"],
                                   noise_type=f["noise_type"], erosion_cycles=2,
                                   mesh_layout="arrays", device=CPU)
    key = fold_in(PRNGKey(5, device=CPU), 3)
    got = step(112, 0, key)
    want = ref.tile_step(c, 112, 0, key, 2, device=CPU)
    for k in ("height", "flow_velocity", "pool", "stream"):
        assert torch.equal(got[k], want[k]), k
    for k in ("positions", "normals", "tangents", "uvs", "indices"):
        assert torch.equal(getattr(got["mesh"], k), want["mesh"][k]), k


@pytest.mark.parametrize("cycles", [0, 1])
def test_tile_batch(configs, cycles):
    from noize_tpu_torch.parallel.tiled import tile_batch

    c = configs["example2_1024"]
    meta = port_meta(c)
    origins = np.asarray([meta.tile_origin((x, z)) for z in (3, 4) for x in (-1, 0)], np.int32)
    got = tile_batch(pipeline_config(c, erosion_cycles=cycles, emit_mesh=True), origins,
                     seed=9, device=CPU)
    want = ref.tile_batch(c, origins, 9, cycles, device=CPU)
    assert torch.equal(got["height"], want["height"])
    assert torch.equal(got["mesh_planes"], want["mesh"]["planes"])


def test_the_control_rounds_every_map(configs):
    c = configs["example1_2048"]
    want = ref.field(c, 0, 0, device=CPU)
    got = ref.field(c, 0, 0, device=CPU, cast=ref.to_bfloat16)
    assert torch.equal(got, got.to(torch.bfloat16).to(torch.float32))
    assert not torch.equal(got, want)

