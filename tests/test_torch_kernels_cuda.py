"""noize_tpu_torch CUDA kernels K1-K12 and the JAX-signature entries on
them against their plain PyTorch versions on the card.

Every test here needs an NVIDIA GPU (and nvcc to build the kernels); on a
machine without one each test skips with a reason.  Run them on the card
with:

    python -m pytest tests/test_torch_kernels_cuda.py -q

Tolerance: bit-equality.  The kernels are built with -fmad=false and sum in
the reference's order, and the plain versions run one rounded op at a time.
"""

import numpy as np
import pytest
import torch

from noize_tpu_torch.erosion import pool as PO
from noize_tpu_torch.erosion import pool_cuda as PC
from noize_tpu_torch.erosion.pool_cuda import pool_automata_cuda, pool_automata_full_cuda
from noize_tpu_torch.ops import flow as FL
from noize_tpu_torch.ops import kernels as KE
from noize_tpu_torch.ops import thermal as TH
from noize_tpu_torch.ops.blur import smooth_taps
from noize_tpu_torch.ops.cuda import flow as FC
from noize_tpu_torch.ops.cuda import stencil as SC
from noize_tpu_torch.ops.cuda import thermal as TC
from noize_tpu_torch.ops.cuda.flow import flow_map_fused, flow_map_pallas
from noize_tpu_torch.ops.cuda.stencil import (fused_separable_chain,
                                              fused_separable_chain_rows, gauss_chain,
                                              separable_chain, separable_chain_plain)
from noize_tpu_torch.ops.cuda.thermal import thermal_erosion_fused
from noize_tpu_torch.ops.kernels import gaussian_taps


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(rng, res, lo=0.0, hi=1.0):
    return rng.uniform(lo, hi, (res, res)).astype(np.float32)


def _equal(got, want):
    got = got.cpu().numpy()
    want = want.cpu().numpy()
    assert got.shape == want.shape
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("res,iters", [(64, 3), (1000, 2), (2048, 17)])
def test_k1_separable_chain_matches_plain(cuda, res, iters):
    x = torch.from_numpy(_field(np.random.default_rng(1), res)).to(cuda)
    before = separable_chain.launches
    got = gauss_chain(x, 5, 1.0, iters)
    want = separable_chain_plain(x, gaussian_taps(1.0, 5), iters)
    torch.cuda.synchronize()
    _equal(got, want)
    assert separable_chain.launches == before + 1


@pytest.mark.parametrize("res,iters", [(64, 3), (2048, 8)])
def test_k2_flow_map_matches_plain(cuda, res, iters):
    h = torch.from_numpy(_field(np.random.default_rng(2), res)).to(cuda)
    got = flow_map_fused(h, iters)
    want = FL.flow_map(h, iters)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.parametrize("res,talus,iters", [(64, 45.0, 2), (63, 55.0, 1),
                                             (2048, 55.0, 1)])
def test_k3_thermal_matches_plain(cuda, res, talus, iters):
    h = torch.from_numpy(_field(np.random.default_rng(3), res)).to(cuda)
    got = thermal_erosion_fused(h, talus, 0.6, 1.0, iters)
    want = TH.thermal_erosion(h, talus, 0.6, 1.0, iters)
    torch.cuda.synchronize()
    _equal(got, want)
    assert not torch.equal(got, h)


def _wet_calls():
    wet = pool_automata_cuda.wet_calls
    return 0 if wet is None else int(wet.item())


def _wet_case(res, seed):
    rng = np.random.default_rng(seed)
    h = _field(rng, res, 0.0, 0.5)
    p = rng.uniform(-0.05, 0.05, (res, res)).clip(0).astype(np.float32)
    return h, p


@pytest.mark.parametrize("res,drain", [(16, True), (128, True), (128, False),
                                       (2048, True)])
def test_k4_pool_wet_matches_plain(cuda, res, drain):
    h, p = _wet_case(res, 4)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    before = _wet_calls()
    gp, gd = pool_automata_cuda(h, p, 3, drain)
    wp, wd = PO.pool_automata(h, p, 3, drain)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert not torch.equal(gp, p)
    if drain:
        assert bool((gd > 0).any())
    assert _wet_calls() == before + 1


@pytest.mark.parametrize("res", [12, 128])
def test_pool_automata_quad_runs_k4(cuda, res):
    """erosion.pool.pool_automata_quad on CUDA tensors: one K4 launch,
    bit-equal to the plain pool_automata; a side that is not a multiple of
    4 raises before any launch."""
    h, p = _wet_case(res, 6)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    before = pool_automata_cuda.launches
    gp, gd = PO.pool_automata_quad(h, p, 3, True)
    wp, wd = PO.pool_automata(h, p, 3, True)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert pool_automata_cuda.launches == before + 1
    with pytest.raises(ValueError, match="multiple of 4"):
        PO.pool_automata_quad(h[:10, :10].contiguous(), p[:10, :10].contiguous(), 3, True)
    assert pool_automata_cuda.launches == before + 1


def test_k4_pool_dry_gate_is_fixed_point(cuda):
    rng = np.random.default_rng(5)
    h = torch.from_numpy(_field(rng, 256, 0.0, 0.5)).to(cuda)
    p = torch.from_numpy(
        rng.uniform(0, PO.MIN_WATER * 0.99, (256, 256)).astype(np.float32)).to(cuda)
    before = _wet_calls()
    gp, gd = pool_automata_cuda(h, p, 10, True)
    torch.cuda.synchronize()
    _equal(gp, p)
    assert not bool(gd.any())
    assert _wet_calls() == before


def test_wrappers_refuse_bad_input(cuda):
    x = torch.zeros((64, 64), dtype=torch.float64, device=cuda)
    with pytest.raises(ValueError, match="float32"):
        flow_map_fused(x, 2)
    with pytest.raises(ValueError, match="even"):
        z = torch.zeros((63, 63), device=cuda)
        PC.pool_automata_pallas_mega(z, z, 2, True)
    with pytest.raises(ValueError, match="square"):
        z = torch.zeros((64, 32), device=cuda)
        pool_automata_full_cuda(z, z, 2, True)
    with pytest.raises(ValueError, match="contiguous"):
        thermal_erosion_fused(torch.zeros((64, 64), device=cuda).t()[:, :], 45.0,
                              0.5, 1.0)


def _wet_calls_of(wrapper):
    wet = wrapper.wet_calls
    return 0 if wet is None else int(wet.item())


@pytest.mark.parametrize("res,drain", [(16, True), (17, True), (33, True), (33, False),
                                       (64, True)])
def test_k5_full_grid_wet_matches_plain(cuda, res, drain):
    h, p = _wet_case(res, 6)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    before = (pool_automata_full_cuda.launches, _wet_calls_of(pool_automata_full_cuda))
    gp, gd = pool_automata_full_cuda(h, p, 3, drain)
    wp, wd = PO._pool_automata_fullgrid(h, p, 3, drain)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert not torch.equal(gp, p)
    if drain:
        assert bool((gd > 0).any())
    assert (pool_automata_full_cuda.launches,
            _wet_calls_of(pool_automata_full_cuda)) == (before[0] + 1, before[1] + 1)


def test_odd_grid_runs_k5_through_pool_automata_cuda(cuda):
    h, p = _wet_case(33, 7)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    k4, k5 = pool_automata_cuda.launches, pool_automata_full_cuda.launches
    gp, gd = pool_automata_cuda(h, p, 2, True)
    wp, wd = PO.pool_automata(h, p, 2, True)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert (pool_automata_cuda.launches, pool_automata_full_cuda.launches) == (k4, k5 + 1)


@pytest.mark.parametrize("entry", PC.ENTRIES, ids=lambda e: e.__name__)
def test_pool_entries_match_plain(cuda, entry):
    h, p = _wet_case(64, 8)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    before = entry.launches
    gp, gd = entry(h, p, 2, True)
    plain = (PO._pool_automata_fullgrid if entry is PC.pool_automata_pallas
             else PO.pool_automata)
    wp, wd = plain(h, p, 2, True)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert entry.launches == before + 1


def test_pair_entry_gate_between_zero_and_min_water(cuda):
    """The reference's pair/quad entries gate on any(pool > 0), K4 on
    MIN_WATER: a grid whose maximum lies between them is a fixed point of
    both."""
    rng = np.random.default_rng(9)
    h = torch.from_numpy(_field(rng, 64, 0.0, 0.5)).to(cuda)
    p = torch.from_numpy(
        rng.uniform(0, PO.MIN_WATER * 0.9, (64, 64)).astype(np.float32)).to(cuda)
    for entry in (PC.pool_automata_pallas_pair, PC.pool_automata_pallas_quad):
        gp, gd = entry(h, p, 3, True)
        torch.cuda.synchronize()
        _equal(gp, p)
        assert not bool(gd.any())


def test_stencil_and_flow_entries_match_plain(cuda):
    x = torch.from_numpy(_field(np.random.default_rng(10), 256)).to(cuda)
    taps = gaussian_taps(1.0, 5)
    want = separable_chain_plain(x, taps, 4)
    for entry in (fused_separable_chain, fused_separable_chain_rows):
        before = entry.launches
        got = entry(x, taps, 4)
        torch.cuda.synchronize()
        _equal(got, want)
        assert entry.launches == before + 1
    before = flow_map_pallas.launches
    got = flow_map_pallas(x, 3)
    want = FL.flow_map(x, 3)
    torch.cuda.synchronize()
    _equal(got, want)
    assert flow_map_pallas.launches == before + 1


# --- K4 and K5 tiled: sizes around the 64² tile, seams, borders, remainders --

def _seam_case(res, seed):
    """Water in bands 4 cells either side of every multiple of 32 in both
    axes (so across every tile seam) and on the diagonal; dry cells between,
    so drains fire at the band edges."""
    rng = np.random.default_rng(seed)
    h = _field(rng, res, 0.0, 0.5)
    z, x = np.meshgrid(np.arange(res), np.arange(res), indexing="ij")
    band = ((z + 4) % 32 < 8) | ((x + 4) % 32 < 8) | (np.abs(z - x) < 3)
    p = rng.uniform(-0.05, 0.05, (res, res)).clip(0).astype(np.float32)
    return h, np.where(band, p, np.float32(0))


def _border_case(res, seed):
    """Water only on the four border bands: every SafeIdx self-return path
    carries volume."""
    rng = np.random.default_rng(seed)
    h = _field(rng, res, 0.0, 0.5)
    p = np.zeros((res, res), np.float32)
    for sl in (np.s_[:2, :], np.s_[-2:, :], np.s_[:, :2], np.s_[:, -2:]):
        p[sl] = rng.uniform(0, 0.05, p[sl].shape).astype(np.float32)
    return h, p


def _check_tiled(cuda, wrapper, plain, case, res, iters, drain):
    h, p = case(res, res + iters)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    before = (wrapper.launches, _wet_calls_of(wrapper))
    gp, gd = wrapper(h, p, iters, drain)
    wp, wd = plain(h, p, iters, drain)
    torch.cuda.synchronize()
    _equal(gp, wp)
    _equal(gd, wd)
    assert not torch.equal(gp, p)
    if drain:
        assert bool((gd > 0).any())
    else:
        assert not bool(gd.any())
    assert (wrapper.launches, _wet_calls_of(wrapper)) == (before[0] + 1, before[1] + 1)


@pytest.mark.parametrize("drain", [True, False])
@pytest.mark.parametrize("iters", [1, 3, 10, 11])
@pytest.mark.parametrize("res", [16, 64, 66, 130, 1000])
def test_k4_tiled_seams_match_plain(cuda, res, iters, drain):
    _check_tiled(cuda, pool_automata_cuda, PO.pool_automata, _seam_case, res, iters, drain)


@pytest.mark.parametrize("drain", [True, False])
@pytest.mark.parametrize("iters", [1, 3, 10, 11])
@pytest.mark.parametrize("res", [16, 17, 33, 64, 66, 130, 1000, 1025, 2049])
def test_k5_tiled_seams_match_plain(cuda, res, iters, drain):
    _check_tiled(cuda, pool_automata_full_cuda, PO._pool_automata_fullgrid, _seam_case, res,
                 iters, drain)


@pytest.mark.parametrize("kernel,res", [("K4", 64), ("K4", 66), ("K5", 65), ("K5", 130)])
def test_pool_tiled_borders_match_plain(cuda, kernel, res):
    wrapper, plain = ((pool_automata_cuda, PO.pool_automata) if kernel == "K4"
                      else (pool_automata_full_cuda, PO._pool_automata_fullgrid))
    _check_tiled(cuda, wrapper, plain, _border_case, res, 11, True)


def test_pool_iterations_zero_copies_pool(cuda):
    h, p = _seam_case(66, 1)
    h = torch.from_numpy(h).to(cuda)
    p = torch.from_numpy(p).to(cuda)
    for wrapper in (pool_automata_cuda, pool_automata_full_cuda):
        gp, gd = wrapper(h, p, 0, True)
        torch.cuda.synchronize()
        _equal(gp, p)
        assert not bool(gd.any())


# --- K1 and K2 tiled: tap counts, shapes around the tile, launch boundaries --

def _map(shape, seed):
    """Uniform noise with steps on rows and columns 3 cells either side of
    every multiple of 31 and 32 (K1's and K2's tile edges at the default
    plans fall on or near them), so structure crosses every tile seam."""
    rng = np.random.default_rng(seed)
    z, x = np.meshgrid(np.arange(shape[0]), np.arange(shape[1]), indexing="ij")
    band = ((z + 3) % 32 < 6) | ((x + 3) % 31 < 6)
    a = rng.uniform(0, 1, shape) + np.where(band, 0.5, 0.0)
    return a.astype(np.float32)


def _check_chain(cuda, x, taps, iters):
    x = torch.from_numpy(x).to(cuda)
    before = separable_chain.launches
    got = separable_chain(x, taps, iters)
    want = separable_chain_plain(x, taps, iters)
    torch.cuda.synchronize()
    _equal(got, want)
    assert separable_chain.launches == before + 1


@pytest.mark.parametrize("kind", ["gauss", "box"])
@pytest.mark.parametrize("k", range(1, 26, 2))
def test_k1_every_tap_count_matches_plain(cuda, k, kind):
    taps = gaussian_taps(1.5, k) if kind == "gauss" else smooth_taps(k)
    _check_chain(cuda, _map((300, 257), k), taps, 7)


@pytest.mark.parametrize("shape", [(1, 2048), (2048, 1), (37, 1000), (2047, 2049), (1, 1),
                                   (5, 3), (63, 64), (64, 65)])
def test_k1_shapes_match_plain(cuda, shape):
    _check_chain(cuda, _map(shape, sum(shape)), gaussian_taps(1.0, 5), 17)


@pytest.mark.parametrize("iters", [0, 1, 4, 5, 6, 17, 32])
def test_k1_iteration_counts_match_plain(cuda, iters):
    """m = 5 iterations a launch at k = 5: 4, 5 and 6 sit on the first
    launch boundary, 17 and 32 cross several."""
    assert SC.chain_plan(5, 5).launches == (5,) and SC.chain_plan(5, 6).launches == (3, 3)
    _check_chain(cuda, _map((200, 300), iters), gaussian_taps(1.0, 5), iters)


@pytest.mark.parametrize("k,iters", [(3, 32), (25, 3), (1, 32)])
def test_k1_seams_match_plain(cuda, k, iters):
    _check_chain(cuda, _map((1000, 1000), k), smooth_taps(k), iters)


def _check_flow(cuda, res, iters, norm_min=-0.1, norm_max=0.1):
    h = torch.from_numpy(_map((res, res), res + iters)).to(cuda)
    before = (flow_map_fused.launches, flow_map_pallas.launches)
    got = flow_map_fused(h, iters, norm_min, norm_max)
    want = FL.flow_map(h, iters, norm_min, norm_max)
    torch.cuda.synchronize()
    _equal(got, want)
    assert (flow_map_fused.launches, flow_map_pallas.launches) == (before[0] + 1, before[1])
    return got


@pytest.mark.parametrize("iters", [0, 1, 4, 5, 8, 9, 17, 128])
def test_k2_iteration_counts_match_plain(cuda, iters):
    """m = 4 iterations a launch: 5 and more cross launch boundaries (from
    three launches on the carried state ping-pongs), 128 is the stage's
    maximum (32 launches)."""
    assert FC.flow_plan(4).launches == (4,) and FC.flow_plan(5).launches == (3, 2)
    _check_flow(cuda, 300, iters)


@pytest.mark.parametrize("res", [1, 2, 63, 65, 1000, 2049])
def test_k2_sizes_match_plain(cuda, res):
    _check_flow(cuda, res, 8)


def test_k2_degenerate_norm_range_matches_plain(cuda):
    """norm_min == norm_max: the rng < 1e-12 guard zeroes the velocity and
    the normalise divides by zero, on both sides alike."""
    got = _check_flow(cuda, 130, 5, 0.05, 0.05)
    assert bool(torch.isinf(got).all())


# --- K3 tiled: sizes around the tile, launch boundaries, seams, talus -------

def _check_thermal(cuda, res, iters, talus=55.0, seed=0):
    """K3 on ``_map``'s field (steps across every multiple of 31 and 32, so
    across every seam of K3's tiles) against the plain version."""
    h = torch.from_numpy(_map((res, res), seed)).to(cuda)
    before = thermal_erosion_fused.launches
    got = thermal_erosion_fused(h, talus, 0.6, 1.0, iters)
    want = TH.thermal_erosion(h, talus, 0.6, 1.0, iters)
    torch.cuda.synchronize()
    _equal(got, want)
    assert thermal_erosion_fused.launches == before + 1
    # below 4 rows no anchor is valid; 0 iterations is a copy
    assert torch.equal(got, h) == (res < 4 or iters == 0)
    assert got.data_ptr() != h.data_ptr()


@pytest.mark.parametrize("res", [1, 2, 3, 5, 63, 64, 127, 1000, 1025, 2048, 2049])
def test_k3_sizes_match_plain(cuda, res):
    """1-127 lie below one 128² tile; 1000 to 2049 cross many seams."""
    _check_thermal(cuda, res, 1, seed=res)


@pytest.mark.parametrize("iters", [0, 1, 2, TC.PER_LAUNCH, TC.PER_LAUNCH + 1, 32])
def test_k3_iteration_counts_match_plain(cuda, iters):
    """M + 1 and 32 cross launch boundaries (through the scratch map)."""
    _check_thermal(cuda, 300, iters, seed=iters)


@pytest.mark.parametrize("res", [5, 63, 130])
def test_k3_small_maps_across_launches_match_plain(cuda, res):
    _check_thermal(cuda, res, TC.PER_LAUNCH + 1, seed=res + 1)


@pytest.mark.parametrize("talus", [1.0, 45.0, 89.0])
def test_k3_talus_matches_plain(cuda, talus):
    _check_thermal(cuda, 257, 2, talus=talus, seed=int(talus))


# --- K1 with distinct X / Z taps and a factor: the kernel filters ----------

FILTER_TAPS = {
    "Smooth3": (KE._SMOOTH3, KE._SMOOTH3, KE._SMOOTH3_FACTOR),
    "Sobel3Horizontal": (KE._SOBEL3_HX, KE._SOBEL3_HZ, 1.0),
    "Sobel3Vertical": (KE._SOBEL3_VX, KE._SOBEL3_VZ, 1.0),
    "Prewitt3Horizontal": (KE._PREWITT3_HX, KE._PREWITT3_HZ, 1.0),
    "Prewitt3Vertical": (KE._PREWITT3_VX, KE._PREWITT3_VZ, 1.0),
}


def _check_filter_chain(cuda, x, tx, tz, factor, iters):
    x = torch.from_numpy(x).to(cuda)
    before = separable_chain.launches
    got = separable_chain(x, tx, iters, taps_z=tz, factor=factor)
    want = separable_chain_plain(x, tx, iters, taps_z=tz, factor=factor)
    torch.cuda.synchronize()
    _equal(got, want)
    assert separable_chain.launches == before + 1


@pytest.mark.parametrize("name", sorted(FILTER_TAPS))
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("shape", [(64, 64), (300, 257), (2049, 2049)])
def test_k1_filter_taps_match_plain(cuda, name, iters, shape):
    """A swapped or unflipped tap list passes for Gauss taps and fails
    here: Sobel/Prewitt are asymmetric, and the Z pass flips its taps."""
    tx, tz, factor = FILTER_TAPS[name]
    _check_filter_chain(cuda, _map(shape, iters), tx, tz, factor, iters)


@pytest.mark.parametrize("tx,tz,factor,iters", [
    (gaussian_taps(1.0, 5), KE._SOBEL3_HZ, 0.5, 7),
    (KE._PREWITT3_VX, gaussian_taps(2.0, 9), 1.0, 4),
    (smooth_taps(25), KE._SOBEL3_VZ, 2.0, 2),
])
def test_k1_unequal_tap_lengths_match_plain(cuda, tx, tz, factor, iters):
    _check_filter_chain(cuda, _map((1000, 1000), iters), tx, tz, factor, iters)


@pytest.mark.parametrize("filter_type", KE.KERNEL_FILTER_TYPES)
def test_kernel_filter_on_k1_matches_cpu(cuda, filter_type):
    """``kernel_filter`` on the card (K1, Sobel3_2D one K1@rss launch an
    iteration) against the port on the CPU, bit for bit."""
    a = _map((256, 256), 5)
    before = (separable_chain.launches, SC.root_sum_squares_chain.launches)
    got = KE.kernel_filter(torch.from_numpy(a).to(cuda), filter_type, 2)
    want = KE.kernel_filter(torch.from_numpy(a), filter_type, 2)
    torch.cuda.synchronize()
    _equal(got, want)
    rss = filter_type == "Sobel3_2D"
    assert (separable_chain.launches, SC.root_sum_squares_chain.launches) == (
        before[0] + (0 if rss else 1), before[1] + (2 if rss else 0))


# --- K1@short and K1@rss: every filter, shapes around the small tile --------

SHORT_SHAPES = [(64, 64), (300, 257), (2049, 2049), (1, 2048), (2048, 1), (3, 300, 257)]


def _short_input(shape, seed):
    if len(shape) == 3:
        return torch.from_numpy(_stack(shape[1:], shape[0], seed))
    return torch.from_numpy(_map(shape, seed))


@pytest.mark.parametrize("shape", SHORT_SHAPES, ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("iters", [1, 2, 3])
@pytest.mark.parametrize("name", KE.KERNEL_FILTER_TYPES)
def test_k1_short_and_rss_match_plain(cuda, name, iters, shape):
    """K1@short (``short_chain``, one launch a call at any of these halos)
    with each filter's taps, and K1@rss (Sobel3_2D, one launch an
    iteration), bit-equal to their plain versions; ``separable_chain``
    routes the short chains to K1@short."""
    x = _short_input(shape, iters + len(shape))
    xc = x.to(cuda)
    if name == "Sobel3_2D":
        taps = ((KE._SOBEL3_HX, KE._SOBEL3_HZ), (KE._SOBEL3_VX, KE._SOBEL3_VZ))
        want = xc
        for _ in range(iters):
            want = SC.root_sum_squares_chain_plain(want, *taps)
        before = SC.root_sum_squares_chain.launches
        got = KE.kernel_filter(xc, name, iters)
        torch.cuda.synchronize()
        _equal(got, want)
        assert SC.root_sum_squares_chain.launches == before + iters
        return
    tx, tz, factor = KE._SERIES_TABLE[name]
    want = separable_chain_plain(xc, tx, iters, taps_z=tz, factor=factor)
    before = SC.short_chain.launches
    got = SC.short_chain(xc, tx, iters, taps_z=tz, factor=factor)
    torch.cuda.synchronize()
    _equal(got, want)
    assert SC.short_chain.launches == before + 1
    if SC.chain_route(len(tx), iters) == "short":
        before = (SC.short_chain.launches, SC.tile_chain.launches)
        _equal(separable_chain(xc, tx, iters, taps_z=tz, factor=factor), want)
        assert (SC.short_chain.launches, SC.tile_chain.launches) == (before[0] + 1, before[1])


@pytest.mark.parametrize("k,iters", [(1, 32), (3, 8), (5, 4), (17, 1), (3, 12), (9, 3)])
def test_k1_short_halos_match_plain(cuda, k, iters):
    """K1@short at the largest halo the route gives it (8) and beyond it
    (12), where the window takes more than 48 KB, and at 1 and 17 taps."""
    taps = smooth_taps(k)
    x = torch.from_numpy(_map((1000, 999), k + iters)).to(cuda)
    before = SC.short_chain.launches
    got = SC.short_chain(x, taps, iters)
    want = separable_chain_plain(x, taps, iters)
    torch.cuda.synchronize()
    _equal(got, want)
    assert SC.short_chain.launches == before + 1


@pytest.mark.parametrize("algorithm", ["SOBEL", "PREWITT"])
@pytest.mark.parametrize("shape", SHORT_SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_edge_2d_on_k1_rss_matches_cpu(cuda, algorithm, shape):
    """``edge.edge_2d`` on the card: one K1@rss launch, no other device
    operation, bit-equal to the port on the CPU."""
    from noize_tpu_torch.ops import edge as ED

    x = _short_input(shape, 7)
    before = (SC.root_sum_squares_chain.launches, separable_chain.launches)
    got = ED.edge_2d(x.to(cuda), algorithm)
    want = ED.edge_2d(x, algorithm)
    torch.cuda.synchronize()
    _equal(got, want)
    assert (SC.root_sum_squares_chain.launches, separable_chain.launches) == (
        before[0] + 1, before[1])


def test_k1_rss_root_specials_match_plain(cuda):
    """``__fsqrt_rn`` against the plain version's float64 root: values from
    1e-30 to 1e30 put the sums of squares in every binade and past the
    largest float (inf), rows of values below 1e-21 among the subnormals;
    an inf and a NaN cell give NaN; zero rows give 0.  Then ``f32.sqrt`` on the card against NumPy's
    correctly rounded float32 root on the specials themselves."""
    from noize_tpu_torch.ops import f32

    rng = np.random.default_rng(3)
    a = (10.0 ** rng.uniform(-30, 30, (300, 257))).astype(np.float32)
    a *= np.where(rng.uniform(0, 1, a.shape) < 0.5, -1, 1).astype(np.float32)
    a[10:14] = 0.0
    a[20:24] = rng.uniform(-1e-21, 1e-21, (4, 257)).astype(np.float32)  # subnormal sums
    a[100, 100], a[200, 50] = np.inf, np.nan
    x = torch.from_numpy(a).to(cuda)
    taps = ((KE._SOBEL3_HX, KE._SOBEL3_HZ), (KE._SOBEL3_VX, KE._SOBEL3_VZ))
    got = SC.root_sum_squares_chain(x, *taps)
    want = SC.root_sum_squares_chain_plain(x, *taps)
    torch.cuda.synchronize()
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert np.isinf(g).any() and np.isnan(g).any() and (g == 0).any()
    assert ((g > 0) & (g < np.sqrt(np.finfo(np.float32).tiny))).any()  # of subnormal sums
    np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    ok = ~np.isnan(w)
    np.testing.assert_array_equal(g[ok].view(np.uint32), w[ok].view(np.uint32))
    tiny = np.finfo(np.float32).smallest_subnormal
    s = np.array([0.0, -0.0, tiny, 3 * tiny, np.finfo(np.float32).tiny, 2.0,
                  np.finfo(np.float32).max, np.inf, -1.0, np.nan], np.float32)
    with np.errstate(invalid="ignore"):
        ref = np.sqrt(s)
    r = f32.sqrt(torch.from_numpy(s).to(cuda)).cpu().numpy()
    np.testing.assert_array_equal(np.isnan(r), np.isnan(ref))
    np.testing.assert_array_equal(r[~np.isnan(ref)].view(np.uint32),
                                  ref[~np.isnan(ref)].view(np.uint32))


def test_threefry_on_card_matches_cpu(cuda):
    from noize_tpu_torch import prng

    for seed in (0, 42):
        kc, kh = prng.PRNGKey(seed, device=cuda), prng.PRNGKey(seed, device="cpu")
        _equal(prng.split(kc, 3), prng.split(kh, 3))
        _equal(prng.fold_in(kc, 9), prng.fold_in(kh, 9))
        _equal(prng.randint(kc, (100_003,), -7, 2049), prng.randint(kh, (100_003,), -7, 2049))


@pytest.mark.parametrize("name", ["PerlinGenerator", "FlowMap", "Sobel"])
def test_preset_fuse_equals_run_on_card(cuda, name):
    from noize_tpu_torch.app import presets
    from noize_tpu_torch.core.stageio import GeneratorData
    from noize_tpu_torch.pipeline.compose import fuse
    from noize_tpu_torch.pipeline.driver import Pipeline

    stages = presets.ALL[name].stages
    data = None if name != "Sobel" else torch.from_numpy(_map((256, 256), 3)).to(cuda)
    run = Pipeline(list(stages)).run(
        GeneratorData(uuid=name, resolution=256, xpos=64, zpos=0, data=data)).data
    fused = fuse(stages, 256)(data, 64, 0)
    torch.cuda.synchronize()
    assert fused.device.type == "cuda"
    _equal(fused, run)


# --- K1 and K2 on a stack of maps [T, R, C]: the batch is blockIdx.z --------

def _stack(shape, t, seed):
    """T maps of very different content (each its own banded noise, scaled
    and offset by its index), so a block that read a neighbour map's rows
    or columns would show."""
    return np.stack([_map(shape, seed + i) * np.float32(1 + 7 * i) + np.float32(50 * i)
                     for i in range(t)]).astype(np.float32)


@pytest.mark.parametrize("t", [1, 3, 16])
@pytest.mark.parametrize("shape", [(64, 64), (65, 65), (37, 100), (300, 257)])
def test_k1_stack_matches_2d_and_plain(cuda, t, shape):
    x = torch.from_numpy(_stack(shape, t, t + shape[0])).to(cuda)
    taps = gaussian_taps(1.0, 5)
    before = separable_chain.launches
    got = separable_chain(x, taps, 17)
    assert separable_chain.launches == before + 1
    want = separable_chain_plain(x, taps, 17)
    torch.cuda.synchronize()
    _equal(got, want)
    for i in range(t):
        _equal(got[i], separable_chain(x[i].contiguous(), taps, 17))


@pytest.mark.parametrize("name", ["Sobel3Horizontal", "Prewitt3Vertical"])
def test_k1_stack_filter_taps_match_plain(cuda, name):
    tx, tz, factor = FILTER_TAPS[name]
    x = torch.from_numpy(_stack((130, 97), 3, 4)).to(cuda)
    got = separable_chain(x, tx, 3, taps_z=tz, factor=factor)
    want = separable_chain_plain(x, tx, 3, taps_z=tz, factor=factor)
    torch.cuda.synchronize()
    _equal(got, want)


@pytest.mark.parametrize("t", [1, 3, 16])
@pytest.mark.parametrize("res,iters", [(64, 8), (65, 9), (300, 8), (97, 0)])
def test_k2_stack_matches_2d_and_plain(cuda, t, res, iters):
    """8 iterations are two launches (one carry set), 9 three (the carry
    ping-pongs), 0 one launch of 0."""
    h = torch.from_numpy(_stack((res, res), t, t + res)).to(cuda)
    before = flow_map_fused.launches
    got = flow_map_fused(h, iters)
    assert flow_map_fused.launches == before + 1
    want = FL.flow_map(h, iters)
    torch.cuda.synchronize()
    _equal(got, want)
    for i in range(t):
        _equal(got[i], flow_map_fused(h[i].contiguous(), iters))


def test_stack_wrappers_refuse_bad_input(cuda):
    with pytest.raises(ValueError, match="stack"):
        separable_chain(torch.zeros((2, 2, 8, 8), device=cuda), gaussian_taps(1.0, 5), 1)
    with pytest.raises(ValueError, match="stack"):
        separable_chain(torch.zeros((0, 8, 8), device=cuda), gaussian_taps(1.0, 5), 1)
    with pytest.raises(ValueError, match="stack"):
        flow_map_fused(torch.zeros((2, 3, 8, 9), device=cuda), 2)
    with pytest.raises(ValueError, match="2-D"):
        thermal_erosion_fused(torch.zeros((3, 8, 8), device=cuda), 45.0, 0.5, 1.0)


def test_job_handler_tracks_card_work(cuda):
    """``utils.tracking.StandAloneJobHandler`` on CUDA tensors: an event on
    the current stream; complete once the card has passed it."""
    from noize_tpu_torch.utils.tracking import StandAloneJobHandler

    x = torch.from_numpy(_map((1024, 1024), 1)).to(cuda)
    h = StandAloneJobHandler()
    state = {"y": gauss_chain(x, 5, 1.0, 17)}
    assert h.track_job(state) and h.is_running
    assert h.wait() is state and not h.is_running
    h.track_job(state)
    torch.cuda.synchronize()
    assert h.job_complete() and h.close_job() and not h.is_running


@pytest.mark.parametrize("shape,t,iters", [((37, 100), 1, 8), ((300, 257), 3, 9),
                                           ((1, 64), 1, 2), ((96, 33), 2, 0)])
def test_k2_non_square_matches_plain(cuda, shape, t, iters):
    """K2 on rows != cols (the sharded flow map's extended blocks)."""
    h = torch.from_numpy(_stack(shape, t, 7)).to(cuda)
    h = h[0].contiguous() if t == 1 else h
    got = flow_map_fused(h, iters)
    want = FL.flow_map(h, iters)
    torch.cuda.synchronize()
    _equal(got, want)


def _windows(res, nx, ny, halo):
    """The blocks of an nx × ny split of a res² grid, each extended by
    ``halo`` toward its neighbours only: (window slices, core slices within
    the window, block slices)."""
    lr, lc = res // nx, res // ny
    out = []
    for i in range(nx):
        for j in range(ny):
            r0, c0 = i * lr, j * lc
            er0, ec0 = max(0, r0 - halo), max(0, c0 - halo)
            er1, ec1 = min(res, r0 + lr + halo), min(res, c0 + lc + halo)
            out.append(((slice(er0, er1), slice(ec0, ec1)),
                        (slice(r0 - er0, r0 - er0 + lr), slice(c0 - ec0, c0 - ec0 + lc)),
                        (slice(r0, r0 + lr), slice(c0, c0 + lc))))
    return out


@pytest.mark.parametrize("res,nx,ny,iters", [(64, 2, 2, 1), (64, 4, 1, 2), (130, 2, 5, 1),
                                             (2048, 2, 2, 1), (96, 3, 2, 5)])
def test_k3_windows_stitch_to_full_grid(cuda, res, nx, ny, iters):
    """K3 on each block of a split, extended 8 cells an iteration toward its
    neighbours with the grid's origin, cropped and stitched: the full-grid
    K3 call, bit for bit (the sharded thermal erosion's scheme); windows at
    the grid's edges equal the plain window version."""
    h = torch.from_numpy(_field(np.random.default_rng(res + nx), res)).to(cuda)
    want = thermal_erosion_fused(h, 55.0, 0.6, 1.0, iters)
    got = torch.empty_like(h)
    before = TC.thermal_erosion_fused.launches
    for win, core, block in _windows(res, nx, ny, 8 * iters):
        ext = h[win].contiguous()
        origin = (win[0].start, win[1].start)
        out = TC.thermal_erosion_window(ext, 55.0, 0.6, 1.0, iters, origin, res)
        got[block] = out[core]
    assert TC.thermal_erosion_fused.launches == before + nx * ny
    torch.cuda.synchronize()
    _equal(got, want)
    whole = TC.thermal_erosion_window(h, 55.0, 0.6, 1.0, iters, (0, 0), res)
    _equal(whole, TH.thermal_erosion_window(h, 55.0, 0.6, 1.0, iters, (0, 0), res))


def _piles_case(res, cells, vols, seed):
    rng = np.random.default_rng(seed)
    h = rng.uniform(0.2, 0.8, (res, res)).astype(np.float32)
    piles = np.zeros((res, res), np.float32)
    for (r, c), v in zip(cells, vols):
        piles[r, c] = v
    return h, piles


@pytest.mark.parametrize("radius", [4, 15])
@pytest.mark.parametrize("res", [256, 255])
def test_k6_exact_piles_matches_plain(cuda, radius, res):
    """Overlapping piles and piles at the border, several sweeps each;
    one launch a call."""
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE

    cells = [(100, 100), (101, 103), (104, 98), (99, 106), (0, 7), (res - 1, res - 1),
             (50, 0), (200, 201)]
    vols = [0.05, 0.3, 0.02, 0.12, 0.04, 0.2, 0.08, 0.5]
    h, piles = _piles_case(res, cells, vols, radius)
    hd, pd = torch.from_numpy(h).to(cuda), torch.from_numpy(piles).to(cuda)
    before = PL.exact_piles.launches
    got = PL.exact_piles(hd, pd, 1e-3, radius)
    assert PL.exact_piles.launches == before + 1
    want = SE.exact_pile_deposit_plain(hd, pd, 1e-3, radius)
    torch.cuda.synchronize()
    _equal(got, want)
    _equal(got.cpu(), SE.exact_pile_deposit_plain(torch.from_numpy(h), torch.from_numpy(piles),
                                                  1e-3, radius))
    assert not torch.equal(got, hd)


def test_k6_more_piles_than_kept_with_ties(cuda):
    """150 candidate piles in 4 tied volume levels: the 64 largest, ties to
    the lower cell index, in cell order."""
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE

    rng = np.random.default_rng(9)
    flat = rng.choice(512 * 512, 150, replace=False)
    cells = [(int(f) // 512, int(f) % 512) for f in flat]
    vols = list(np.float32(0.01) * rng.integers(1, 5, 150).astype(np.float32))
    h, piles = _piles_case(512, cells, vols, 3)
    hd, pd = torch.from_numpy(h).to(cuda), torch.from_numpy(piles).to(cuda)
    got = PL.exact_piles(hd, pd, 1e-3, 15)
    want = SE.exact_pile_deposit_plain(hd, pd, 1e-3, 15)
    torch.cuda.synchronize()
    _equal(got, want)
    vols_d, idxs_d = SE.select_piles(pd)
    vols_c, idxs_c = SE.select_piles(torch.from_numpy(piles))
    assert torch.equal(idxs_d.cpu(), idxs_c) and torch.equal(vols_d.cpu(), vols_c)


def test_k6_no_piles_and_refusals(cuda):
    from noize_tpu_torch.erosion import pile_cuda as PL

    h = torch.rand((64, 64), device=cuda)
    _equal(PL.exact_piles(h, torch.zeros_like(h), 1e-3, 15), h)
    with pytest.raises(ValueError, match="radius"):
        PL.exact_piles(h, torch.zeros_like(h), 1e-3, PL.MAX_RADIUS + 1)
    with pytest.raises(ValueError, match="increment"):
        PL.exact_piles(h, torch.zeros_like(h), 0.0, 4)


def _k5_stitch(window_fn, h, p, res, nx, ny, iters, drain=True):
    """A water step a call of ``window_fn`` (K5's window entry or its plain
    version) on each block of an nx × ny split extended 8 cells toward its
    neighbours, the drains carried in, the blocks stitched after each
    step: the sharded pool's scheme on one device."""
    got_p, got_d = p.clone(), torch.zeros_like(p)
    for _ in range(iters):
        new_p, new_d = got_p.clone(), got_d.clone()
        for win, core, block in _windows(res, nx, ny, 8):
            op, od = window_fn(h[win].contiguous(), got_p[win].contiguous(),
                               got_d[win].contiguous(), 1, drain,
                               (win[0].start, win[1].start), res)
            new_p[block], new_d[block] = op[core], od[core]
        got_p, got_d = new_p, new_d
    return got_p, got_d


@pytest.mark.parametrize("res,nx,ny", [(64, 2, 2), (64, 4, 1), (66, 3, 2), (99, 3, 3),
                                       (2048, 2, 2), (2048, 4, 1), (2049, 3, 3)])
def test_k5_window_stitches_to_full_grid(cuda, res, nx, ny):
    """K5 on the blocks of a split (odd window origins at 66 = 3 × 2 and
    99 = 3 × 3, non-square windows), one launch a water step with the
    drains carried in: the full-grid K5 call and the plain windows, bit
    for bit."""
    rng = np.random.default_rng(res + nx)
    h = torch.from_numpy(_field(rng, res)).to(cuda)
    p = torch.from_numpy(rng.uniform(-0.3, 0.1, (res, res)).clip(0).astype(np.float32)).to(cuda)
    want_p, want_d = pool_automata_full_cuda(h, p, 3, True)
    before = PC.pool_automata_window.launches
    got_p, got_d = _k5_stitch(PC.pool_automata_window, h, p, res, nx, ny, 3)
    assert PC.pool_automata_window.launches == before + 3 * nx * ny
    plain_p, plain_d = _k5_stitch(PO._pool_automata_window, h, p, res, nx, ny, 3)
    torch.cuda.synchronize()
    assert not torch.equal(want_p, p)
    for got, want in ((got_p, want_p), (got_d, want_d), (plain_p, want_p), (plain_d, want_d)):
        _equal(got, want)


@pytest.mark.parametrize("origin,shape,iters", [((0, 0), (130, 130), 3), ((7, 33), (90, 61), 2),
                                                ((1, 0), (129, 130), 1)])
def test_k5_window_matches_plain_with_drains_carried_in(cuda, origin, shape, iters):
    """One call of several water steps on a window of a 130² grid, with
    nonzero drains coming in: equal to the plain window on every cell that
    is not within 8 a step of an inner window edge (the whole window when
    it is the grid)."""
    res = 130
    rng = np.random.default_rng(sum(origin) + iters)
    rows, cols = shape
    h = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.uniform(-0.3, 0.1, shape).clip(0).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.uniform(0, 0.01, shape).astype(np.float32)).to(cuda)
    got = PC.pool_automata_window(h, p, d, iters, True, origin, res)
    want = PO._pool_automata_window(h, p, d, iters, True, origin, res)
    torch.cuda.synchronize()
    m = 8 * iters
    r0 = 0 if origin[0] == 0 else m
    c0 = 0 if origin[1] == 0 else m
    r1 = rows if origin[0] + rows == res else rows - m
    c1 = cols if origin[1] + cols == res else cols - m
    for g, w in zip(got, want):
        _equal(g[r0:r1, c0:c1], w[r0:r1, c0:c1])
    assert not torch.equal(got[1], d)  # drains were added onto the carried sum
    with pytest.raises(ValueError, match="leaves"):
        PC.pool_automata_window(h, p, d, 1, True, (res - rows + 1, 0), res)


def _k5_group_stitch(h, p, res, nx, ny, iters, group):
    """The sharded pool's schedule on one card: each block of an nx × ny
    split extended 8 cells a step of a group toward its neighbours, one K5
    window call a group of ``group`` water steps with the drains carried
    in, the blocks stitched after each group."""
    got_p, got_d = p.clone(), torch.zeros_like(p)
    for done in range(0, iters, group):
        new_p, new_d = got_p.clone(), got_d.clone()
        for win, core, block in _windows(res, nx, ny, 8 * group):
            op, od = PC.pool_automata_window(h[win].contiguous(), got_p[win].contiguous(),
                                             got_d[win].contiguous(), min(group, iters - done),
                                             True, (win[0].start, win[1].start), res)
            new_p[block], new_d[block] = op[core], od[core]
        got_p, got_d = new_p, new_d
    return got_p, got_d


@pytest.mark.parametrize("res,nx,ny,iters,group", [
    (2048, 2, 2, 10, 10), (2048, 4, 1, 10, 10), (2049, 3, 3, 10, 10), (2048, 2, 2, 10, 4),
    (64, 4, 1, 3, 3), (66, 3, 2, 5, 2), (99, 3, 3, 10, 10), (130, 2, 5, 7, 7)])
def test_k5_window_groups_stitch_to_full_grid(cuda, res, nx, ny, iters, group):
    """K5 on the blocks of a split, one call a group of water steps on a
    halo of 8 cells a step (64 = 4 × 1 at 3 steps: the 24-cell halo spans
    three neighbour blocks), each step computing only the tiles that can
    still be exact: the full-grid K5 call, pool and drains bit for
    bit, in ceil(iters / group) calls a block."""
    rng = np.random.default_rng(res + nx + group)
    h = torch.from_numpy(_field(rng, res)).to(cuda)
    p = torch.from_numpy(rng.uniform(-0.3, 0.1, (res, res)).clip(0).astype(np.float32)).to(cuda)
    want_p, want_d = pool_automata_full_cuda(h, p, iters, True)
    before = PC.pool_automata_window.launches
    got_p, got_d = _k5_group_stitch(h, p, res, nx, ny, iters, group)
    assert PC.pool_automata_window.launches == before + -(-iters // group) * nx * ny
    torch.cuda.synchronize()
    assert not torch.equal(want_p, p)
    _equal(got_p, want_p)
    _equal(got_d, want_d)


@pytest.mark.parametrize("origin,shape,exact,iters", [
    ((0, 0), (1104, 1104), (slice(0, 1024), slice(0, 1024)), 10),
    ((944, 944), (1104, 1104), (slice(80, 1104), slice(80, 1104)), 10),
    ((40, 20), (90, 100), (slice(24, 90), slice(24, 76)), 3),
    ((0, 7), (130, 61), (slice(0, 130), slice(16, 45)), 2)])
def test_k5_window_kept_cells_match_plain(cuda, origin, shape, exact, iters):
    """One call of several water steps: the cells it leaves exact (8 a step
    inside every inner window edge; the 2×2 split's blocks of 2048² at 10
    steps) bit-equal to the plain window, which computes every cell, with
    nonzero drains carried in."""
    res = 2048 if shape[0] > 1000 else 130
    rng = np.random.default_rng(sum(origin) + iters)
    h = torch.from_numpy(rng.uniform(0, 1, shape).astype(np.float32)).to(cuda)
    p = torch.from_numpy(rng.uniform(-0.3, 0.1, shape).clip(0).astype(np.float32)).to(cuda)
    d = torch.from_numpy(rng.uniform(0, 0.01, shape).astype(np.float32)).to(cuda)
    got = PC.pool_automata_window(h, p, d, iters, True, origin, res)
    want = PO._pool_automata_window(h, p, d, iters, True, origin, res)
    torch.cuda.synchronize()
    for g, w in zip(got, want):
        _equal(g[exact], w[exact])
    assert not torch.equal(got[1][exact], d[exact])


def _pile_table(h, pile_map, radius, max_piles=64):
    """The sharded EXACT_PILES table at world size 1: the piles, each
    slot's clamped cell and its value on ``h``."""
    from noize_tpu_torch.erosion import sediment as SE

    res_r, res_c = h.shape
    t = SE._pile_tables(radius)
    vols, idxs = SE.select_piles(pile_map, max_piles)
    rows = (idxs // res_c)[:, None] + torch.from_numpy(t["off_r"]).to(h.device).long()[None]
    cols = (idxs % res_c)[:, None] + torch.from_numpy(t["off_c"]).to(h.device).long()[None]
    valid = (rows >= 0) & (cols >= 0) & (rows < res_r) & (cols < res_c)
    cid = rows.clamp(0, res_r - 1) * res_c + cols.clamp(0, res_c - 1)
    return h.reshape(-1)[cid], valid, vols, cid


def _commit(h, com_vals, com_eff, cid):
    out = h.clone().reshape(-1)
    for j in range(com_vals.shape[0]):
        out[cid[j][com_eff[j]]] = com_vals[j][com_eff[j]]
    return out.reshape(h.shape)


@pytest.mark.parametrize("radius,n_cand", [(4, None), (15, None), (15, 100)])
def test_k6_table_matches_plain_and_full_map(cuda, radius, n_cand):
    """K6's table entry (one launch) against its plain version, bit-equal,
    and its commits against K6 on the map: overlapping and border piles,
    and 64 of 100 tied piles."""
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE

    res = 256 if n_cand is None else 512
    if n_cand is None:
        cells = [(100, 100), (101, 103), (104, 98), (99, 106), (0, 7), (res - 1, res - 1),
                 (50, 0), (200, 201)]
        h, piles = _piles_case(res, cells, [0.05, 0.3, 0.02, 0.12, 0.04, 0.2, 0.08, 0.5],
                               radius)
    else:
        rng = np.random.default_rng(9)
        flat = rng.choice(res * res, n_cand, replace=False)
        h, piles = _piles_case(res, [(int(f) // res, int(f) % res) for f in flat],
                               list(np.float32(0.01) * rng.integers(1, 5, n_cand)), 3)
    hd, pd = torch.from_numpy(h).to(cuda), torch.from_numpy(piles).to(cuda)
    vals0, valid, vols, cid = _pile_table(hd, pd, radius)
    before = PL.solve_pile_table.launches
    got = PL.solve_pile_table(vals0, valid, vols, cid, 1e-3, radius)
    assert PL.solve_pile_table.launches == before + 1
    want = SE.solve_pile_table_plain(vals0, valid, vols, cid, 1e-3, radius)
    torch.cuda.synchronize()
    _equal(got[0], want[0])
    assert torch.equal(got[1], want[1])
    _equal(_commit(hd, *got, cid), PL.exact_piles(hd, pd, 1e-3, radius))


def _k6_against_plain(cuda, h, piles, inc, radius):
    """K6 on the map and on its pile table (one launch each) against their
    plain versions, bit for bit, and the table's commits against K6."""
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE

    hd, pd = torch.from_numpy(h).to(cuda), torch.from_numpy(piles).to(cuda)
    before = PL.exact_piles.launches, PL.solve_pile_table.launches
    got = PL.exact_piles(hd, pd, inc, radius)
    vals0, valid, vols, cid = _pile_table(hd, pd, radius)
    table = PL.solve_pile_table(vals0, valid, vols, cid, inc, radius)
    assert (PL.exact_piles.launches, PL.solve_pile_table.launches) == (before[0] + 1,
                                                                       before[1] + 1)
    want = SE.exact_pile_deposit_plain(hd, pd, inc, radius)
    want_table = SE.solve_pile_table_plain(vals0, valid, vols, cid, inc, radius)
    torch.cuda.synchronize()
    _equal(got, want)
    _equal(table[0], want_table[0])
    assert torch.equal(table[1], want_table[1])
    _equal(_commit(hd, *table, cid), got)
    return got, hd


def _k6_case(name):
    """(height, pile map, increment, radius) of a ``pile_cases`` case."""
    import pile_cases as C

    kind, key = name.split(":")
    if kind == "pile":
        radius, r0, c0, amount, inc, _ = C.handle_cases()[key]
        return C.height(32, radius + r0), C.pile_map(32, [(r0, c0)], [amount]), inc, radius
    cells, vols, radius, hs, res = C.map_cases()[key]
    return C.height(res, 7), C.pile_map(res, cells, vols), np.float32(1.0 / hs), radius


def _k6_case_names():
    import pile_cases as C

    return [f"pile:{k}" for k in C.handle_cases()] + [f"map:{k}" for k in C.map_cases()]


@pytest.mark.parametrize("name", _k6_case_names())
def test_k6_edge_cases_match_plain(cuda, name):
    """The CPU parity cases (``pile_cases``: a partial deposit mid-round, a
    volume of whole increments, many sweeps, an increment float32 rounds,
    piles in the corners, a chain among disjoint piles), K6 and its table
    entry against their plain versions."""
    h, piles, inc, radius = _k6_case(name)
    got, hd = _k6_against_plain(cuda, h, piles, float(inc), radius)
    assert not torch.equal(got, hd)


def _k6_layout(layout):
    """(height, pile map, increment, radius) of a schedule layout at radius
    15 (reach 16: centres within 32 of each other may share a cell)."""
    import pile_cases as C

    rng = np.random.default_rng(11)
    if layout == "disjoint-64":  # 256 apart: every pile at once
        res = 2048
        cells = [(128 + 256 * i, 128 + 256 * j) for i in range(8) for j in range(8)]
        vols = rng.uniform(0.01, 0.04, 64)
    elif layout == "chain-64":  # 12 apart in a row: each waits for the one before
        res = 1024
        cells = [(500, 20 + 12 * j) for j in range(64)]
        vols = rng.uniform(0.1, 0.3, 64)
    elif layout.startswith("rim-"):  # the corners, the borders' middles, one cell in
        res = int(layout[4:])
        e, m = res - 1, res // 2
        cells = [(0, 0), (0, e), (e, 0), (e, e), (0, m), (m, 0), (e, m), (m, e), (1, 1),
                 (e - 1, 1), (1, e - 1), (e - 1, e - 1)]
        vols = rng.uniform(0.01, 0.3, len(cells))
    else:
        raise ValueError(layout)
    return C.height(res, 5), C.pile_map(res, cells, vols), C.INC, 15


@pytest.mark.parametrize("layout", ["disjoint-64", "chain-64", "rim-255", "rim-256"])
def test_k6_schedules_match_plain(cuda, layout):
    """64 disjoint piles at 2048² (all at once), a chain of 64 piles each
    overlapping the next (fully serial), and piles at the corners and
    borders of an odd and an even grid: K6 and its table entry against
    their plain versions."""
    h, piles, inc, radius = _k6_layout(layout)
    got, hd = _k6_against_plain(cuda, h, piles, float(inc), radius)
    assert not torch.equal(got, hd)


def test_k6_stalled_sweep_ends(cuda):
    """An increment below the pile cells' ulp on a flat field places
    nothing: K6 ends after the first empty sweep, as the plain version does,
    and leaves the height as it was."""
    import pile_cases as C

    h = np.full((64, 64), 0.5, np.float32)
    piles = C.pile_map(64, [(0, 0), (20, 30), (21, 33), (63, 40)], [0.01, 0.3, 0.02, 0.05])
    got, hd = _k6_against_plain(cuda, h, piles, 1e-9, 4)
    assert torch.equal(got, hd)


# --- K7: particle descent; K8: threefry -------------------------------------

def _descent_world(res, seed, plants=False):
    """A smooth world with pools, flow and (optionally) plant canopies, on
    the card."""
    from noize_tpu_torch.erosion.world import WorldState

    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:res, 0:res].astype(np.float32) / np.float32(res)
    h = (0.5 + 0.2 * np.sin(6.283 * (3 * x + rng.uniform())) * np.cos(6.283 * (2 * y))
         + 0.1 * np.sin(6.283 * (7 * x * y)) + rng.uniform(0, 0.01, (res, res)))
    maps = dict(height=h,
                pool=np.where(rng.uniform(0, 1, (res, res)) < 0.2,
                              rng.uniform(0, 1e-3, (res, res)), 0.0),
                flow=rng.uniform(0, 0.6, (res, res)),
                track=np.zeros((res, res)),
                plants=rng.uniform(0, 4, (res, res)) if plants else np.zeros((res, res)))
    return WorldState(**{k: torch.from_numpy(v.astype(np.float32)).cuda()
                         for k, v in maps.items()})


def _descent_params(maxage, plants=False):
    from noize_tpu_torch.erosion.params import ErosionSettings

    return ErosionSettings(MAXAGE=maxage,
                           VEGETATION_FRICTION=5.0 if plants else 0.0).as_parameters()


def _bits(a, b):
    """Bit-equality, signs of zero and NaN payloads included."""
    assert a.shape == b.shape and a.dtype == b.dtype
    if a.is_floating_point():
        a, b = a.contiguous().view(torch.int32), b.contiguous().view(torch.int32)
    assert torch.equal(a, b)


def _particles_bits(got, want):
    for f in got._fields:
        _bits(getattr(got, f), getattr(want, f))


def _records(world, params):
    from noize_tpu_torch.erosion import descent_cuda as DC

    return DC.descent_table(world, params, 1000.0)


@pytest.mark.parametrize("maxage", [32, 100])
@pytest.mark.parametrize("n", [1, 250, 777, 1000])
@pytest.mark.parametrize("res", [64, 256, 1025, 2048])
def test_k7_descent_matches_plain(cuda, res, n, maxage):
    """``descend_all`` on the card (K7 on the record table, one launch, and
    K9) against the fixed-step plain loop on the card with the same
    scatter, and against the early-exit loop (a scatter a chunk):
    particles, events and sums bit for bit (777 particles fill no block
    exactly).  K9 adds each cell's events in order, so the chunking does not
    move a bit."""
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.prng import PRNGKey

    world = _descent_world(res, res + n)
    params = _descent_params(maxage)
    p = PA.spawn(PRNGKey(n + maxage, device=cuda), n, res)
    steps = 8 * (-(-(maxage + 1) // 8))
    maps = PA.step_maps(world, params, 1000.0)
    before = DC.descend_steps.launches
    got = PA.descend_all(p, world, params, 1000.0, 1, res)
    assert DC.descend_steps.launches == before + 1
    ev = DC.descend_steps(p, _records(world, params), params, 1000.0, 1, res, steps)
    ev_plain = PA.descend_steps_plain(p, maps, params, 1000.0, 1, res, steps)
    want = PA.scatter_events(ev_plain[1], ev_plain[2:], res * res)
    early = PA._descend_all_plain(p, world, params, 1000.0, 1, res, maxage + 1, 8)
    torch.cuda.synchronize()
    _particles_bits(ev[0], ev_plain[0])
    for a, b in zip(ev[1:], ev_plain[1:]):
        _bits(a, b)
    _particles_bits(got[0], ev_plain[0])
    _particles_bits(early[0], ev_plain[0])
    for a, b, c in zip(got[1:], want, early[1:]):
        _bits(a.reshape(-1), b)
        _bits(a, c)
    assert (n == 1 or float(got[1].max()) > 0) and not bool(got[0].alive.any())


def test_k7_dead_particles_and_plants_match_plain(cuda):
    """Every particle dead at the start (events: the cells and zeros), and
    the plant friction's fourth record field."""
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.prng import PRNGKey

    res = 256
    for plants, alive in ((False, False), (True, True), (True, False)):
        world = _descent_world(res, 3, plants=plants)
        params = _descent_params(100, plants)
        p = PA.spawn(PRNGKey(9, device=cuda), 1000, res, alive=alive)
        maps = PA.step_maps(world, params, 1000.0)
        assert maps.numel() == (4 if plants else 3) * res * res
        table = _records(world, params)
        assert table.shape == (res * res, 4)
        got = DC.descend_steps(p, table, params, 1000.0, 1, res, 104)
        want = PA.descend_steps_plain(p, maps, params, 1000.0, 1, res, 104)
        torch.cuda.synchronize()
        _particles_bits(got[0], want[0])
        for a, b in zip(got[1:], want[1:]):
            _bits(a, b)
        assert bool(got[2].any()) == alive
        acc = PA.descend_all(p, world, params, 1000.0, 1, res)
        ref = PA.scatter_events(want[1], want[2:], res * res)
        for a, b in zip(acc[1:], ref):
            _bits(a.reshape(-1), b)


def test_k7_off_grid_positions_match_plain(cuda):
    """Positions off the integer grid (half-integers round half-to-even, so
    a move can jump two cells and leave the prefetched 5x5) and particles
    at the grid's edges: K7 reloads its patch and stays bit-equal."""
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.prng import PRNGKey

    res = 128
    world = _descent_world(res, 5)
    params = _descent_params(64)
    p = PA.spawn(PRNGKey(2, device=cuda), 1000, res)
    rng = np.random.default_rng(2)
    frac = torch.from_numpy(rng.choice([0.0, 0.5, 0.25, -0.5], 1000).astype(np.float32)).cuda()
    edge = torch.from_numpy(rng.choice([0.0, res - 1.0, -1.0], 1000).astype(np.float32)).cuda()
    row = torch.where(torch.arange(1000, device=cuda) % 3 == 0, edge, p.row + frac)
    p = p._replace(row=row, col=p.col + frac.flip(0))
    got = DC.descend_steps(p, _records(world, params), params, 1000.0, 1, res, 72)
    want = PA.descend_steps_plain(p, PA.step_maps(world, params, 1000.0), params, 1000.0, 1,
                                  res, 72)
    torch.cuda.synchronize()
    _particles_bits(got[0], want[0])
    for a, b in zip(got[1:], want[1:]):
        _bits(a, b)


@pytest.mark.parametrize("plants", [False, True])
@pytest.mark.parametrize("shape", [(64, 64), (1040, 1040), (2048, 2048), (33, 70)])
def test_k7_records_match_plain(cuda, shape, plants):
    """K7's record pass against ``step_records_plain`` on the card and
    against ``step_maps`` and ``_quantize``: bit for bit, one launch."""
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion.world import WorldState

    rng = np.random.default_rng(shape[0])
    maps = {k: torch.from_numpy(rng.uniform(lo, hi, shape).astype(np.float32)).to(cuda)
            for k, lo, hi in (("height", -0.2, 1.2), ("pool", 0, 1e-3), ("flow", -0.1, 0.9),
                              ("plants", 0, 4))}
    world = WorldState(track=torch.zeros(shape, device=cuda), **maps)
    params = _descent_params(32, plants)
    before = DC.step_records.launches
    got = DC.descent_table(world, params, 1000.0)
    assert DC.step_records.launches == before + 1
    want = DC.step_records_plain(world.height, world.pool, world.flow,
                                 world.plants if plants else None, params, 1000.0)
    torch.cuda.synchronize()
    _bits(got, want)
    cells = shape[0] * shape[1]
    table = PA.step_maps(world, params, 1000.0)
    _bits(got[:, 0], PA._quantize(table[cells:2 * cells]))
    _bits(got[:, 1], table[:cells])
    _bits(got[:, 2], table[2 * cells:3 * cells])
    _bits(got[:, 3], table[3 * cells:] if plants else torch.zeros_like(got[:, 3]))


@pytest.mark.parametrize("res,nx,ny", [(256, 2, 2), (256, 4, 1), (255, 3, 3), (2048, 2, 2)])
def test_k7_window_matches_plain_with_owner_masks(cuda, res, nx, ny):
    """K7@window on each block's window (extended by the chunk of 8), as the
    sharded descent runs it: chunk by chunk with the owner mask, events and
    particles bit-equal to the windowed plain loop."""
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.prng import PRNGKey

    chunk = 8
    world = _descent_world(res, nx * 10 + ny, plants=nx == 3)
    params = _descent_params(32, plants=nx == 3)
    full = PA.step_maps(world, params, 1000.0)
    parts = full.numel() // (res * res)
    tiles = full.reshape(parts, res, res)
    records = _records(world, params).reshape(res, res, 4)
    p0 = PA.spawn(PRNGKey(res + nx, device=cuda), 1000, res)
    lr, lc = -(-res // nx), -(-res // ny)
    before = DC.descend_steps_window.launches
    calls = 0
    for bx in range(nx):
        for by in range(ny):
            r0, c0 = bx * lr, by * lc
            origin, shape = (r0 - chunk, c0 - chunk), (lr + 2 * chunk, lc + 2 * chunk)
            r = torch.clamp(torch.arange(origin[0], origin[0] + shape[0], device=cuda), 0, res - 1)
            c = torch.clamp(torch.arange(origin[1], origin[1] + shape[1], device=cuda), 0, res - 1)
            table = torch.cat([t[r][:, c].reshape(-1) for t in tiles]).contiguous()
            window = records[r][:, c].reshape(-1, 4).contiguous()
            p_k, p_p = p0, p0
            for _ in range(5):
                ri = torch.clamp(torch.round(p_k.row).to(torch.int32), 0, res - 1)
                ci = torch.clamp(torch.round(p_k.col).to(torch.int32), 0, res - 1)
                owned = (ri >= r0) & (ri < r0 + lr) & (ci >= c0) & (ci < c0 + lc)
                got = DC.descend_steps_window(p_k, window, params, 1000.0, 1, res, chunk,
                                              origin, shape, owned)
                want = PA.descend_steps_plain(p_p, table, params, 1000.0, 1, res, chunk,
                                              window_origin=origin, window_shape=shape,
                                              owned=owned)
                calls += 1
                torch.cuda.synchronize()
                _particles_bits(got[0], want[0])
                for a, b in zip(got[1:], want[1:]):
                    _bits(a, b)
                p_k, p_p = got[0], want[0]
    assert DC.descend_steps_window.launches == before + calls


def _cpu_scatter(cells, vals, size, acc=None):
    from noize_tpu_torch.erosion import particles as PA

    return PA.scatter_events(cells.cpu(), [v.cpu() for v in vals], size,
                             None if acc is None else [a.cpu().clone() for a in acc])


@pytest.mark.parametrize("run", [1, 31, 32, 33, 1000, 100_000])
def test_k9_scatter_matches_cpu_for_run_lengths(cuda, run):
    """K9 against the CPU's ``scatter_events`` (in order) on runs of
    ``run`` N(0, 1) events a cell, some of them zeros, interleaved across
    cells: one call, into zeros and into given maps, and the events cut
    into 13 calls, all bit-equal to the CPU's one call."""
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion import scatter_cuda as SCU

    rng = np.random.default_rng(run)
    n_cells = max(1, min(2000, 200_000 // run))
    size = 4 * n_cells + 7
    cells = np.repeat(rng.permutation(size)[:n_cells], run)
    cells = cells[rng.permutation(cells.size)]  # each cell's run spread over the events
    vals = rng.normal(0, 1, (3, cells.size)).astype(np.float32)
    vals[:, rng.uniform(0, 1, cells.size) < 0.2] = 0.0  # dead slots' zeros inside runs
    vals[1, rng.uniform(0, 1, cells.size) < 0.1] = -0.0
    c = torch.from_numpy(cells.astype(np.int64)).to(cuda)
    v = [torch.from_numpy(x).to(cuda) for x in vals]
    start = [torch.from_numpy(rng.normal(0, 1, size).astype(np.float32)).to(cuda)
             for _ in range(3)]
    want = _cpu_scatter(c, v, size)
    want_on = _cpu_scatter(c, v, size, start)
    before = SCU.scatter_in_order.launches
    got = PA.scatter_events(c, v, size)
    assert SCU.scatter_in_order.launches == before + 1
    on = [a.clone() for a in start]
    assert PA.scatter_events(c, v, size, on) is on
    pieces = [torch.zeros(size, device=cuda) for _ in range(3)]
    for cc, *vv in zip(c.tensor_split(13), *(x.tensor_split(13) for x in v)):
        PA.scatter_events(cc, vv, size, pieces)
    torch.cuda.synchronize()
    for g, o, p_, w, wo in zip(got, on, pieces, want, want_on):
        _bits(g.cpu(), w)
        _bits(p_.cpu(), w)
        _bits(o.cpu(), wo)


def test_event_scatter_on_card_depends_only_on_each_cells_run(cuda):
    """What the single-device and the one-rank sharded descents rely on:
    ``scatter_events`` on the card is deterministic, and a cell's sum
    depends only on its own events in order, not on how the cells are
    numbered (the window's cells against the grid's) nor on other cells'
    events."""
    from noize_tpu_torch.erosion import particles as PA

    rng = np.random.default_rng(4)
    m, size = 200_000, 5000
    cells = torch.from_numpy(rng.zipf(1.3, m) % size).to(cuda)
    vals = [torch.from_numpy(rng.normal(0, 1, m).astype(np.float32)).to(cuda)
            for _ in range(3)]
    a = PA.scatter_events(cells, vals, size)
    b = PA.scatter_events(cells, vals, size)
    perm = torch.from_numpy(rng.permutation(size)).to(cuda)  # another numbering
    c = PA.scatter_events(perm[cells], vals, size)
    keep = cells < size // 2  # other cells' events dropped
    d = PA.scatter_events(cells[keep], [v[keep] for v in vals], size)
    for x, y, z, w in zip(a, b, c, d):
        _bits(x, y)
        _bits(x, z[perm])
        _bits(x[: size // 2], w[: size // 2])


def test_k9_refuses_bad_input(cuda):
    from noize_tpu_torch.erosion import scatter_cuda as SCU

    c = torch.zeros(10, dtype=torch.int64, device=cuda)
    v = torch.ones(10, device=cuda)
    with pytest.raises(ValueError):
        SCU.scatter_in_order(c, [v] * 5, 16)  # more than four maps
    with pytest.raises(ValueError):
        SCU.scatter_in_order(c.int(), [v], 16)
    with pytest.raises(ValueError):
        SCU.scatter_in_order(c, [v.double()], 16)
    with pytest.raises(ValueError):
        SCU.scatter_in_order(c, [v], 16, [torch.zeros(15, device=cuda)])


def _k9_case(size, n, seed, zero=0.3, nan=0.0):
    """``n`` events on ``size`` cells: half on four hot cells (runs across
    warps and tiles), the grid's first and last cells among them, three
    N(0, 1) deltas with ``zero`` of the events all zero and ``nan`` of them
    NaN."""
    rng = np.random.default_rng(seed)
    hot = rng.integers(0, size, 4)
    cells = np.where(rng.uniform(0, 1, n) < 0.5, rng.choice(hot, n), rng.integers(0, size, n))
    cells[: min(n, 2)] = [size - 1, 0][: min(n, 2)]
    vals = rng.normal(0, 1, (3, n)).astype(np.float32)
    vals[:, rng.uniform(0, 1, n) < zero] = 0.0
    vals[0, rng.uniform(0, 1, n) < nan] = np.nan
    return (torch.from_numpy(cells.astype(np.int64)).cuda(),
            [torch.from_numpy(v).cuda() for v in vals])


def _bits_or_nan(a, b):
    """Bit-equality where ``b`` is a number, NaN where it is NaN: the card's
    add of a NaN gives the canonical NaN, the CPU's keeps the operand's
    payload."""
    nan = torch.isnan(b)
    assert torch.equal(torch.isnan(a), nan)
    _bits(torch.where(nan, 0.0, a), torch.where(nan, 0.0, b))


def _check_k9(size, c, v):
    """K9 into fresh zeros and into maps of -0.0 against the CPU's
    ``scatter_events``, bit for bit (NaN payloads aside)."""
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.erosion import scatter_cuda as SCU

    before = SCU.scatter_in_order.launches
    got = PA.scatter_events(c, v, size)
    neg = [torch.full((size,), -0.0, device=c.device) for _ in v]
    on = PA.scatter_events(c, v, size, [a.clone() for a in neg])
    torch.cuda.synchronize()
    assert SCU.scatter_in_order.launches == before + (2 if c.numel() else 0)
    for g, w in zip(got, _cpu_scatter(c, v, size)):
        _bits_or_nan(g.cpu(), w)
    for g, w in zip(on, _cpu_scatter(c, v, size, neg)):
        _bits_or_nan(g.cpu(), w)


@pytest.mark.parametrize("size", [1, 2, 2**11, 2**11 + 1, 2**22, 2**22 + 1, 2049 * 2049])
def test_k9_sizes_on_pass_edges_match_cpu(cuda, size):
    """Sizes whose key widths fall on the sort's pass edges (1, 1, 11, 12,
    22, 23, 23 bits: one, two and three passes), 20,000 events with zero
    and NaN deltas."""
    _check_k9(size, *_k9_case(size, 20_000, size, nan=0.05))


@pytest.mark.parametrize("case", ["none", "one", "all-skipped", "run-1e5", "spread-1e6",
                                  "spread-1e6-4-maps", "stamps-524288", "stamps-1-map"])
def test_k9_event_counts_match_cpu(cuda, case):
    """No event, one, every event all-zero (the fresh call skips them all),
    one run of 10⁵ events on a cell, 10⁶ events spread over 2048² (three
    and four maps), and the vegetation's 524,288 stamps (three maps and its
    one): the last four past 128 tiles (three passes of 8 bits) and past
    the resident grid (a thread walks several runs)."""
    size = 2048 * 2048
    if case == "none":
        c, v = _k9_case(size, 0, 1)
    elif case == "one":
        c, v = _k9_case(size, 1, 2, zero=0.0)
    elif case == "all-skipped":
        c, v = _k9_case(size, 50_000, 3, zero=1.0)
    elif case == "run-1e5":
        c, v = _k9_case(size, 100_000, 4)
        c = torch.full_like(c, 123_457)
    elif case.startswith("spread-1e6"):
        c, v = _k9_case(size, 1_000_000, 5)
        if case.endswith("4-maps"):
            v = v + [v[0] * 0.5]
    else:
        c, v = _k9_case(size, 524_288, 6, zero=0.0)
        if case == "stamps-1-map":
            v = v[:1]
    _check_k9(size, c, v)


def test_k9_traps_on_a_cell_outside_the_maps(cuda):
    """A cell outside [0, size) traps on the card (a process of its own: a
    trap ends the CUDA context)."""
    import os
    import subprocess
    import sys

    code = ("import torch\n"
            "from noize_tpu_torch.erosion import scatter_cuda as SCU\n"
            "c = torch.tensor([3, 16, 1], dtype=torch.int64, device='cuda')\n"
            "SCU.scatter_in_order(c, [torch.ones(3, device='cuda')], 16)\n"
            "torch.cuda.synchronize()\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    out = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode != 0, out.stdout


def _device_ops_of_last_call(fn, calls=6):
    """The device operations (kernels, fills, copies) the last of ``calls``
    calls of ``fn`` ran, in one ``torch.profiler`` trace: a host-to-device
    copy, which ``fn`` never makes, runs before each call and delimits it.
    A trace that dropped records (the last two calls' operations differ) is
    taken again, up to three times."""
    from torch.profiler import ProfilerActivity, profile

    one = torch.ones(1)
    mark = torch.zeros(1, device="cuda")
    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                mark.copy_(one)
                fn()
                torch.cuda.synchronize()
        ops = sorted((e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA),
                     key=lambda e: e.time_range.start)
        marks = [i for i, e in enumerate(ops) if "HtoD" in e.name]
        if len(marks) >= 2:
            last = [e.name for e in ops[marks[-1] + 1:]]
            if last == [e.name for e in ops[marks[-2] + 1:marks[-1]]]:
                return last
    raise AssertionError("no complete profiler trace of a call in 3 attempts")


@pytest.mark.parametrize("n,maps", [(104_000, 3), (524_288, 1)])
def test_k9_runs_one_kernel_a_call(cuda, n, maps):
    """By the profiler: a call adding into given maps runs one device
    kernel, K9's, at the descent's 104,000 events and at the vegetation's
    524,288 (past the resident grid, three passes of 8 bits); into fresh
    maps the fill comes before it."""
    from noize_tpu_torch.erosion import particles as PA

    size = 2048 * 2048
    c, v = _k9_case(size, n, 7, zero=0.6)
    v = v[:maps]
    acc = [torch.zeros(size, device=cuda) for _ in v]
    given = _device_ops_of_last_call(lambda: PA.scatter_events(c, v, size, acc))
    fresh = _device_ops_of_last_call(lambda: PA.scatter_events(c, v, size))
    assert len(given) == 1 and "scatter_sort" in given[0], given
    assert len(fresh) == 2 and fresh[1] == given[0], fresh


def test_k7_refuses_bad_input(cuda):
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import particles as PA
    from noize_tpu_torch.prng import PRNGKey

    world = _descent_world(64, 1)
    params = _descent_params(32)
    table = _records(world, params)
    p = PA.spawn(PRNGKey(1, device=cuda), 10, 64)
    with pytest.raises(ValueError):
        DC.descend_steps(p, table[:-1], params, 1000.0, 1, 64, 8)  # not 64² records
    with pytest.raises(ValueError):
        DC.descend_steps(p, PA.step_maps(world, params, 1000.0), params, 1000.0, 1, 64, 8)
    with pytest.raises(ValueError):
        DC.descend_steps(p, table.double(), params, 1000.0, 1, 64, 8)
    with pytest.raises(ValueError):
        DC.descend_steps(p._replace(row=p.row.cpu()), table, params, 1000.0, 1, 64, 8)


def test_k7_atan_sin_match_torch(cuda):
    """K7's atanf and sinf (built with -fmad=false, as every source) against
    torch.atan and torch.sin on ~10^6 inputs: the descent's ranges (slopes
    of any size, angles within ±π/2), wide magnitudes, subnormals and the
    special values, bit for bit."""
    from noize_tpu_torch.erosion import descent_cuda as DC

    rng = np.random.default_rng(0)
    mags = 10.0 ** rng.uniform(-40, 38, 300_000)
    x = np.concatenate([
        rng.uniform(-np.pi / 2, np.pi / 2, 300_000),
        rng.uniform(-50.0, 50.0, 200_000),
        np.where(rng.uniform(0, 1, 300_000) < 0.5, -mags, mags),
        rng.uniform(-1e-3, 1e-3, 100_000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.17549435e-38, 3.4028235e38],
    ]).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    a, s = DC.atan_sin(t)
    torch.cuda.synchronize()
    _bits(a, torch.atan(t))
    _bits(s, torch.sin(t))


def test_k8_threefry_matches_plain(cuda):
    """K8 against the plain int64 rounds on the card: single keys, key
    stacks and views, split, fold_in, fold_in_stack, and 10^6 randint
    draws (whose halves are one broadcast hash)."""
    from noize_tpu_torch import prng

    key = prng.PRNGKey(2**31 - 1, device=cuda)
    stack = prng.split(key, 5)
    n = torch.arange(1_000_003, dtype=torch.int64, device=cuda)
    cases = [
        (key, n >> 32, n & 0xFFFFFFFF),
        (stack, n[:1000] >> 32, n[:1000]),
        (prng.split(stack, 2), n[:77] >> 32, n[:77]),
        (stack[3], n[5:9] * 0, n[5:9] * 2654435761 % (1 << 32)),
        (stack, torch.zeros(5, 1, dtype=torch.int64, device=cuda), n[:5, None] + 7),
        (key, torch.zeros(1, dtype=torch.int64, device=cuda),
         torch.full((1,), 0xFFFFFFFF, dtype=torch.int64, device=cuda)),
    ]
    for args in cases:
        before = prng.threefry2x32.launches
        got = prng.threefry2x32(*args)
        assert prng.threefry2x32.launches == before + 1
        want = prng._threefry2x32_plain(*args)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            _bits(g, w)
    for seed in (0, 42, -5):
        kc, kh = prng.PRNGKey(seed, device=cuda), prng.PRNGKey(seed, device="cpu")
        _bits(prng.split(kc, 7).cpu(), prng.split(kh, 7))
        _bits(prng.fold_in(kc, 123456).cpu(), prng.fold_in(kh, 123456))
        _bits(prng.fold_in_stack(kc, [1, 2, 3]).cpu(), prng.fold_in_stack(kh, [1, 2, 3]))
        _bits(prng.fold_in_stack(prng.split(kc, 3), [4, 5, 6]).cpu(),
              prng.fold_in_stack(prng.split(kh, 3), [4, 5, 6]))
        _bits(prng.randint(kc, (1_000_000,), -1024, 2049).cpu(),
              prng.randint(kh, (1_000_000,), -1024, 2049))
        _bits(prng.randint(prng.split(kc, 4), (250,), 0, 2048).cpu(),
              prng.randint(prng.split(kh, 4), (250,), 0, 2048))


def test_k8_draw_matches_cpu(cuda):
    """K8's draw entry (``randint`` on the card, and the spawn's
    ``randint(split(key))``) in one launch a draw, against the CPU's
    composition: single keys and stacks, negative and empty spans, int32
    and the spawn's float32, 10^6 draws."""
    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion import particles as PA

    for seed in (0, 42, -5, 2**31 - 1):
        kc, kh = prng.PRNGKey(seed, device=cuda), prng.PRNGKey(seed, device="cpu")
        for keys_c, keys_h in ((kc, kh), (prng.split(kc, 3), prng.split(kh, 3)),
                               (prng.split(prng.split(kc, 2), 2), prng.split(prng.split(kh, 2), 2))):
            for shape, lo, hi in (((1000,), 0, 2048), ((37, 5), -1024, 1025), ((8,), 3, 3),
                                  ((9,), -2**31, 2**31 - 1), ((0,), 0, 5)):
                before = prng._randint_cuda.launches
                got = prng.randint(keys_c, shape, lo, hi)
                got_s = prng._randint_of_split(keys_c, shape, lo, hi)
                got_f = prng._randint_of_split(keys_c, shape, lo, hi, torch.float32)
                launched = prng._randint_cuda.launches - before
                assert launched == (3 if got.numel() else 0)
                _bits(got.cpu(), prng.randint(keys_h, shape, lo, hi))
                _bits(got_s.cpu(), prng.randint(prng.split(keys_h), shape, lo, hi))
                _bits(got_f.cpu(), prng.randint(prng.split(keys_h), shape, lo, hi)
                      .to(torch.float32))
        _bits(prng.randint(kc, (1_000_000,), -1024, 2049).cpu(),
              prng._randint_composed(kh, (1_000_000,), -1024, 2049))
        before = (prng._randint_cuda.launches, prng.threefry2x32.launches)
        got = PA.spawn(kc, 1000, 2048)
        assert (prng._randint_cuda.launches, prng.threefry2x32.launches) == \
            (before[0] + 1, before[1])
        for f in got._fields:
            _bits(getattr(got, f).cpu(), getattr(PA.spawn(kh, 1000, 2048), f))


def test_erosion_cycle_draws_with_two_k8_launches(cuda):
    """A cycle's spawn takes two K8 launches (the cycle's ``split`` and the
    spawn's draw), and K7 and K9 one each."""
    from noize_tpu_torch import prng
    from noize_tpu_torch.erosion import descent_cuda as DC
    from noize_tpu_torch.erosion import scatter_cuda as SCU
    from noize_tpu_torch.erosion.sim import ErosionSim

    h = _descent_world(256, 7).height
    sim = ErosionSim(h)
    counts = lambda: (prng.threefry2x32.launches + prng._randint_cuda.launches,  # noqa: E731
                      DC.descend_steps.launches, SCU.scatter_in_order.launches)
    before = counts()
    sim.step()
    torch.cuda.synchronize()
    cycles = sim.settings.CYCLES
    after = counts()
    assert after[0] - before[0] == 2 * cycles
    assert after[1] - before[1] == cycles and after[2] - before[2] == cycles


# --- K10: the fBm (csrc/fractal.cu) ------------------------------------------

K10_KW = dict(hurst=0.4, octaves=4, noise_size=170.0)


@pytest.mark.parametrize("kind", ["Sin", "Perlin", "PeriodicPerlin", "Simplex",
                                  "RotatedSimplex", "Cellular", "DomainRotatedPerlin",
                                  "DomainRotatedSimplex"])
def test_k10_matches_plain_for_every_basis(cuda, kind):
    """One launch a call, bit-equal to the plain version on the card."""
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import fractal as FK

    before = FK.fractal_fused.launches
    got = FR.fractal(256, 1234.0, -777.0, noise_type=kind, device=cuda, **K10_KW)
    assert FK.fractal_fused.launches == before + 1
    want = FR.fractal_window_plain(0, 0, 256, 256, 1234.0, -777.0, noise_type=kind,
                                   device=cuda, **K10_KW)
    torch.cuda.synchronize()
    _bits(got, want)
    assert float(got.max() - got.min()) > 0


@pytest.mark.parametrize("kw", [dict(noise_type="Simplex", hurst=0.9, octaves=13),
                                dict(noise_type="Perlin", hurst=0.4, octaves=13),
                                dict(noise_type="Simplex", hurst=0.123, octaves=24,
                                     stepdown=1.9607, detune_rate=0.04,
                                     starting_amplitude=0.7),
                                dict(noise_type="Cellular", hurst=0.5, octaves=32)])
def test_k10_octaves_match_plain(cuda, kw):
    from noize_tpu_torch.ops import fractal as FR

    got = FR.fractal(300, 5.0, 7.0, noise_size=1700.0, device=cuda, **kw)
    want = FR.fractal_window_plain(0, 0, 300, 300, 5.0, 7.0, noise_size=1700.0,
                                   device=cuda, **kw)
    torch.cuda.synchronize()
    _bits(got, want)


def test_k10_stack_and_window_match_plain(cuda):
    """A stack of T origins in one launch, each tile its own call's; a
    window equal to that slice of the whole tile."""
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import fractal as FK

    kw = dict(noise_type="Simplex", hurst=0.4, octaves=13, noise_size=1700.0)
    xs, zs = [0.0, 992.0, 1984.0, 0.0, 992.0], [0.0, 0.0, 0.0, 992.0, 992.0]
    before = FK.fractal_fused.launches
    stack = FR.fractal(200, xs, zs, device=cuda, **kw)
    assert FK.fractal_fused.launches == before + 1 and tuple(stack.shape) == (5, 200, 200)
    _bits(stack, FR.fractal_window_plain(0, 0, 200, 200, xs, zs, device=cuda, **kw))
    for i, (x, z) in enumerate(zip(xs, zs)):
        _bits(stack[i], FR.fractal(200, x, z, device=cuda, **kw))
    whole = FR.fractal(200, 10.0, 20.0, device=cuda, **kw)
    win = FR.fractal_window(37, 101, 60, 99, 10.0, 20.0, device=cuda, **kw)
    _bits(win, whole[37:97, 101:200].contiguous())
    _bits(win, FR.fractal_window_plain(37, 101, 60, 99, 10.0, 20.0, device=cuda, **kw))


def test_k10_refuses_too_many_octaves(cuda):
    from noize_tpu_torch.ops import fractal as FR
    from noize_tpu_torch.ops.cuda import fractal as FK

    with pytest.raises(ValueError, match="octaves"):
        FR.fractal(16, 0.0, 0.0, octaves=FK.MAX_OCTAVES + 1, device=cuda)


def test_k10_sin_cos_match_torch(cuda):
    """K10's sinf and cosf (built with -fmad=false, as every source) against
    torch.sin and torch.cos on ~10^6 inputs: the PeriodicPerlin and
    RotatedSimplex gradient angles [0, 2π), the Sin basis' coordinates,
    wide magnitudes, subnormals and the special values, bit for bit."""
    from noize_tpu_torch.ops.cuda import fractal as FK

    rng = np.random.default_rng(10)
    mags = 10.0 ** rng.uniform(-40, 38, 200_000)
    x = np.concatenate([
        rng.uniform(0.0, 2 * np.pi, 400_000),
        rng.uniform(-1e4, 1e4, 200_000),
        np.where(rng.uniform(0, 1, 200_000) < 0.5, -mags, mags),
        rng.uniform(-1e-3, 1e-3, 100_000),
        [0.0, -0.0, np.inf, -np.inf, np.nan, 1e-45, -1e-45, 1.17549435e-38, 3.4028235e38],
    ]).astype(np.float32)
    t = torch.from_numpy(x).to(cuda)
    s, c = FK.sin_cos(t)
    torch.cuda.synchronize()
    _bits_or_nan(s, torch.sin(t))
    _bits_or_nan(c, torch.cos(t))


# --- K11: the sediment write-back (csrc/sediment.cu) -------------------------

def _sediment_case(shape, seed, radius, piles, negative=False):
    """Height with cells at the breaker's edges, sediment of both signs with
    values on and beside the threshold, and (``piles``) piles on the four
    corners, on each edge, one stamp reach in and inside."""
    rng = np.random.default_rng(seed)
    rows, cols = shape
    h = rng.uniform(0.2, 0.8, shape).astype(np.float32)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = np.float32(0.99999)
    h.flat[rng.choice(h.size, h.size // 50, replace=False)] = np.float32(1e-6)
    sed = rng.normal(-1e-3 if negative else 0.0, 3e-4 if negative else 1e-4,
                     shape).astype(np.float32)
    thresh = np.float32(2.0 / 1000.0)
    edge = [thresh, np.nextafter(thresh, np.float32(0)), -thresh, 0.0, -0.0]
    if piles:
        edge.append(np.nextafter(thresh, np.float32(1)))
        for r, c in [(0, 0), (0, cols - 1), (rows - 1, 0), (rows - 1, cols - 1),
                     (0, cols // 2), (rows // 2, 0), (rows - 1, cols // 3),
                     (rows // 3, cols - 1), (1, 5), (radius - 1, radius),
                     (rows - radius, cols - 2), (rows // 2, cols // 2)]:
            sed[r, c] = rng.uniform(0.005, 0.05)
    sed.flat[rng.choice(sed.size, len(edge), replace=False)] = edge
    return torch.from_numpy(h).to("cuda"), torch.from_numpy(sed).to("cuda")


def _raw_equal(got, want):
    """``assert_array_equal`` on the raw float32 bits (signs of zero too)."""
    np.testing.assert_array_equal(got.view(torch.int32).cpu().numpy(),
                                  want.view(torch.int32).cpu().numpy())


@pytest.mark.parametrize("case", ["piles", "no_piles", "negative"])
@pytest.mark.parametrize("radius", [6, 8, 15])
@pytest.mark.parametrize("shape", [(2048, 2048), (1024, 1024), (1025, 1025), (48, 48),
                                   (97, 150)])
def test_k11_write_sediment_matches_plain(cuda, shape, radius, case):
    """K11 against ``write_sediment_map_plain`` on the card, bit for bit:
    one launch a call, the tent on exactly when a pile exists."""
    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.erosion.params import ErosionSettings

    params = ErosionSettings(PILING_RADIUS=radius).as_parameters()
    h, sed = _sediment_case(shape, radius, radius, case == "piles", case == "negative")
    before = (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches)
    syncs = []
    got = SE.write_sediment_map(h, sed, params, 1000.0, syncs=syncs)
    assert syncs == ["sediment.piles"]
    assert (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches) == \
        (before[0] + 1, before[1] + (case == "piles"))
    want = SE.write_sediment_map_plain(h, sed, params, 1000.0)
    torch.cuda.synchronize()
    _raw_equal(got, want)
    assert not torch.equal(got, h)


@pytest.mark.parametrize("shape", [(1024, 1024), (1025, 1025), (48, 48)])
def test_k11_exact_piles_matches_plain(cuda, shape):
    """``EXACT_PILES``: K11 without the tent, then K6 commits the piles, as
    the plain version does."""
    from noize_tpu_torch.erosion import pile_cuda as PL
    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.erosion.params import ErosionSettings

    params = ErosionSettings(PILING_RADIUS=8, EXACT_PILES=True).as_parameters()
    h, sed = _sediment_case(shape, 11, 8, True)
    before = (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches,
              PL.exact_piles.launches)
    got = SE.write_sediment_map(h, sed, params, 1000.0)
    assert (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches,
            PL.exact_piles.launches) == (before[0] + 1, before[1], before[2] + 1)
    want = SE.write_sediment_map_plain(h, sed, params, 1000.0)
    torch.cuda.synchronize()
    _raw_equal(got, want)


def test_k11_refuses_bad_input(cuda):
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.erosion.params import ErosionSettings

    params = ErosionSettings().as_parameters()
    h, sed = _sediment_case((64, 64), 1, 15, True)
    with pytest.raises(ValueError, match="float32"):
        SK.write_sediment_cuda(h.double(), sed, params, 1000.0)
    with pytest.raises(ValueError, match="contiguous"):
        SK.write_sediment_cuda(h.t(), sed, params, 1000.0)
    with pytest.raises(ValueError, match="match"):
        SK.write_sediment_cuda(h, sed[:32], params, 1000.0)
    with pytest.raises(ValueError, match="2-D"):
        SK.write_sediment_cuda(h[None], sed[None], params, 1000.0)
    with pytest.raises(ValueError, match="CUDA"):
        SK.write_sediment_cuda(h, sed.cpu(), params, 1000.0)
    with pytest.raises(ValueError, match="PILING_RADIUS"):
        SK.write_sediment_cuda(h, sed, ErosionSettings(PILING_RADIUS=SK.MAX_RADIUS + 1)
                               .as_parameters(), 1000.0)
    with pytest.raises(ValueError, match="smaller"):
        SK.write_sediment_cuda(h[:10, :10].contiguous(), sed[:10, :10].contiguous(), params,
                               1000.0)


@pytest.mark.parametrize("piles", [True, False])
def test_k11_one_launch_a_cycle(cuda, monkeypatch, piles):
    """One ``erosion_cycle`` launches K11 once, with the tent exactly when
    the cycle banks a pile (PILE_THRESHOLD a micrometre, or a kilometre),
    and leaves the state the plain write-back leaves."""
    from dataclasses import replace

    from noize_tpu_torch.erosion import sediment as SE
    from noize_tpu_torch.erosion import sediment_cuda as SK
    from noize_tpu_torch.erosion import sim as SIM
    from noize_tpu_torch.erosion.params import ErosionSettings

    settings = ErosionSettings(PILE_THRESHOLD=1e-6 if piles else 1e6)
    sim = SIM.ErosionSim(_descent_world(256, 7).height, settings=settings)
    before = (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches)
    syncs = []
    got = SIM.erosion_cycle(sim.state, settings, sim.meta, syncs=syncs)
    torch.cuda.synchronize()
    assert (SK.write_sediment_cuda.launches, SK.write_sediment_cuda.tent_launches) == \
        (before[0] + 1, before[1] + piles)
    assert syncs == ["spawn.drains", "sediment.piles"]
    monkeypatch.setattr(SIM, "write_sediment_piles",  # the plain write-back for K11
                        lambda h, sed, p, hs, piles, out=None:
                        SE.write_sediment_map_plain(h, sed, p, hs))
    want = SIM.erosion_cycle(replace(sim.state), settings, sim.meta)
    torch.cuda.synchronize()
    assert SK.write_sediment_cuda.launches == before[0] + 1
    for name in ("height", "pool", "track", "flow"):
        _raw_equal(getattr(got.world, name), getattr(want.world, name))
    _raw_equal(got.drain_water, want.drain_water)


# --- K12: the deposit's adds and the track/flow decay (csrc/decay.cu) --------

def _decay_case(shape, seed, special=False):
    """A world and descent accumulators on the card: pools straddling
    MINFLOWPOOL, tracks and accumulators with +0 and -0, and (``special``)
    NaN, ±inf and -0.0 among every input."""
    from noize_tpu_torch.erosion import world as W

    rng = np.random.default_rng(seed)
    mfp = np.float32(W.MINFLOWPOOL)
    maps = {"height": rng.uniform(0, 1, shape), "plants": np.zeros(shape),
            "pool": rng.uniform(0, 2 * mfp, shape), "flow": rng.uniform(0, 0.3, shape),
            "track": rng.uniform(0, 1e-4, shape)}
    maps = {k: v.astype(np.float32) for k, v in maps.items()}
    maps["pool"].flat[:5] = [mfp, np.nextafter(mfp, np.float32(0)),
                             np.nextafter(mfp, np.float32(1)), 0.0, -0.0]
    maps["track"][::3] = 0.0
    maps["track"][1::5] = -0.0
    accs = [rng.uniform(0, 1e-4, shape).astype(np.float32) for _ in range(2)]
    for a in accs:
        a[::4] = 0.0
        a[2::7] = -0.0
    if special:
        edge = np.float32([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e30, -1e-30])
        for a in [maps["pool"], maps["flow"], maps["track"], *accs]:
            a.flat[rng.choice(a.size, 64 * len(edge), replace=False)] = np.repeat(edge, 64)
    world = W.WorldState(**{k: torch.from_numpy(v).to("cuda") for k, v in maps.items()})
    return world, torch.from_numpy(accs[0]).to("cuda"), torch.from_numpy(accs[1]).to("cuda")


def _offset(t):
    """``t``'s values in a map 4 bytes past a 16-byte boundary (K12's
    cell-a-thread path)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize("case", ["spawn", "out", "special", "no_spawn", "unaligned"])
@pytest.mark.parametrize("shape", [(2048, 2048), (1024, 1024), (1025, 1025), (37, 50)])
def test_k12_deposit_and_decay_matches_plain(cuda, shape, case):
    """K12 against ``deposit_and_decay_plain`` on the card, bit for bit
    (signs of zero, NaN): one launch a call; ``out`` aliasing the world's
    flow and track (graph B's in-place write); NaN, ±inf and -0.0 inputs
    with no evaporation (a -0.0 pool reaches the clamp); no accumulators
    (no spawn); maps off a 16-byte boundary."""
    from dataclasses import replace

    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion import world as W
    from noize_tpu_torch.erosion.params import ErosionSettings

    params = ErosionSettings().as_parameters()
    world, track_acc, pool_acc = _decay_case(shape, shape[0], case == "special")
    if case == "special":
        params = replace(params, SURFACE_EVAPORATION_RATE=0.0, FLOW_LOSS_RATE=0.25)
    if case == "no_spawn":
        track_acc = pool_acc = None
    if case == "unaligned":
        world = replace(world, pool=_offset(world.pool), flow=_offset(world.flow))
        track_acc = _offset(track_acc)
    want = W.deposit_and_decay_plain(world, track_acc, pool_acc, params, 1000.0)
    before = DK.deposit_and_decay_cuda.launches
    if case == "out":
        flow, track = world.flow, world.track
        got = W.deposit_and_decay(world, track_acc, pool_acc, params, 1000.0, out=world)
        assert got.flow is flow and got.track is track and got.pool is not world.pool
    else:
        got = W.deposit_and_decay(world, track_acc, pool_acc, params, 1000.0)
    assert DK.deposit_and_decay_cuda.launches == before + 1
    torch.cuda.synchronize()
    for name in ("pool", "flow", "track"):
        _raw_equal(getattr(got, name), getattr(want, name))
    assert got.height is world.height and got.plants is world.plants


def test_k12_refuses_bad_input(cuda):
    from dataclasses import replace

    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion.params import ErosionSettings

    params = ErosionSettings().as_parameters()
    world, track_acc, pool_acc = _decay_case((64, 64), 3)
    with pytest.raises(ValueError, match="both"):
        DK.deposit_and_decay_cuda(world, track_acc, None, params, 1000.0)
    with pytest.raises(ValueError, match="float32"):
        DK.deposit_and_decay_cuda(world, track_acc.double(), pool_acc, params, 1000.0)
    with pytest.raises(ValueError, match="contiguous"):
        DK.deposit_and_decay_cuda(replace(world, flow=world.flow.t()), track_acc, pool_acc,
                                  params, 1000.0)
    with pytest.raises(ValueError, match="match"):
        DK.deposit_and_decay_cuda(world, track_acc[:32], pool_acc, params, 1000.0)
    with pytest.raises(ValueError, match="CUDA"):
        DK.deposit_and_decay_cuda(world, track_acc.cpu(), pool_acc, params, 1000.0)
    with pytest.raises(ValueError, match="apart"):
        DK.deposit_and_decay_cuda(world, track_acc, pool_acc, params, 1000.0,
                                  out=replace(world, flow=world.pool))


def test_k12_one_launch_a_cycle(cuda, monkeypatch):
    """One ``erosion_cycle`` launches K12 once and leaves the state the
    plain deposit and decay leave."""
    from dataclasses import replace

    from noize_tpu_torch.erosion import decay_cuda as DK
    from noize_tpu_torch.erosion import sim as SIM
    from noize_tpu_torch.erosion import world as W
    from noize_tpu_torch.erosion.params import ErosionSettings

    settings = ErosionSettings()
    sim = SIM.ErosionSim(_descent_world(256, 8).height, settings=settings)
    before = DK.deposit_and_decay_cuda.launches
    got = SIM.erosion_cycle(sim.state, settings, sim.meta)
    torch.cuda.synchronize()
    assert DK.deposit_and_decay_cuda.launches == before + 1
    monkeypatch.setattr(SIM, "deposit_and_decay",  # the plain deposit and decay for K12
                        lambda w, t, p, prm, hs, out=None:
                        W.deposit_and_decay_plain(w, t, p, prm, hs))
    want = SIM.erosion_cycle(replace(sim.state), settings, sim.meta)
    torch.cuda.synchronize()
    assert DK.deposit_and_decay_cuda.launches == before + 1
    for name in ("height", "pool", "track", "flow"):
        _raw_equal(getattr(got.world, name), getattr(want.world, name))
    _raw_equal(got.drain_water, want.drain_water)
