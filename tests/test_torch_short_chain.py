"""K1's short-chain kernels on the CPU: K1@short (``ops/cuda/stencil``'s
``short_chain``, routed by ``chain_route``) and K1@rss
(``root_sum_squares_chain``: Sobel3_2D and ``edge.edge_2d`` in one launch).

The CUDA kernels cannot run here, but what makes them exact can be checked:

- the route: which chains go to K1@short and which to ``chain_tile``, and
  that every ``KernelFilterStage`` call of the BasicDemo presets is short
  and small enough for four blocks an SM;
- a replay of K1@short's kernel in NumPy: the same tiles and windows (the
  tile with an off·m halo, cut at the grid's edge, the cells off the grid
  never read: they hold NaN here), the same per-iteration clamp of reads
  to the cells exact after the previous iteration, the same walk of a
  column strip with the X pass kept in a ring of K rows (the kernel's last
  iteration; it runs the ones before as ``chain_tile`` does, whose plan
  ``tests/test_torch_stencil_plan.py`` replays), each sum from 0 with tap
  0 first and the factor after it.  It must equal
  ``separable_chain_plain`` bit for bit, on odd shapes, stacks and 1×N /
  N×1 maps; a halo one cell short must not;
- K1@rss's plain version against JAX evaluated one primitive at a time
  (``jax.disable_jit()``), bit-exact, and against the compiled program at
  ``tests/test_torch_kernel_filters.py``'s tolerance (1e-6 of the output's
  scale: XLA contracts multiply-adds into FMAs);
- ``f32.sqrt`` (the plain version's float64 root rounded to float32)
  against NumPy's float32 root, which is correctly rounded, on 10⁶ seeded
  inputs and the specials: the licence for the kernel's ``__fsqrt_rn``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.ops import edge as JE
from noize_tpu.ops import kernels as JK
from noize_tpu_torch.app import presets
from noize_tpu_torch.ops import edge as TE
from noize_tpu_torch.ops import f32
from noize_tpu_torch.ops import kernels as TK
from noize_tpu_torch.ops.blur import smooth_taps
from noize_tpu_torch.ops.cuda import stencil as SC
from noize_tpu_torch.pipeline import stages as S

# the SM's limits a K1@short block shares (H100: 228 KB of shared memory,
# 1 KB of it reserved a block, 2048 threads)
SM_SHARED, BLOCK_RESERVED, SM_THREADS = 228 * 1024, 1024, 2048

SOBEL = ((TK._SOBEL3_HX, TK._SOBEL3_HZ), (TK._SOBEL3_VX, TK._SOBEL3_VZ))
PREWITT = ((TK._PREWITT3_HX, TK._PREWITT3_HZ), (TK._PREWITT3_VX, TK._PREWITT3_VZ))


def _field(seed, shape):
    return np.random.default_rng(seed).uniform(0, 1, shape).astype(np.float32)


# --- the route ----------------------------------------------------------------

def test_chain_route():
    assert SC.chain_route(5, 17) == "tile"  # the flagship's Gauss-5 ×17
    assert SC.chain_route(3, 32) == "tile"
    assert SC.chain_route(25, 1) == "tile"
    assert SC.chain_route(19, 1) == "tile"  # off 9 > SHORT_HALO
    assert SC.chain_route(5, 0) == "tile"  # 0 iterations: chain_tile's copy
    for k, m in ((3, 1), (3, 3), (3, 8), (9, 2), (5, 4), (17, 1), (1, 32)):
        assert SC.chain_route(k, m) == "short", (k, m)
    assert SC.chain_route(3, SC.SHORT_HALO + 1) == "tile"
    assert SC.chain_route(9, 3) == "tile"


def test_short_plan():
    """One iteration on SHORT_ONE's wide tiles, more on SHORT_MANY's."""
    assert SC.short_plan(3, 1) == SC.ShortPlan(1, 1, SC.SHORT_ONE[:2], *SC.SHORT_ONE[2:])
    p = SC.short_plan(9, 2)
    assert (p.iterations, p.halo, p.tile, p.threads, p.strip) == (
        2, 8, SC.SHORT_MANY[:2], *SC.SHORT_MANY[2:])
    assert SC.short_plan(1, 32).halo == 0
    assert SC.short_plan(3, 1, (16, 64, 32, 8)) == SC.ShortPlan(1, 1, (16, 64), 32, 8)
    assert SC.short_plan(3, 9) is None
    assert SC.short_plan(3, 9, halo=None).halo == 9
    assert SC.short_plan(19, 1, halo=None) is None  # past SHORT_MAX_TAPS
    assert SC.short_plan(3, 0, halo=None) is None
    for blocking in (SC.SHORT_ONE, SC.SHORT_MANY):
        rows, cols, threads, strip = blocking
        assert cols % 4 == 0 and threads % 32 == 0 and 1 <= strip
    # one buffer at one iteration, rows on 16-byte boundaries; two at an odd pitch above
    assert SC.short_window_bytes(3, SC.short_plan(3, 1, (32, 128, 128, 32))) == 4 * 34 * 136
    assert SC.short_window_bytes(9, SC.short_plan(9, 2, (32, 128, 128, 32))) == 2 * 4 * 48 * 145
    assert SC.short_window_bytes(3, SC.short_plan(3, 3, (32, 128, 128, 32))) == 2 * 4 * 38 * 135


def _preset_calls():
    """(filter, iterations) of every KernelFilterStage in the presets."""
    out = []
    for pd in presets.ALL.values():
        out += [(st.filter, st.iterations) for st in pd.stages
                if isinstance(st, S.KernelFilterStage)]
    return out


def test_every_presets_call_is_short():
    calls = _preset_calls()
    assert ("Gauss9_S1", 2) in calls and ("Gauss3_S1", 3) in calls
    assert ("Sobel3_2D", 1) in calls
    for name, iterations in calls:
        if name == "Sobel3_2D":  # K1@rss: one iteration of a 3-tap pair a launch
            k, iterations = len(TK._SOBEL3_HX), 1
        else:
            k = len(TK._SERIES_TABLE[name][0])
        assert SC.chain_route(k, iterations) == "short", name
        plan = SC.short_plan(k, iterations)
        blocks = min(SM_SHARED // (SC.short_window_bytes(k, plan) + BLOCK_RESERVED),
                     SM_THREADS // plan.threads)
        assert blocks >= 4, (name, blocks)


@pytest.mark.parametrize("name", TK.KERNEL_FILTER_TYPES)
@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_kernel_filter_types_route_short(name, iterations):
    """Every kernel filter at 1-3 iterations runs one K1@short launch a call
    (Sobel3_2D: one K1@rss launch an iteration) but the 7- and 9-tap
    Gaussians at 3 iterations (a halo of 9 and 12), which run on
    ``chain_tile``: the launches the card tests count."""
    if name == "Sobel3_2D":
        assert len(TK._SOBEL3_HX) <= SC.RSS_MAX_TAPS
        return
    k = len(TK._SERIES_TABLE[name][0])
    assert SC.chain_route(k, iterations) == ("tile" if k >= 7 and iterations == 3
                                             else "short")


# --- a replay of K1@short's kernel --------------------------------------------

def _lo(base, j, off):
    return max(0, base + j * off) - base


def _hi(base, length, n, j, off):
    return min(n - 1, base + length - 1 - j * off) - base


def _x_sum(row, ci, t, factor):
    acc = np.zeros(len(ci[0]), np.float32)
    for i, c in enumerate(ci):
        acc = acc + t[i] * row[c]
    return acc * factor if factor != 1.0 else acc


def _z_sum(ring, u, factor):
    acc = np.zeros_like(ring[0])
    for i in range(len(u)):
        acc = acc + u[i] * ring[len(u) - 1 - i]
    return acc * factor if factor != 1.0 else acc


def _pass(src, dst, zlo, zhi, xlo, xhi, rlo, rhi, clo, chi, series, factor, strip):
    """``short_pass``: every column at once, a strip of rows at a time."""
    k = len(series[0][0])
    off = (k - 1) // 2
    cols = np.arange(xlo, xhi + 1)
    ci = [np.clip(cols - off + i, clo, chi) for i in range(k)]
    f = 1.0 if len(series) == 2 else factor
    for r0 in range(zlo, zhi + 1, strip):
        rings = [[None] + [_x_sum(src[int(np.clip(r0 - off + i, rlo, rhi))], ci, tx,
                                  f if n == 0 else 1.0) for i in range(k - 1)]
                 for n, (tx, _) in enumerate(series)]
        for r in range(r0, min(zhi, r0 + strip - 1) + 1):
            row = src[int(np.clip(r + off, rlo, rhi))]
            outs = []
            for n, ((tx, tz), ring) in enumerate(zip(series, rings)):
                fn = f if n == 0 else 1.0
                ring.pop(0)
                ring.append(_x_sum(row, ci, tx, fn))
                outs.append(_z_sum(ring, tz, fn))
            v = outs[0]
            if len(outs) == 2:
                v = np.sqrt(v * v + outs[1] * outs[1])
            dst[r, xlo:xhi + 1] = v


def replay_short(x, series, m, tile, strip, factor=1.0):
    """K1@short (``series`` = [(X taps, Z taps)]) or K1@rss ([H, V], m = 1)
    on every block of a map or stack, as ``short_tile`` runs it."""
    x = x.numpy()
    stack = x.ndim == 3
    xs = x if stack else x[None]
    series = [(np.asarray(a, np.float32), np.asarray(b, np.float32)) for a, b in series]
    k = len(series[0][0])
    off = (k - 1) // 2
    h = off * m
    tz, tx = tile
    out = np.full_like(xs, np.nan)
    for t, grid in enumerate(xs):
        rows, cols = grid.shape
        for bz in range(-(-rows // tz)):
            for bx in range(-(-cols // tx)):
                z0, x0 = bz * tz - h, bx * tx - h
                rz, rx = tz + 2 * h, tx + 2 * h
                a = np.full((rz, rx), np.nan, np.float32)  # off the grid: never read
                zl, zh = _lo(z0, 0, off), _hi(z0, rz, rows, 0, off)
                xl, xh = _lo(x0, 0, off), _hi(x0, rx, cols, 0, off)
                a[zl:zh + 1, xl:xh + 1] = grid[z0 + zl:z0 + zh + 1, x0 + xl:x0 + xh + 1]
                for j in range(1, m + 1):
                    ranges = [_lo(z0, j, off), _hi(z0, rz, rows, j, off), _lo(x0, j, off),
                              _hi(x0, rx, cols, j, off), _lo(z0, j - 1, off),
                              _hi(z0, rz, rows, j - 1, off), _lo(x0, j - 1, off),
                              _hi(x0, rx, cols, j - 1, off)]
                    b = np.full_like(a, np.nan)
                    _pass(a, b, *ranges, series, np.float32(factor), strip)
                    a = b
                zs = slice(h, h + min(tz, rows - bz * tz))
                xs_ = slice(h, h + min(tx, cols - bx * tx))
                out[t, bz * tz:bz * tz + tz, bx * tx:bx * tx + tx] = a[zs, xs_]
    return torch.from_numpy(out if stack else out[0])


@pytest.mark.parametrize("shape", [(37, 50), (1, 40), (40, 1), (5, 3), (3, 29, 21)])
@pytest.mark.parametrize("name,iterations", [("Gauss3_S1", 3), ("Gauss9_S1", 2),
                                             ("Smooth3", 1), ("Sobel3Horizontal", 2),
                                             ("Prewitt3Vertical", 1)])
def test_short_replay_is_exact(shape, name, iterations):
    tx, tz, factor = TK._SERIES_TABLE[name]
    x = torch.from_numpy(_field(sum(shape) + iterations, shape))
    got = replay_short(x, [(tx, tz)], iterations, (8, 16), 3, factor)
    want = SC.separable_chain_plain(x, tx, iterations, taps_z=tz, factor=factor)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


@pytest.mark.parametrize("k,iterations,strip", [(1, 5, 32), (5, 4, 32), (3, 8, 7),
                                                (17, 1, 32), (7, 2, 1)])
def test_short_replay_tap_counts_and_strips(k, iterations, strip):
    t = smooth_taps(k)
    x = torch.from_numpy(_field(k, (45, 70)))
    got = replay_short(x, [(t, t)], iterations, (16, 32), strip)
    np.testing.assert_array_equal(got.numpy(),
                                  SC.separable_chain_plain(x, t, iterations).numpy())


def test_short_replay_on_the_default_tile_matches_jax():
    tx, tz, factor = TK._SERIES_TABLE["Gauss9_S1"]
    x = torch.from_numpy(_field(3, (70, 300)))
    plan = SC.short_plan(9, 2)
    got = replay_short(x, [(tx, tz)], 2, plan.tile, plan.strip, factor)
    with jax.disable_jit():
        want = np.asarray(JK.kernel_filter(jnp.asarray(x.numpy()), "Gauss9_S1", 2))
    np.testing.assert_array_equal(got.numpy(), want)


def test_short_halo_one_short_is_not_exact():
    """The plan's halo is what keeps the tile exact: the chain run on each
    tile's window cut one cell short of it differs from the whole map."""
    tx, tz, factor = TK._SERIES_TABLE["Gauss3_S1"]
    x = torch.from_numpy(_field(6, (40, 40)))
    plan = SC.short_plan(3, 3)
    want = SC.separable_chain_plain(x, tx, 3, taps_z=tz)

    def windows(halo):
        out = torch.empty_like(x)
        for z in range(0, 40, 8):
            for c in range(0, 40, 8):
                wz = slice(max(0, z - halo), min(40, z + 8 + halo))
                wx = slice(max(0, c - halo), min(40, c + 8 + halo))
                part = SC.separable_chain_plain(x[wz, wx], tx, 3, taps_z=tz)
                out[z:z + 8, c:c + 8] = part[z - wz.start:z - wz.start + 8,
                                             c - wx.start:c - wx.start + 8]
        return out
    assert torch.equal(windows(plan.halo), want)
    assert not torch.equal(windows(plan.halo - 1), want)


@pytest.mark.parametrize("shape", [(37, 50), (1, 40), (40, 1), (2, 19, 23)])
@pytest.mark.parametrize("taps", [SOBEL, PREWITT], ids=["sobel", "prewitt"])
def test_rss_replay_is_exact(shape, taps):
    x = torch.from_numpy(_field(sum(shape), shape))
    got = replay_short(x, list(taps), 1, (8, 16), 5)
    want = SC.root_sum_squares_chain_plain(x, *taps)
    np.testing.assert_array_equal(got.numpy(), want.numpy())


# --- K1@rss's plain version against the reference ------------------------------

def _check(got, eager, compiled):
    np.testing.assert_array_equal(got, eager)
    scale = max(1.0, float(np.abs(compiled).max()))
    np.testing.assert_allclose(got, compiled, rtol=0, atol=1e-6 * scale)


def test_rss_plain_is_the_wrappers_cpu_route():
    x = torch.from_numpy(_field(1, (33, 47)))
    np.testing.assert_array_equal(SC.root_sum_squares_chain(x, *SOBEL).numpy(),
                                  SC.root_sum_squares_chain_plain(x, *SOBEL).numpy())
    np.testing.assert_array_equal(TK.sobel2d(x).numpy(),
                                  SC.root_sum_squares_chain_plain(x, *SOBEL).numpy())


def test_rss_matches_sobel2d():
    a = _field(2, (40, 52))
    got = SC.root_sum_squares_chain_plain(torch.from_numpy(a), *SOBEL).numpy()
    with jax.disable_jit():
        eager = np.asarray(JK.sobel2d(jnp.asarray(a)))
    _check(got, eager, np.asarray(jax.jit(JK.sobel2d)(jnp.asarray(a))))


@pytest.mark.parametrize("iterations", [1, 2, 3])
def test_rss_matches_kernel_filter_sobel3_2d(iterations):
    a = _field(10 + iterations, (36, 45))
    x = torch.from_numpy(a)
    for _ in range(iterations):
        x = SC.root_sum_squares_chain_plain(x, *SOBEL)
    got = x.numpy()
    np.testing.assert_array_equal(
        TK.kernel_filter(torch.from_numpy(a), "Sobel3_2D", iterations).numpy(), got)
    with jax.disable_jit():
        eager = np.asarray(JK.kernel_filter(jnp.asarray(a), "Sobel3_2D", iterations))
    compiled = np.asarray(jax.jit(JK.kernel_filter, static_argnums=(1, 2))(
        jnp.asarray(a), "Sobel3_2D", iterations))
    _check(got, eager, compiled)


@pytest.mark.parametrize("algorithm,taps", [("SOBEL", SOBEL), ("PREWITT", PREWITT)])
def test_rss_matches_edge_2d(algorithm, taps):
    a = _field(20, (41, 38))
    got = SC.root_sum_squares_chain_plain(torch.from_numpy(a), *taps).numpy()
    np.testing.assert_array_equal(TE.edge_2d(torch.from_numpy(a), algorithm).numpy(), got)
    with jax.disable_jit():
        eager = np.asarray(JE.edge_2d(jnp.asarray(a), algorithm))
    compiled = np.asarray(jax.jit(JE.edge_2d, static_argnums=1)(jnp.asarray(a), algorithm))
    _check(got, eager, compiled)


def test_launch_constants():
    """What the wrappers hand the kernel (``NoizeSeries``), built here as on
    the card: unequal tap lists centred in zeros, the factor in float32,
    the plan's tile; K1@rss's two series."""
    g5 = TK.gaussian_taps(1.0, 5)
    s = SC._build("short", g5, TK._SOBEL3_HZ, float(np.float32(1.0 / 3.0)), 2).series
    assert (s.k, s.iterations, s.rss, s.factor) == (5, 2, 0, float(np.float32(1.0 / 3.0)))
    assert (s.tile_z, s.tile_x, s.threads, s.strip) == (*SC.SHORT_MANY[:2], *SC.SHORT_MANY[2:])
    np.testing.assert_array_equal(np.array(s.hx[:5], np.float32), g5)
    np.testing.assert_array_equal(np.array(s.hz[:5], np.float32), [0, 1, 2, 1, 0])
    with pytest.raises(ValueError, match="≤ 17 long"):
        SC._build("short", smooth_taps(19), None, 1.0, 1)
    assert SC._build("auto", smooth_taps(19), None, 1.0, 1).plan.launches == (1,)  # chain_tile
    taps = [SC._taps_arg(t, "t", SC.RSS_MAX_TAPS) for pair in PREWITT for t in pair]
    k, taps = SC._centred(taps)
    r = SC._series(k, SC.short_plan(k, 1), [(taps[0], taps[1]), (taps[2], taps[3])])
    assert (r.k, r.iterations, r.rss) == (3, 1, 1)
    for got, want in zip((r.hx, r.hz, r.vx, r.vz), (*PREWITT[0], *PREWITT[1])):
        np.testing.assert_array_equal(np.array(got[:3], np.float32), want)
    with pytest.raises(ValueError, match="≤ 9 long"):
        SC._taps_arg(smooth_taps(11), "H taps", SC.RSS_MAX_TAPS)


# --- the root -------------------------------------------------------------------

def _sqrt_cases():
    rng = np.random.default_rng(14)
    bits = rng.integers(0, 2**32, 1_000_000, dtype=np.uint64).astype(np.uint32)
    x = bits.view(np.float32)
    tiny = np.float32(np.finfo(np.float32).smallest_subnormal)
    specials = np.array([0.0, -0.0, tiny, 2 * tiny, np.finfo(np.float32).tiny * 0.5,
                         np.finfo(np.float32).tiny, np.finfo(np.float32).max, np.inf, -np.inf,
                         np.nan, -1.0, 1.0, 2.0, 4.0], np.float32)
    return np.concatenate([x, specials])


def test_f32_sqrt_is_correctly_rounded():
    """Random bit patterns cover every binade, the subnormals and the
    negatives (NaN on both sides); the root of -0 is -0."""
    x = _sqrt_cases()
    with np.errstate(invalid="ignore"):
        want = np.sqrt(x)
    got = f32.sqrt(torch.from_numpy(x)).numpy()
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))
    assert np.signbit(f32.sqrt(torch.tensor([-0.0])).numpy()[0])
