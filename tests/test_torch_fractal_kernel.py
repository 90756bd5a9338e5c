"""K10, the fBm kernel (``csrc/fractal.cu``, ``ops/cuda/fractal.py``), on
the CPU: what the wrapper hands the kernel and the kernel's arithmetic.

K10 itself runs only on a card, in ``tests/test_torch_kernels_cuda.py``.
Here, on the CPU:

  * the host octave table (f, a, acc) against the reference's own float32
    recurrence (eager JAX) and against the scalars the plain version uses;
  * the packing of a call (origins, stacks, windows, the octave limit);
  * the CPU path never reaches K10, and ``device="cuda"`` without a GPU
    raises;
  * every constant of ``csrc/noise.cuh`` is the float32 rounding of the
    Python literal the plain version multiplies by;
  * ``csrc/noise.cuh`` (the bases and one cell's octave loop, the code each
    K10 thread runs) compiled for the host with g++ through a shim of the
    CUDA names, against the plain version bit for bit at every basis, with
    the sin and cos values the plain version itself computed.

The plain version stays held to JAX by ``tests/test_torch_noise.py`` and
``tests/test_torch_noise_bases.py``.
"""

import ctypes
import re
import shutil
import subprocess

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu_torch import _cuda
from noize_tpu_torch.ops import f32 as F32
from noize_tpu_torch.ops import fractal as TF
from noize_tpu_torch.ops.cuda import fractal as FK

f32 = np.float32

#: (hurst, octaves, stepdown, detune_rate, starting_amplitude): the
#: flagship's, the presets' (app/presets.py), gain-sensitive hurst values
#: (ROADMAP §3, F5), detuned and non-2 stepdowns, and both ends of the range
SETTINGS = [
    (0.4, 13, 2.0, 0.0, 1.0),
    (0.9, 13, 2.0, 0.0, 1.0),
    (0.5938, 8, 2.0, 0.0, 1.0),
    (0.9001, 6, 2.0, 0.0, 1.0),
    (0.87, 5, 1.9607, 0.04, 1.0),
    (0.123, 24, 2.5, 0.01, 0.7),
    (0.059, 17, 1.75, -0.03, 2.5),
    (1.7, 32, 1.5, 0.02, 3.0),
    (0.0, 1, 2.0, 0.0, 1.0),
    (0.4, 0, 2.0, 0.0, 1.0),
]


def _reference_table(hurst, octaves, stepdown, detune_rate, amp):
    """noize_tpu/ops/fractal.py:134-155's scalars, eager JAX float32."""
    with jax.disable_jit():
        g = jnp.exp2(-jnp.asarray(hurst, jnp.float32))
        stepdown = jnp.asarray(stepdown, jnp.float32)
        detune_rate = jnp.asarray(detune_rate, jnp.float32)
        f = jnp.asarray(1.0, jnp.float32)
        a = jnp.asarray(amp, jnp.float32)
        detune = jnp.asarray(0.0, jnp.float32)
        fs, amps = [], []
        for _ in range(octaves):
            fs.append(np.asarray(f))
            amps.append(np.asarray(a))
            detune = detune + detune_rate
            f = f * (stepdown - detune)
            a = a * g
        norm = jnp.asarray(1.0, jnp.float32)
        acc = jnp.asarray(0.0, jnp.float32)
        for _ in range(octaves):
            acc = acc + norm
            norm = norm * g
    return np.asarray(fs, f32), np.asarray(amps, f32), f32(np.asarray(acc))


@pytest.mark.parametrize("setting", SETTINGS, ids=[str(s) for s in SETTINGS])
def test_octave_table_matches_reference_recurrence(setting):
    fs, amps, acc = TF.octave_table(*setting)
    want_f, want_a, want_acc = _reference_table(*setting)
    np.testing.assert_array_equal(fs, want_f)
    np.testing.assert_array_equal(amps, want_a)
    assert acc.dtype == f32 and acc.tobytes() == want_acc.tobytes()
    assert not fs.flags.writeable and not amps.flags.writeable


@pytest.mark.parametrize("setting", SETTINGS[:8], ids=[str(s) for s in SETTINGS[:8]])
def test_plain_version_takes_the_table(setting, monkeypatch):
    """The plain version's scalars, read off its noise calls: at a cell
    whose coordinate is 1 the basis sees f itself, and a one-hot noise (1 in
    octave j's column) leaves a_j / acc there."""
    hurst, octaves, stepdown, detune_rate, amp = setting
    seen = []

    def one_hot(kind, x, z):
        seen.append(float(x[0, 0]))
        v = torch.zeros_like(x)
        v[:, len(seen) - 1] = 1.0
        return v

    monkeypatch.setattr(TF, "noise_value", one_hot)
    out = TF.fractal_window(0, 0, 1, octaves, 1.0, 0.0, noise_type="Simplex", hurst=hurst,
                            octaves=octaves, stepdown=stepdown, detune_rate=detune_rate,
                            noise_size=1.0, starting_amplitude=amp, device="cpu")
    fs, amps, acc = TF.octave_table(*setting)
    np.testing.assert_array_equal(np.asarray(seen, f32), fs)
    want = (torch.from_numpy(amps.copy()) / torch.tensor(float(acc))).numpy()
    np.testing.assert_array_equal(out.numpy()[0], want)


def test_octave_table_gain_is_the_runtime_exp2():
    g = F32.exp2(-f32(0.9))
    _, amps, _ = TF.octave_table(0.9, 3, 2.0, 0.0, 1.0)
    assert amps[1] == g and amps[2] == f32(g * g)


def _fields(p):
    return {name: getattr(p, name) for name, _ in p._fields_ if name not in ("f", "a")}


KW = dict(noise_type="Cellular", hurst=0.4, octaves=13, stepdown=2.0, detune_rate=0.0,
          noise_size=1700.0, starting_amplitude=1.0)


def test_pack_single_tile():
    p, origins, shape = FK.pack(0, 0, 64, 48, 0.1, -2.5, **KW)
    assert origins is None and shape == (64, 48)
    fs, amps, acc = TF.octave_table(0.4, 13, 2.0, 0.0, 1.0)
    assert _fields(p) == dict(basis=TF.NOISE_TYPES.index("Cellular"), octaves=13, tiles=1,
                              rows=64, cols=48, row0=0, col0=0,
                              inv_size=float(f32(1.0) / f32(1700.0)), x0=float(f32(0.1)),
                              z0=-2.5, acc=float(acc))
    np.testing.assert_array_equal(np.asarray(p.f[:13], f32), fs)
    np.testing.assert_array_equal(np.asarray(p.a[:13], f32), amps)
    assert list(p.f[13:]) == [0.0] * (FK.MAX_OCTAVES - 13)


def test_pack_window():
    p, origins, shape = FK.pack(7, 1024, 5, 3, 100.0, 200.0, **KW)
    assert (p.row0, p.col0, p.rows, p.cols, p.tiles) == (7, 1024, 5, 3, 1)
    assert origins is None and shape == (5, 3)


@pytest.mark.parametrize("xpos,zpos,want", [
    ([0.0, 1024.0, 2048.0], [0.0, 0.0, 1024.5], [[0, 0], [1024, 0], [2048, 1024.5]]),
    ([1.0, 2.0, 3.0], 5.0, [[1, 5], [2, 5], [3, 5]]),
    (np.asarray([[0.1]]), np.asarray([7.0]), [[0.1, 7.0]]),
    ([3.0], [4.0], [[3.0, 4.0]]),
])
def test_pack_stack_of_origins(xpos, zpos, want):
    p, origins, shape = FK.pack(0, 0, 8, 8, xpos, zpos, **KW)
    want = np.asarray(want, f32)
    assert origins.dtype == f32 and origins.flags.c_contiguous
    np.testing.assert_array_equal(origins, want)
    assert p.tiles == len(want) and shape == (len(want), 8, 8)
    plain = TF.fractal_window_plain(0, 0, 8, 8, xpos, zpos, device="cpu",
                                    **{**KW, "octaves": 1})
    assert tuple(plain.shape) == shape


def test_pack_limits():
    FK.pack(0, 0, 4, 4, 0.0, 0.0, **{**KW, "octaves": FK.MAX_OCTAVES})
    with pytest.raises(ValueError, match="at most 32 octaves"):
        FK.pack(0, 0, 4, 4, 0.0, 0.0, **{**KW, "octaves": FK.MAX_OCTAVES + 1})
    with pytest.raises(ValueError, match="unknown noise type"):
        FK.pack(0, 0, 4, 4, 0.0, 0.0, **{**KW, "noise_type": "Voronoi"})
    with pytest.raises(ValueError, match="negative window"):
        FK.pack(-1, 0, 4, 4, 0.0, 0.0, **KW)
    assert FK.MAX_OCTAVES == _cuda.MAX_OCTAVES
    assert len(_cuda.Fractal().f) == len(_cuda.Fractal().a) == FK.MAX_OCTAVES
    src = (_cuda.CSRC / "fractal.cu").read_text()
    assert f"constexpr int kMaxOctaves = {FK.MAX_OCTAVES};" in src


def test_cpu_calls_never_reach_k10(monkeypatch):
    def refuse(*args, **kw):
        raise AssertionError("K10 reached from a CPU call")

    monkeypatch.setattr(_cuda, "call", refuse)
    monkeypatch.setattr(_cuda, "library", refuse)
    before = FK.fractal_fused.launches
    one = TF.fractal(16, 0.0, 0.0, noise_type="Simplex", octaves=3, device="cpu")
    stack = TF.fractal(16, [0.0, 16.0], [0.0, 0.0], noise_type="Perlin", octaves=2,
                       device="cpu")
    win = TF.fractal_window(2, 3, 4, 5, 0.0, 0.0, noise_type="Simplex", octaves=3,
                            device=torch.device("cpu"))
    assert FK.fractal_fused.launches == before
    assert tuple(one.shape) == (16, 16) and tuple(stack.shape) == (2, 16, 16)
    assert torch.equal(win, one[2:6, 3:8])


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.fractal(16, 0.0, 0.0, device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TF.fractal_window(0, 0, 4, 4, 0.0, 0.0)
    with pytest.raises(ValueError, match="expected a CUDA device"):
        FK.fractal_fused(0, 0, 4, 4, 0.0, 0.0, device="cpu")


_CONST = re.compile(r"constexpr float (k\w+) = (-?0x[0-9a-f.]+p[-+]?\d+)f;\s*// = (.+)$")


def _constants():
    src = (_cuda.CSRC / "noise.cuh").read_text()
    return [m.groups() for m in map(_CONST.match, src.splitlines()) if m]


def test_noise_constants_found():
    assert len(_constants()) >= 20


@pytest.mark.parametrize("name,literal,expr", _constants(), ids=lambda v: str(v)[:24])
def test_noise_constant_is_float32_of_python_literal(name, literal, expr):
    assert float.fromhex(literal) == float(f32(eval(expr, {})))  # noqa: S307


# --- noise.cuh on the host ---------------------------------------------------

# The CUDA names noise.cuh and common.cuh use, for g++: the rounded
# intrinsics as plain float operations (SSE rounds each; -ffp-contract=off
# forbids contraction), sinf and cosf through pointers the test sets.
_SHIM = r"""
#pragma once
#include <cmath>
#define __device__
#define __forceinline__ inline
struct NoizeDim3 { unsigned x, y, z; };
static NoizeDim3 threadIdx, blockDim;
inline unsigned long long __cvta_generic_to_shared(const void*) { return 0; }
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }
inline float __fdiv_rn(float a, float b) { return a / b; }
inline float __fsqrt_rn(float a) { return std::sqrt(a); }
extern "C" float (*noize_host_sin)(float);
extern "C" float (*noize_host_cos)(float);
#define sinf(x) noize_host_sin(x)
#define cosf(x) noize_host_cos(x)
"""

_HARNESS = r"""
#include "noise.cuh"
extern "C" {
float (*noize_host_sin)(float) = nullptr;
float (*noize_host_cos)(float) = nullptr;
void fbm_cells(int basis, long long n, const float* xi, const float* zi, const float* f,
               const float* a, int octaves, float acc, float* out) {
  using noize::noise::fbm;
  for (long long e = 0; e < n; ++e) {
    switch (basis) {
      case 0: out[e] = fbm<0>(xi[e], zi[e], f, a, octaves, acc); break;
      case 1: out[e] = fbm<1>(xi[e], zi[e], f, a, octaves, acc); break;
      case 2: out[e] = fbm<2>(xi[e], zi[e], f, a, octaves, acc); break;
      case 3: out[e] = fbm<3>(xi[e], zi[e], f, a, octaves, acc); break;
      case 4: out[e] = fbm<4>(xi[e], zi[e], f, a, octaves, acc); break;
      case 5: out[e] = fbm<5>(xi[e], zi[e], f, a, octaves, acc); break;
      case 6: out[e] = fbm<6>(xi[e], zi[e], f, a, octaves, acc); break;
      default: out[e] = fbm<7>(xi[e], zi[e], f, a, octaves, acc); break;
    }
  }
}
}
"""

_TRIG = ctypes.CFUNCTYPE(ctypes.c_float, ctypes.c_float)


@pytest.fixture(scope="module")
def host_noise(tmp_path_factory):
    """``csrc/noise.cuh`` built for the host: (library, sin table, cos
    table); the tables map float32 bits to the value the plain version's
    ``torch.sin``/``torch.cos`` gave, and the kernel's calls read them."""
    gxx = shutil.which("g++")
    assert gxx, "g++ is needed to build noise.cuh for the host"
    d = tmp_path_factory.mktemp("k10_host")
    (d / "cuda_runtime.h").write_text(_SHIM)
    (d / "harness.cpp").write_text(_HARNESS)
    lib_path = d / "libk10_host.so"
    subprocess.run([gxx, "-std=c++17", "-O1", "-ffp-contract=off", "-fPIC", "-shared",
                    "-I", str(d), "-I", str(_cuda.CSRC), str(d / "harness.cpp"), "-o",
                    str(lib_path)], check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(lib_path))
    P = ctypes.c_void_p
    lib.fbm_cells.argtypes = [ctypes.c_int, ctypes.c_longlong, P, P, P, P, ctypes.c_int,
                              ctypes.c_float, P]
    tables = {"sin": {}, "cos": {}}

    def lookup(name):
        def fn(x):
            return tables[name][int(np.float32(x).view(np.int32))]
        return _TRIG(fn)

    callbacks = [lookup("sin"), lookup("cos")]  # kept alive with the fixture
    for var, cb in zip(("noize_host_sin", "noize_host_cos"), callbacks):
        P.in_dll(lib, var).value = ctypes.cast(cb, P).value
    yield lib, tables
    del callbacks


def _recorded(tables, monkeypatch):
    """torch.sin and torch.cos that also store their values by input bits."""
    for name in ("sin", "cos"):
        real = getattr(torch, name)

        def fn(x, real=real, table=tables[name]):
            y = real(x)
            table.update(zip(x.numpy().ravel().view(np.int32).tolist(),
                             y.numpy().ravel().tolist()))
            return y
        monkeypatch.setattr(torch, name, fn)


CASES = [
    (40, 0.0, 0.0, dict(hurst=0.4, octaves=6, stepdown=2.0, detune_rate=0.0,
                        noise_size=37.0, starting_amplitude=1.0)),
    (24, 1234.0, -777.0, dict(hurst=0.9, octaves=13, stepdown=1.9607, detune_rate=0.04,
                              noise_size=187.0, starting_amplitude=0.7)),
]


@pytest.mark.parametrize("case", range(len(CASES)))
@pytest.mark.parametrize("kind", TF.NOISE_TYPES)
def test_noise_cuh_on_the_host_matches_plain(host_noise, kind, case, monkeypatch):
    lib, tables = host_noise
    res, xpos, zpos, kw = CASES[case]
    with monkeypatch.context() as m:
        _recorded(tables, m)
        want = TF.fractal_window_plain(0, 0, res, res, xpos, zpos, noise_type=kind,
                                       device="cpu", **kw).numpy()
    # the plain version's coordinates: (col + xpos) * inv_size in float32
    grid = np.arange(res, dtype=f32)
    inv = f32(1.0) / f32(kw["noise_size"])
    xi = np.ascontiguousarray(np.broadcast_to((grid + f32(xpos)) * inv, (res, res)))
    zi = np.ascontiguousarray(np.broadcast_to(((grid + f32(zpos)) * inv)[:, None], (res, res)))
    fs, amps, acc = TF.octave_table(kw["hurst"], kw["octaves"], kw["stepdown"],
                                    kw["detune_rate"], kw["starting_amplitude"])
    fs, amps = np.ascontiguousarray(fs), np.ascontiguousarray(amps)
    got = np.empty((res, res), f32)
    lib.fbm_cells(TF.NOISE_TYPES.index(kind), res * res, xi.ctypes.data, zi.ctypes.data,
                  fs.ctypes.data, amps.ctypes.data, len(fs), float(acc), got.ctypes.data)
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.ptp(got) > 0
