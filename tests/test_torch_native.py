"""The port's native IO runtime (``noize_tpu_torch.native``, its own copy of
``serde_native.cpp``, built with g++ on first use) and what runs on it: the
NZTFU checkpoints of ``core.serde`` and the OBJ writer of
``app.mesh_export``.

Tolerance: exact — checkpoints are raw bytes behind a checksummed header,
and the OBJ text is compared byte for byte with the NumPy writer's and the
reference's.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu import native as JNative
from noize_tpu.app import mesh_export as JX
from noize_tpu.core import serde as JSerde
from noize_tpu.ops import mesh as JM
from noize_tpu_torch import native
from noize_tpu_torch.app import mesh_export as TX
from noize_tpu_torch.core import serde as TSerde
from noize_tpu_torch.ops import mesh as TM

MAGIC = (0x4E5A544655).to_bytes(8, "little")


def _arrays():
    rng = np.random.default_rng(0)
    return {"f32": rng.uniform(-1, 1, (64, 64)).astype(np.float32),
            "i32": rng.integers(-9, 9, (5, 7)).astype(np.int32),
            "u8": rng.integers(0, 255, 1000).astype(np.uint8)}


def _no_tmp(root):
    return not [n for _, _, names in os.walk(root) for n in names if n.endswith(".tmp")]


def test_round_trip_header_and_checksum(tmp_path):
    for name, arr in _arrays().items():
        path = str(tmp_path / f"{name}.data")
        native.write_file(path, arr)
        raw = open(path, "rb").read()
        payload = arr.tobytes()
        assert raw[:8] == MAGIC and int.from_bytes(raw[8:12], "little") == 1
        assert int.from_bytes(raw[16:24], "little") == len(payload)
        assert int.from_bytes(raw[24:32], "little") == TSerde._fnv1a(payload)
        assert raw[32:] == payload
        back = native.read_file(path, arr.dtype)
        np.testing.assert_array_equal(back, arr.reshape(-1))
    assert _no_tmp(tmp_path)


def test_corrupt_payload_and_truncation_raise(tmp_path):
    arr = _arrays()["f32"]
    path = str(tmp_path / "h.data")
    native.write_file(path, arr)
    with open(path, "r+b") as fh:
        fh.seek(32 + 1000)
        b = fh.read(1)
        fh.seek(32 + 1000)
        fh.write(bytes([b[0] ^ 0x01]))
    with pytest.raises(native.NativeIOError, match="checksum"):
        native.read_file(path, np.float32)
    native.write_file(path, arr)
    with open(path, "r+b") as fh:
        fh.truncate(32 + 100)
    with pytest.raises(native.NativeIOError, match="truncated"):
        native.read_file(path, np.float32)


def test_legacy_raw_file_is_read(tmp_path):
    for name, arr in _arrays().items():
        path = str(tmp_path / f"{name}.raw")
        arr.tofile(path)
        np.testing.assert_array_equal(native.read_file(path, arr.dtype), arr.reshape(-1))
    short = tmp_path / "short.raw"  # shorter than a header
    np.arange(3, dtype=np.int32).tofile(short)
    np.testing.assert_array_equal(native.read_file(str(short), np.int32), [0, 1, 2])


def test_async_tickets_and_flush(tmp_path):
    arrs = {f"a{i}": np.full((256, 256), i, np.float32) for i in range(12)}
    tickets = []
    for name, arr in arrs.items():
        tickets.append(native.write_file_async(str(tmp_path / f"{name}.data"), arr))
        arr[:] = -1.0  # the pool copied the bytes when the write was queued
    assert tickets == sorted(tickets) and len(set(tickets)) == len(tickets)
    native.wait(tickets[3])
    for i in range(4):
        assert os.path.exists(tmp_path / f"a{i}.data")
    native.wait(0)
    assert native.pending() == 0
    for i in range(12):
        np.testing.assert_array_equal(
            native.read_file(str(tmp_path / f"a{i}.data"), np.float32), float(i))
    assert _no_tmp(tmp_path)


def test_async_saves_from_threads_then_flush(tmp_path):
    sm = TSerde.SerdeManager(str(tmp_path), "t", "0")
    arrs = {f"b{i}": np.random.default_rng(i).uniform(0, 1, (128, 128)).astype(np.float32)
            for i in range(16)}
    lock = threading.Lock()  # the manifest is the caller's to serialise

    def worker(names):
        for n in names:
            with lock:
                sm.save(n, arrs[n], async_=True)

    threads = [threading.Thread(target=worker, args=(list(arrs)[i::4],)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
        assert not t.is_alive()
    sm.flush()
    fresh = TSerde.SerdeManager(str(tmp_path), "t", "0")
    for n, a in arrs.items():
        np.testing.assert_array_equal(fresh.load(n), a)
    assert _no_tmp(tmp_path)


def test_failed_write_raises(tmp_path):
    with pytest.raises(native.NativeIOError):
        native.write_file(str(tmp_path / "missing" / "x.data"), np.zeros(4, np.float32))


def test_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "serde_native.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(native.NativeIOError, match="failed"):
        native.available()
    assert not native.library_path().exists()


@pytest.mark.parametrize("ref_route", ["native", "numpy"])
def test_checkpoints_cross_both_ways(tmp_path, monkeypatch, ref_route):
    if ref_route == "numpy":
        monkeypatch.setattr(JSerde, "_native", lambda: None)
    else:
        assert JNative.available()
    arrs = _arrays()
    # the port writes (sync and async), the reference reads
    port = TSerde.SerdeManager(str(tmp_path / "p"), "w", "1")
    for i, (k, v) in enumerate(arrs.items()):
        port.save(k, v, async_=bool(i % 2))
    port.flush()
    ref = JSerde.SerdeManager(str(tmp_path / "p"), "w", "1")
    for k, v in arrs.items():
        back = ref.load(k)
        assert back.dtype == v.dtype
        np.testing.assert_array_equal(back, v)
    # the reference writes, the port reads
    ref = JSerde.SerdeManager(str(tmp_path / "r"), "w", "1")
    for k, v in arrs.items():
        ref.save(k, v)
    ref.flush()
    port = TSerde.SerdeManager(str(tmp_path / "r"), "w", "1")
    for k, v in arrs.items():
        np.testing.assert_array_equal(port.load(k), v)
    head = open(port._path_for("f32"), "rb").read(8)
    assert (head == MAGIC) == (ref_route == "native")


def _meshes(res):
    """The reference's mesh of a ``res``² tile and the same streams as the
    port's ``MeshArrays`` (int32 indices)."""
    h = np.random.default_rng(1).uniform(0, 1, (res + 8, res + 8)).astype(np.float32)
    jm = JM.heightmap_mesh_overshoot(jnp.asarray(h), res, res + 8, 1000.0, float(res))
    tm = TM.MeshArrays(*(torch.from_numpy(np.array(getattr(jm, f))) for f in
                         ("positions", "normals", "tangents", "uvs")),
                       indices=torch.from_numpy(np.asarray(jm.indices).astype(np.int32)))
    return jm, tm


def test_obj_byte_identical_to_numpy_and_reference(tmp_path, monkeypatch):
    jm, tm = _meshes(64)
    TX.to_obj(str(tmp_path / "native.obj"), tm, name="tile")
    TX.to_obj_numpy(str(tmp_path / "numpy.obj"), tm, name="tile")
    JX.to_obj(str(tmp_path / "ref_native.obj"), jm, name="tile")
    monkeypatch.setattr(JNative, "obj_write",
                        lambda *a, **k: (_ for _ in ()).throw(JNative.NativeIOError("off")))
    JX.to_obj(str(tmp_path / "ref_numpy.obj"), jm, name="tile")
    want = (tmp_path / "numpy.obj").read_bytes()
    assert want.count(b"\n") > 3 * 64 * 64
    for f in ("native.obj", "ref_native.obj", "ref_numpy.obj"):
        assert (tmp_path / f).read_bytes() == want, f
    assert native.obj_write(str(tmp_path / "n2.obj"), "tile", *[
        np.asarray(getattr(tm, k)) for k in ("positions", "normals", "uvs")],
        np.asarray(tm.indices)) == len(want)
    assert _no_tmp(tmp_path)


def test_obj_write_refuses_bad_shapes(tmp_path):
    with pytest.raises(native.NativeIOError, match="shapes"):
        native.obj_write(str(tmp_path / "x.obj"), "x", np.zeros((4, 3)), np.zeros((4, 3)),
                         np.zeros((3, 2)), np.zeros(6, np.int32))
