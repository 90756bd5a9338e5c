"""The port's buffer store and serde (``noize_tpu_torch.core``) against
``noize_tpu.core``: a save written by either package restores in the
other, with an identical manifest and payload bytes (the port writes the
native NZTFU format, the reference's NumPy route raw dumps); the native
format is read and its checksum enforced.

Tolerance: exact — checkpoints are raw float32 bytes.
"""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from noize_tpu.core import serde as JSerde
from noize_tpu.core.store import PipelineStateManager as JStore
from noize_tpu_torch import convert
from noize_tpu_torch.core import serde as TSerde
from noize_tpu_torch.core.store import PipelineStateManager

NAMES = ("0_0__64__TERRAIN_HEIGHT", "0_0__64__PARTERO_WATERMAP_POOL", "ints")


def _buffers():
    rng = np.random.default_rng(0)
    return {NAMES[0]: rng.uniform(0, 1, (64, 64)).astype(np.float32),
            NAMES[1]: rng.uniform(0, 1e-3, (64, 64)).astype(np.float32),
            NAMES[2]: np.arange(12, dtype=np.int32).reshape(3, 4)}


@pytest.fixture
def numpy_route(monkeypatch):
    """The reference's NumPy serde route (its native library off)."""
    monkeypatch.setattr(JSerde, "_native", lambda: None)


def _files(root):
    out = {}
    for dirpath, _, names in os.walk(root):
        for n in names:
            p = os.path.join(dirpath, n)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def test_jax_save_restores_in_port_and_bytes_match(tmp_path, numpy_route):
    bufs = _buffers()
    js = JStore(str(tmp_path / "jax"), "world", "v1")
    for k, v in bufs.items():
        js.set_buffer(k, jnp.asarray(v))
        assert js.save_buffer_to_disk(k)
    port = PipelineStateManager(str(tmp_path / "jax"), "world", "v1", device="cpu")
    for k, v in bufs.items():
        back = port.get_buffer(k)
        assert isinstance(back, torch.Tensor) and back.shape == v.shape
        np.testing.assert_array_equal(back.numpy(), v)
    # the port writes the same manifest, and the same payload bytes behind
    # the native format's 32-byte header
    ts = PipelineStateManager(str(tmp_path / "port"), "world", "v1", device="cpu")
    for k, v in bufs.items():
        ts.set_buffer(k, torch.from_numpy(v))
        assert ts.save_buffer_to_disk(k)
    port, ref = _files(tmp_path / "port"), _files(tmp_path / "jax")
    assert sorted(port) == sorted(ref)
    for name, raw in ref.items():
        if name.endswith(".data"):
            assert port[name][:8] == (0x4E5A544655).to_bytes(8, "little")
            assert port[name][32:] == raw
        else:
            assert port[name] == raw


def test_port_save_restores_in_jax(tmp_path, numpy_route):
    bufs = _buffers()
    ts = PipelineStateManager(str(tmp_path), "world", "v1", device="cpu")
    for k, v in bufs.items():
        ts.set_buffer(k, torch.from_numpy(v))
    assert ts.save_all() == {}
    js = JStore(str(tmp_path), "world", "v1")
    for k, v in bufs.items():
        back = np.asarray(js.get_buffer(k))
        assert back.dtype == v.dtype
        np.testing.assert_array_equal(back, v)
    via = convert.load_jax_store(str(tmp_path), "world", "v1", device="cpu")
    assert via.names() == sorted(bufs)


def _native_file(path, arr):
    payload = np.ascontiguousarray(arr).tobytes()
    head = ((0x4E5A544655).to_bytes(8, "little") + (1).to_bytes(4, "little")
            + bytes(4) + len(payload).to_bytes(8, "little")
            + JSerde._fnv1a(payload).to_bytes(8, "little"))
    with open(path, "wb") as fh:
        fh.write(head + payload)


def test_native_format_read_and_corruption_refused(tmp_path):
    arr = _buffers()[NAMES[0]][:16, :16].copy()
    ts = PipelineStateManager(str(tmp_path), "n", "0", device="cpu")
    ts.set_buffer("h", torch.from_numpy(arr))
    ts.save_buffer_to_disk("h")
    path = ts.serde._path_for("h")
    _native_file(path, arr)
    assert TSerde._fnv1a(b"noize") == JSerde._fnv1a(b"noize")
    fresh = PipelineStateManager(str(tmp_path), "n", "0", device="cpu")
    np.testing.assert_array_equal(fresh.get_buffer("h").numpy(), arr)
    with open(path, "r+b") as fh:
        fh.seek(40)
        b = fh.read(1)
        fh.seek(40)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(IOError, match="checksum"):
        PipelineStateManager(str(tmp_path), "n", "0", device="cpu").get_buffer("h")
    with open(path, "r+b") as fh:
        fh.truncate(100)
    with pytest.raises(IOError, match="truncated"):
        PipelineStateManager(str(tmp_path), "n", "0", device="cpu").get_buffer("h")


def test_reference_native_writer_restores_in_port(tmp_path):
    """Where the reference's C++ library is built, its saves are native
    files; the port reads them through its NumPy route."""
    bufs = _buffers()
    js = JStore(str(tmp_path), "w", "1")
    for k, v in bufs.items():
        js.set_buffer(k, jnp.asarray(v))
        js.save_buffer_to_disk(k)
    port = PipelineStateManager(str(tmp_path), "w", "1", device="cpu")
    for k, v in bufs.items():
        np.testing.assert_array_equal(port.get_buffer(k).numpy(), v)


def test_store_buffers_locks_callbacks(tmp_path):
    sm = PipelineStateManager(str(tmp_path), device="cpu")
    seen = []
    cb = lambda name, value: seen.append(name)  # noqa: E731
    sm.register_callback("a", cb)
    assert sm.get_buffer("a", factory=lambda: torch.zeros(2)).shape == (2,)
    sm.set_buffer("a", torch.ones(3))
    assert seen == ["a"] and sm.remove_callback("a", cb) and not sm.remove_callback("a", cb)
    t1, t2 = object(), object()
    assert sm.try_set_lock("a", t1) and not sm.try_set_lock("a", t2)
    assert sm.is_locked("a") and not sm.is_locked("a", t1)
    assert not sm.unlock("a", t2) and sm.unlock("a", t1) and not sm.is_locked("a")
    sm.set_buffer("meta", {"k": 1})
    sm.set_buffer("ragged", [[1, 2], [3]])
    assert sm.save_all() == {}
    assert sorted(sm.serde.directory.entries) == ["a"]
    sm.release_buffer("a")
    assert sm.buffer_exists("a")  # on disk
    assert torch.equal(sm.get_buffer("a"), torch.ones(3))
    assert not PipelineStateManager(device="cpu").save_buffer_to_disk("a")
