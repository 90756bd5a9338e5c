"""ctypes bindings for the port's native IO runtime (``serde_native.cpp``,
its own copy of ``noize_tpu``'s).

The library is compiled on first use,

    g++ -O2 -fPIC -std=c++17 -pthread -shared serde_native.cpp

into ``build/noize_tpu_torch/libnoize_serde_<hash of source and flags>.so``
beside the package (the way ``_cuda.library_path`` names the kernels'), so
an edited source rebuilds and an unchanged one loads the cached build.  A
failed build raises ``NativeIOError`` with the compiler's output: the port
has no NumPy fallback for what the library does.

File format (NZTFU): a 32-byte header (u64 magic 'NZTFU', u32 version, u32
reserved, u64 payload bytes, u64 FNV-1a checksum of the payload), then the
raw little-endian payload.  Writes are atomic (a ``.tmp`` file, fsync,
rename) and can be queued on the library's pool of two writer threads, so
checkpoints overlap device work; the pool copies the bytes when a write is
queued, so the caller's buffer may go at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

from .._cuda import BUILD_DIR

SOURCE = pathlib.Path(__file__).resolve().parent / "serde_native.cpp"
CXX_FLAGS = ("-O2", "-fPIC", "-std=c++17", "-pthread", "-shared")

_lib: Optional[ctypes.CDLL] = None
_lock = threading.Lock()


class NativeIOError(IOError):
    pass


def library_path() -> pathlib.Path:
    digest = hashlib.sha256(SOURCE.read_bytes())
    digest.update(" ".join(CXX_FLAGS).encode())
    return BUILD_DIR / f"libnoize_serde_{digest.hexdigest()[:16]}.so"


def build() -> pathlib.Path:
    """Compile the library unless the build for this source exists."""
    out = library_path()
    if out.exists():
        return out
    cxx = os.environ.get("CXX") or shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        raise NativeIOError("no C++ compiler (g++) found: the native IO runtime "
                            "cannot be built")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        lib = os.path.join(tmpdir, "lib.so")
        proc = subprocess.run([cxx, *CXX_FLAGS, "-o", lib, str(SOURCE)],
                              capture_output=True, text=True, timeout=300)
        if proc.returncode != 0:
            raise NativeIOError(f"building {SOURCE.name} failed ({proc.returncode}):\n"
                                f"{proc.stderr}")
        os.replace(lib, out)  # atomic: processes building at once agree
    return out


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.nz_write.restype = ctypes.c_int
        lib.nz_write.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.nz_write_async.restype = ctypes.c_uint64
        lib.nz_write_async.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.nz_wait.restype = ctypes.c_int
        lib.nz_wait.argtypes = [ctypes.c_uint64]
        lib.nz_pending.restype = ctypes.c_int
        lib.nz_pending.argtypes = []
        lib.nz_read.restype = ctypes.c_int
        lib.nz_read.argtypes = [ctypes.c_char_p, ctypes.c_void_p, ctypes.c_uint64]
        lib.nz_payload_size.restype = ctypes.c_int64
        lib.nz_payload_size.argtypes = [ctypes.c_char_p]
        lib.nz_checksum.restype = ctypes.c_uint64
        lib.nz_checksum.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.nz_obj_write.restype = ctypes.c_int64
        lib.nz_obj_write.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_uint64, ctypes.c_void_p, ctypes.c_uint64,
        ]
        _lib = lib
        return lib


def available() -> bool:
    """The library is built and loaded (building it now if need be); a
    failed build raises rather than answering False."""
    return _load() is not None


def write_file(path: str, arr: np.ndarray):
    """Atomic checked write of ``arr``'s bytes (NZTFU)."""
    arr = np.ascontiguousarray(arr)
    rc = _load().nz_write(os.fsencode(path), arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes)
    if rc != 0:
        raise NativeIOError(f"nz_write({path}) failed: {os.strerror(-rc) if rc < 0 else rc}")


def write_file_async(path: str, arr: np.ndarray) -> int:
    """Queue an atomic checked write on the native pool (the bytes are
    copied before this returns); returns a ticket for ``wait``."""
    arr = np.ascontiguousarray(arr)
    return int(_load().nz_write_async(os.fsencode(path),
                                      arr.ctypes.data_as(ctypes.c_void_p), arr.nbytes))


def wait(ticket: int = 0):
    """Block until ``ticket`` (0: every write queued so far) has retired;
    raise if any queued write has failed."""
    rc = _load().nz_wait(int(ticket))
    if rc != 0:
        raise NativeIOError(f"async write failed: {os.strerror(-rc) if rc < 0 else rc}")


def pending() -> int:
    """Queued writes not yet retired."""
    return int(_load().nz_pending())


def obj_write(path: str, name: str, positions, normals, uvs, indices) -> int:
    """Buffered Wavefront OBJ emission, byte-identical to
    ``app.mesh_export``'s NumPy writer (``%.7g`` in the C locale).
    Returns the bytes written."""
    lib = _load()
    pos = np.ascontiguousarray(positions, dtype=np.float32)
    nrm = np.ascontiguousarray(normals, dtype=np.float32)
    uv = np.ascontiguousarray(uvs, dtype=np.float32)
    tris = np.ascontiguousarray(indices, dtype=np.uint32).reshape(-1)
    n_verts = pos.shape[0]
    if pos.shape != (n_verts, 3) or nrm.shape != (n_verts, 3) \
            or uv.shape != (n_verts, 2) or tris.size % 3:
        raise NativeIOError("obj_write: inconsistent stream shapes")
    n = lib.nz_obj_write(
        os.fsencode(path), name.encode(),
        pos.ctypes.data_as(ctypes.c_void_p), nrm.ctypes.data_as(ctypes.c_void_p),
        uv.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(n_verts),
        tris.ctypes.data_as(ctypes.c_void_p), ctypes.c_uint64(tris.size // 3))
    if n < 0:
        raise NativeIOError(f"nz_obj_write({path}) failed: {os.strerror(-n)}")
    return int(n)


def read_file(path: str, dtype) -> np.ndarray:
    """Checked read of a NZTFU file as a flat array of ``dtype``; a legacy
    raw file (no NZTFU header) is read as it is.  Raises on a checksum
    mismatch or a truncated file."""
    lib = _load()
    bpath = os.fsencode(path)
    size = lib.nz_payload_size(bpath)
    if size in (-1, -2):  # shorter than a header, or no magic: a raw dump
        return np.fromfile(path, dtype=np.dtype(dtype))
    if size < 0:
        raise NativeIOError(f"reading {path} failed: {os.strerror(-size)}")
    out = np.empty(size // np.dtype(dtype).itemsize, dtype=np.dtype(dtype))
    rc = lib.nz_read(bpath, out.ctypes.data_as(ctypes.c_void_p), size)
    if rc == -4:
        raise NativeIOError(f"checksum mismatch reading {path}")
    if rc == -3:
        raise NativeIOError(f"truncated native checkpoint: {path}")
    if rc != 0:
        raise NativeIOError(f"nz_read({path}) failed rc={rc}")
    return out
