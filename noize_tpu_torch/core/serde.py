"""Buffer store disk serialization — port of ``noize_tpu.core.serde``
(the NumPy route; no native library, so ``save(async_=True)`` writes at
once and ``flush`` has nothing to wait for).

Layout (PipelineSerialization.cs:15-236): a save root
``save__{name}_{version}/`` holding ``data/{buffer}.data`` raw
little-endian dumps and a ``files.json`` manifest mapping buffer name →
file, element count, dtype and shape.  Files and manifest are
byte-identical to what ``noize_tpu``'s NumPy route writes, so a checkpoint
written by either package restores in the other.

The reader also takes the reference's native format (32-byte header:
u64 magic 'NZTFU', u32 version, u32 reserved, u64 payload bytes, u64
FNV-1a checksum, then the payload), which ``noize_tpu`` writes where its
C++ library is built, and verifies the checksum: a corrupt checkpoint
raises.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

MANIFEST = "files.json"

_NATIVE_MAGIC = (0x4E5A544655).to_bytes(8, "little")
_NATIVE_HEADER_BYTES = 32


def _fnv1a(data: bytes) -> int:
    """FNV-1a 64 over the payload (serde_native.cpp::fnv1a).  The chain is
    sequential per byte; about 1-2 s per 16 MB map."""
    h = 1469598103934665603
    prime = 1099511628211
    mask = (1 << 64) - 1
    for b in memoryview(data):
        h = ((h ^ b) * prime) & mask
    return h


def _read(path: str, dtype) -> np.ndarray:
    """Read a raw dump or a native-format file (checksum verified)."""
    with open(path, "rb") as fh:
        head = fh.read(_NATIVE_HEADER_BYTES)
        if len(head) == _NATIVE_HEADER_BYTES and head[:8] == _NATIVE_MAGIC:
            nbytes = int.from_bytes(head[16:24], "little")
            checksum = int.from_bytes(head[24:32], "little")
            payload = fh.read(nbytes)
            if len(payload) != nbytes:
                raise IOError(f"truncated native checkpoint: {path}")
            if _fnv1a(payload) != checksum:
                raise IOError(f"checksum mismatch in checkpoint: {path}")
            return np.frombuffer(payload, dtype=np.dtype(dtype))
        fh.seek(0)
        return np.fromfile(fh, dtype=np.dtype(dtype))


@dataclass
class FileObject:
    """PipelineSerialization.cs:98-126 analog."""

    file_name: str
    count: int
    dtype: str
    shape: tuple


class FileDirectory:
    """The files.json manifest (PipelineSerialization.cs:15-96)."""

    def __init__(self, root: str):
        self.root = root
        self.entries: Dict[str, FileObject] = {}
        self._load()

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.root, MANIFEST)

    def _load(self):
        if os.path.exists(self.manifest_path):
            with open(self.manifest_path) as fh:
                raw = json.load(fh)
            self.entries = {
                k: FileObject(v["fileName"], v["count"], v["dtype"], tuple(v["shape"]))
                for k, v in raw.items()
            }

    def flush(self):
        os.makedirs(self.root, exist_ok=True)
        with open(self.manifest_path, "w") as fh:
            json.dump(
                {
                    k: {
                        "fileName": v.file_name,
                        "count": v.count,
                        "dtype": v.dtype,
                        "shape": list(v.shape),
                    }
                    for k, v in self.entries.items()
                },
                fh,
                indent=1,
            )

    def __contains__(self, name: str) -> bool:
        return name in self.entries


class SerdeManager:
    """PipelineSerdeManager analog: dump/restore named NumPy buffers under
    ``{base_dir}/save__{save_name}_{version}``."""

    def __init__(self, base_dir: str, save_name: str = "default", version: str = "0"):
        self.root = os.path.join(base_dir, f"save__{save_name}_{version}")
        self.data_dir = os.path.join(self.root, "data")
        self.directory = FileDirectory(self.root)

    def _path_for(self, name: str) -> str:
        safe = name.replace("/", "_")
        return os.path.join(self.data_dir, f"{safe}.data")

    def save(self, name: str, array: np.ndarray, async_: bool = False):
        """Dump one buffer and rewrite the manifest.  The write is always
        made at once: ``async_`` (the reference's native write pool, not
        ported) changes nothing, as it does in the reference without its
        native library."""
        os.makedirs(self.data_dir, exist_ok=True)
        arr = np.ascontiguousarray(array)
        path = self._path_for(name)
        arr.tofile(path)
        self.directory.entries[name] = FileObject(
            os.path.basename(path), arr.size, str(arr.dtype), arr.shape)
        self.directory.flush()

    def flush(self):
        """Barrier for ``async_`` saves: a no-op, every save is already
        on disk."""

    def exists(self, name: str) -> bool:
        return name in self.directory and os.path.exists(self._path_for(name))

    def load(self, name: str) -> Optional[np.ndarray]:
        """Restore a buffer; None if absent."""
        if not self.exists(name):
            return None
        fo = self.directory.entries[name]
        flat = _read(self._path_for(name), fo.dtype)
        if flat.size != fo.count:
            raise IOError(
                f"corrupt checkpoint for {name!r}: {flat.size} != {fo.count}")
        return flat.reshape(fo.shape)
