"""Buffer store disk serialization — port of ``noize_tpu.core.serde``, on
the port's native IO runtime (``noize_tpu_torch.native``).

Layout (PipelineSerialization.cs:15-236): a save root
``save__{name}_{version}/`` holding ``data/{buffer}.data`` files and a
``files.json`` manifest mapping buffer name → file, element count, dtype
and shape.  Every file is written in the native format, as ``noize_tpu``
writes it where its C++ library is built: a 32-byte header (u64 magic
'NZTFU', u32 version, u32 reserved, u64 payload bytes, u64 FNV-1a
checksum), then the raw little-endian payload; atomically (a temporary
file, then a rename), at once or queued on the library's write pool
(``save(async_=True)``, barrier ``flush()``).  Reads verify the checksum —
a corrupt checkpoint raises — and take the legacy raw dumps that
``noize_tpu``'s NumPy route writes, so a checkpoint written by either
package restores in the other.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from .. import native

MANIFEST = "files.json"


def _fnv1a(data: bytes) -> int:
    """FNV-1a 64 over the payload, in Python (serde_native.cpp::fnv1a):
    the native format's checksum, for tools that check a file without the
    library."""
    h = 1469598103934665603
    prime = 1099511628211
    mask = (1 << 64) - 1
    for b in memoryview(data):
        h = ((h ^ b) * prime) & mask
    return h


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
        """Dump one host buffer (NZTFU, atomic) and rewrite the manifest.
        ``async_`` queues the write on the native pool, which copies the
        bytes before returning; ``flush()`` waits for it."""
        os.makedirs(self.data_dir, exist_ok=True)
        arr = np.ascontiguousarray(array)
        path = self._path_for(name)
        if async_:
            native.write_file_async(path, arr)
        else:
            native.write_file(path, arr)
        self.directory.entries[name] = FileObject(
            os.path.basename(path), arr.size, str(arr.dtype), arr.shape)
        self.directory.flush()

    def flush(self):
        """Barrier for ``async_`` saves: every queued write is on disk
        (and renamed into place) when this returns; raises if one
        failed."""
        native.wait(0)

    def exists(self, name: str) -> bool:
        return name in self.directory and os.path.exists(self._path_for(name))

    def load(self, name: str) -> Optional[np.ndarray]:
        """Restore a buffer; None if absent."""
        if not self.exists(name):
            return None
        fo = self.directory.entries[name]
        flat = native.read_file(self._path_for(name), fo.dtype)
        if flat.size != fo.count:
            raise IOError(
                f"corrupt checkpoint for {name!r}: {flat.size} != {fo.count}")
        return flat.reshape(fo.shape)
