"""Pipeline state manager — port of ``noize_tpu.core.store``: a registry
of named buffers with locks, change callbacks and transparent checkpoint
(PipelineStateManager.cs:13-189, PipelineStateLock.cs:12-39).

Buffers are device tensors (or any host object: lists, dicts, refs).  A
lock is an ordering token the host driver holds while a producer is in
flight.  A buffer restored from disk lands on the manager's ``device``
(the card by default), with the dtype and shape its manifest records.
"""

from __future__ import annotations

import logging
import threading
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from .serde import SerdeManager

log = logging.getLogger(__name__)


def _host(value) -> np.ndarray:
    # a blocking copy: an async save hands the bytes to the native write
    # pool at once, so they must have landed
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    return np.asarray(value)


class PipelineStateManager:
    def __init__(self, save_dir: Optional[str] = None,
                 save_name: str = "default", version: str = "0", *,
                 device="cuda"):
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("PipelineStateManager(device='cuda'): no CUDA device")
        self._buffers: Dict[str, Any] = {}
        self._locks: Dict[str, Any] = {}
        self._callbacks: Dict[str, list] = {}
        self._mutex = threading.RLock()
        self.serde: Optional[SerdeManager] = None
        if save_dir is not None:
            self.set_save_path(save_dir, save_name, version)

    # --- save path (PipelineStateManager.cs:18-20) -------------------------

    def set_save_path(self, save_dir: str, save_name: str = "default",
                      version: str = "0"):
        self.serde = SerdeManager(save_dir, save_name, version)

    # --- buffers (PipelineStateManager.cs:30-96) ---------------------------

    def get_buffer(self, name: str, default: Any = None,
                   factory: Optional[Callable[[], Any]] = None) -> Any:
        """Get-or-create.  On first access, restores from the save
        directory if a checkpoint exists (PipelineStateManager.cs:63-71),
        onto ``device``.  ``factory`` builds the initial value; ``default``
        is a constant initial value."""
        with self._mutex:
            if name in self._buffers:
                return self._buffers[name]
            if self.serde is not None and self.serde.exists(name):
                restored = self.serde.load(name)
                value = torch.from_numpy(np.array(restored)).to(self.device)
            elif factory is not None:
                value = factory()
            else:
                value = default
            self._buffers[name] = value
            return value

    def set_buffer(self, name: str, value: Any):
        """Commit a new value and fire its change callbacks
        (PipelineState.cs:294-318)."""
        with self._mutex:
            self._buffers[name] = value
            cbs = list(self._callbacks.get(name, ()))
        for cb in cbs:
            cb(name, value)

    def buffer_exists(self, name: str) -> bool:
        with self._mutex:
            return name in self._buffers or (
                self.serde is not None and self.serde.exists(name))

    def release_buffer(self, name: str):
        with self._mutex:
            self._buffers.pop(name, None)
            self._locks.pop(name, None)

    def names(self):
        with self._mutex:
            return sorted(self._buffers)

    # --- locks (PipelineStateLock.cs:12-39, PipelineState.cs:320-337) ------

    def try_set_lock(self, name: str, token: Any) -> bool:
        with self._mutex:
            if name in self._locks and self._locks[name] is not token:
                return False
            self._locks[name] = token
            return True

    def is_locked(self, name: str, token: Any = None) -> bool:
        """Locked unless the querying computation holds the token itself."""
        with self._mutex:
            held = self._locks.get(name)
            if held is None:
                return False
            return held is not token

    def unlock(self, name: str, token: Any = None) -> bool:
        with self._mutex:
            held = self._locks.get(name)
            if held is None:
                return True
            if token is None or held is token:
                del self._locks[name]
                return True
            return False

    # --- callbacks (PipelineState.cs:294-318) ------------------------------

    def register_callback(self, name: str, cb: Callable[[str, Any], None]):
        with self._mutex:
            self._callbacks.setdefault(name, []).append(cb)

    def remove_callback(self, name: str, cb) -> bool:
        with self._mutex:
            lst = self._callbacks.get(name, [])
            if cb in lst:
                lst.remove(cb)
                return True
            return False

    # --- checkpoint (PipelineStateManager.cs:98-113) -----------------------

    def save_buffer_to_disk(self, name: str, async_: bool = False) -> bool:
        if self.serde is None:
            return False
        with self._mutex:
            if name not in self._buffers:
                return False
            value = self._buffers[name]
        self.serde.save(name, _host(value), async_=async_)
        return True

    def save_all(self, async_: bool = True) -> Dict[str, Exception]:
        """Checkpoint every numeric buffer, ending with ``serde.flush()``
        when ``async_``, as the reference does.  Returns ``{name:
        exception}`` for the writes that failed (empty when the checkpoint
        is whole); each failure is also logged."""
        failures: Dict[str, Exception] = {}
        if self.serde is None:
            return failures
        for name in self.names():
            with self._mutex:
                value = self._buffers.get(name)
            if value is None or isinstance(value, (dict, set)):
                continue  # non-array container: not saved
            try:
                arr = _host(value)
            except ValueError:  # a ragged sequence: not saved
                continue
            if arr.dtype == object:
                continue
            try:
                self.serde.save(name, arr, async_=async_)
            except OSError as e:
                failures[name] = e
        if async_:
            try:
                self.serde.flush()
            except OSError as e:
                failures["<flush>"] = e
        if failures:
            log.warning("save_all: %d buffer(s) failed to checkpoint: %s",
                        len(failures), {k: repr(v) for k, v in failures.items()})
        return failures
