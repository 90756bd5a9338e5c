"""TileServer — port of ``noize_tpu.app.server``: batched streaming tile
generation for serving.

The reference's MeshTileGenerator serves one tile per frame from its work
queue (MeshTileGenerator.cs:125-138).  Here a worker thread collects
requests into batches of up to ``batch_size`` tiles, runs each batch as
one ``parallel.tiled.tile_batch`` on the card (the field stages on the
stack: one K1 and one K2 call a batch), waits for it on a CUDA event, and
delivers per-tile results through callbacks.  A failed batch delivers its
exception to every order of the batch; ``drain`` waits on the queue's
unfinished-task count, which drops only after an order's batch and
callback are done.

Single-process, one-device serving; the sharded server (``mesh=``)
waits for ROADMAP queue 1's last item, with the sharded erosion cycle.
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from ..core.tiles import TileRequest
from ..parallel import tiled as TL


NO_MESH = ("TileServer(mesh=...): the sharded server waits for ROADMAP queue 1's last "
           "item (the sharded erosion cycle, the sharded mesh and checkpoint, and "
           "TileServer(mesh=))")

log = logging.getLogger(__name__)


@dataclass
class TileOrder:
    request: TileRequest
    on_complete: Optional[Callable] = None


@dataclass
class ServedTile:
    request: TileRequest
    heights: object          # f32[R, R] (device tensor); None when error set
    batch_id: int
    latency_ms: float
    error: object = None     # the batch exception, delivered per order
    mesh_planes: object = None  # f32[12, tr+1, tr+1] when config.emit_mesh


class TileServer:
    def __init__(
        self,
        config: TL.TilePipelineConfig,
        batch_size: int = 4,
        mesh=None,
        max_wait_ms: float = 5.0,
        seed: int = 0,
        *,
        device="cuda",
    ):
        if mesh is not None:
            raise NotImplementedError(NO_MESH)
        self.device = torch.device(device)
        if self.device.type == "cuda":
            if not torch.cuda.is_available():
                raise RuntimeError("TileServer(device='cuda'): no CUDA device")
            if self.device.index is None:  # the worker thread sets it by index
                self.device = torch.device("cuda", torch.cuda.current_device())
        self.config = config
        self.batch_size = batch_size
        self.mesh = mesh
        self.max_wait_ms = max_wait_ms
        self.seed = seed
        self.queue: "queue.Queue[TileOrder]" = queue.Queue()
        self.served: int = 0
        self.batches: int = 0
        self.errors: List[Exception] = []
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    # --- client surface ------------------------------------------------------

    def submit(self, tile_id: str, pos: Tuple[int, int],
               on_complete: Optional[Callable[[ServedTile], None]] = None):
        self.queue.put(TileOrder(TileRequest(uuid=tile_id, pos=pos), on_complete))

    def start(self):
        if self._thread is None or not self._thread.is_alive():
            self._stop.clear()
            self._thread = threading.Thread(target=self._loop, daemon=True)
            self._thread.start()
        return self

    def stop(self):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=10)

    def drain(self, timeout: float = 120.0) -> bool:
        """Wait until every submitted order has been fully processed.

        Uses the queue's unfinished-task count (orders are marked done only
        after their batch completes and callbacks fire), so there is no
        window where a dequeued-but-unprocessed order looks drained.
        Returns False on timeout or if the worker thread has died."""
        deadline = time.time() + timeout
        while time.time() < deadline:
            if self.queue.unfinished_tasks == 0:
                return True
            if self._thread is not None and not self._thread.is_alive():
                return self.queue.unfinished_tasks == 0
            time.sleep(0.005)
        return False

    # --- batching loop --------------------------------------------------------

    def _collect_batch(self) -> List[TileOrder]:
        orders: List[TileOrder] = []
        try:
            orders.append(self.queue.get(timeout=0.05))
        except queue.Empty:
            return orders
        deadline = time.time() + self.max_wait_ms / 1e3
        while len(orders) < self.batch_size and time.time() < deadline:
            try:
                orders.append(self.queue.get_nowait())
            except queue.Empty:
                time.sleep(0.0005)
        return orders

    def _run_batch(self, orders: List[TileOrder]):
        """One batch: pad to ``batch_size`` with repeats of the last
        origin, run ``tile_batch``, wait for it on a CUDA event."""
        origins = np.asarray(
            [self.config.meta.tile_origin(o.request.pos) for o in orders], np.int32)
        pad = self.batch_size - len(origins)
        if pad > 0:
            origins = np.concatenate([origins, np.repeat(origins[-1:], pad, 0)])
        # seed is the global seed: per-tile randomness comes from the world
        # position inside tile_batch, so re-requested tiles reproduce
        # whatever batch they land in
        tiles = TL.tile_batch(self.config, origins, seed=self.seed, device=self.device)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        if isinstance(tiles, dict):
            return tiles["height"], tiles["mesh_planes"]
        return tiles, None

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while not self._stop.is_set():
            orders = self._collect_batch()
            if not orders:
                continue
            try:
                t0 = time.perf_counter()
                heights_arr, planes_arr = self._run_batch(orders)
                dt = (time.perf_counter() - t0) * 1e3
                self.batches += 1
                for i, order in enumerate(orders):
                    self.served += 1
                    if order.on_complete is not None:
                        # one order's raising callback must not starve the
                        # rest of the batch of their results
                        try:
                            order.on_complete(ServedTile(
                                request=order.request,
                                heights=heights_arr[i],
                                batch_id=self.batches,
                                latency_ms=dt,
                                mesh_planes=(None if planes_arr is None
                                             else planes_arr[i]),
                            ))
                        except Exception as e:
                            self.errors.append(e)
                            log.exception(
                                "on_complete raised for tile %s",
                                order.request.pos)
            except Exception as e:
                self.errors.append(e)
                log.exception("TileServer batch failed (%d orders dropped)",
                              len(orders))
                # deliver the failure per order so waiters unblock instead
                # of deadlocking on a result that will never arrive
                for order in orders:
                    if order.on_complete is not None:
                        try:
                            order.on_complete(ServedTile(
                                request=order.request, heights=None,
                                batch_id=self.batches, latency_ms=0.0,
                                error=e,
                            ))
                        except Exception:
                            log.exception(
                                "on_complete raised for failed tile %s",
                                order.request.pos)
            finally:
                # mark every dequeued order done so drain() can't hang on
                # a failed batch
                for _ in orders:
                    self.queue.task_done()
