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

With ``mesh`` (a ``DeviceMesh`` with a ``batch`` axis,
``parallel.device_mesh.batch_mesh``) every rank of the mesh runs a server
with the same arguments, and each batch is one ``tile_batch(mesh=)``: whole
tiles a rank, the stack gathered with ``full_tensor()``.  The ranks must
issue the same collectives in the same order, and a batch formed by
timing could differ between them, so one rank decides: the controller
(batch coordinate 0) takes the orders, forms each batch and broadcasts its
origins on the mesh's group (a heartbeat while idle, a stop message on
``stop()``); the other ranks follow, run the same batch, and return from
``drain`` when the controller stops.  Only the controller takes orders and
delivers results.  A batch size the mesh does not divide raises
``tile_batch``'s error, delivered per order.

Spans (``utils.tracking``): ``serve.queue``, one an order, from ``submit``
(the caller's thread) to the start of the batch that takes it (the
worker's), with the order's id and the batch's; ``serve.collect`` around
each batch's formation; ``serve.batch`` around its run and the wait on its
CUDA event, and ``serve.deliver`` around its callbacks, with the batch's
id (the ``batch_id`` its ``ServedTile``s carry).
"""

from __future__ import annotations

import logging
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

import torch.distributed as dist

from ..core.tiles import TileRequest
from ..parallel import tiled as TL
from ..parallel.halo import _mesh_device
from ..utils.tracking import close_span, open_span, span

log = logging.getLogger(__name__)


@dataclass
class TileOrder:
    request: TileRequest
    on_complete: Optional[Callable] = None
    #: the order's ``serve.queue`` span, open from ``submit`` to its batch
    queued: object = field(default=None, init=False, repr=False, compare=False)


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
            if "batch" not in (getattr(mesh, "mesh_dim_names", None) or ()):
                raise ValueError("TileServer(mesh=...): expected a DeviceMesh with a 'batch' "
                                 "axis (parallel.device_mesh.batch_mesh)")
            self.device = _mesh_device(mesh)  # the mesh's device, not ``device``
            self._group = mesh.get_group("batch")
            self.controller = mesh.get_local_rank("batch") == 0
        else:
            self.device = torch.device(device)
            self.controller = True
        if mesh is None and self.device.type == "cuda":
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
        if not self.controller:
            raise RuntimeError("TileServer(mesh=...): orders go to the controller rank "
                               "(batch coordinate 0)")
        order = TileOrder(TileRequest(uuid=tile_id, pos=pos), on_complete)
        order.queued = open_span("serve.queue", order=tile_id)
        self.queue.put(order)

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
        Returns False on timeout or if the worker thread has died.  A
        following rank of a sharded server waits for the controller to
        stop."""
        if not self.controller:
            if self._thread is not None:
                self._thread.join(timeout)
                return not self._thread.is_alive()
            return True
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
        with span("serve.collect"):
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

    def _origins(self, orders: List[TileOrder]) -> np.ndarray:
        return np.asarray([self.config.meta.tile_origin(o.request.pos) for o in orders],
                          np.int32).reshape(-1, 2)

    def _broadcast(self, origins: Optional[np.ndarray]) -> Optional[np.ndarray]:
        """The controller's decision for the next batch, the same on every
        rank: its origins (possibly none), or None to stop."""
        msg = torch.zeros(1 + 2 * self.batch_size, dtype=torch.int64, device=self.device)
        if self.controller:
            if origins is None:
                msg[0] = -1
            else:
                msg[0] = len(origins)
                msg[1:1 + origins.size] = torch.from_numpy(origins.reshape(-1).astype(np.int64))
        dist.broadcast(msg, dist.get_global_rank(self._group, 0), group=self._group)
        n = int(msg[0])
        if n < 0:
            return None
        return msg[1:1 + 2 * n].cpu().numpy().astype(np.int32).reshape(n, 2)

    def _run_batch(self, origins: np.ndarray):
        """One batch: pad to ``batch_size`` with repeats of the last
        origin, run ``tile_batch``, wait for it on a CUDA event."""
        pad = self.batch_size - len(origins)
        if pad > 0:
            origins = np.concatenate([origins, np.repeat(origins[-1:], pad, 0)])
        # seed is the global seed: per-tile randomness comes from the world
        # position inside tile_batch, so re-requested tiles reproduce
        # whatever batch they land in
        if self.mesh is not None:
            tiles = TL.tile_batch(self.config, origins, mesh=self.mesh, seed=self.seed)
            tiles = ({k: v.full_tensor() for k, v in tiles.items()} if isinstance(tiles, dict)
                     else tiles.full_tensor())
        else:
            tiles = TL.tile_batch(self.config, origins, seed=self.seed, device=self.device)
        if self.device.type == "cuda":
            done = torch.cuda.Event()
            done.record(torch.cuda.current_stream(self.device))
            done.synchronize()
        if isinstance(tiles, dict):
            return tiles["height"], tiles["mesh_planes"]
        return tiles, None

    def _next_batch(self):
        """(orders, origins) of the next batch; None to stop.  Without a
        mesh the worker forms it; with one the controller does and every
        rank follows its broadcast."""
        if self.mesh is None:
            if self._stop.is_set():
                return None
            orders = self._collect_batch()
            return orders, self._origins(orders)
        if self.controller:
            if self._stop.is_set():
                self._broadcast(None)
                return None
            orders = self._collect_batch()
            self._broadcast(self._origins(orders))
            return orders, None
        origins = self._broadcast(None)
        return None if origins is None else ([], origins)

    def _loop(self):
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        while True:
            batch = self._next_batch()
            if batch is None:
                return
            orders, origins = batch
            if origins is None:
                origins = self._origins(orders)
            if not len(origins):
                continue
            batch_id = self.batches + 1
            for order in orders:
                close_span(order.queued, batch=batch_id)
            try:
                t0 = time.perf_counter()
                with span("serve.batch", batch=batch_id):
                    heights_arr, planes_arr = self._run_batch(origins)
                dt = (time.perf_counter() - t0) * 1e3
                self.batches += 1
                with span("serve.deliver", batch=batch_id):
                    for i, order in enumerate(orders):
                        self.served += 1
                        if order.on_complete is not None:
                            # one order's raising callback must not starve
                            # the rest of the batch of their results
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
