"""Coworker data services: CPU processes preprocess, trainers consume
(port of dlrover_tpu/trainer/elastic/coworker.py).

Three roles over the port's 2-verb TCP control plane (common/rpc.py):

- :class:`CoworkerDataService` runs on a CPU host. A feeder thread pulls
  from the user's (preprocessing) iterator into a bounded queue; the
  ``get`` verb pops one batch. It needs no accelerator runtime.
- :class:`DataInfoService` runs next to trainer rank 0. Coworkers
  ``report`` (addr, batch_count) announcements; trainer ranks ``get``
  the next announcement: a work-stealing queue, so a slow coworker never
  stalls a fast trainer.
- :class:`CoworkerDataset` is the trainer-side iterator: it resolves
  announcements to coworker addresses and fetches batches with a
  prefetch thread, falling back to other coworkers when one dies (a dead
  coworker only removes its announcements), and drops a coworker whose
  stream ended (the EOF batch).
"""

from __future__ import annotations

import queue
import threading
from typing import Callable, Iterable, Optional

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.rpc import RpcClient, RpcServer, RpcService

logger = get_logger(__name__)


EOF_BATCH = {"__dlrtpu_coworker_eof__": True}


def _is_eof(batch) -> bool:
    return isinstance(batch, dict) and batch.get(
        "__dlrtpu_coworker_eof__", False
    )


class _BatchQueueService(RpcService):
    """``get`` pops one preprocessed batch (blocking with timeout)."""

    def __init__(self, batch_queue: "queue.Queue", stats: dict,
                 drained: threading.Event,
                 stats_lock: "threading.Lock | None" = None):
        self._queue = batch_queue
        self._stats = stats
        # shared with the owning CoworkerDataService: the feeder thread
        # and N RPC handler threads all bump counters in one dict
        # (dlint DL008)
        self._stats_lock = stats_lock or threading.Lock()
        self._drained = drained

    def get(self, node_type, node_id, message):
        timeout = 30.0
        if isinstance(message, dict):
            timeout = float(message.get("timeout", 30.0))
        # a dead feeder (crashed or exhausted iterator) with an empty
        # queue will never produce again: tell the trainer so it drops
        # this coworker instead of recycling its announcements forever
        if self._drained.is_set() and self._queue.empty():
            return dict(EOF_BATCH)
        # block strictly less than the caller's socket deadline, or an
        # empty queue would always surface as a client-side socket
        # timeout (and blacklist a healthy coworker)
        try:
            batch = self._queue.get(timeout=max(1.0, timeout - 5.0))
        except queue.Empty:
            if self._drained.is_set():
                return dict(EOF_BATCH)
            return None
        with self._stats_lock:
            self._stats["served"] = self._stats.get("served", 0) + 1
        return batch

    def report(self, node_type, node_id, message) -> bool:
        return True


class CoworkerDataService:
    """CPU-pod side: serve preprocessed batches over the control plane.

    ``iterator_fn`` builds the (possibly infinite) preprocessing
    iterator; its items must be picklable (numpy trees). ``announce_to``
    optionally points at the trainer's :class:`DataInfoService`; every
    ``announce_every`` queued batches the coworker re-announces itself.
    """

    def __init__(
        self,
        iterator_fn: Callable[[], Iterable],
        port: int = 0,
        queue_size: int = 16,
        announce_to: str = "",
        announce_every: int = 8,
        advertise_host: str = "127.0.0.1",
    ):
        self._iterator_fn = iterator_fn
        self._queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.stats: dict = {"produced": 0, "served": 0}
        self._stats_lock = threading.Lock()
        self._drained = threading.Event()
        self._server = RpcServer(
            port, _BatchQueueService(self._queue, self.stats,
                                     self._drained,
                                     stats_lock=self._stats_lock)
        )
        self._announce_to = announce_to
        self._announce_every = max(1, int(announce_every))
        self._advertise_host = advertise_host
        self._stopped = threading.Event()
        self._feeder: Optional[threading.Thread] = None

    @property
    def addr(self) -> str:
        return f"{self._advertise_host}:{self._server.port}"

    def start(self):
        self._server.start()
        self._feeder = threading.Thread(
            target=self._feed, name="coworker-feeder", daemon=True
        )
        self._feeder.start()
        logger.info("coworker data service serving at %s", self.addr)

    def stop(self):
        self._stopped.set()
        self._server.stop()

    def _feed(self):
        announcer = (
            RpcClient(self._announce_to) if self._announce_to else None
        )
        produced_since = 0
        try:
            for batch in self._iterator_fn():
                if self._stopped.is_set():
                    return
                while not self._stopped.is_set():
                    try:
                        self._queue.put(batch, timeout=1.0)
                        break
                    except queue.Full:
                        continue
                with self._stats_lock:
                    self.stats["produced"] += 1
                    produced = self.stats["produced"]
                produced_since += 1
                if announcer is not None and (
                    produced_since >= self._announce_every
                    or produced == 1
                ):
                    try:
                        announcer.report(
                            "coworker", 0,
                            {"addr": self.addr, "ready": produced_since},
                        )
                        produced_since = 0
                    except Exception:  # noqa: BLE001 - info svc restart
                        logger.warning(
                            "data-info announce failed; will retry"
                        )
        except Exception:  # noqa: BLE001 - user iterator crash
            logger.exception("coworker preprocessing iterator failed")
        finally:
            self._drained.set()


class _DataInfoQueue(RpcService):
    def __init__(self):
        self._infos: "queue.Queue" = queue.Queue()

    def report(self, node_type, node_id, message) -> bool:
        self._infos.put(dict(message))
        return True

    def get(self, node_type, node_id, message):
        timeout = 30.0
        if isinstance(message, dict):
            timeout = float(message.get("timeout", 30.0))
        try:
            return self._infos.get(timeout=max(1.0, timeout - 5.0))
        except queue.Empty:
            return None


class DataInfoService:
    """Trainer-rank-0 side: the coworker announcement queue."""

    def __init__(self, port: int = 0):
        self._service = _DataInfoQueue()
        self._server = RpcServer(port, self._service)

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self._server.port}"

    def start(self):
        self._server.start()

    def stop(self):
        self._server.stop()


class CoworkerDataset:
    """Trainer-side iterator over coworker-preprocessed batches.

    Resolves announcements from the :class:`DataInfoService`, pulls
    batches from the announced coworker, and prefetches in a background
    thread. A dead coworker is dropped after ``max_failures`` fetch
    errors; iteration ends after ``n_batches`` (required — the coworker
    stream itself is unbounded).
    """

    def __init__(
        self,
        info_addr: str,
        n_batches: int,
        prefetch: int = 4,
        max_failures: int = 3,
        fetch_timeout: float = 30.0,
    ):
        # socket deadlines sit ABOVE the application fetch timeout so
        # a served-just-late reply is received, not dropped mid-flight
        self._info = RpcClient(info_addr, timeout=fetch_timeout + 10.0)
        self._n = int(n_batches)
        self._prefetch = max(1, int(prefetch))
        self._max_failures = max_failures
        self._timeout = fetch_timeout
        self._clients: dict[str, RpcClient] = {}
        self._failures: dict[str, int] = {}

    def _client(self, addr: str) -> RpcClient:
        if addr not in self._clients:
            self._clients[addr] = RpcClient(
                addr, timeout=self._timeout + 10.0
            )
        return self._clients[addr]

    def _fetch_one(self):
        while True:
            info = self._info.get(
                "worker", 0, {"timeout": self._timeout}
            )
            if info is None:
                raise TimeoutError(
                    "no coworker announcements within the timeout"
                )
            addr = info["addr"]
            if self._failures.get(addr, 0) >= self._max_failures:
                continue
            ready = max(1, int(info.get("ready", 1)))
            def _reannounce(credit):
                if credit < 1:
                    return
                try:
                    self._info.report(
                        "worker", 0, {"addr": addr, "ready": credit}
                    )
                except Exception:  # noqa: BLE001
                    pass

            try:
                batch = self._client(addr).get(
                    "worker", 0, {"timeout": self._timeout}
                )
            except Exception:  # noqa: BLE001 - dead coworker
                self._failures[addr] = self._failures.get(addr, 0) + 1
                logger.warning(
                    "coworker %s fetch failed (%d)", addr,
                    self._failures[addr],
                )
                if self._failures[addr] < self._max_failures:
                    # transient: keep the announcement's credit alive
                    _reannounce(ready)
                continue
            if _is_eof(batch):
                # the coworker's producer is gone for good: blacklist
                # and let its stale announcements drain
                self._failures[addr] = self._max_failures
                logger.info("coworker %s reports end of stream", addr)
                continue
            if batch is None:
                # momentarily empty queue — the credit is still good
                _reannounce(ready)
                continue
            if ready > 1:
                # re-announce the remaining credit so other ranks keep
                # pulling from this coworker
                _reannounce(ready - 1)
            return batch

    def __iter__(self):
        out: "queue.Queue" = queue.Queue(maxsize=self._prefetch)
        done = threading.Event()
        err: list = []

        def put_checked(item) -> bool:
            # never block forever on the bounded queue: an early-exiting
            # consumer sets `done` and this thread must wind down
            while not done.is_set():
                try:
                    out.put(item, timeout=0.5)
                    return True
                except queue.Full:
                    continue
            return False

        def fill():
            try:
                for _ in range(self._n):
                    if done.is_set():
                        return
                    if not put_checked(self._fetch_one()):
                        return
            except Exception as e:  # noqa: BLE001
                err.append(e)
            finally:
                put_checked(None)

        t = threading.Thread(target=fill, name="coworker-prefetch",
                             daemon=True)
        t.start()
        try:
            while True:
                item = out.get()
                if item is None:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            done.set()
            # unblock a fill thread stuck in put()
            try:
                while True:
                    out.get_nowait()
            except queue.Empty:
                pass
