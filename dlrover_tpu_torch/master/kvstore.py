"""In-master KV store used as the workers' shared rendezvous store.

Equivalent capability: reference master-side kv-store RPCs consumed by
MasterKVStore (dlrover/python/elastic_agent/torch/master_kv_store.py).

Growth is bounded (max entries + byte cap, insertion-order eviction with
a telemetry counter): a long-lived master that survives failovers — and
now persists the store across them — must not accumulate workers'
barrier keys without limit.

The PyTorch port's copy of dlrover_tpu/master/kvstore.py.
"""

from __future__ import annotations

import base64
import os
import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

ENV_MAX_ENTRIES = "DLROVER_KVSTORE_MAX_ENTRIES"
ENV_MAX_BYTES = "DLROVER_KVSTORE_MAX_BYTES"

_DEFAULT_MAX_ENTRIES = 8192
_DEFAULT_MAX_BYTES = 32 << 20


class KVStoreService:
    def __init__(
        self,
        max_entries: int | None = None,
        max_bytes: int | None = None,
    ):
        self._lock = threading.Lock()
        self._store: dict[str, bytes] = {}
        self._cond = threading.Condition(self._lock)
        self._max_entries = max_entries if max_entries is not None else int(
            os.environ.get(ENV_MAX_ENTRIES, str(_DEFAULT_MAX_ENTRIES))
        )
        self._max_bytes = max_bytes if max_bytes is not None else int(
            os.environ.get(ENV_MAX_BYTES, str(_DEFAULT_MAX_BYTES))
        )
        self._bytes = 0
        self.evicted = 0

    @staticmethod
    def _entry_bytes(key: str, value: bytes) -> int:
        return len(key) + len(value)

    def _evict_over_caps(self, protect: str):
        """Insertion-order eviction down to the caps. ``protect`` (the
        key just written) is never evicted, even when it alone busts the
        byte cap — dropping a write that was just acked would be worse
        than a transient overage."""
        while self._store and (
            len(self._store) > self._max_entries
            or self._bytes > self._max_bytes
        ):
            victim = next(
                (k for k in self._store if k != protect), None
            )
            if victim is None:
                if self._bytes > self._max_bytes:
                    logger.warning(
                        "kv entry %r alone exceeds the byte cap "
                        "(%d > %d); keeping it",
                        protect, self._bytes, self._max_bytes,
                    )
                return
            value = self._store.pop(victim)
            self._bytes -= self._entry_bytes(victim, value)
            self.evicted += 1
            telemetry.counter_inc("kvstore.evicted")
        telemetry.gauge_set("kvstore.entries", float(len(self._store)))
        telemetry.gauge_set("kvstore.bytes", float(self._bytes))

    def _set_nolock(self, key: str, value: bytes):
        old = self._store.pop(key, None)
        if old is not None:
            self._bytes -= self._entry_bytes(key, old)
        self._store[key] = value
        self._bytes += self._entry_bytes(key, value)
        self._evict_over_caps(protect=key)

    def set(self, key: str, value: bytes, wal=None):
        """``wal`` (the state store's append, when durability is on)
        runs INSIDE the store lock: two racing writes to one key must
        land in the WAL in the same order they were applied, or replay
        could restore a value an acked write already superseded."""
        with self._cond:
            self._set_nolock(key, value)
            if wal is not None:
                wal(
                    "kv", key=key,
                    value=base64.b64encode(value).decode("ascii"),
                )
            self._cond.notify_all()

    def get(self, key: str) -> bytes:
        with self._lock:
            return self._store.get(key, b"")

    def add(self, key: str, delta: int, wal=None) -> int:
        """Atomic counter add (torch Store ``add`` semantics). The WAL
        record carries the RESULT and is appended under the same lock
        hold that computed it — see :meth:`set`."""
        with self._cond:
            current = int(self._store.get(key, b"0") or b"0")
            current += delta
            self._set_nolock(key, str(current).encode())
            if wal is not None:
                wal(
                    "kv", key=key,
                    value=base64.b64encode(
                        str(current).encode()
                    ).decode("ascii"),
                )
            self._cond.notify_all()
            return current

    def wait(self, keys: list[str], timeout: float = 300.0) -> bool:
        deadline = time.time() + timeout
        with self._cond:
            while True:
                if all(k in self._store for k in keys):
                    return True
                remaining = deadline - time.time()
                if remaining <= 0:
                    return False
                self._cond.wait(min(remaining, 1.0))

    def delete(self, key: str) -> bool:
        with self._lock:
            value = self._store.pop(key, None)
            if value is None:
                return False
            self._bytes -= self._entry_bytes(key, value)
            return True

    def clear(self):
        with self._lock:
            self._store.clear()
            self._bytes = 0

    # -------------------------------------------------- failover durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                key: base64.b64encode(value).decode("ascii")
                for key, value in self._store.items()
            }

    def restore_state(self, state: dict):
        with self._cond:
            for key, encoded in state.items():
                self._set_nolock(key, base64.b64decode(encoded))
            self._cond.notify_all()


class SyncService:
    """Named barriers across workers (reference sync_service.py:26)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._sync_objs: dict[str, set] = {}
        self._finished: set[str] = set()

    def join_sync(self, sync_name: str, node_type: str, node_id: int) -> bool:
        with self._lock:
            self._sync_objs.setdefault(sync_name, set()).add(
                (node_type, node_id)
            )
            return True

    def sync_finished(self, sync_name: str) -> bool:
        with self._lock:
            return sync_name in self._finished

    def notify_barrier(self, sync_name: str) -> bool:
        with self._lock:
            self._finished.add(sync_name)
            return True

    def remove_node(self, node_type: str, node_id: int):
        with self._lock:
            for members in self._sync_objs.values():
                members.discard((node_type, node_id))

    # -------------------------------------------------- failover durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "sync_objs": {
                    name: sorted([t, i] for t, i in members)
                    for name, members in self._sync_objs.items()
                },
                "finished": sorted(self._finished),
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._sync_objs = {
                name: {(t, int(i)) for t, i in members}
                for name, members in (
                    state.get("sync_objs") or {}
                ).items()
            }
            self._finished = set(state.get("finished") or ())
