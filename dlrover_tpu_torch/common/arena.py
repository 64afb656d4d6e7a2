"""Process-lifetime host buffer arena for the checkpoint data path.

Equivalent capability: the reference pins and reuses host staging
buffers for its D2H/H2D checkpoint legs (atorch's pinned-memory pools)
so a multi-GB save/restore does not pay page-fault-in on every pass.
Our cold-vs-warm bench gap (``ckpt_engine_cold_gbps`` 1.31 vs 5.81
warm, BENCH_r05) is exactly that tax: a fresh buffer's first touch
faults pages in single-threaded, while a reused one runs at memory
bandwidth. This arena keeps freed checkpoint buffers alive for the
process lifetime so repeat saves/restores hit warm pages.

Ownership rules (enforced by the API shape, documented in
docs/DESIGN.md "Restore data path"):

- ``lease(nbytes)`` returns a :class:`Lease` whose ``view`` is a
  memoryview of exactly ``nbytes`` over a pooled buffer. The lease OWNS
  the buffer until ``release()`` (or context-manager exit).
- A lease must only be released when no view derived from it can be
  touched again. Buffers whose contents escape to a caller with
  arbitrary lifetime (e.g. restored state arrays handed back from a
  targetless ``engine.load()``) must NOT be arena-backed — the engine
  allocates those fresh.
- H2D staging buffers are NEVER pooled: backends can zero-copy-alias a
  numpy array's memory into ``jax.device_put`` (the CPU PJRT client
  does — verified by probe), so a pooled staging buffer would corrupt
  restored device state on reuse.

Telemetry: ``ckpt.arena.hits`` / ``ckpt.arena.misses`` counters and a
``ckpt.arena.pooled_bytes`` gauge make reuse visible in
``tools/obs_report.py`` and the bench.

The PyTorch port's copy of dlrover_tpu/common/arena.py.
"""

from __future__ import annotations

import os
import threading

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

ENV_MAX_BYTES = "DLROVER_TPU_ARENA_MAX_BYTES"
_DEFAULT_MAX_BYTES = 8 << 30
_MIN_CLASS = 1 << 16  # pool nothing smaller than 64 KiB


def _size_class(nbytes: int) -> int:
    c = _MIN_CLASS
    while c < nbytes:
        c <<= 1
    return c


class Lease:
    """One pooled buffer, checked out. ``view`` is exactly the requested
    length; release returns the buffer to the pool (idempotent)."""

    __slots__ = ("_arena", "_buf", "nbytes", "_released")

    def __init__(self, arena: "HostArena | None", buf: bytearray,
                 nbytes: int):
        self._arena = arena
        self._buf = buf
        self.nbytes = nbytes
        self._released = False

    @property
    def view(self) -> memoryview:
        if self._released:
            raise ValueError("lease already released")
        return memoryview(self._buf)[: self.nbytes]

    def release(self):
        if self._released:
            return
        self._released = True
        if self._arena is not None:
            self._arena._return(self._buf)
        self._buf = None  # type: ignore[assignment]

    def __enter__(self) -> "Lease":
        return self

    def __exit__(self, *exc):
        self.release()
        return False


class HostArena:
    """Size-class bucketed pool of process-lifetime host buffers.

    Thread-safe. Total pooled (idle) bytes are bounded by
    ``DLROVER_TPU_ARENA_MAX_BYTES`` (default 8 GiB): a returned buffer
    that would push the pool past the cap is dropped instead, so a
    one-off giant restore cannot pin host memory forever.
    """

    def __init__(self, max_bytes: int | None = None):
        if max_bytes is None:
            raw = os.environ.get(ENV_MAX_BYTES, "")
            try:
                max_bytes = int(raw) if raw else _DEFAULT_MAX_BYTES
            except ValueError:
                logger.warning(
                    "ignoring malformed %s=%r", ENV_MAX_BYTES, raw
                )
                max_bytes = _DEFAULT_MAX_BYTES
        self._max_bytes = max_bytes
        self._lock = threading.Lock()
        self._free: dict[int, list[bytearray]] = {}
        self._pooled_bytes = 0
        self.hits = 0
        self.misses = 0

    def lease(self, nbytes: int) -> Lease:
        """Check a buffer of >= ``nbytes`` out of the pool (or allocate
        a fresh one on miss). Contents are GARBAGE — callers overwrite."""
        if nbytes <= 0:
            return Lease(None, bytearray(0), 0)
        cls = _size_class(nbytes)
        with self._lock:
            bucket = self._free.get(cls)
            if bucket:
                buf = bucket.pop()
                self._pooled_bytes -= len(buf)
                self.hits += 1
                telemetry.counter_inc("ckpt.arena.hits")
                telemetry.gauge_set(
                    "ckpt.arena.pooled_bytes", self._pooled_bytes
                )
                return Lease(self, buf, nbytes)
            self.misses += 1
        telemetry.counter_inc("ckpt.arena.misses")
        # allocate OUTSIDE the lock: a multi-GB allocation (plus its
        # first-touch faults later) must not serialize other leases
        return Lease(self, bytearray(cls), nbytes)

    def _return(self, buf: bytearray):
        if buf is None or len(buf) < _MIN_CLASS:
            return
        with self._lock:
            if self._pooled_bytes + len(buf) > self._max_bytes:
                return  # over cap: let it be garbage-collected
            self._free.setdefault(len(buf), []).append(buf)
            self._pooled_bytes += len(buf)
            telemetry.gauge_set(
                "ckpt.arena.pooled_bytes", self._pooled_bytes
            )

    def stats(self) -> dict:
        with self._lock:
            return {
                "hits": self.hits,
                "misses": self.misses,
                "pooled_bytes": self._pooled_bytes,
            }

    def clear(self):
        with self._lock:
            self._free.clear()
            self._pooled_bytes = 0


_ARENA: HostArena | None = None
_ARENA_LOCK = threading.Lock()


def get_arena() -> HostArena:
    global _ARENA
    if _ARENA is None:
        with _ARENA_LOCK:
            if _ARENA is None:
                _ARENA = HostArena()
    return _ARENA
