"""Checkpoint storage backends + retention strategies.

Equivalent capability: reference dlrover/python/common/storage.py
(CheckpointStorage ABC :23, PosixDiskStorage :127,
KeepStepIntervalStrategy :202, KeepLatestStepStrategy :230) — plus the
chunked/parallel read-write primitives the pipelined persist path uses
(bounded writer pool, positional chunk writes, header-after-payload
streaming so a CRC computed DURING the write can still land in a header
that precedes the payload on disk).

The PyTorch port's copy of dlrover_tpu/common/storage.py.
"""

from __future__ import annotations

import os
import shutil
import threading
from abc import ABC, abstractmethod
from concurrent.futures import ThreadPoolExecutor

from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# Bounded process-wide writer pool shared by every storage instance: the
# saver daemon runs one persist thread per local shard, and each shard's
# chunk writes fan out here — DLROVER_TPU_CKPT_WRITE_THREADS bounds the
# TOTAL disk-writer concurrency, not per-shard.
_WRITE_POOL: ThreadPoolExecutor | None = None
_WRITE_POOL_LOCK = threading.Lock()
WRITE_CHUNK_BYTES = 32 << 20


def _write_pool() -> ThreadPoolExecutor:
    global _WRITE_POOL
    if _WRITE_POOL is None:
        with _WRITE_POOL_LOCK:
            if _WRITE_POOL is None:
                raw = os.environ.get("DLROVER_TPU_CKPT_WRITE_THREADS", "")
                try:
                    n = int(raw) if raw else 0
                except ValueError:
                    n = 0
                if n <= 0:
                    n = min(4, os.cpu_count() or 1)
                _WRITE_POOL = ThreadPoolExecutor(
                    max_workers=n, thread_name_prefix="ckpt-write"
                )
    return _WRITE_POOL


def _chunk_views(data, chunk_bytes: int):
    """Zero-copy chunk views over a byte-like payload."""
    mv = memoryview(data)
    if mv.ndim != 1 or mv.itemsize != 1:
        mv = mv.cast("B")
    for off in range(0, len(mv), chunk_bytes):
        yield off, mv[off : off + chunk_bytes]


class CheckpointDeletionStrategy(ABC):
    @abstractmethod
    def clean_up(self, step: int, delete_func):
        """Decide whether/which old step dirs to remove after ``step`` was
        committed; call ``delete_func(dir)`` for each."""


def _step_dir(checkpoint_dir: str, step: int) -> str:
    return os.path.join(
        checkpoint_dir, f"{CheckpointConstant.STEP_DIR_PREFIX}{step}"
    )


def _existing_steps(checkpoint_dir: str) -> list[int]:
    """Step dirs already on disk (restart survivors must be counted)."""
    prefix = CheckpointConstant.STEP_DIR_PREFIX
    steps = []
    try:
        for name in os.listdir(checkpoint_dir):
            if name.startswith(prefix):
                try:
                    steps.append(int(name[len(prefix):]))
                except ValueError:
                    pass
    except FileNotFoundError:
        pass
    return sorted(steps)


class KeepStepIntervalStrategy(CheckpointDeletionStrategy):
    """Keep only checkpoints whose step is a multiple of
    ``keep_interval``. Thread-safe and idempotent: commit may run once
    per shard thread for the same step."""

    def __init__(self, keep_interval: int, checkpoint_dir: str):
        self._keep_interval = keep_interval
        self._checkpoint_dir = checkpoint_dir
        self._lock = threading.Lock()

    def clean_up(self, step: int, delete_func):
        with self._lock:
            # no memo of past deletions: after a rollback resume the
            # same step numbers can legitimately reappear and must be
            # cleanable again; disk state is the only source of truth
            candidates = [
                s for s in _existing_steps(self._checkpoint_dir)
                if s % self._keep_interval != 0
                and s < step  # never the just-committed or newer steps
            ]
        # delete OUTSIDE the lock (dlint DL002): step dirs are
        # multi-GB and an rmtree under the lock stalls every other
        # shard thread's commit for the whole disk walk. Concurrent
        # double-deletes are safe — delete_func tolerates a vanished
        # path and disk remains the source of truth.
        for rm_step in candidates:
            path = _step_dir(self._checkpoint_dir, rm_step)
            try:
                delete_func(path)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"fail to clean {path}: {e}")


class KeepLatestStepStrategy(CheckpointDeletionStrategy):
    """Keep at most ``max_to_keep`` newest step dirs.

    Thread-safe and idempotent: the set of steps is re-derived from the
    directories actually on disk, so repeated commits of one step (one
    per shard thread), custom-path saves outside checkpoint_dir, and
    dirs surviving an agent restart are all accounted correctly."""

    def __init__(self, max_to_keep: int, checkpoint_dir: str):
        self._max_to_keep = max(max_to_keep, 1)
        self._checkpoint_dir = checkpoint_dir
        self._lock = threading.Lock()

    def clean_up(self, step: int, delete_func):
        with self._lock:
            steps = _existing_steps(self._checkpoint_dir)
            # protect the just-committed step AND anything newer: a
            # lagging shard thread may commit step N after N+1 already
            # landed, and must never delete the tracker's target
            protected = {s for s in steps if s >= step} | {step}
            victims = [s for s in steps if s < step]
            keep_slots = max(self._max_to_keep - len(protected), 0)
            excess = victims[: max(len(victims) - keep_slots, 0)]
        # delete OUTSIDE the lock (dlint DL002, see
        # KeepStepIntervalStrategy.clean_up): the victim choice above
        # is the critical section, the rmtree is not
        for rm_step in excess:
            path = _step_dir(self._checkpoint_dir, rm_step)
            try:
                delete_func(path)
            except Exception as e:  # noqa: BLE001
                logger.warning(f"fail to clean {path}: {e}")


class CheckpointStorage(ABC):
    """Byte/file-level storage used by the async saver daemon."""

    @abstractmethod
    def write(self, content, path: str):
        ...

    def write_parts(self, parts, path: str):
        """Write a sequence of byte-like chunks as one file without
        concatenating them in memory (multi-GB checkpoint payloads)."""
        self.write(b"".join(bytes(p) for p in parts), path)

    def write_payload_with_header(
        self,
        path: str,
        header_size: int,
        make_header,
        payload,
        chunk_bytes: int = WRITE_CHUNK_BYTES,
    ) -> int:
        """Write ``[header][payload]`` where the header bytes depend on
        a streaming CRC of the payload. ``make_header(crc) -> bytes`` of
        EXACTLY ``header_size``. Returns the payload crc.

        Base implementation keeps the two-pass shape (crc pass over the
        in-memory payload, then a sequential write); backends with
        positional writes overlap the CRC with the payload writes and
        patch the header in last (the file only becomes visible after
        its atomic publish, so in-file write order is free).
        """
        from dlrover_tpu_torch import native as dlrtpu_native

        crc = 0
        for _off, chunk in _chunk_views(payload, chunk_bytes):
            crc = dlrtpu_native.crc32(chunk, crc)
        self.write_parts([make_header(crc), payload], path)
        return crc

    @abstractmethod
    def read(self, path: str, mode: str = "r"):
        ...

    @abstractmethod
    def safe_rmtree(self, dir_path: str):
        ...

    @abstractmethod
    def safe_remove(self, path: str):
        ...

    @abstractmethod
    def safe_makedirs(self, dir_path: str):
        ...

    @abstractmethod
    def commit(self, step: int, success: bool):
        ...

    @abstractmethod
    def exists(self, path: str) -> bool:
        ...

    @abstractmethod
    def listdir(self, path: str) -> list[str]:
        ...


class PosixDiskStorage(CheckpointStorage):
    def __init__(self, deletion_strategy=None):
        self._deletion_strategy = deletion_strategy

    def write(self, content, path: str):
        # raw persist seam (dlint DL003): every byte that reaches disk
        # through this class passes a chaos site first, so schedules
        # can error/delay/hang the storage layer itself — not only the
        # payload-transform sites (ckpt.write) above it
        chaos_point("storage.write", path=path)
        mode = "wb" if isinstance(content, (bytes, bytearray, memoryview)) else "w"
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, mode) as f:
            f.write(content)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    # parts at/above this size get chunked positional writes through the
    # bounded writer pool; small parts stay on the sequential fast path
    _PARALLEL_PART_BYTES = 64 << 20

    def write_parts(self, parts, path: str):
        chaos_point("storage.write", path=path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        parts = list(parts)
        large = any(
            getattr(p, "nbytes", len(p)) >= self._PARALLEL_PART_BYTES
            for p in parts
        )
        with open(tmp, "wb") as f:
            if large:
                self._write_parts_positional(f, parts)
            else:
                for part in parts:
                    f.write(part)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)

    @staticmethod
    def _write_parts_positional(f, parts):
        """Chunk-parallel pwrite of the large parts (zero-copy views
        into e.g. the shm segment); byte-identical to the sequential
        path — only the in-file write ORDER differs, which is invisible
        behind the atomic rename."""
        fd = f.fileno()
        offsets = []
        off = 0
        for p in parts:
            offsets.append(off)
            off += getattr(p, "nbytes", len(p))
        f.truncate(off)
        futures = []
        pool = _write_pool()
        for p, start in zip(parts, offsets):
            for rel, chunk in _chunk_views(p, WRITE_CHUNK_BYTES):
                futures.append(
                    pool.submit(os.pwrite, fd, chunk, start + rel)
                )
        for fut in futures:
            fut.result()  # surface write errors (ENOSPC, EIO)

    def write_payload_with_header(
        self,
        path: str,
        header_size: int,
        make_header,
        payload,
        chunk_bytes: int = WRITE_CHUNK_BYTES,
    ) -> int:
        """Single-pass persist: payload chunks stream to disk through
        the writer pool while the running CRC is computed over the same
        chunks (zlib releases the GIL, so the checksum of chunk i
        overlaps the pwrite of chunks <= i); the header — which embeds
        the final crc — lands last at offset 0. The tmp file only
        becomes the real file after fsync + atomic rename, so a reader
        can never observe the header-less intermediate."""
        from dlrover_tpu_torch import native as dlrtpu_native

        chaos_point("storage.write", path=path)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = path + ".tmp"
        crc = 0
        with open(tmp, "wb") as f:
            fd = f.fileno()
            mv = memoryview(payload)
            if mv.ndim != 1 or mv.itemsize != 1:
                mv = mv.cast("B")
            f.truncate(header_size + len(mv))
            pool = _write_pool()
            futures = []
            for off, chunk in _chunk_views(mv, chunk_bytes):
                futures.append(
                    pool.submit(os.pwrite, fd, chunk, header_size + off)
                )
                crc = dlrtpu_native.crc32(chunk, crc)
            for fut in futures:
                fut.result()
            header = make_header(crc)
            if len(header) != header_size:
                raise ValueError(
                    f"make_header returned {len(header)} bytes, "
                    f"promised {header_size}"
                )
            os.pwrite(fd, header, 0)
            f.flush()
            os.fsync(fd)
        os.replace(tmp, path)
        return crc

    def read(self, path: str, mode: str = "r"):
        if not os.path.exists(path):
            return None
        with open(path, mode) as f:
            return f.read()

    def safe_rmtree(self, dir_path: str):
        shutil.rmtree(dir_path, ignore_errors=True)

    def safe_remove(self, path: str):
        if os.path.exists(path):
            os.remove(path)

    def safe_makedirs(self, dir_path: str):
        os.makedirs(dir_path, exist_ok=True)

    def commit(self, step: int, success: bool):
        if self._deletion_strategy and success:
            self._deletion_strategy.clean_up(step, self.safe_rmtree)

    def exists(self, path: str) -> bool:
        return os.path.exists(path)

    def listdir(self, path: str) -> list[str]:
        return os.listdir(path) if os.path.isdir(path) else []


def get_checkpoint_storage(deletion_strategy=None) -> CheckpointStorage:
    return PosixDiskStorage(deletion_strategy)
