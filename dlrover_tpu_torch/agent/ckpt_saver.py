"""Flash Checkpoint: shared-memory layout + agent-side async saver daemon.

Equivalent capability: reference dlrover/python/elastic_agent/torch/
ckpt_saver.py — SharedMemoryHandler (:209, tensor-meta dict + shm
buffer), AsyncCheckpointSaver (:342) with its factory queue (:406),
shm->storage event loop (:506), per-shard save (:533),
save_shm_to_storage on failure/SIGTERM (:622), signal handlers (:468);
CommonDirCheckpointSaver (:761), TempDirCheckpointSaver (:908).

TPU redesign: the training process is a JAX host process whose
addressable array shards are written (async HBM->host) into a
POSIX shm segment; this module is deliberately **jax-free** — the agent
daemon only moves bytes between shm and storage, so it keeps working
while the training process is dead (that is the whole point: the
checkpoint survives worker crashes and persists in the background).

Shm layout:  [u64 meta_len][pickled meta][raw tensor bytes...]
Meta: {"step": int, "paths": [leaf names], "leaves": [LeafMeta], ...}

The PyTorch port's copy of dlrover_tpu/agent/ckpt_saver.py, with the
same layout, two-phase publish, streaming CRC, manifests, verify and
retention. Its segments are named ``dlrtpu_torch_ckpt_{job}_{rank}``,
and it reads metas through the allowlist of ``common/serialize.py``:
only this package's classes resolve.
"""

from __future__ import annotations

import json
import os
import pickle
import queue as _queue
import signal
import threading
import time
from dataclasses import dataclass, field

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.chaos import chaos_transform
from dlrover_tpu_torch.common.constants import CheckpointConstant
from dlrover_tpu_torch.common.ipc import (
    SharedLock,
    SharedQueue,
    get_or_create_shm,
    job_name,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.serialize import deserialize_message
from dlrover_tpu_torch.common.storage import PosixDiskStorage

logger = get_logger(__name__)

_META_LEN_SIZE = 8

SAVER_FACTORY_QUEUE = "ckpt_factory"
# set ("1") in a worker's env by the agent that hosts its saver: the
# worker's engine must then reach the factory queue and never fall back
# to a saver of its own
AGENT_SAVER_ENV = "DLROVER_TORCH_AGENT_SAVER"


def _pid_alive(pid: str) -> bool:
    """True if the process that acquired a SharedLock still exists."""
    try:
        os.kill(int(pid), 0)
        return True
    except (ValueError, ProcessLookupError):
        return False
    except PermissionError:
        return True


def shm_name(local_rank: int = 0) -> str:
    return f"dlrtpu_torch_ckpt_{job_name()}_{local_rank}"


def lock_name(local_rank: int = 0) -> str:
    return f"ckpt_shm_{local_rank}"


def event_queue_name(local_rank: int = 0) -> str:
    return f"ckpt_event_{local_rank}"


def persist_done_queue_name(local_rank: int = 0) -> str:
    """Agent -> worker persist-completion wakeups: the saver puts the
    persisted step here after the commit protocol, so the engine's
    ``wait_for_persist`` (and the trainer's final-save retry loop) wake
    on the event instead of quantizing end-of-run latency to a poll
    interval. The tracker file stays the source of truth — the queue is
    only a wakeup hint, bounded and droppable."""
    return f"ckpt_done_{local_rank}"


def _load_meta(raw: bytes) -> "CheckpointMeta":
    """Unpickle a meta through the allowlist of ``common/serialize.py``:
    only this package's classes and plain containers resolve, so a meta
    that names another package's classes (the JAX package writes the
    same layout) is refused instead of importing that package."""
    return deserialize_message(raw)


@dataclass
class LeafMeta:
    """One array (or array shard) in the shm buffer."""

    path: str = ""
    dtype: str = ""
    shape: tuple = ()
    offset: int = 0
    nbytes: int = 0
    # GSPMD sharding info: the global shape of the array and the index of
    # this host-local shard as ((start, stop) per dim); None => replicated
    global_shape: tuple | None = None
    index: tuple | None = None


@dataclass
class CheckpointMeta:
    step: int = 0
    leaves: list = field(default_factory=list)
    treedef: bytes = b""
    # which framework engine wrote it (replicated | sharded)
    engine: str = "replicated"
    host_rank: int = 0
    num_hosts: int = 1
    total_bytes: int = 0
    user_meta: dict = field(default_factory=dict)
    # CRC-32 of the persisted payload (set at persist time; -1 = absent).
    # Verified on read so a torn/corrupted shard file is rejected instead
    # of silently restoring garbage.
    payload_crc: int = -1


@dataclass
class SaveEvent:
    step: int = 0
    path: str = ""
    storage_type: str = "disk"  # "disk" persists; "memory" = shm only


class SharedMemoryHandler:
    """Reads/writes the checkpoint shm segment (usable from either side
    of the agent/worker boundary)."""

    def __init__(self, local_rank: int = 0):
        self._local_rank = local_rank
        self._shm = None

    @property
    def shm(self):
        return self._shm

    def _ensure(self, size: int):
        if self._shm is None or self._shm.size < size:
            if self._shm is not None:
                self._shm.close()
            self._shm = get_or_create_shm(
                shm_name(self._local_rank), size
            )
            if getattr(self._shm, "just_created", False):
                # A FRESH segment's pages fault in on first touch; left
                # to the copy loop that tax is paid inside the timed
                # save interleaved with the memcpy (the
                # ckpt_engine_cold_gbps vs warm gap). Fault them in NOW
                # with a dedicated page-touch pass — measurably ~4-6x
                # cheaper than faulting from inside a large memcpy even
                # single-threaded, and threaded on multi-core hosts.
                # The segment is new, so its contents are garbage by
                # contract (the touch writes zeros).
                try:
                    from dlrover_tpu_torch import native as dlrtpu_native

                    dlrtpu_native.prefault(self._shm.buf)
                except Exception:  # noqa: BLE001 - prefault is an
                    # optimization; the copy path faults pages in anyway
                    pass

    def attach(self) -> bool:
        """Attach to an existing segment (agent side)."""
        try:
            self._shm = get_or_create_shm(shm_name(self._local_rank))
            return True
        except FileNotFoundError:
            return False

    def refresh(self):
        """Drop the cached mapping and re-attach: the worker may have
        unlinked+recreated the segment when the state dict grew, and a
        cached mapping would keep reading the stale bytes forever."""
        if self._shm is not None:
            self._shm.close()
            self._shm = None
        return self.attach()

    def write_meta_and_reserve(
        self, meta: CheckpointMeta, publish: bool = True
    ) -> memoryview:
        """Write the meta header and return a view over the tensor area.

        ``publish=False`` stages the meta but leaves the length prefix
        zeroed (readers see "no checkpoint") until :meth:`publish_meta`
        — two-phase commit for drains that fill the tensor area over a
        long window (chunked D2H): a preemption mid-drain must never
        leave a valid meta over partial bytes, or the failure-path
        save_shm_to_storage persists a torn snapshot and restore loads
        mixed-step weights. The prefix itself is invalidated FIRST in
        both modes so a crash between meta and data writes is also
        unreadable.
        """
        meta_bytes = pickle.dumps(meta)
        data_start = _META_LEN_SIZE + len(meta_bytes)
        total = data_start + meta.total_bytes
        self._ensure(total)
        buf = self._shm.buf
        buf[:_META_LEN_SIZE] = (0).to_bytes(_META_LEN_SIZE, "little")
        buf[_META_LEN_SIZE : data_start] = meta_bytes
        self._staged_meta_len = len(meta_bytes)
        if publish:
            self.publish_meta()
        return buf[data_start : data_start + meta.total_bytes]

    def publish_meta(self) -> None:
        """Commit a staged meta: the single prefix-word write makes the
        checkpoint visible atomically (readers re-validate by parsing)."""
        self._shm.buf[:_META_LEN_SIZE] = self._staged_meta_len.to_bytes(
            _META_LEN_SIZE, "little"
        )

    def read(self) -> tuple[CheckpointMeta, memoryview] | None:
        if self._shm is None and not self.attach():
            return None
        buf = self._shm.buf
        meta_len = int.from_bytes(buf[:_META_LEN_SIZE], "little")
        if meta_len == 0 or meta_len > self._shm.size:
            return None
        try:
            meta: CheckpointMeta = _load_meta(
                bytes(buf[_META_LEN_SIZE : _META_LEN_SIZE + meta_len])
            )
        except Exception:  # noqa: BLE001 - partial/garbage header
            return None
        data_start = _META_LEN_SIZE + meta_len
        return meta, buf[data_start : data_start + meta.total_bytes]

    def get_checkpoint_step(self) -> int:
        result = self.read()
        return result[0].step if result else -1

    def no_checkpoint_state(self) -> bool:
        return self.read() is None

    def mark_empty(self):
        if self._shm is not None:
            self._shm.buf[:_META_LEN_SIZE] = (0).to_bytes(
                _META_LEN_SIZE, "little"
            )

    def close(self, unlink: bool = False):
        if self._shm is not None:
            self._shm.close()
            if unlink:
                try:
                    self._shm.unlink()
                except FileNotFoundError:
                    pass
            self._shm = None


# --------------------------------------------------------------------------
# storage file format: one file per host per step
# --------------------------------------------------------------------------


def host_shard_filename(host_rank: int) -> str:
    return f"host_{host_rank}.dlck"


def manifest_filename(host_rank: int) -> str:
    return f"host_{host_rank}.manifest.json"


# Slack appended to the pickled-meta slot so the header's byte length
# is fixed BEFORE the streaming crc lands in it: pickle ignores bytes
# after the STOP opcode, and an int's pickled width varies by value
# (BININT1 through LONG1 across the crc range) by at most a few bytes.
_META_CRC_SLACK = 16


def write_host_shard(
    storage, path: str, meta: CheckpointMeta, data
) -> tuple[int, int]:
    """Stream header + meta + payload; ``data`` may be a memoryview into
    shm — never copy the (multi-GB) payload into an intermediate blob.

    The payload CRC is stamped into the meta so restores detect torn or
    bit-rotted shard files. It is computed chunk-wise DURING the payload
    write (one traversal: the checksum of chunk i overlaps the disk
    write of chunks <= i) instead of in a pre-pass over the whole
    payload; the header lands last in the invisible temp file, its byte
    length pinned up front by padding the pickled meta (readers stop at
    pickle's STOP opcode, so the pad is compatible with every existing
    reader). Returns (payload_crc, payload_nbytes) — the INTENDED
    values, stamped into the sidecar manifest before any fault (chaos
    tear/bitflip, a real crash mid-write) can corrupt the on-disk
    bytes."""
    from dlrover_tpu_torch import native as dlrtpu_native

    payload_nbytes = (
        data.nbytes if isinstance(data, memoryview) else len(data)
    )
    # fault site: tear (truncate mid-shard) or bit-flip the persisted
    # payload — the crc must describe the INTENDED bytes while the
    # corrupted ones hit the disk, so a fired transform forces the
    # two-pass shape (crc over the original, write the corrupted)
    transformed = chaos_transform(
        "ckpt.write", data, step=meta.step, path=path
    )
    if transformed is not data:
        meta.payload_crc = dlrtpu_native.crc32_parallel(data)
        meta_bytes = pickle.dumps(meta)
        storage.write_parts(
            [
                len(meta_bytes).to_bytes(_META_LEN_SIZE, "little"),
                meta_bytes,
                transformed,
            ],
            path,
        )
        return meta.payload_crc, payload_nbytes

    meta.payload_crc = 0
    meta_len = len(pickle.dumps(meta)) + _META_CRC_SLACK

    def make_header(crc: int) -> bytes:
        meta.payload_crc = crc
        meta_bytes = pickle.dumps(meta)
        assert len(meta_bytes) <= meta_len, "crc widened meta past slack"
        meta_bytes += b"\x00" * (meta_len - len(meta_bytes))
        return (
            meta_len.to_bytes(_META_LEN_SIZE, "little") + meta_bytes
        )

    crc = storage.write_payload_with_header(
        path, _META_LEN_SIZE + meta_len, make_header, data
    )
    return crc, payload_nbytes


def write_shard_manifest(
    storage, step_dir: str, shard_id: int, step: int,
    payload_crc: int, payload_nbytes: int, engine: str,
) -> None:
    """Per-shard checksum manifest, written right after its shard and
    strictly BEFORE the atomic step-dir rename / tracker update, so a
    restore can verify integrity without trusting the shard's own
    (possibly torn) embedded meta."""
    entry = {
        "format": 1,
        "step": step,
        "file": host_shard_filename(shard_id),
        "payload_crc": payload_crc,
        "payload_nbytes": payload_nbytes,
        "engine": engine,
    }
    blob = json.dumps(entry, sort_keys=True).encode()
    blob = chaos_transform("ckpt.manifest", blob, step=step)
    storage.write(blob, os.path.join(step_dir, manifest_filename(shard_id)))


_READ_CHUNK = 8 << 20


def _file_payload_crc(path: str, payload_start: int) -> tuple[int, int]:
    """(crc32, nbytes) of the payload region, chunked (bounded memory).
    The chunk buffer comes from the host arena and is read INTO, so a
    full-checkpoint verify allocates nothing per chunk."""
    from dlrover_tpu_torch import native as dlrtpu_native
    from dlrover_tpu_torch.common.arena import get_arena

    crc = 0
    nbytes = 0
    with get_arena().lease(_READ_CHUNK) as lease, open(path, "rb") as f:
        buf = lease.view
        f.seek(payload_start)
        while True:
            got = f.readinto(buf)
            if not got:
                break
            crc = dlrtpu_native.crc32(buf[:got], crc)
            nbytes += got
    return crc, nbytes


_VERIFIED_MARKER = ".verified"


def verify_step_dir(step_dir: str, deep: bool = True) -> tuple[bool, str]:
    """Integrity-verify every shard of a persisted step directory.

    Returns (ok, reason). A shard verifies against its sidecar manifest
    (payload size + crc recomputed from the actual bytes); a legacy
    shard without a manifest falls back to the crc embedded in its own
    meta. Any torn, bit-flipped, unreadable, or manifest-corrupted
    shard fails the WHOLE directory — restore then falls back to the
    next-newest verified checkpoint instead of loading garbage.

    ``deep=False`` runs structural + size checks only (catches torn
    writes, unreadable metas, corrupt manifests) and skips the payload
    CRC: for the EAGER load path, whose ``read_host_shard`` re-verifies
    every payload's embedded crc anyway — a deep verify there would
    read and checksum multi-GB payloads twice. The targeted shard-wise
    path performs crc-less slice reads, so it must verify deep.

    Deep CRC results are cached in a ``.verified`` marker inside the
    step dir (shard files are immutable once committed): the first
    verifier pays the full read; later ones — other hosts of a shared
    filesystem, repeat restores — only size-check, so an 8-host restore
    does not read the whole checkpoint 8 times over. Trade: bit-rot
    striking AFTER a successful deep verify (same size) is not
    re-detected through the cache."""
    if not os.path.isdir(step_dir):
        return False, "not a directory"
    try:
        names = sorted(os.listdir(step_dir))
    except OSError as e:
        return False, f"unreadable: {e}"
    shards = [n for n in names if n.endswith(".dlck")]
    if not shards:
        return False, "no shard files"
    marker_path = os.path.join(step_dir, _VERIFIED_MARKER)
    try:
        with open(marker_path) as f:
            already_verified = json.load(f).get("files", {})
    except Exception:  # noqa: BLE001 - absent or corrupt cache: re-crc
        already_verified = {}
    newly_verified = {}
    for fname in shards:
        fpath = os.path.join(step_dir, fname)
        mpath = os.path.join(step_dir, fname[: -len(".dlck")] +
                             ".manifest.json")
        header = read_host_shard_meta(fpath)
        if header is None:
            return False, f"{fname}: missing or unreadable shard"
        meta, payload_start = header
        if os.path.exists(mpath):
            try:
                with open(mpath) as f:
                    manifest = json.load(f)
                want_crc = int(manifest["payload_crc"])
                want_nbytes = int(manifest["payload_nbytes"])
            except (OSError, ValueError, KeyError, TypeError) as e:
                return False, f"{fname}: corrupted manifest ({e})"
        else:
            # legacy checkpoint (pre-manifest): the crc embedded in the
            # shard's own meta is the only integrity signal; pre-crc
            # shards (payload_crc < 0) still get the SIZE check below —
            # a torn legacy shard must fail verify, not crash the
            # loader's np.frombuffer
            want_crc = (
                meta.payload_crc if meta.payload_crc >= 0 else None
            )
            want_nbytes = meta.total_bytes
        try:
            actual_nbytes = os.path.getsize(fpath) - payload_start
        except OSError as e:
            return False, f"{fname}: unreadable ({e})"
        if actual_nbytes != want_nbytes:
            return False, (
                f"{fname}: torn payload ({actual_nbytes} bytes, "
                f"expected {want_nbytes})"
            )
        if not deep or want_crc is None:
            continue  # size-verified; no (or loader-side) payload crc
        if already_verified.get(fname) == want_nbytes:
            continue  # full crc already paid by a previous verifier
        try:
            got_crc, got_nbytes = _file_payload_crc(fpath, payload_start)
        except OSError as e:
            return False, f"{fname}: unreadable payload ({e})"
        if got_nbytes != want_nbytes:
            return False, (
                f"{fname}: torn payload ({got_nbytes} bytes, expected "
                f"{want_nbytes})"
            )
        if got_crc != want_crc:
            return False, (
                f"{fname}: checksum mismatch (want {want_crc:08x} got "
                f"{got_crc:08x})"
            )
        newly_verified[fname] = want_nbytes
    if newly_verified:
        # best-effort cache write (atomic rename); read-only storage
        # just means every verifier pays the full crc
        try:
            already_verified.update(newly_verified)
            tmp = marker_path + f".tmp.{os.getpid()}"
            # dlint: allow-chaos(best-effort verify cache: a torn/corrupt marker fails json.load and only costs a re-crc; sizes are cross-checked against the manifest on every read)
            with open(tmp, "w") as f:
                json.dump({"files": already_verified}, f)
            os.replace(tmp, marker_path)
        except OSError:
            pass
    return True, ""


def list_step_numbers(checkpoint_dir: str) -> list[int]:
    """Persisted step-dir numbers under ``checkpoint_dir``, newest
    first. The ONE place that knows the dir-name/.tmp convention — the
    engine's candidate scan and the agent's verified scan both build on
    it, so the consensus report can never skew from what the restore
    path will actually consider."""
    prefix = CheckpointConstant.STEP_DIR_PREFIX
    steps: set[int] = set()
    try:
        for name in os.listdir(checkpoint_dir):
            if not name.startswith(prefix) or name.endswith(".tmp"):
                continue
            try:
                steps.add(int(name[len(prefix):]))
            except ValueError:
                continue
    except OSError:
        pass
    return sorted(steps, reverse=True)


def verified_storage_steps(
    checkpoint_dir: str, limit: int = 64
) -> list[int]:
    """The newest (up to ``limit``) persisted steps whose directories
    pass the DEEP verify (payload CRCs included). This feeds the
    master's restore-step consensus, and the restore path deep-verifies
    its candidates — advertising on a shallower check would let a
    bit-rotted step become the job-wide consensus, fail every restore,
    and livelock the whole job in restart loops. The ``.verified``
    marker caches full-CRC work per step dir, so only the first scan
    after a persist pays the read.

    ``limit`` bounds the scan; it sits far above any sane retention
    policy (keep-latest-N), but a host that somehow retains more dirs
    gets a LOUD log when truncation could hide a cross-host common
    step from the consensus intersection — never a silent cap."""
    prefix = CheckpointConstant.STEP_DIR_PREFIX
    out: list[int] = []
    steps = list_step_numbers(checkpoint_dir)
    for step in steps:
        if len(out) >= limit:
            logger.warning(
                "verified-step scan truncated at %d of %d step dirs "
                "under %s: steps older than %d are not advertised for "
                "restore consensus",
                limit, len(steps), checkpoint_dir, out[-1],
            )
            break
        step_dir = os.path.join(checkpoint_dir, f"{prefix}{step}")
        ok, _reason = verify_step_dir(step_dir, deep=True)
        if ok:
            out.append(step)
    return out


def newest_verified_step(checkpoint_dir: str) -> int:
    steps = verified_storage_steps(checkpoint_dir, limit=1)
    return steps[0] if steps else -1


def read_host_shard_meta(
    path: str,
) -> tuple[CheckpointMeta, int] | None:
    """Read ONLY the pickled meta of a ``.dlck`` host-shard file.

    Returns (meta, payload_start_offset). The payload stays on disk so
    restores can ``np.memmap`` exactly the byte ranges a target shard
    intersects (scalable resharded restore — the full-file read of
    :func:`read_host_shard` materialises every saved byte). Slice reads
    cannot verify the whole-payload CRC without defeating their point;
    the eager path keeps the check.
    """
    if not os.path.exists(path):
        return None
    try:
        with open(path, "rb") as f:
            meta_len = int.from_bytes(f.read(_META_LEN_SIZE), "little")
            meta = _load_meta(f.read(meta_len))
    except Exception:  # noqa: BLE001 - torn header/meta region
        logger.error("unreadable shard meta in %s; rejecting", path)
        return None
    return meta, _META_LEN_SIZE + meta_len


def read_host_shard(
    path: str, stats: dict | None = None
) -> tuple[CheckpointMeta, memoryview] | None:
    """Read one ``.dlck`` shard: chunked ``readinto`` with the CRC
    verified INCREMENTALLY on each chunk as it lands — one traversal,
    transient memory beyond the returned payload stays O(chunk) (the
    old shape ``f.read(total)`` + a second full CRC pass doubled the
    passes and spiked peak RSS on multi-GB shards). Torn headers and
    short payloads are rejected exactly like before.

    Returns (meta, payload) where payload is a READ-ONLY memoryview
    (callers build numpy views over it, as with the old ``bytes``).
    ``stats`` (optional) accumulates ``read_s``/``verify_s``/``bytes``
    for the staged restore breakdown."""
    if not os.path.exists(path):
        return None
    from dlrover_tpu_torch import native as dlrtpu_native

    try:
        with open(path, "rb") as f:
            meta_len = int.from_bytes(f.read(_META_LEN_SIZE), "little")
            meta = _load_meta(f.read(meta_len))
            # uninitialized allocation: bytearray(n) would memset the
            # whole multi-GB buffer to zero just for readinto to
            # overwrite it — a full extra memory-bandwidth pass
            import numpy as _np

            mv = memoryview(_np.empty(meta.total_bytes, _np.uint8))
            crc = 0
            filled = 0
            check = meta.payload_crc >= 0
            while filled < meta.total_bytes:
                t0 = time.perf_counter()
                got = f.readinto(
                    mv[filled : filled + _READ_CHUNK]
                )
                t1 = time.perf_counter()
                if not got:
                    break
                if check:
                    crc = dlrtpu_native.crc32(
                        mv[filled : filled + got], crc
                    )
                if stats is not None:
                    stats["read_s"] = stats.get("read_s", 0.0) + (t1 - t0)
                    stats["verify_s"] = stats.get("verify_s", 0.0) + (
                        time.perf_counter() - t1
                    )
                filled += got
    except Exception:  # noqa: BLE001 - torn header/meta region
        logger.error("unreadable shard meta in %s; rejecting", path)
        return None
    if filled < meta.total_bytes:
        logger.error(
            "torn payload in %s (%d of %d bytes); rejecting shard",
            path, filled, meta.total_bytes,
        )
        return None
    if check and crc != meta.payload_crc:
        logger.error(
            "checksum mismatch reading %s (want %08x got %08x); "
            "rejecting shard", path, meta.payload_crc, crc,
        )
        return None
    if stats is not None:
        stats["bytes"] = stats.get("bytes", 0) + meta.total_bytes
    return meta, mv.toreadonly()


# --------------------------------------------------------------------------
# the agent-side daemon
# --------------------------------------------------------------------------


class AsyncCheckpointSaver:
    """Agent-side daemon: listens for save events from the training
    process and persists shm checkpoints to storage in the background.

    One instance per host; handles all local ranks' shm segments. A
    process without an agent runs its own, serving only its own segment
    (``local_ranks``) while the commit still counts every local rank's
    shard.
    """

    _saver_instance: "AsyncCheckpointSaver | None" = None
    _factory_thread: threading.Thread | None = None

    def __init__(
        self,
        checkpoint_dir: str = "",
        local_shard_num: int = 1,
        host_rank: int = 0,
        num_hosts: int = 1,
        master_client=None,
        storage=None,
        deletion_strategy=None,
        local_ranks=None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self.local_shard_num = local_shard_num
        # the local ranks whose segments this saver serves (all of them
        # for an agent's)
        self.local_ranks = (tuple(range(local_shard_num))
                            if local_ranks is None else tuple(local_ranks))
        self.host_rank = host_rank
        self.num_hosts = num_hosts
        self._master_client = master_client
        # Retention (reference KeepStepIntervalStrategy/
        # KeepLatestStepStrategy): applied through the storage's commit
        # hook so non-POSIX backends stay in charge of their own
        # deletion. None = keep everything; env
        # DLROVER_TPU_MAX_CKPTS_TO_KEEP=<n> selects keep-latest-n.
        if deletion_strategy is None and storage is None:
            raw = os.environ.get("DLROVER_TPU_MAX_CKPTS_TO_KEEP", "")
            try:
                keep = int(raw or 0)
            except ValueError:
                logger.warning(
                    "ignoring malformed DLROVER_TPU_MAX_CKPTS_TO_KEEP=%r",
                    raw,
                )
                keep = 0
            if keep > 0 and checkpoint_dir:
                from dlrover_tpu_torch.common.storage import (
                    KeepLatestStepStrategy,
                )

                deletion_strategy = KeepLatestStepStrategy(
                    keep, checkpoint_dir
                )
        if storage is None:
            from dlrover_tpu_torch.common.storage import get_checkpoint_storage

            storage = get_checkpoint_storage(deletion_strategy)
        elif deletion_strategy is not None:
            # attach the caller's policy to their storage when possible;
            # never silently drop an explicit retention request
            if getattr(storage, "_deletion_strategy", "absent") is None:
                storage._deletion_strategy = deletion_strategy
            else:
                logger.warning(
                    "deletion_strategy ignored: the provided storage "
                    "already manages retention"
                )
        self._storage = storage
        self._shm_handlers = {
            i: SharedMemoryHandler(i) for i in self.local_ranks
        }
        self._shm_locks = {
            i: SharedLock(lock_name(i), create=True)
            for i in self.local_ranks
        }
        self._event_queues = {
            i: SharedQueue(event_queue_name(i), create=True)
            for i in self.local_ranks
        }
        # persist-completion wakeups (bounded: a slow/absent consumer
        # must not grow agent memory — stale hints are droppable, the
        # tracker file is the source of truth)
        self._done_queues = {
            i: SharedQueue(persist_done_queue_name(i), create=True,
                           maxsize=64)
            for i in self.local_ranks
        }
        self._stopped = threading.Event()
        self._threads: list[threading.Thread] = []
        # high-water mark shared by every per-rank saver thread and the
        # SIGTERM flush path: locked max-update, or a lagging rank's
        # commit could roll it backwards past a newer step (dlint
        # DL008). RLock, not Lock: save_shm_to_storage also runs on the
        # MAIN thread (breakpoint flush, SIGTERM handler), so a signal
        # arriving while that same thread holds the lock re-enters the
        # commit path on the interrupted thread — a non-reentrant lock
        # would self-deadlock the dying process, as a logging call from
        # a signal handler can
        self._persist_lock = threading.RLock()
        self._last_persisted_step = -1

    # -- lifecycle ---------------------------------------------------------

    def start(self):
        for i in self.local_ranks:
            t = threading.Thread(
                target=self._sync_shm_to_storage,
                args=(i,),
                name=f"ckpt-saver-{i}",
                daemon=True,
            )
            t.start()
            self._threads.append(t)
        logger.info(
            "AsyncCheckpointSaver started: dir=%s shards=%d",
            self.checkpoint_dir,
            self.local_shard_num,
        )

    def stop(self, join_timeout: float = 10.0):
        self._stopped.set()
        # wake event threads blocked in q.get so the join is immediate,
        # then bound-join: callers may delete the checkpoint dir right
        # after stop(), and an in-flight persist must not recreate it.
        for q in self._event_queues.values():
            try:
                q.put(None)
            except Exception:  # noqa: BLE001
                pass
        deadline = time.time() + join_timeout
        for t in self._threads:
            if t is not threading.current_thread():
                t.join(max(0.0, deadline - time.time()))
                if t.is_alive():
                    logger.warning(
                        "saver thread %s still persisting after stop(); "
                        "checkpoint dir must not be deleted yet", t.name
                    )

    @classmethod
    def register_signal_handlers(cls):
        """Persist whatever is in shm before dying on SIGTERM (pod
        eviction) — reference ckpt_saver.py:468."""

        def handler(signum, frame):  # noqa: ARG001
            saver = cls._saver_instance
            # no logging from signal context (dlint DL004): the
            # handler may have interrupted the main
            # thread while it holds the logging module's non-reentrant
            # handler lock — write to the raw fd instead
            if saver is not None:
                # stderr may be a pipe to an already-dead parent (the
                # very teardown this handler serves): a raised EPIPE
                # here must not abort the flush or the 143 exit
                try:
                    os.write(
                        2,
                        b"SIGTERM: flushing shm checkpoint to storage\n",
                    )
                except OSError:
                    pass
                try:
                    # eviction-time best-effort flush: its locks are
                    # saver-thread-owned, never main-thread, so they
                    # can block here but not self-deadlock
                    saver.save_shm_to_storage()
                except Exception:  # noqa: BLE001
                    try:
                        os.write(2, b"SIGTERM shm flush failed\n")
                    except OSError:
                        pass
            raise SystemExit(143)

        signal.signal(signal.SIGTERM, handler)

    @classmethod
    def start_async_saving_ckpt(cls):
        """Start the factory listener: the training process announces its
        saver config on the factory queue; the agent builds the saver
        (reference ckpt_saver.py:406-461)."""
        if cls._factory_thread is not None:
            return
        factory_queue = SharedQueue(SAVER_FACTORY_QUEUE, create=True)
        cls._factory_queue = factory_queue
        stop = threading.Event()
        cls._factory_stop = stop

        def factory_loop():
            while not stop.is_set():
                try:
                    config = factory_queue.get(timeout=60)
                except _queue.Empty:
                    continue
                except Exception:  # noqa: BLE001
                    if stop.is_set():
                        return
                    time.sleep(1)
                    continue
                try:
                    if cls._saver_instance is None:
                        cls._saver_instance = AsyncCheckpointSaver(**config)
                        cls._saver_instance.start()
                except Exception:  # noqa: BLE001
                    logger.exception("failed to build checkpoint saver")

        cls._factory_thread = threading.Thread(
            target=factory_loop, name="ckpt-saver-factory", daemon=True
        )
        cls._factory_thread.start()

    @classmethod
    def get_ckpt_saver(cls):
        return cls._saver_instance

    @classmethod
    def reset(cls):
        if cls._saver_instance is not None:
            cls._saver_instance.stop()
            cls._saver_instance = None
        # also retire the factory listener: a stale thread bound to a
        # previous socket dir would make the next start_async_saving_ckpt
        # a silent no-op (its queue socket no longer matches the env)
        if cls._factory_thread is not None:
            stop = getattr(cls, "_factory_stop", None)
            if stop is not None:
                stop.set()
            queue_obj = getattr(cls, "_factory_queue", None)
            if queue_obj is not None:
                try:
                    queue_obj.unlink()
                except Exception:  # noqa: BLE001
                    pass
            cls._factory_thread = None
            cls._factory_queue = None
            cls._factory_stop = None

    # -- event loop --------------------------------------------------------

    def _sync_shm_to_storage(self, local_rank: int):
        """Reference ckpt_saver.py:506 — wait for save events, persist."""
        q = self._event_queues[local_rank]
        while not self._stopped.is_set():
            try:
                event: SaveEvent = q.get(timeout=5)
            except _queue.Empty:
                continue
            except Exception:  # noqa: BLE001
                time.sleep(1)
                continue
            if event is None:
                continue  # stop() wake-up sentinel
            if event.storage_type == "memory":
                continue  # shm-only checkpoint; nothing to persist
            try:
                self.save_step_checkpoint(event, local_rank)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "persist step %s failed (rank %d)",
                    event.step,
                    local_rank,
                )

    # -- persistence -------------------------------------------------------

    def _step_dir(self, path: str, step: int) -> str:
        if path:
            return path
        return os.path.join(
            self.checkpoint_dir,
            f"{CheckpointConstant.STEP_DIR_PREFIX}{step}",
        )

    def save_step_checkpoint(self, event: SaveEvent, local_rank: int):
        """Persist one local shard, then run the commit protocol."""
        start = time.time()
        lock = self._shm_locks[local_rank]
        acquired = self._acquire_or_take_over(lock)
        if not acquired:
            # never read shm unlocked: a live writer may be mid-copy and
            # we would persist (and advertise) a torn checkpoint
            logger.error(
                "skipping persist of step %s shard %d: shm lock unavailable",
                event.step,
                local_rank,
            )
            return
        try:
            self._shm_handlers[local_rank].refresh()
            result = self._shm_handlers[local_rank].read()
            if result is None:
                logger.warning("no checkpoint in shm for rank %d", local_rank)
                return
            meta, data = result
            if meta.step != event.step:
                logger.warning(
                    "shm holds step %s, event asked %s; saving shm step",
                    meta.step,
                    event.step,
                )
            step_dir = self._step_dir(event.path, meta.step)
            self._save_shard(step_dir, meta, data, local_rank)
            # a sharded save names the shards its step's commit waits
            # for (its process group's size, which an in-process reshape
            # changes under a fixed local world)
            self._commit_checkpoint(
                step_dir, meta.step, local_rank, engine=meta.engine,
                shards=int((meta.user_meta or {}).get("commit_shards", 0)),
            )
        finally:
            if acquired:
                lock.release(force=True)
        # wake any engine blocked in wait_for_persist / the trainer's
        # final-save retry loop: best-effort, non-blocking (a full queue
        # just means the waiter is behind on hints; the tracker file
        # still carries the truth)
        try:
            self._done_queues[local_rank].put(meta.step, block=False)
        except Exception:  # noqa: BLE001 - hint only
            pass
        elapsed = time.time() - start
        # timeline only: the daemon's persist overlaps training, so the
        # goodput ledger deliberately does NOT treat it as lost time
        telemetry.event(
            "ckpt.persist", step=event.step, dur=elapsed,
            shard=local_rank,
        )
        telemetry.observe("ckpt.persist.seconds", elapsed)
        logger.info(
            "persisted step %s shard %d in %.2fs",
            event.step,
            local_rank,
            elapsed,
        )

    def _acquire_or_take_over(
        self, lock, dead_grace: float = 2.0
    ) -> bool:
        """Bounded acquire with forced takeover ONLY from a dead holder.

        A worker that died while holding the shm lock must not deadlock
        the agent's breakpoint flush (the exact crash Flash Checkpoint
        exists to survive) — but a *live* writer mid-copy may legitimately
        hold the lock for a long time (multi-GB D2H), so we never steal
        from a holder whose pid is still alive."""
        deadline = time.time() + CheckpointConstant.SAVE_TIMEOUT
        dead_since = None
        while time.time() < deadline:
            if lock.acquire(blocking=False):
                return True
            owner = lock.owner()
            if owner is not None and _pid_alive(owner):
                dead_since = None  # live writer: wait, never steal
            elif dead_since is None:
                dead_since = time.time()
            elif time.time() - dead_since >= dead_grace:
                logger.warning(
                    "shm lock holder (pid %s) is gone; taking the lock over",
                    owner,
                )
                lock.release(force=True)
                if lock.acquire(blocking=False):
                    return True
                dead_since = None  # lost the race; re-observe
            time.sleep(0.2)
        logger.error(
            "could not acquire shm lock within %.0fs (holder alive)",
            CheckpointConstant.SAVE_TIMEOUT,
        )
        return False

    def _save_shard(self, step_dir, meta, data, local_rank):
        shard_id = self.host_rank * self.local_shard_num + local_rank
        path = os.path.join(step_dir, host_shard_filename(shard_id))
        crc, payload_nbytes = write_host_shard(
            self._storage, path, meta, data
        )
        # manifest lands before the .done marker, the atomic rename and
        # the tracker update: nothing can advertise this shard until its
        # integrity record exists
        write_shard_manifest(
            self._storage, step_dir, shard_id, meta.step,
            crc, payload_nbytes, meta.engine,
        )

    def _commit_checkpoint(
        self, step_dir: str, step: int, local_rank, engine: str = "sharded",
        shards: int = 0,
    ):
        """.done marker per shard; when all expected shards are done,
        update the tracker file (reference commit_checkpoint :847)."""
        done_dir = os.path.join(step_dir, ".done")
        self._storage.safe_makedirs(done_dir)
        shard_id = self.host_rank * self.local_shard_num + local_rank
        self._storage.write("", os.path.join(done_dir, f"{shard_id}.done"))
        # replicated engines write from host 0 only; sharded engines from
        # every host
        if engine == "replicated":
            total_shards = self.local_shard_num
        else:
            total_shards = shards or self.local_shard_num * self.num_hosts
        deadline = time.time() + CheckpointConstant.SAVE_TIMEOUT
        while time.time() < deadline:
            done = len(
                [
                    f
                    for f in self._storage.listdir(done_dir)
                    if f.endswith(".done")
                ]
            )
            if done >= total_shards:
                break
            time.sleep(0.5)
        else:
            logger.warning("commit timeout for step %s", step)
            return
        if self._master_client is not None and self.num_hosts > 1:
            # cross-host agreement through the master
            deadline = time.time() + CheckpointConstant.SAVE_TIMEOUT
            while time.time() < deadline:
                if self._master_client.sync_checkpoint(step):
                    break
                time.sleep(0.5)
        # Finalize the directory BEFORE advertising the step in the
        # tracker — a reader must never see a tracker pointing at a dir
        # that does not exist yet.
        self._finalize_step_dir(step_dir)
        if self.host_rank == 0:
            # the tracker must live NEXT TO the step dir it advertises —
            # a custom event.path outside checkpoint_dir gets its own
            # tracker there, not one in checkpoint_dir pointing nowhere
            self._storage.write(
                str(step),
                os.path.join(
                    os.path.dirname(step_dir),
                    CheckpointConstant.TRACKER_FILE,
                ),
            )
            # retention must only run for steps committed under
            # checkpoint_dir: a custom event.path outside it would
            # otherwise evict the tracker's target dir
            if os.path.dirname(step_dir) == self.checkpoint_dir.rstrip(
                "/"
            ):
                self._storage.commit(step, True)
        with self._persist_lock:
            self._last_persisted_step = max(
                self._last_persisted_step, step
            )

    def _finalize_step_dir(self, step_dir: str):
        """Hook for atomic-rename savers; base saver writes in place."""

    def save_shm_to_storage(self):
        """Flush every local shard currently in shm to storage — called
        when a worker dies or the agent gets SIGTERM (reference :622)."""
        for local_rank in self.local_ranks:
            self._shm_handlers[local_rank].refresh()
            result = self._shm_handlers[local_rank].read()
            if result is None:
                continue
            meta, _ = result
            # locked read: this runs on the main/SIGTERM thread while
            # saver threads still commit; the lock is reentrant, so a
            # handler interrupting this very thread mid-hold re-enters
            # instead of self-deadlocking
            with self._persist_lock:
                last_persisted = self._last_persisted_step
            if meta.step <= last_persisted:
                continue
            event = SaveEvent(step=meta.step, storage_type="disk")
            try:
                self.save_step_checkpoint(event, local_rank)
            except Exception:  # noqa: BLE001
                logger.exception(
                    "breakpoint flush of shard %d failed", local_rank
                )

    # -- queries -----------------------------------------------------------

    @staticmethod
    def get_latest_step(checkpoint_dir: str) -> int:
        tracker = os.path.join(
            checkpoint_dir, CheckpointConstant.TRACKER_FILE
        )
        if not os.path.exists(tracker):
            return -1
        try:
            with open(tracker) as f:
                return int(f.read().strip())
        except (ValueError, OSError):
            return -1


class TempDirCheckpointSaver(AsyncCheckpointSaver):
    """Writes into a temp dir then atomically renames into place
    (reference TempDirCheckpointSaver :908). The rename happens in
    _finalize_step_dir, i.e. strictly before the tracker update."""

    def _step_dir(self, path: str, step: int) -> str:
        final = super()._step_dir(path, step)
        return final + ".tmp"

    def _finalize_step_dir(self, step_dir: str):
        if self.host_rank == 0 and step_dir.endswith(".tmp"):
            final = step_dir[: -len(".tmp")]
            if os.path.exists(step_dir) and not os.path.exists(final):
                os.replace(step_dir, final)
