"""Flash-checkpoint engines (training-process side), port of
dlrover_tpu/trainer/flash_checkpoint/engine.py.

The state is a tree of dicts, lists and tuples over ``torch.Tensor``
leaves (on the card or on the host) and numpy arrays. ``save_to_memory``
copies every leaf's bytes into the shm segment of
``agent/ckpt_saver.py`` under the shm lock, with the meta published only
after the last byte landed (two-phase); the saver persists it to storage
in the background. ``load`` restores the newest step, preferring shm over
storage, onto each target leaf's own device and dtype.

What the JAX engine does with ``copy_to_host_async`` and ``device_put``
the port does with CUDA streams and page-locked host memory:

- Save, card -> shm. The segment's mapping is registered once with the
  card's driver (``cudaHostRegister``), so it is pinned host memory: an
  event recorded on the compute stream fences a side stream, which
  copies the leaves' bytes (``non_blocking``) straight into their places
  in shm while the host leaves are copied with the native threaded
  ``scatter_copy``. No bytes are staged on the host; a save waits for
  the card's link alone.
- In-place updates. The port's step writes params and moments in place,
  where JAX's arrays are immutable. A blocking save returns after the
  copies' event completed; ``save_to_memory_async`` makes the compute
  stream wait on that event before anything it enqueues next, and
  copies host leaves before it returns. So either save stores the state
  of the step it was called on.
- Restore, shm or storage -> card. Positional reads (``os.preadv`` over
  the copy threads) of the shm segment's descriptor or of the shard file
  fill the reused pinned chunks, and ``non_blocking`` copies move them
  to the card on the side stream; the compute stream waits on the side
  stream before the first step. Reading the descriptor, not a mapping,
  spares a restarted process a page fault per 4 KiB page of a fresh
  mapping.

Leaf names, the legacy-name translation, the shm layout, the metas, the
storage fallback with ``verify_step_dir`` and the ``DLROVER_TPU_RESTORE_STEP``
consensus are the JAX engine's. A ``bfloat16`` leaf is recorded as
``"bfloat16"`` as JAX records it and moves as 16-bit words. Engines:

- ReplicatedCheckpointEngine: every host holds the full state; host 0
  writes it.
- ShardedCheckpointEngine: each host writes its own shards. A tensor is
  one shard covering the whole array, as a single-device ``jax.Array``
  is; host arrays are written by host 0. Restoring onto another layout
  waits for the sharded axes (ROADMAP Queue 1 item 7).
"""

from __future__ import annotations

import os
import pickle
import queue as _queue
import threading
import time

import numpy as np
import torch

from dlrover_tpu_torch import native as dlrtpu_native
from dlrover_tpu_torch.agent.ckpt_saver import (
    AGENT_SAVER_ENV,
    AsyncCheckpointSaver,
    CheckpointMeta,
    LeafMeta,
    SAVER_FACTORY_QUEUE,
    SaveEvent,
    SharedMemoryHandler,
    _META_LEN_SIZE,
    _VERIFIED_MARKER,
    event_queue_name,
    list_step_numbers,
    lock_name,
    persist_done_queue_name,
    read_host_shard,
    read_host_shard_meta,
    verify_step_dir,
)
from dlrover_tpu_torch.common import telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.constants import CheckpointConstant, NodeEnv
from dlrover_tpu_torch.common.ipc import SharedLock, SharedQueue
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# a restore's pinned staging: chunk size, and the ring of chunks it cycles
_CHUNK = 64 << 20
_RING = 4
# a positional read is split over the copy threads in parts of at least
# this many bytes
_READ_PART = 4 << 20


# ------------------------------------------------------------------- trees


def _flatten(tree, path, out):
    """(path, leaf) pairs in ``jax.tree_util`` order: dict keys sorted,
    sequences in order, None an empty subtree. Returns the treedef."""
    if isinstance(tree, dict):
        keys = sorted(tree)
        return ("dict", keys,
                [_flatten(tree[k], path + (("k", k),), out) for k in keys])
    if isinstance(tree, (list, tuple)):
        return (type(tree),
                [_flatten(c, path + (("i", i),), out)
                 for i, c in enumerate(tree)])
    if tree is None:
        return ("none",)
    out.append((path, tree))
    return ("leaf",)


def _unflatten(treedef, leaves):
    it = iter(leaves)

    def build(node):
        kind = node[0]
        if kind == "leaf":
            return next(it)
        if kind == "none":
            return None
        if kind == "dict":
            return {k: build(c) for k, c in zip(node[1], node[2])}
        return kind(build(c) for c in node[1])

    return build(treedef)


def _keystr(path) -> str:
    """``jax.tree_util.keystr`` of a path: ``['a'][0]``."""
    return "".join(f"[{v!r}]" if kind == "k" else f"[{v}]"
                   for kind, v in path)


def _tree_flatten_with_names(tree):
    """(names, leaves, treedef) with the JAX engine's dotted names
    ("params.w", "opt.0"), falling back to keystr names for the whole
    tree when dotted names collide (a dict key containing '.')."""
    pairs: list = []
    treedef = _flatten(tree, (), pairs)
    names = [".".join(str(v) for _, v in path) or "leaf"
             for path, _ in pairs]
    if len(set(names)) != len(names):
        names = [_keystr(path) for path, _ in pairs]
    return names, [leaf for _, leaf in pairs], treedef


_LEGACY_NAME_RE = None


def _legacy_to_dotted(name: str) -> str:
    """Translate pre-dotted keystr names ("['a']['b']", "[0]") so
    checkpoints written by older builds keep restoring. Names that are
    not entirely bracket-form are returned unchanged."""
    global _LEGACY_NAME_RE
    if _LEGACY_NAME_RE is None:
        import re

        _LEGACY_NAME_RE = re.compile(r"\[(?:'([^']*)'|(\d+))\]")
    matches = list(_LEGACY_NAME_RE.finditer(name))
    if not matches or "".join(m.group(0) for m in matches) != name:
        return name
    return ".".join(
        m.group(1) if m.group(1) is not None else m.group(2)
        for m in matches
    )


def _translate_legacy_names(paths: list[str]) -> dict[str, str]:
    """Per-checkpoint legacy-name mapping, applied only when the dotted
    forms stay collision-free: a tree whose dotted names collide is
    saved under keystr names by design, and translating those back would
    merge distinct leaves."""
    translated = {p: _legacy_to_dotted(p) for p in paths}
    if len(set(translated.values())) != len(paths):
        return {p: p for p in paths}
    return translated


# ------------------------------------------------------------------ dtypes

_TORCH_DTYPES = {
    "float32": torch.float32, "float64": torch.float64,
    "float16": torch.float16, "bfloat16": torch.bfloat16,
    "int8": torch.int8, "uint8": torch.uint8, "int16": torch.int16,
    "int32": torch.int32, "int64": torch.int64, "bool": torch.bool,
    "float8_e4m3fn": torch.float8_e4m3fn, "float8_e5m2": torch.float8_e5m2,
}
_DTYPE_NAMES = {v: k for k, v in _TORCH_DTYPES.items()}
# dtypes numpy lacks move through unsigned words of their width
_NP_STORAGE = {"bfloat16": np.uint16, "float8_e4m3fn": np.uint8,
               "float8_e5m2": np.uint8}


def _dtype_name(x) -> str:
    """The dtype string the JAX engine writes for the same logical
    dtype."""
    if isinstance(x, torch.Tensor):
        return _DTYPE_NAMES[x.dtype]
    return str(np.dtype(x.dtype))


def _np_dtype(name: str) -> np.dtype:
    return np.dtype(_NP_STORAGE.get(name, name))


def _torch_dtype(name: str) -> torch.dtype:
    if name not in _TORCH_DTYPES:
        raise ValueError(f"checkpoint dtype {name!r} has no torch dtype")
    return _TORCH_DTYPES[name]


def _as_leaf(x):
    """A tensor or a numpy array (Python and numpy scalars become 0-d
    arrays, as jax.tree_util leaves)."""
    if isinstance(x, torch.Tensor):
        return x.detach()
    return np.asarray(x)


def _nbytes(x) -> int:
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    return int(x.nbytes)


def _host_bytes(x) -> np.ndarray:
    """A flat uint8 numpy view of a host leaf's bytes (a contiguous copy
    when the leaf is not contiguous)."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().reshape(-1).view(torch.uint8).numpy()
    return np.ascontiguousarray(x).reshape(-1).view(np.uint8)


def _device_bytes(t: torch.Tensor) -> torch.Tensor:
    """A flat uint8 view of a card tensor's bytes."""
    return t.contiguous().reshape(-1).view(torch.uint8)


def _is_cuda(x) -> bool:
    return isinstance(x, torch.Tensor) and x.is_cuda


def _index_to_meta(index, ndim) -> tuple | None:
    if index is None:
        return None
    out = [(s.start, s.stop) for s in index]
    while len(out) < ndim:
        out.append((None, None))
    return tuple(out)


# ---------------------------------------------------------- pinned staging


class _PinnedStager:
    """What an engine's copies reuse: pinned host chunks of ``_CHUNK``
    bytes for restores, allocated on first use (pinning is what makes a
    ``non_blocking`` copy asynchronous, and the chunks are never
    re-pinned), the shm mapping a save writes, registered once with the
    card's driver (``cudaHostRegister``) so that copies off the card land
    in shm directly, one side stream per card, and the threads of the
    positional reads."""

    def __init__(self):
        self._slots: list[torch.Tensor] = []
        self._streams: dict = {}
        self._pool = None
        # (address, bytes, registered) of the mapping last offered
        self._mapping = None

    def pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(
                _copy_threads(), thread_name_prefix="ckpt-read")
        return self._pool

    def close(self):
        if self._pool is not None:
            self._pool.shutdown()
            self._pool = None
        self._slots = []
        self.unregister()

    def slot(self, i: int) -> torch.Tensor:
        while len(self._slots) <= i:
            self._slots.append(
                torch.empty(_CHUNK, dtype=torch.uint8, pin_memory=True))
        return self._slots[i]

    def stream(self, device: torch.device) -> torch.cuda.Stream:
        s = self._streams.get(device)
        if s is None:
            s = self._streams[device] = torch.cuda.Stream(device=device)
        return s

    def register(self, buf) -> bool:
        """Page-lock the mapping ``buf`` once; True when the driver took
        it. A refused mapping still takes the copies, synchronously
        (the driver stages them), and is not offered again."""
        view = torch.frombuffer(buf, dtype=torch.uint8)
        address, nbytes = view.data_ptr(), view.numel()
        del view
        if self._mapping is not None and self._mapping[:2] == (
                address, nbytes):
            return self._mapping[2]
        self.unregister()
        rc = torch.cuda.cudart().cudaHostRegister(address, nbytes, 0)
        ok = int(rc) == 0
        if not ok:
            logger.warning(
                "cudaHostRegister refused the checkpoint segment (%s): "
                "saves copy off the card synchronously", rc)
        self._mapping = (address, nbytes, ok)
        return ok

    @property
    def registered(self) -> bool:
        return self._mapping is not None and self._mapping[2]

    def unregister(self):
        """Before the mapping goes away (a resize, a close)."""
        if self._mapping is not None and self._mapping[2]:
            torch.cuda.cudart().cudaHostUnregister(self._mapping[0])
        self._mapping = None


def _card_of(leaves) -> torch.device | None:
    devices = {x.device for x in leaves if _is_cuda(x)}
    if len(devices) > 1:
        raise NotImplementedError(
            f"a checkpoint tree on several cards {sorted(map(str, devices))}"
            ": one process holds one card until the sharded axes are "
            "ported (ROADMAP Queue 1 item 7)")
    return devices.pop() if devices else None


def _segment_bytes(ckpt_meta) -> int:
    """The segment size ``write_meta_and_reserve`` asks for."""
    return (_META_LEN_SIZE + len(pickle.dumps(ckpt_meta))
            + ckpt_meta.total_bytes)


def _scatter(buf, parts):
    """Copy [(offset, uint8 array)] into ``buf``: the native threaded
    copy, or numpy where the library is unavailable."""
    if not parts:
        return
    if not dlrtpu_native.scatter_copy(buf, parts, nthreads=_copy_threads()):
        for off, arr in parts:
            dst = np.frombuffer(buf, dtype=np.uint8, count=arr.nbytes,
                                offset=off)
            np.copyto(dst, arr)


def _copy_threads() -> int:
    """Threads of each host copy: as many as torch's intra-op threads,
    the cores this process was given (a test that pins torch to two
    threads copies on two)."""
    return max(torch.get_num_threads(), 1)


def _publish_restore_stats(stats: dict):
    """Per-stage restore gauges (read/verify/h2d) + the checkpoint-
    bucket event for the blocking H2D leg. Publishes a given stats dict
    at most once (load() and load_from_storage() share it)."""
    if not stats or stats.get("_published"):
        return
    stats["_published"] = True
    nbytes = stats.get("bytes", 0)
    for leg, gauge in (
        ("read_s", "ckpt.restore.read_gbps"),
        ("verify_s", "ckpt.restore.verify_gbps"),
        ("h2d_s", "ckpt.restore.h2d_gbps"),
    ):
        secs = stats.get(leg, 0.0)
        if secs > 0 and nbytes:
            telemetry.gauge_set(gauge, nbytes / secs / (1 << 30))
    h2d = stats.get("h2d_s", 0.0)
    if h2d > 0:
        telemetry.event("ckpt.restore.h2d", dur=h2d, mb=nbytes / 1e6)


class CheckpointEngine:
    """Base engine: shm write path + saver notification + load paths."""

    engine_name = "replicated"

    def __init__(
        self,
        checkpoint_dir: str,
        master_client=None,
        local_rank: int = 0,
        host_rank: int = 0,
        num_hosts: int = 1,
        save_timeout: float = CheckpointConstant.SAVE_TIMEOUT,
        standalone: bool | None = None,
    ):
        self.checkpoint_dir = checkpoint_dir
        self._client = master_client
        self._local_rank = local_rank
        self._host_rank = host_rank
        self._num_hosts = num_hosts
        self._save_timeout = save_timeout
        self._shm_handler = SharedMemoryHandler(local_rank)
        self._latest_step = 0
        self._async_thread: threading.Thread | None = None
        self._stager = _PinnedStager()
        self._file_source = _FileSource(self._stager)
        # An agent hosts the saver behind the factory queue; without one
        # (plain `python train.py`) the engine runs its own in-process
        # saver so the API still works. A worker whose agent said it
        # hosts the saver (AGENT_SAVER_ENV) never falls back: a saver
        # in the worker would die with it, and its shm with no one to
        # persist it.
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", "1"))
        saver_config = dict(
            checkpoint_dir=checkpoint_dir,
            local_shard_num=max(local_world, local_rank + 1),
            host_rank=host_rank,
            num_hosts=num_hosts,
        )
        agent_saver = os.environ.get(AGENT_SAVER_ENV) == "1"
        if standalone is None:
            standalone = not SharedQueue(
                SAVER_FACTORY_QUEUE, create=False
            ).is_available()
            if standalone and agent_saver:
                raise RuntimeError(
                    f"{AGENT_SAVER_ENV} says the agent hosts the "
                    f"checkpoint saver, but its factory queue "
                    f"{SAVER_FACTORY_QUEUE!r} is not there")
        if not standalone:
            # A stale socket file from a dead agent must not brick the
            # engine: fall back to standalone if the queue is dead.
            try:
                SharedQueue(SAVER_FACTORY_QUEUE, create=False).put(
                    saver_config
                )
            except (ConnectionError, OSError):
                if agent_saver:
                    raise
                logger.warning(
                    "checkpoint factory queue is dead; running the saver "
                    "in-process"
                )
                standalone = True
        if not standalone:
            logger.info("checkpoint saver: the agent's (factory queue %s)",
                        SAVER_FACTORY_QUEUE)
        self._standalone = standalone
        if standalone:
            if AsyncCheckpointSaver.get_ckpt_saver() is None:
                AsyncCheckpointSaver._saver_instance = AsyncCheckpointSaver(
                    master_client=master_client, **saver_config
                )
                AsyncCheckpointSaver._saver_instance.start()
            self._saver = AsyncCheckpointSaver.get_ckpt_saver()
            self._event_queue = None
            self._shm_lock = self._saver._shm_locks[local_rank]
            self._done_queue = (
                self._saver._done_queues[local_rank]
                if local_rank < len(self._saver._done_queues)
                else None
            )
        else:
            self._saver = None
            # wait for the agent to create lock/event queues
            deadline = time.time() + 60
            while time.time() < deadline:
                if SharedQueue(
                    event_queue_name(local_rank), create=False
                ).is_available():
                    break
                time.sleep(0.2)
            self._event_queue = SharedQueue(
                event_queue_name(local_rank), create=False
            )
            self._shm_lock = SharedLock(
                lock_name(local_rank), create=False
            )
            self._done_queue = SharedQueue(
                persist_done_queue_name(local_rank), create=False
            )
        # the last save/restore's per-leg breakdown
        self.last_save_stats: dict = {}
        self.last_restore_stats: dict = {}

    # ------------------------------------------------------------- barrier

    def _all_hosts_ready(self, step: int) -> bool:
        """Host-side readiness barrier via the master. Bails out early if
        any peer reported a skip for this step."""
        if self._client is None or self._num_hosts <= 1:
            return True
        self._client.report_ckpt_ready(step, "save", self._num_hosts)
        deadline = time.time() + self._save_timeout
        while time.time() < deadline:
            passed, aborted = self._client.check_ckpt_barrier(
                step, "save", self._num_hosts
            )
            if passed:
                return True
            if aborted:
                logger.warning(
                    "peer skipped ckpt save at step %s; aborting barrier",
                    step,
                )
                return False
            time.sleep(0.1)
        return False

    def _report_skip(self, step: int):
        if self._client is not None and self._num_hosts > 1:
            try:
                self._client.report_ckpt_skip(step, "save")
            except Exception:  # noqa: BLE001 - best effort
                logger.warning("could not report ckpt skip for %s", step)

    # ---------------------------------------------------------- save paths

    def _select_shards(self, arr):
        """Which shards of this leaf this host must write. Overridden
        per engine."""
        raise NotImplementedError

    def _plan(self, step: int, state_dict):
        """Metas and the bytes behind them: (CheckpointMeta, card pieces
        [(uint8 view, offset, nbytes)], host parts [(offset, uint8
        array)], card). Shapes alone fix the metas."""
        names, leaves, _treedef = _tree_flatten_with_names(state_dict)
        leaves = [_as_leaf(x) for x in leaves]
        card = _card_of(leaves)
        metas: list[LeafMeta] = []
        card_pieces: list = []
        host_parts: list = []
        offset = 0
        for name, leaf in zip(names, leaves):
            for index, data in self._select_shards(leaf):
                shape = tuple(int(s) for s in data.shape)
                nbytes = _nbytes(data)
                metas.append(LeafMeta(
                    path=name,
                    dtype=_dtype_name(data),
                    shape=shape,
                    offset=offset,
                    nbytes=nbytes,
                    global_shape=tuple(int(s) for s in leaf.shape),
                    index=_index_to_meta(index, len(shape)),
                ))
                if nbytes:
                    if _is_cuda(data):
                        card_pieces.append(
                            (_device_bytes(data), offset, nbytes))
                    else:
                        host_parts.append((offset, _host_bytes(data)))
                offset += nbytes
        ckpt_meta = CheckpointMeta(
            step=step,
            leaves=metas,
            treedef=b"",
            engine=self.engine_name,
            host_rank=self._host_rank,
            num_hosts=self._num_hosts,
            total_bytes=offset,
        )
        return ckpt_meta, card_pieces, host_parts, card

    def _write_shm_locked(self, step: int, state_dict, staged=None) -> int:
        """Copy the selected shards into shm. Caller holds the shm lock.
        Returns total bytes written.

        The meta stays unpublished (readers see "empty") until every
        byte landed: this waits on the card's copies that ``_stage``
        issued (``staged``: an async save's) before publishing.
        """
        if staged is None:
            staged = self._stage(step, state_dict)
        ckpt_meta, done, fill_s, card_bytes, _card = staged
        t0 = time.perf_counter()
        if done is not None:
            done.synchronize()
        materialize_s = time.perf_counter() - t0
        self._shm_handler.publish_meta()
        self._latest_step = step
        offset = ckpt_meta.total_bytes
        self.last_save_stats = {
            "bytes": offset,
            # of which came off the card straight into the segment
            "card_bytes": card_bytes,
            "registered": bool(card_bytes) and self._stager.registered,
            "materialize_s": materialize_s,
            "fill_s": fill_s,
        }
        if materialize_s + fill_s > 0:
            telemetry.gauge_set(
                "ckpt.save.fill_gbps",
                offset / (materialize_s + fill_s) / (1 << 30),
            )
        return offset

    def _stage(self, step: int, state_dict):
        """Plan the save, reserve its bytes in shm with the meta
        unpublished, and issue every card->shm copy on the side stream
        behind the compute stream's work so far; the host leaves are
        copied meanwhile (the fill leg). The segment's mapping is
        registered with the card's driver, so the copies are DMA into
        shm and a blocking save waits for the link alone. Returns (meta,
        the copies' event or None, fill seconds, card bytes, card)."""
        ckpt_meta, card_pieces, host_parts, card = self._plan(
            step, state_dict)
        shm = self._shm_handler.shm
        if shm is not None and shm.size < _segment_bytes(ckpt_meta):
            # the handler re-creates a grown segment: release the old
            # mapping's registration before it is unmapped
            self._stager.unregister()
        buf = self._shm_handler.write_meta_and_reserve(
            ckpt_meta, publish=False
        )
        done = None
        card_bytes = sum(n for _src, _off, n in card_pieces)
        if card_pieces:
            self._stager.register(self._shm_handler.shm.buf)
            dst = torch.frombuffer(buf, dtype=torch.uint8)
            stream = self._stager.stream(card)
            start = torch.cuda.Event()
            start.record(torch.cuda.current_stream(card))
            stream.wait_event(start)
            with torch.cuda.stream(stream):
                for src, off, n in card_pieces:
                    dst[off:off + n].copy_(src, non_blocking=True)
                done = torch.cuda.Event()
                done.record(stream)
            del dst
        t0 = time.perf_counter()
        _scatter(buf, host_parts)
        return (ckpt_meta, done, time.perf_counter() - t0, card_bytes,
                card)

    def save_to_memory(self, step: int, state_dict) -> bool:
        """Write the state into shm; ~the only blocking time the training
        loop sees. Returns False if skipped (saver busy)."""
        with tracing.span("ckpt.save.shm", step=step):
            return self._save_to_memory_traced(step, state_dict)

    def _save_to_memory_traced(self, step: int, state_dict) -> bool:
        start = time.time()
        if not self._shm_lock.acquire(blocking=False):
            logger.warning(
                "skip shm save at step %s: previous persist in flight", step
            )
            self._report_skip(step)
            return False
        try:
            if not self._all_hosts_ready(step):
                logger.warning("ckpt readiness barrier failed at %s", step)
                return False
            offset = self._write_shm_locked(step, state_dict)
        finally:
            self._shm_lock.release()
        self._notify(SaveEvent(step=step, storage_type="memory"))
        elapsed = time.time() - start
        try:
            from dlrover_tpu_torch.trainer.timer import Tag, get_step_timer

            get_step_timer().record(
                Tag.CKPT_SHM, int(start * 1e9), int(elapsed * 1e9)
            )
        except Exception:  # noqa: BLE001 - timing must never break saves
            pass
        logger.info(
            "saved step %s to shm in %.3fs (%.1f MB)",
            step,
            elapsed,
            offset / 1e6,
        )
        # goodput: the trainer blocks for exactly this window. Emitted
        # BEFORE the chaos site so a kill-after-save leaves the save on
        # the timeline ahead of the fire.
        telemetry.event(
            "ckpt.save", step=step, dur=elapsed, mb=offset / 1e6
        )
        telemetry.observe("ckpt.save.seconds", elapsed)
        # fault site AFTER the shm save committed: a kill here is the
        # canonical "worker dies right after checkpointing step N"
        chaos_point("ckpt.save", step=step)
        return True

    def save_to_memory_async(
        self, step: int, state_dict, storage_path: str | None = None
    ) -> bool:
        """Non-blocking save: issue every card->shm copy on the side
        stream, make the compute stream wait on them, and hand the wait
        and the meta's publish to a copier thread; the training loop
        pays the dispatch and the host leaves' copy.

        The caller may update the state in place right away: the
        compute stream cannot run past the copies, and host leaves were
        copied into shm before this returns.
        """
        if self._async_thread is not None and self._async_thread.is_alive():
            logger.warning("skip async save %s: previous still running", step)
            self._report_skip(step)
            return False
        if not self._shm_lock.acquire(blocking=False):
            logger.warning("skip async save %s: shm lock busy", step)
            self._report_skip(step)
            return False
        try:
            if not self._all_hosts_ready(step):
                logger.warning("ckpt readiness barrier failed at %s", step)
                self._shm_lock.release()
                return False
            staged = self._stage(step, state_dict)
            done, card = staged[1], staged[4]
            if done is not None:
                torch.cuda.current_stream(card).wait_event(done)
        except BaseException:
            self._shm_lock.release()
            raise

        def _finish():
            start = time.time()
            try:
                offset = self._write_shm_locked(step, None, staged=staged)
            finally:
                self._shm_lock.release()
            self._notify(SaveEvent(step=step, storage_type="memory"))
            if storage_path is not None:
                self._notify(
                    SaveEvent(
                        step=step, path=storage_path, storage_type="disk"
                    )
                )
            logger.info(
                "async-saved step %s to shm in %.3fs (%.1f MB)",
                step, time.time() - start, offset / 1e6,
            )

        self._async_thread = threading.Thread(
            target=_finish, name=f"ckpt-shm-copier-{step}", daemon=True
        )
        self._async_thread.start()
        return True

    def wait_for_shm_save(self, timeout: float | None = None) -> bool:
        """Join the in-flight async shm write (flush before restart)."""
        t = self._async_thread
        if t is None:
            return True
        t.join(timeout)
        return not t.is_alive()

    def save_to_storage(self, step: int, state_dict, path: str = "") -> bool:
        """Shm write (blocking) + async persistence in the saver."""
        with tracing.span("ckpt.save", step=step, persist=True):
            if not self.save_to_memory(step, state_dict):
                return False
            self._notify(
                SaveEvent(step=step, path=path, storage_type="disk")
            )
            return True

    def _notify(self, event: SaveEvent):
        if self._event_queue is not None:
            self._event_queue.put(event)
        elif self._saver is not None and event.storage_type == "disk":
            self._saver._event_queues[self._local_rank].put(event)

    def _tracker_at_least(self, step: int) -> bool:
        tracker = os.path.join(
            self.checkpoint_dir, CheckpointConstant.TRACKER_FILE
        )
        if not os.path.exists(tracker):
            return False
        try:
            with open(tracker) as f:
                return int(f.read().strip()) >= step
        except (ValueError, OSError):
            return False

    def wait_for_persist(self, step: int, timeout: float = 300) -> bool:
        """Block until the saver persisted ``step``: wakes on the saver's
        persist-done queue, re-checks the tracker file (the source of
        truth) on every wakeup, with the deadline as the backstop."""
        deadline = time.time() + timeout
        while True:
            if self._tracker_at_least(step):
                return True
            remaining = deadline - time.time()
            if remaining <= 0:
                return False
            self.wait_for_persist_progress(min(remaining, 2.0))

    def wait_for_persist_progress(self, timeout: float) -> bool:
        """Block until the saver signals ANY persist completed (or
        ``timeout``). Returns True on a wakeup hint — callers re-check
        their own condition either way. Degrades to a short sleep when
        the done queue is unavailable."""
        q = self._done_queue
        if q is not None:
            try:
                if q.is_available() or self._standalone:
                    q.get(timeout=max(timeout, 0.0))
                    return True
            except _queue.Empty:
                return False
            except Exception:  # noqa: BLE001 - dead queue: poll instead
                pass
        time.sleep(min(max(timeout, 0.0), 0.05))
        return False

    # ---------------------------------------------------------- load paths

    def load(self, path: str = "", target=None, zero_copy: bool = False):
        """Restore, preferring shm (survives worker restarts within the
        host) and falling back to storage.

        With a ``target`` tree, returns ``(tree, step)``: each leaf comes
        back on the target leaf's device with its dtype (a mismatch of
        shape or dtype raises). Without one, returns ``{"step", "state":
        {name: CPU tensor}}``; ``zero_copy=True`` makes those tensors
        views of the shm segment (no copy; a later save rewrites them,
        and they must never be written or passed back into a save).

        When the master brokered a restore-step consensus
        (``DLROVER_TPU_RESTORE_STEP``), shm is used only if it holds
        exactly that step, and storage candidates are capped at it."""
        with tracing.span("ckpt.restore.load"):
            return self._load_traced(path, target, zero_copy)

    def _load_traced(
        self, path: str = "", target=None, zero_copy: bool = False
    ):
        t0 = time.monotonic()
        # an async save still draining owns the pinned chunks
        self.wait_for_shm_save()
        self.last_restore_stats = {}
        consensus = self._consensus_restore_step()
        use_shm = True
        if consensus is not None:
            shm_step = self._shm_handler.get_checkpoint_step()
            use_shm = shm_step == consensus
            if shm_step > consensus:
                telemetry.event(
                    "ckpt.consensus.forced",
                    step=consensus,
                    local_newest=shm_step,
                    source_kind="shm",
                )
                logger.warning(
                    "consensus restore step %d overrides newer local "
                    "shm checkpoint (step %d)", consensus, shm_step,
                )
        if use_shm:
            result = self._load_from_memory(target, zero_copy=zero_copy)
            if result is not None:
                self._record_restore(result, "shm", t0, consensus)
                return result
        result = self.load_from_storage(
            path, target, max_step=consensus
        )
        if consensus is not None and not path:
            # a quiet restore of anything OLDER than the consensus would
            # resume this host at a different step than its peers: fail
            # loudly, and drop the step's verify cache so the next
            # rendezvous re-checks it instead of advertising it again
            got = self._result_step(result)
            if got != consensus:
                marker = os.path.join(
                    self.checkpoint_dir,
                    f"{CheckpointConstant.STEP_DIR_PREFIX}{consensus}",
                    _VERIFIED_MARKER,
                )
                try:
                    os.remove(marker)
                except OSError:
                    pass
                raise ValueError(
                    f"consensus restore step {consensus} is not "
                    f"restorable on this host (newest loadable: "
                    f"{got if got >= 0 else 'none'}) — refusing to "
                    f"silently resume at a different step than the "
                    f"rest of the job"
                )
        if result is not None:
            self._record_restore(result, "storage", t0, consensus)
        return result

    @staticmethod
    def _result_step(result) -> int:
        if result is None:
            return -1
        if isinstance(result, tuple):
            return int(result[1])
        return int(result.get("step", -1))

    @staticmethod
    def _consensus_restore_step() -> int | None:
        """Master-brokered min verified step (env, set by the agent per
        rendezvous round); None = unconstrained local restore."""
        raw = os.environ.get(NodeEnv.RESTORE_STEP, "")
        if not raw:
            return None
        try:
            step = int(raw)
        except ValueError:
            logger.warning(
                "ignoring malformed %s=%r", NodeEnv.RESTORE_STEP, raw
            )
            return None
        return step if step >= 0 else None

    def _record_restore(self, result, source_kind: str, t0: float,
                        consensus):
        fields = dict(
            step=self._result_step(result),
            source_kind=source_kind,
            dur=time.monotonic() - t0,
        )
        if consensus is not None:
            fields["consensus"] = consensus
        telemetry.event("ckpt.restore", **fields)
        telemetry.observe("ckpt.restore.seconds", fields["dur"])
        _publish_restore_stats(self.last_restore_stats)

    def _load_from_memory(self, target=None, zero_copy: bool = False):
        with tracing.span("ckpt.restore.shm"):
            return self._load_from_memory_traced(target, zero_copy)

    def _load_from_memory_traced(
        self, target=None, zero_copy: bool = False
    ):
        result = self._shm_handler.read()
        if result is None:
            return None
        meta, buf = result
        # copies out of shm read the segment through its descriptor: a
        # restarted process's fresh mapping would take a page fault per
        # 4 KiB page inside the copies
        shm = self._shm_handler.shm
        data_start = 8 + int.from_bytes(bytes(shm.buf[:8]), "little")
        # meta.leaves holds one entry per *shard*: the collision check
        # must see unique paths only
        names = _translate_legacy_names(
            sorted({l.path for l in meta.leaves})
        )
        piece_map: dict[str, list] = {}
        for leaf in meta.leaves:
            piece_map.setdefault(names[leaf.path], []).append(
                (leaf, shm._fd, data_start)
            )
        if target is not None:
            # an incomplete shm image (another host wrote some leaves)
            # falls back to storage rather than keeping fresh leaves
            tnames, _, _ = _tree_flatten_with_names(target)
            if any(name not in piece_map for name in tnames):
                logger.info(
                    "shm checkpoint incomplete for this host; falling "
                    "back to storage"
                )
                return None
        if not _covers_global(piece_map):
            logger.info(
                "shm shards do not cover the global arrays (multi-host "
                "state); falling back to storage"
            )
            return None
        if target is not None:
            result = self._fill_from_pieces(
                piece_map, target, meta.step, self._file_source
            )
            logger.info("restored step %s from shared memory", meta.step)
            return result
        t0 = time.perf_counter()
        state = {}
        nbytes = 0
        for name, pieces in piece_map.items():
            if zero_copy and _single_piece(pieces):
                leaf = pieces[0][0]
                raw = torch.frombuffer(
                    buf, dtype=torch.uint8, count=leaf.nbytes,
                    offset=leaf.offset,
                ) if leaf.nbytes else torch.empty(0, dtype=torch.uint8)
                state[name] = _typed(raw, leaf.dtype, leaf.shape)
            else:
                state[name] = _host_leaf(pieces, self._file_source)
            nbytes += _leaf_nbytes(pieces[0][0])
        stats = self.last_restore_stats
        if not zero_copy:
            stats["read_s"] = stats.get("read_s", 0.0) + (
                time.perf_counter() - t0
            )
            stats["bytes"] = stats.get("bytes", 0) + nbytes
        logger.info("restored step %s from shared memory", meta.step)
        return {"step": meta.step, "state": state}

    def load_from_storage(
        self, path: str = "", target=None, max_step: int | None = None,
    ):
        """Restore from storage with VERIFIED fallback.

        Candidate step dirs are tried newest-first; each must pass
        :func:`verify_step_dir` before a byte is deserialized, so a torn
        or bit-flipped newest checkpoint falls back to the newest
        complete, verified step. An explicit ``path`` is verified too,
        and a named-but-corrupt checkpoint RAISES (a named path that
        does not exist returns None, loudly logged). The eager
        (targetless) loader re-checks every payload's embedded crc, so
        it gets the size verify; the targeted loader reads byte ranges
        without one, so its candidates get the deep payload-crc verify.
        """
        with tracing.span("ckpt.restore.storage"):
            return self._load_from_storage_traced(path, target, max_step)

    def _load_from_storage_traced(
        self, path: str = "", target=None, max_step: int | None = None,
    ):
        candidates = [path] if path else self._candidate_step_dirs()
        self.last_restore_stats = {}
        if not path and max_step is not None:
            # consensus cap: steps newer than the job-wide agreed
            # restore step are off-limits
            kept, skipped_steps = [], []
            prefix = CheckpointConstant.STEP_DIR_PREFIX
            for step_dir in candidates:
                try:
                    step = int(os.path.basename(step_dir)[len(prefix):])
                except ValueError:
                    step = -1
                if step > max_step:
                    skipped_steps.append(step)
                else:
                    kept.append(step_dir)
            if skipped_steps:
                telemetry.event(
                    "ckpt.consensus.forced",
                    step=max_step,
                    local_newest=max(skipped_steps),
                    source_kind="storage",
                )
                logger.warning(
                    "consensus restore step %d skips newer local "
                    "storage steps %s", max_step, sorted(skipped_steps),
                )
            candidates = kept
        for step_dir in candidates:
            if not step_dir or not os.path.isdir(step_dir):
                if path:
                    logger.warning(
                        "explicitly named checkpoint path %s does not "
                        "exist; treating as no checkpoint", path,
                    )
                continue
            t_verify = time.perf_counter()
            ok, reason = verify_step_dir(
                step_dir, deep=target is not None
            )
            verify_s = time.perf_counter() - t_verify
            if not ok:
                if path:
                    raise ValueError(
                        f"checkpoint at {step_dir} failed integrity "
                        f"verification ({reason}) — refusing to load "
                        f"an explicitly named torn/corrupt checkpoint"
                    )
                telemetry.event(
                    "ckpt.fallback",
                    dir=os.path.basename(step_dir),
                    reason=reason[:200],
                )
                telemetry.counter_inc("ckpt.fallbacks")
                logger.warning(
                    "checkpoint %s failed integrity verification (%s); "
                    "falling back to an older checkpoint",
                    step_dir, reason,
                )
                continue
            self.last_restore_stats = {"verify_s": verify_s}
            result = self._load_step_dir(step_dir, target)
            if result is not None:
                _publish_restore_stats(self.last_restore_stats)
                return result
            if path:
                raise ValueError(
                    f"checkpoint at {step_dir} is incomplete or failed "
                    f"its payload checks — refusing to substitute "
                    f"anything for an explicitly named checkpoint"
                )
            telemetry.event(
                "ckpt.fallback",
                dir=os.path.basename(step_dir),
                reason="incomplete",
            )
            telemetry.counter_inc("ckpt.fallbacks")
            logger.warning(
                "checkpoint %s is incomplete; falling back to an older "
                "checkpoint", step_dir,
            )
        return None

    def _candidate_step_dirs(self) -> list[str]:
        """All persisted step dirs, newest first. The tracker's step is
        just the first candidate — a tracker advertising a step whose
        dir fails verification must not brick the restore."""
        prefix = CheckpointConstant.STEP_DIR_PREFIX
        steps = set(list_step_numbers(self.checkpoint_dir))
        tracker_step = AsyncCheckpointSaver.get_latest_step(
            self.checkpoint_dir
        )
        if tracker_step >= 0:
            steps.add(tracker_step)
        return [
            os.path.join(self.checkpoint_dir, f"{prefix}{s}")
            for s in sorted(steps, reverse=True)
        ]

    def _load_step_dir(self, step_dir: str, target=None):
        """Deserialize ONE verified step directory: with a ``target``,
        leaf by leaf from byte ranges of the shard files; without one,
        every shard file is read whole with its payload crc checked as
        the chunks land."""
        if target is not None:
            return self._load_storage_targeted(step_dir, target)
        fnames = [
            f for f in sorted(os.listdir(step_dir))
            if f.endswith(".dlck")
        ]
        stats = self.last_restore_stats
        entries: list = []
        step = -1
        for fname in fnames:
            result = read_host_shard(
                os.path.join(step_dir, fname), stats=stats
            )
            if result is None:
                continue
            meta, data = result
            step = max(step, meta.step)
            for leaf in meta.leaves:
                entries.append((leaf, data, None))
        if not entries:
            return None
        names = _translate_legacy_names(
            sorted({leaf.path for leaf, _, _ in entries})
        )
        piece_map: dict[str, list] = {}
        for piece in entries:
            piece_map.setdefault(names[piece[0].path], []).append(piece)
        if not _covers_global(piece_map):
            logger.warning(
                "checkpoint at %s is missing shards; refusing a partial "
                "restore", step_dir,
            )
            return None
        state = {name: _host_leaf(pieces, _BUFFER_SOURCE)
                 for name, pieces in piece_map.items()}
        logger.info("restored step %s from %s", step, step_dir)
        return {"step": step, "state": state}

    def _load_storage_targeted(self, step_dir: str, target):
        """Meta-only scan + per-leaf byte-range reads."""
        pieces_by_path: list = []
        step = -1
        for fname in sorted(os.listdir(step_dir)):
            if not fname.endswith(".dlck"):
                continue
            fpath = os.path.join(step_dir, fname)
            result = read_host_shard_meta(fpath)
            if result is None:
                continue
            meta, payload_start = result
            step = max(step, meta.step)
            for leaf in meta.leaves:
                pieces_by_path.append((leaf, fpath, payload_start))
        if not pieces_by_path:
            return None
        names = _translate_legacy_names(
            sorted({leaf.path for leaf, _, _ in pieces_by_path})
        )
        piece_map: dict[str, list] = {}
        for piece in pieces_by_path:
            piece_map.setdefault(names[piece[0].path], []).append(piece)
        if not _covers_global(piece_map):
            logger.warning(
                "checkpoint at %s is missing shards; refusing a partial "
                "restore", step_dir,
            )
            return None
        tnames, _, _ = _tree_flatten_with_names(target)
        missing = [n for n in tnames if n not in piece_map]
        if missing:
            raise ValueError(
                f"checkpoint at {step_dir} is missing "
                f"{len(missing)} target leaves (e.g. {missing[:3]}) "
                f"— refusing a partial restore of a changed model"
            )
        result = self._fill_from_pieces(piece_map, target, step,
                                        self._file_source)
        logger.info("restored step %s from %s", step, step_dir)
        return result

    def _fill_from_pieces(self, piece_map, target, step, source):
        """Rebuild the target tree from saved pieces, each leaf on its
        target's device with its dtype. Card leaves stream through the
        pinned chunks: chunk c is read into its slot (``source``: shm or
        a shard file) while chunks before it are still crossing to the
        card on the side stream; the compute stream waits on the side
        stream before anything it runs next. Host leaves are read
        straight into fresh arrays, so no restored leaf aliases shm."""
        tnames, tleaves, treedef = _tree_flatten_with_names(target)
        new_leaves: list = [None] * len(tnames)
        card = _card_of([_as_leaf(x) for x in tleaves])
        stream = self._stager.stream(card) if card is not None else None
        slot_events: list = [None] * _RING
        chunk_count = 0
        read_s = 0.0
        nbytes_total = 0
        t_all = time.perf_counter()
        for i, (name, leaf_t) in enumerate(zip(tnames, tleaves)):
            leaf_t = _as_leaf(leaf_t)
            pieces = piece_map[name]
            meta0 = pieces[0][0]
            want_shape = tuple(int(s) for s in leaf_t.shape)
            got_shape = tuple(
                meta0.global_shape if meta0.index is not None
                else meta0.shape
            )
            if want_shape and got_shape != want_shape:
                raise ValueError(
                    f"checkpoint leaf {name} has shape {got_shape}, "
                    f"target expects {want_shape} — refusing a silent "
                    f"mismatched restore (stale or foreign checkpoint?)"
                )
            want_dtype = _dtype_name(leaf_t)
            if meta0.dtype != want_dtype:
                raise ValueError(
                    f"checkpoint leaf {name} has dtype {meta0.dtype}, "
                    f"target expects {want_dtype} — refusing a silent "
                    f"mismatched-dtype restore"
                )
            nbytes = _leaf_nbytes(meta0)
            nbytes_total += nbytes
            if not _single_piece(pieces):
                # pieces of a sharded save: assemble on the host first
                t0 = time.perf_counter()
                host = _host_leaf(pieces, source)
                read_s += time.perf_counter() - t0
                new_leaves[i] = _to_target(host, leaf_t)
                continue
            if not _is_cuda(leaf_t):
                t0 = time.perf_counter()
                new_leaves[i] = _host_leaf(pieces, source, like=leaf_t)
                read_s += time.perf_counter() - t0
                continue
            dst = torch.empty(want_shape, dtype=leaf_t.dtype,
                              device=leaf_t.device)
            dst_u8 = dst.reshape(-1).view(torch.uint8)
            meta, src1, src2 = pieces[0]
            pos = 0
            while pos < nbytes:
                n = min(_CHUNK, nbytes - pos)
                k = chunk_count % _RING
                slot = self._stager.slot(k)
                if slot_events[k] is not None:
                    slot_events[k].synchronize()
                t0 = time.perf_counter()
                source.read(src1, src2, meta, pos, slot.numpy()[:n])
                read_s += time.perf_counter() - t0
                with torch.cuda.stream(stream):
                    dst_u8[pos:pos + n].copy_(slot[:n], non_blocking=True)
                    ev = torch.cuda.Event()
                    ev.record(stream)
                slot_events[k] = ev
                chunk_count += 1
                pos += n
            # dst was allocated on the compute stream and is written on
            # the side stream
            dst.record_stream(stream)
            new_leaves[i] = dst
        t_h2d = time.perf_counter()
        if stream is not None:
            torch.cuda.current_stream(card).wait_stream(stream)
            stream.synchronize()
        stats = self.last_restore_stats
        h2d_s = time.perf_counter() - t_h2d
        stats["h2d_s"] = stats.get("h2d_s", 0.0) + h2d_s
        stats["read_s"] = stats.get("read_s", 0.0) + read_s
        stats["bytes"] = stats.get("bytes", 0) + nbytes_total
        stats["total_s"] = stats.get("total_s", 0.0) + (
            time.perf_counter() - t_all)
        return _unflatten(treedef, new_leaves), step

    def latest_step(self) -> int:
        shm_step = self._shm_handler.get_checkpoint_step()
        disk_step = AsyncCheckpointSaver.get_latest_step(self.checkpoint_dir)
        return max(shm_step, disk_step)

    def close(self):
        self.wait_for_shm_save()
        # unregister the mapping before it is unmapped
        self._stager.close()
        self._shm_handler.close()


# --------------------------------------------------------------- sources


class _BufferSource:
    """Bytes of a piece in memory (a shard file read whole): ``src1`` is
    the buffer."""

    @staticmethod
    def read(buf, _unused, meta, start, dst_u8):
        if not dst_u8.nbytes:
            return
        parts = [(meta.offset + start, dst_u8)]
        if not dlrtpu_native.gather_copy(
                buf, parts, nthreads=_copy_threads()):
            np.copyto(dst_u8, np.frombuffer(
                buf, np.uint8, count=dst_u8.nbytes,
                offset=meta.offset + start))


def _pread(fd: int, pos: int, dst_u8: np.ndarray, what: str, stager):
    """Fill ``dst_u8`` from ``fd`` at ``pos``, in parts over the copy
    threads (``os.preadv`` releases the GIL)."""
    view = memoryview(dst_u8)

    def part(a, b):
        while a < b:
            got = os.preadv(fd, [view[a:b]], pos + a)
            if got <= 0:
                raise ValueError(f"short read at {pos + a} for {what}")
            a += got

    n = len(view)
    step = max(_READ_PART, -(-n // _copy_threads()))
    if n <= step:
        part(0, n)
        return
    for fut in [stager.pool().submit(part, a, min(a + step, n))
                for a in range(0, n, step)]:
        fut.result()


class _FileSource:
    """Bytes of a piece in a file: ``src1`` is a shard file's path or
    the shm segment's descriptor, ``src2`` the payload's offset in it;
    read over the threads of ``stager``."""

    def __init__(self, stager):
        self._stager = stager

    def read(self, file, payload_start, meta, start, dst_u8):
        if not dst_u8.nbytes:
            return
        pos = payload_start + meta.offset + start
        if isinstance(file, int):
            _pread(file, pos, dst_u8, meta.path, self._stager)
            return
        fd = os.open(file, os.O_RDONLY)
        try:
            _pread(fd, pos, dst_u8, f"{meta.path} in {file}", self._stager)
        finally:
            os.close(fd)


_BUFFER_SOURCE = _BufferSource()


def _count(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


def _leaf_nbytes(meta) -> int:
    shape = meta.global_shape if meta.index is not None else meta.shape
    return _count(shape) * _np_dtype(meta.dtype).itemsize


def _single_piece(pieces) -> bool:
    meta0 = pieces[0][0]
    return len(pieces) == 1 and (
        meta0.index is None
        or tuple(meta0.shape) == tuple(meta0.global_shape)
    )


def _covers_global(leaf_map) -> bool:
    """Every leaf's pieces must tile its full global shape (pieces are
    non-overlapping unique shards, so volumes may be summed)."""
    for _name, pieces in leaf_map.items():
        meta0 = pieces[0][0]
        if meta0.index is None or tuple(meta0.shape) == tuple(
            meta0.global_shape
        ):
            continue
        total = _count(meta0.global_shape)
        have = sum(_count(p[0].shape) for p in pieces)
        if have < total:
            return False
    return True


def _piece_slices(meta: "LeafMeta"):
    """Global-coordinate region a saved piece covers. Index bounds may
    be None on unsharded dims (a full-extent slice): normalise against
    the piece's local shape."""
    if meta.index is not None:
        out = []
        for (a, b), dim in zip(meta.index, meta.shape):
            start = 0 if a is None else int(a)
            stop = start + int(dim) if b is None else int(b)
            out.append(slice(start, stop))
        return tuple(out)
    return tuple(slice(0, int(s)) for s in meta.shape)


def _typed(raw_u8: torch.Tensor, dtype_name: str, shape) -> torch.Tensor:
    """A flat uint8 tensor of a leaf's bytes as its dtype and shape."""
    return raw_u8.view(_torch_dtype(dtype_name)).reshape(tuple(shape))


def _host_leaf(pieces, source, like=None):
    """One leaf assembled on the host from its pieces, as a fresh CPU
    tensor (or a numpy array when ``like`` is one)."""
    meta0 = pieces[0][0]
    gshape = tuple(
        meta0.global_shape if meta0.index is not None else meta0.shape)
    full = np.empty(gshape, dtype=_np_dtype(meta0.dtype))
    if _single_piece(pieces):
        meta, s1, s2 = pieces[0]
        source.read(s1, s2, meta, 0, full.reshape(-1).view(np.uint8))
    else:
        for meta, s1, s2 in pieces:
            part = np.empty(tuple(meta.shape), dtype=full.dtype)
            source.read(s1, s2, meta, 0, part.reshape(-1).view(np.uint8))
            full[_piece_slices(meta)] = part
    if isinstance(like, np.ndarray):
        return full
    return _typed(torch.from_numpy(full.reshape(-1).view(np.uint8)),
                  meta0.dtype, gshape)


def _to_target(host, leaf_t):
    """A host-assembled leaf moved to the target's device."""
    if isinstance(leaf_t, np.ndarray):
        return host if isinstance(host, np.ndarray) else host.numpy()
    if isinstance(host, np.ndarray):
        host = torch.from_numpy(host)
    return host.to(leaf_t.device)


class ReplicatedCheckpointEngine(CheckpointEngine):
    """Pure-DP states: all hosts identical; host 0 writes everything."""

    engine_name = "replicated"

    def _select_shards(self, arr):
        if self._host_rank != 0:
            return []
        return [(None, arr)]

    def save_to_memory(self, step: int, state_dict) -> bool:
        if self._host_rank != 0:
            # non-zero hosts only take part in the readiness barrier
            return self._all_hosts_ready(step)
        return super().save_to_memory(step, state_dict)

    def save_to_memory_async(
        self, step: int, state_dict, storage_path: str | None = None
    ) -> bool:
        if self._host_rank != 0:
            # no shards to write here: joining the barrier is the whole
            # job — persisting empty shards would corrupt host 0's
            # commit count
            return self._all_hosts_ready(step)
        return super().save_to_memory_async(step, state_dict, storage_path)


class ShardedCheckpointEngine(CheckpointEngine):
    """Each host writes its own shards. In one process a tensor is one
    shard covering the whole array (the index a single-device jax.Array
    reports); host arrays are written by host 0."""

    engine_name = "sharded"

    def _select_shards(self, arr):
        if not isinstance(arr, torch.Tensor):
            return [(None, arr)] if self._host_rank == 0 else []
        return [(tuple(slice(None) for _ in arr.shape), arr)]
