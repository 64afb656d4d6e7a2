"""Durable master control-plane state: snapshots + a write-ahead log.

Equivalent capability: resilient-training coordinators treat their own
loss as a recoverable event (Oobleck SOSP'23 keeps pipeline templates on
durable storage; TorchElastic agents outlive a restarted rendezvous
backend). Our master held everything in memory — rendezvous round and
membership, dataset shard progress (including in-flight doing tasks),
checkpoint-barrier agreement, the workers' kv-store, merged telemetry —
so a master crash ended the job even though every *other* component
already rides through faults. This module closes that last single point
of failure.

Two persistence tiers, chosen by what each piece of state can tolerate:

- **Write-ahead log** (``master_wal.jsonl``) for shard accounting and
  the kv-store: one JSON line appended *after* the in-memory mutation
  and flushed *before* the RPC ack, so a completion the worker saw
  acked can never be lost (exactly-once accounting), and a completion
  the master lost was never acked (the worker retries). WAL records
  carry absolute state (resulting counter values, task ids + ranges),
  so replay is idempotent — over-replaying the tail around a snapshot
  boundary is safe by construction.
- **Coalesced snapshots** (``master_state.json``) for everything whose
  loss only costs a re-report or a re-form: rendezvous params / round /
  membership / verified-step sets / consensus restore step, checkpoint
  barrier agreement, sync barriers, run configs, merged telemetry.
  State-mutating servicer calls mark the store dirty; a background
  thread coalesces bursts and writes atomically (tmp + rename) off the
  RPC hot path.

Restore = load snapshot, apply it to the live components, then replay
every WAL record with ``seq`` greater than the snapshot's high-water
mark. The WAL seq is captured *before* the snapshot collects component
state, so a record at or below the mark is guaranteed reflected in the
snapshot (mutations happen before their WAL append), and records above
it may be double-covered — which idempotent replay absorbs.

The PyTorch port's copy of dlrover_tpu/master/state_store.py.
"""

from __future__ import annotations

import base64
import json
import os
import threading
import time

from dlrover_tpu_torch.common import telemetry, tracing
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

SNAPSHOT_FILE = "master_state.json"
WAL_FILE = "master_wal.jsonl"
STATE_FORMAT = 1

# rewrite the WAL (dropping records the newest snapshot already covers)
# once it accumulates this many lines — an O(datasets * shards) bound,
# not an O(job lifetime) one
_WAL_COMPACT_LINES = 50_000


class MasterStateStore:
    """Persists and restores the master's control-plane state."""

    def __init__(
        self,
        state_dir: str,
        coalesce_interval: float = 0.05,
        periodic_interval: float = 5.0,
    ):
        self._dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self._snap_path = os.path.join(state_dir, SNAPSHOT_FILE)
        self._wal_path = os.path.join(state_dir, WAL_FILE)
        self._coalesce = coalesce_interval
        self._periodic = periodic_interval
        self._dirty = threading.Event()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._wal_lock = threading.Lock()
        self._wal_file = None
        self._wal_seq = 0
        self._wal_lines = 0
        self._snap_lock = threading.Lock()
        self.snapshots_written = 0
        # bound components
        self._task_manager = None
        self._rdzv_managers: dict = {}
        self._kv_store = None
        self._sync_service = None
        self._servicer = None
        self._port = 0

    # ------------------------------------------------------------- binding

    def bind(
        self,
        task_manager=None,
        rdzv_managers=None,
        kv_store=None,
        sync_service=None,
        servicer=None,
        port: int = 0,
    ):
        self._task_manager = task_manager
        self._rdzv_managers = rdzv_managers or {}
        self._kv_store = kv_store
        self._sync_service = sync_service
        self._servicer = servicer
        self._port = port

    # ------------------------------------------------------------------ WAL

    def wal_append(self, op: str, **fields):
        """Append one durable record. MUST be called *after* the
        in-memory mutation it describes and *before* the RPC ack —
        that ordering is what makes snapshot+replay lossless."""
        rec = {"op": op, **fields}
        # durable-write seam (dlint DL003): schedules can error/delay/
        # hang the WAL append — the exact outage shape a master crash
        # between mutation and ack produces
        chaos_point("master.wal", op=op)
        t0 = time.perf_counter()
        with self._wal_lock:
            if self._wal_file is None:
                self._wal_file = open(  # noqa: SIM115 - long-lived handle
                    self._wal_path, "a", encoding="utf-8"
                )
            self._wal_seq += 1
            rec["seq"] = self._wal_seq
            self._wal_file.write(json.dumps(rec) + "\n")
            # flush to the kernel: survives the process (chaos kill via
            # os._exit included); media-level fsync is out of scope for
            # a process-failure model
            # dlint: allow-blocking(mutate->append->flush->ack ordering is the WAL's durability contract; flushing outside the lock would let a later record ack first)
            self._wal_file.flush()
            self._wal_lines += 1
        # a histogram, not a span: the append sits on the RPC ack path
        # of every mutation — its latency distribution is exactly what
        # the future WAL-group-commit work must drive down, and a span
        # per append would flood the event ring
        telemetry.observe(
            "master.wal.append.seconds",
            time.perf_counter() - t0,
            op=op,
        )
        self.mark_dirty()

    def _read_wal(self) -> list[dict]:
        entries = []
        try:
            with open(self._wal_path, encoding="utf-8") as f:
                for line in f:
                    line = line.strip()
                    if not line:
                        continue
                    try:
                        entries.append(json.loads(line))
                    except ValueError:
                        # a torn tail line (crash mid-append) is
                        # expected; anything it described was never
                        # acked, so skipping it is correct
                        logger.warning("skipping torn WAL line")
        except OSError:
            return []
        return entries

    def _maybe_compact(self, snapshot_seq: int):
        with self._wal_lock:
            if self._wal_lines < _WAL_COMPACT_LINES:
                return
            keep = [
                e for e in self._read_wal()
                if e.get("seq", 0) > snapshot_seq
            ]
            tmp = f"{self._wal_path}.tmp.{os.getpid()}"
            with open(tmp, "w", encoding="utf-8") as f:
                for e in keep:
                    f.write(json.dumps(e) + "\n")
            if self._wal_file is not None:
                self._wal_file.close()
            os.replace(tmp, self._wal_path)
            self._wal_file = open(  # noqa: SIM115
                self._wal_path, "a", encoding="utf-8"
            )
            self._wal_lines = len(keep)
            logger.info(
                "compacted WAL to %d records (> seq %d)",
                len(keep), snapshot_seq,
            )

    # ------------------------------------------------------------ snapshots

    def mark_dirty(self):
        self._dirty.set()

    def collect(self) -> dict:
        """Gather a consistent-enough snapshot. The WAL high-water mark
        is captured BEFORE component state so replay of newer records
        can only over-cover (idempotent), never under-cover."""
        with self._wal_lock:
            wal_seq = self._wal_seq
        state: dict = {
            "format": STATE_FORMAT,
            "time": time.time(),
            "port": self._port,
            "wal_seq": wal_seq,
        }
        state["rdzv"] = {
            name: mgr.export_state()
            for name, mgr in self._rdzv_managers.items()
        }
        if self._task_manager is not None:
            state["datasets"] = self._task_manager.export_state()
        if self._kv_store is not None:
            state["kvstore"] = self._kv_store.export_state()
        if self._sync_service is not None:
            state["sync"] = self._sync_service.export_state()
        if self._servicer is not None:
            state["ckpt_barrier"] = (
                self._servicer.ckpt_barrier.export_state()
            )
            state["run_configs"] = self._servicer.get_run_configs()
            state["telemetry"] = self._servicer.telemetry.snapshots()
            # the live metrics plane's history (tiered series + dedup
            # high-water marks): a restarted master resumes with its
            # sparklines/SLO baselines intact, and the preserved
            # last-sseq marks make post-failover full re-sends land
            # idempotently
            state["metrics_store"] = (
                self._servicer.metrics_store.export_state()
            )
            # repair-brain plans: a master failover mid-plan must
            # re-serve the same decided/executing plans (same ids)
            # instead of re-deciding them — the WAL covers the window
            # between decision and the next snapshot
            brain = getattr(self._servicer, "brain", None)
            if brain is not None:
                state["brain"] = brain.export_state()
            # the serving request ledger: in-flight decode requests
            # must outlive a master failover (never-silently-dropped),
            # like the shard ledger does for training
            serving = getattr(self._servicer, "serving", None)
            if serving is not None:
                state["serving"] = serving.export_state()
            # deep-capture ledger: a directive decided (or served)
            # before a failover must be re-served IDENTICALLY by the
            # restored master, never re-decided or double-executed
            capture = getattr(self._servicer, "capture", None)
            if capture is not None:
                state["captures"] = capture.export_state()
            # hardware fingerprints + the quarantine waiting set: a
            # failover mid-quarantine must re-serve the same verdict
            health = getattr(self._servicer, "health", None)
            if health is not None:
                state["health"] = health.export_state()
        return state

    def write_snapshot(self) -> str | None:
        chaos_point("master.snapshot")
        with tracing.span("master.snapshot") as sp, self._snap_lock:
            state = self.collect()
            tmp = f"{self._snap_path}.tmp.{os.getpid()}"
            try:
                with open(tmp, "w", encoding="utf-8") as f:
                    json.dump(state, f)
                os.replace(tmp, self._snap_path)
            except (OSError, TypeError, ValueError) as e:
                logger.warning("master state snapshot failed: %s", e)
                return None
            self.snapshots_written += 1
            sp.annotate(wal_seq=state["wal_seq"])
        self._maybe_compact(state["wal_seq"])
        return self._snap_path

    # -------------------------------------------------------------- restore

    @staticmethod
    def peek_port(state_dir: str) -> int:
        """The port the previous incarnation served on (0 if unknown) —
        read before construction so ``--restore-state`` can re-bind it."""
        try:
            with open(
                os.path.join(state_dir, SNAPSHOT_FILE), encoding="utf-8"
            ) as f:
                return int(json.load(f).get("port", 0))
        except (OSError, ValueError):
            return 0

    def load(self) -> dict | None:
        try:
            with open(self._snap_path, encoding="utf-8") as f:
                state = json.load(f)
        except (OSError, ValueError):
            return None
        if state.get("format") != STATE_FORMAT:
            logger.warning(
                "ignoring state snapshot with format %r",
                state.get("format"),
            )
            return None
        return state

    def restore(self) -> bool:
        """Apply the persisted snapshot + WAL tail to the bound
        components. Returns True when any state was restored."""
        state = self.load()
        entries = self._read_wal()
        if entries:
            self._wal_seq = max(
                (e.get("seq", 0) for e in entries), default=0
            )
            self._wal_lines = len(entries)
        snap_seq = 0
        restored = False
        snapshot_applied = False
        if state is not None:
            snap_seq = int(state.get("wal_seq", 0))
            self._wal_seq = max(self._wal_seq, snap_seq)
            self._apply_snapshot(state)
            restored = True
            snapshot_applied = True
        tail = [e for e in entries if e.get("seq", 0) > snap_seq]
        for entry in tail:
            try:
                self._apply_wal_entry(
                    entry, snapshot_applied=snapshot_applied
                )
            except Exception:  # noqa: BLE001 - one bad record must not
                # void the rest of the recovery
                logger.exception("failed to replay WAL record %r", entry)
        if tail:
            restored = True
        if restored:
            age = time.time() - state["time"] if state else -1.0
            logger.info(
                "restored master state: snapshot_seq=%d wal_tail=%d "
                "age=%.1fs", snap_seq, len(tail), age,
            )
            telemetry.event(
                "master.restart",
                restored=True,
                wal_tail=len(tail),
                snapshot_age=round(age, 3),
            )
        return restored

    def _apply_snapshot(self, state: dict):
        for name, rdzv_state in (state.get("rdzv") or {}).items():
            mgr = self._rdzv_managers.get(name)
            if mgr is not None:
                mgr.restore_state(rdzv_state)
        if self._task_manager is not None and state.get("datasets"):
            self._task_manager.restore_state(state["datasets"])
        if self._kv_store is not None and state.get("kvstore") is not None:
            self._kv_store.restore_state(state["kvstore"])
        if self._sync_service is not None and state.get("sync"):
            self._sync_service.restore_state(state["sync"])
        if self._servicer is not None:
            if state.get("ckpt_barrier"):
                self._servicer.ckpt_barrier.restore_state(
                    state["ckpt_barrier"]
                )
            if state.get("run_configs"):
                self._servicer.set_run_configs(state["run_configs"])
            for snap in state.get("telemetry") or ():
                self._servicer.telemetry.update(snap)
            if state.get("metrics_store"):
                self._servicer.metrics_store.restore_state(
                    state["metrics_store"]
                )
            brain = getattr(self._servicer, "brain", None)
            if brain is not None and state.get("brain"):
                brain.restore_state(state["brain"])
            serving = getattr(self._servicer, "serving", None)
            if serving is not None and state.get("serving"):
                serving.restore_state(state["serving"])
            capture = getattr(self._servicer, "capture", None)
            if capture is not None and state.get("captures"):
                capture.restore_state(state["captures"])
            health = getattr(self._servicer, "health", None)
            if health is not None and state.get("health"):
                health.restore_state(state["health"])

    def _apply_wal_entry(self, e: dict, snapshot_applied: bool = True):
        op = e.get("op")
        if op == "dataset" and self._task_manager is not None:
            # new_dataset is a no-op for an already-registered name
            self._task_manager.new_dataset(**e["params"])
        elif op == "dispatch" and self._task_manager is not None:
            # epoch materialization is allowed ONLY in WAL-only
            # recovery: with a snapshot applied, its task state is
            # authoritative and an unmatched dispatch was covered by it
            self._task_manager.replay_dispatch(
                e["ds"], e["task_id"], e["start"], e["end"],
                e.get("indices") or [],
                e.get("node_type", ""), e.get("node_id", -1),
                allow_create=not snapshot_applied,
            )
        elif op == "task_result" and self._task_manager is not None:
            self._task_manager.replay_result(
                e["ds"], e["task_id"], bool(e.get("success", True))
            )
        elif op == "stream" and self._task_manager is not None:
            self._task_manager.replay_stream(
                e["ds"], int(e["reported"]), bool(e["ended"])
            )
        elif op == "restore_ds" and self._task_manager is not None:
            # a worker-pushed shard checkpoint (absolute dataset state)
            self._task_manager.restore_dataset_from_checkpoint(
                e["content"]
            )
        elif op == "brain_plan" and self._servicer is not None:
            brain = getattr(self._servicer, "brain", None)
            if brain is not None:
                # absolute plan state: replay upserts by plan id, so
                # over-replaying the tail around a snapshot boundary
                # is a no-op and the id counter only moves forward
                brain.replay_plan(e["plan"], seq=e.get("brain_seq"))
        elif op == "capture" and self._servicer is not None:
            capture = getattr(self._servicer, "capture", None)
            if capture is not None:
                # absolute record state: upsert replay by capture id,
                # id counter monotonic — over-replaying the tail
                # around a snapshot boundary is a no-op
                capture.replay(e["record"], next_id=e.get("next_id"))
        elif op == "health" and self._servicer is not None:
            health = getattr(self._servicer, "health", None)
            if health is not None:
                # absolute health state: upsert restore, so replaying
                # the WAL tail around a snapshot boundary is a no-op
                health.restore_state(e["state"])
        elif op == "kv" and self._kv_store is not None:
            self._kv_store.set(
                e["key"], base64.b64decode(e["value"])
            )
        elif op == "kv_del" and self._kv_store is not None:
            self._kv_store.delete(e["key"])
        else:
            logger.warning("unknown WAL op %r", op)

    def reset(self):
        """Start clean: a NEW job pointed at a reused state dir must not
        inherit a previous job's shard progress."""
        for path in (self._snap_path, self._wal_path):
            try:
                os.remove(path)
            except FileNotFoundError:
                pass
        self._wal_seq = 0
        self._wal_lines = 0

    # ------------------------------------------------------------ lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="master-state-store", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stop.set()
        self._dirty.set()  # unblock the wait
        try:
            self.write_snapshot()
        except Exception:  # noqa: BLE001 - shutting down regardless
            logger.exception("final state snapshot failed")
        with self._wal_lock:
            if self._wal_file is not None:
                self._wal_file.close()
                self._wal_file = None

    def _loop(self):
        while not self._stop.is_set():
            fired = self._dirty.wait(self._periodic)
            if self._stop.is_set():
                return
            if not fired:
                continue  # clean: nothing changed since the last write
            # coalesce the burst: one write absorbs every mutation that
            # lands inside the window, keeping snapshots off the RPC
            # hot path
            self._stop.wait(self._coalesce)
            self._dirty.clear()
            try:
                self.write_snapshot()
            except Exception:  # noqa: BLE001 - the loop must survive a
                # transient disk error and try again next tick
                logger.exception("state snapshot tick failed")
