"""Master-side deep-capture manager: anomaly-triggered profiling with
an exactly-once, failover-durable ledger.

Equivalent capability: the reference's xpu_timer stack can dump a
hanging process's stacks ON DEMAND; what no one ships is the trigger
loop — here an SLO breach (step-time/MFU regression), a straggler
verdict, or an operator request turns into a bounded directive to the
BLAMED host's agent: capture N steps of device trace plus the live
span window and all-thread stacks (the flight-recorder idiom), and
index the artifact where the dashboard and ``/captures.json`` can list
it with its attribution diff ("collective-permute +38% vs baseline").

Discipline (the serving-ledger rules applied to profiling):

- **One capture in flight job-wide** — profiling overhead is the thing
  being measured; two concurrent deep traces would poison each other.
- **Per-host rate limit** (:data:`COOLDOWN_S`) — a standing breach
  must not turn into a capture loop on the same host.
- **Exactly-once across failover** — every ledger mutation is
  WAL-logged (absolute record state, upsert replay) and rides the
  master snapshot, so a master killed between decision and execution
  re-serves the IDENTICAL directive (same capture id) to the agent's
  next poll instead of re-deciding, and a completed capture is never
  re-served.
- **Bounded** — a directive nobody executes expires
  (:data:`DIRECTIVE_TTL_S`) and frees the in-flight slot; the ledger
  keeps the newest :data:`MAX_RECORDS` records.

Delivery rides the existing diagnosis poll (``DiagnosisResult.capture``)
— agents already pull verdicts every monitor tick, so a capture
directive needs no new polling loop, only a field.

The PyTorch port's copy of dlrover_tpu/master/capture.py.
"""

from __future__ import annotations

import os
import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# minimum seconds between captures of the SAME host
COOLDOWN_S = float(os.environ.get("DLROVER_CAPTURE_COOLDOWN", "300"))
# how many steps of device trace a triggered capture asks for
DEFAULT_STEPS = int(os.environ.get("DLROVER_CAPTURE_STEPS", "2"))
# a served-but-never-reported directive expires (agent died mid-
# capture, worker never acked): frees the one-in-flight slot
DIRECTIVE_TTL_S = float(os.environ.get("DLROVER_CAPTURE_TTL", "180"))
MAX_RECORDS = 64

# diagnosis/SLO keys that name a host this manager reacts to
_SLO_RULES = ("step_time", "mfu")


def _slo_rank(key: str) -> int | None:
    """Parse the blamed node rank out of an SLO breach key
    (``step_time:worker-<rank>-<pid>``) — same source-name convention
    as ``diagnosis._source_rank``."""
    _rule, _, source = key.partition(":")
    parts = source.rsplit("-", 2)
    if len(parts) != 3:
        return None
    try:
        return int(parts[1])
    except ValueError:
        return None


class CaptureManager:
    """The capture ledger + trigger policy. Thread-safe: RPC handler
    threads (operator requests, agent polls/reports) and the diagnosis
    sweep all enter here."""

    def __init__(
        self,
        wal_fn=None,
        dirty_fn=None,
        cooldown_s: float = COOLDOWN_S,
        directive_ttl_s: float = DIRECTIVE_TTL_S,
        default_steps: int = DEFAULT_STEPS,
        enabled: bool = True,
    ):
        self._wal = wal_fn or (lambda op, **fields: None)
        self._dirty = dirty_fn or (lambda: None)
        self._cooldown = cooldown_s
        self._ttl = directive_ttl_s
        self._default_steps = default_steps
        self.enabled = enabled
        self._lock = threading.Lock()
        # capture_id -> record (insertion-ordered; oldest evicted)
        self._records: dict[str, dict] = {}
        self._next_id = 1
        # rank -> wall time of its newest accepted capture
        self._last_by_rank: dict[int, float] = {}

    # ------------------------------------------------------------ requests

    def request(
        self, node_rank: int, steps: int = 0, reason: str = "operator",
        now: float | None = None,
    ) -> dict:
        """Admit a capture request. Returns the ack payload
        ``{capture_id, accepted, reason}`` — refusals name WHY (rate
        limit / in flight / disabled), so the operator tool and the
        trigger loop never guess."""
        now = time.time() if now is None else now
        if not self.enabled:
            return {
                "capture_id": "", "accepted": False,
                "reason": "capture manager disabled",
            }
        if node_rank < 0:
            return {
                "capture_id": "", "accepted": False,
                "reason": "no target host (node_rank < 0)",
            }
        rec = None
        with self._lock:
            self._expire_locked(now)
            inflight = self._inflight_locked()
            if inflight is not None:
                return {
                    "capture_id": "", "accepted": False,
                    "reason": (
                        f"capture {inflight['id']} already in flight "
                        f"(host {inflight['rank']})"
                    ),
                }
            last = self._last_by_rank.get(node_rank)
            if last is not None and now - last < self._cooldown:
                return {
                    "capture_id": "", "accepted": False,
                    "reason": (
                        f"host {node_rank} in cooldown "
                        f"({self._cooldown - (now - last):.0f}s left)"
                    ),
                }
            cid = f"cap-{self._next_id:04d}"
            self._next_id += 1
            rec = {
                "id": cid,
                "rank": int(node_rank),
                "steps": int(steps) or self._default_steps,
                "reason": str(reason)[:200],
                "state": "requested",
                "requested_t": now,
                "started_t": 0.0,
                "done_t": 0.0,
                "artifact": "",
                "summary": {},
                "error": "",
            }
            self._records[cid] = rec
            self._last_by_rank[node_rank] = now
            self._evict_locked()
            self._log_locked(rec)
        telemetry.event(
            "prof.capture.requested", capture=rec["id"],
            rank=node_rank, reason=rec["reason"],
        )
        telemetry.counter_inc("prof.capture.requests")
        logger.info(
            "deep capture %s requested for host %s (%s)",
            rec["id"], node_rank, rec["reason"],
        )
        self._dirty()
        return {
            "capture_id": rec["id"], "accepted": True, "reason": "",
        }

    # ------------------------------------------------------------ triggers

    def on_sweep(self, verdicts: dict, now: float | None = None):
        """Ride the DiagnosisManager sweep (called OUTSIDE its lock,
        like the brain): a straggler verdict or a host-naming SLO
        breach becomes a capture request for the blamed host. The
        one-in-flight + cooldown guards above make this loop safe to
        call on every sweep."""
        if not self.enabled:
            return
        now = time.time() if now is None else now
        with self._lock:
            self._expire_locked(now)
        for rank, info in (verdicts.get("stragglers") or {}).items():
            self.request(
                int(rank), reason=(
                    f"straggler:{info.get('phase', '?')}"
                    f" x{info.get('ratio', '?')}"
                ),
                now=now,
            )
        for key, info in (verdicts.get("slo") or {}).items():
            rule = str(info.get("rule", key.partition(":")[0]))
            if not any(key.startswith(r + ":") for r in _SLO_RULES):
                continue
            rank = _slo_rank(key)
            if rank is None:
                continue
            self.request(
                rank, reason=f"slo:{rule} ratio={info.get('ratio')}",
                now=now,
            )

    # ------------------------------------------------------------ delivery

    def poll_directive(self, node_rank: int, now: float | None = None
                       ) -> dict:
        """The agent's pull: the pending/running directive assigned to
        ``node_rank`` (re-polling re-serves the SAME directive — the
        idempotence a post-failover or post-reconnect poll relies on),
        or ``{}``."""
        if node_rank < 0:
            return {}
        now = time.time() if now is None else now
        served = None
        with self._lock:
            self._expire_locked(now)
            for rec in self._records.values():
                if rec["rank"] != node_rank:
                    continue
                if rec["state"] == "requested":
                    rec["state"] = "running"
                    rec["started_t"] = now
                    self._log_locked(rec)
                    served = dict(rec)
                    break
                if rec["state"] == "running":
                    served = dict(rec)
                    break
        if served is None:
            return {}
        if served["started_t"] == now:
            telemetry.event(
                "prof.capture.served", capture=served["id"],
                rank=node_rank,
            )
            self._dirty()
        return {
            "capture_id": served["id"],
            "steps": served["steps"],
            "reason": served["reason"],
        }

    def report_result(
        self, capture_id: str, node_rank: int, ok: bool,
        artifact: str = "", summary: dict | None = None,
        error: str = "", now: float | None = None,
    ) -> bool:
        """Land a capture outcome. Exactly-once: only the assigned
        host's FIRST report lands; duplicates and zombie reports are
        acknowledged-and-dropped (False)."""
        now = time.time() if now is None else now
        with self._lock:
            rec = self._records.get(capture_id)
            if rec is None or rec["rank"] != int(node_rank):
                return False
            if rec["state"] not in ("requested", "running"):
                return False  # duplicate / late report: dropped
            rec["state"] = "done" if ok else "failed"
            rec["done_t"] = now
            rec["artifact"] = str(artifact)
            rec["summary"] = dict(summary or {})
            rec["error"] = str(error)[:400]
            self._log_locked(rec)
            rec = dict(rec)
        telemetry.event(
            "prof.capture.result", capture=capture_id,
            ok=bool(ok), rank=node_rank,
        )
        telemetry.counter_inc(
            "prof.capture.results", state=rec["state"]
        )
        attribution = (rec["summary"] or {}).get("attribution") or []
        worst = attribution[0] if attribution else None
        logger.info(
            "deep capture %s %s on host %s%s", capture_id,
            rec["state"], node_rank,
            (
                f" — {worst['category']} "
                f"{worst['delta_pct']:+.0f}% vs baseline"
                if worst and worst.get("delta_pct") is not None
                else ""
            ),
        )
        self._dirty()
        return True

    # ------------------------------------------------------------- queries

    def list(self, now: float | None = None) -> list[dict]:
        """Every ledger record, newest request first."""
        now = time.time() if now is None else now
        with self._lock:
            self._expire_locked(now)
            return sorted(
                (dict(r) for r in self._records.values()),
                key=lambda r: -r["requested_t"],
            )

    def summary(self) -> dict:
        with self._lock:
            states: dict[str, int] = {}
            for rec in self._records.values():
                states[rec["state"]] = states.get(rec["state"], 0) + 1
            inflight = self._inflight_locked()
            return {
                "enabled": self.enabled,
                "states": states,
                "in_flight": inflight["id"] if inflight else "",
            }

    # ------------------------------------------------------------ internals

    def _inflight_locked(self) -> dict | None:
        for rec in self._records.values():
            if rec["state"] in ("requested", "running"):
                return rec
        return None

    def _expire_locked(self, now: float):
        for rec in self._records.values():
            if rec["state"] not in ("requested", "running"):
                continue
            anchor = rec["started_t"] or rec["requested_t"]
            if now - anchor > self._ttl:
                rec["state"] = "failed"
                rec["done_t"] = now
                rec["error"] = (
                    f"directive expired after {self._ttl:.0f}s "
                    f"(state was "
                    f"{'running' if rec['started_t'] else 'requested'})"
                )
                self._log_locked(rec)
                logger.warning(
                    "deep capture %s expired unexecuted", rec["id"]
                )

    def _evict_locked(self):
        while len(self._records) > MAX_RECORDS:
            oldest = next(iter(self._records))
            if self._records[oldest]["state"] in (
                "requested", "running",
            ):
                break  # never evict the live directive
            del self._records[oldest]

    def _log_locked(self, rec: dict):
        # absolute record state -> idempotent upsert replay; the id
        # counter rides along so a WAL-only recovery never re-mints an
        # already-used capture id
        self._wal("capture", record=dict(rec), next_id=self._next_id)

    # -------------------------------------------------- failover durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "records": [dict(r) for r in self._records.values()],
                "next_id": self._next_id,
                "last_by_rank": {
                    str(r): t for r, t in self._last_by_rank.items()
                },
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._records = {
                r["id"]: dict(r) for r in state.get("records") or ()
            }
            self._next_id = max(
                int(state.get("next_id", 1)), self._next_id
            )
            self._last_by_rank = {
                int(r): float(t)
                for r, t in (state.get("last_by_rank") or {}).items()
            }

    def replay(self, record: dict, next_id: int | None = None):
        """WAL replay: upsert by capture id (absolute state — replaying
        the tail around a snapshot boundary is a no-op), id counter
        monotonic."""
        if not isinstance(record, dict) or not record.get("id"):
            return
        with self._lock:
            self._records[record["id"]] = dict(record)
            if next_id is not None:
                self._next_id = max(self._next_id, int(next_id))
            rank = int(record.get("rank", -1))
            if rank >= 0:
                t = float(record.get("requested_t", 0.0))
                self._last_by_rank[rank] = max(
                    self._last_by_rank.get(rank, 0.0), t
                )
