"""Master-side serving request ledger: the front door of the decode
pool.

Equivalent capability: the reference fronts its inference backend with
a request router; here the existing master IS the router — requests
enter over the same 2-verb RPC plane as everything else
(``ServeSubmitRequest``), decode workers pull work with leases
(``ServeLeaseRequest``), and results come back as reports
(``ServeResultReport``). The ledger enforces the serving arm's one
hard promise: **a submitted request is never silently dropped and
never double-served.**

State machine per request::

    queued -> leased(worker, deadline) -> done
                     |                       ^
                     | lease expired          | (only the CURRENT
                     v                        |  leaseholder's report
                 re-queued (exactly once) ----+  lands)
                     |
                     v  second expiry
                  failed (surfaced, counted — never silent)

- **Leases** carry a deadline; a worker that dies (chaos kill, real
  crash) simply stops reporting and its leases expire — the sweep
  re-queues each of them EXACTLY once (``attempts`` capped), so a
  request can ride out one worker death and a double death surfaces
  as an explicit failure instead of an invisible hang.
- **Double-serve guard**: a result is accepted only from the worker
  currently holding the lease. A zombie leaseholder reporting after
  its lease was re-queued is acknowledged-and-dropped (the re-queued
  copy is authoritative) — the smoke test asserts every request id
  lands in ``done`` exactly once.
- The queue-depth gauge this module publishes is the repair brain's
  pool-scaling sensor and the SLO watchdog's queue-ceiling input.

Lock discipline (dlint DL008 / dtsan): one leaf lock guards the
ledger; telemetry emission happens outside it.

The PyTorch port's copy of dlrover_tpu/serving/manager.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# a worker whose lease outlives this is presumed dead (its requests
# re-queue); decode steps are milliseconds, so seconds of silence is
# already an eternity — tests shrink it further
LEASE_TIMEOUT_S = 15.0
# total serve attempts per request: the original lease plus exactly
# one re-queue
MAX_ATTEMPTS = 2
# a worker with no lease/report activity for this long leaves the
# pool-size view (the brain's scale-plan completion check)
WORKER_TTL_S = 30.0
# retained done/failed records (result tokens included): beyond this
# the oldest finished records evict, so a long-lived serving master's
# ledger is bounded by live traffic, not total requests ever served
MAX_FINISHED_RECORDS = 4096


class ServingRequestManager:
    def __init__(
        self,
        lease_timeout_s: float = LEASE_TIMEOUT_S,
        max_attempts: int = MAX_ATTEMPTS,
        worker_ttl_s: float = WORKER_TTL_S,
        max_finished: int = MAX_FINISHED_RECORDS,
    ):
        self._lease_timeout = lease_timeout_s
        self._max_attempts = max(int(max_attempts), 1)
        self._worker_ttl = worker_ttl_s
        self._max_finished = max(int(max_finished), 1)
        self._lock = threading.Lock()
        # request_id -> record dict (payload + ledger fields)
        self._requests: dict[str, dict] = {}
        self._queue: list[str] = []        # FIFO of queued ids
        # finished (done|failed) ids in completion order — the
        # eviction queue that bounds the ledger
        self._finished_order: list[str] = []
        # worker rank -> {"last_seen": t, "served": n}
        self._workers: dict[int, dict] = {}
        self._requeues = 0

    # ------------------------------------------------------------- intake

    def submit(self, payload: dict, now: float | None = None) -> bool:
        """Admit one request into the ledger. Re-submitting an id the
        ledger already holds is idempotent (client retries after a
        dropped ack must not double-serve)."""
        now = time.time() if now is None else now
        rid = str(payload.get("request_id", ""))
        if not rid or not payload.get("prompt"):
            return False
        with self._lock:
            if rid in self._requests:
                return True
            self._requests[rid] = {
                "payload": dict(payload),
                "state": "queued",
                "submit_t": now,
                "attempts": 0,
                "worker": -1,
                "lease_deadline": 0.0,
                "tokens": [],
                "finish_reason": "",
            }
            self._queue.append(rid)
            depth = len(self._queue)
        telemetry.gauge_set("serve.queue.depth", float(depth))
        telemetry.counter_inc("serve.requests", state="submitted")
        return True

    # -------------------------------------------------------------- lease

    def lease(self, worker_rank: int, max_requests: int,
              now: float | None = None) -> tuple[list[dict], int]:
        """Hand up to ``max_requests`` queued requests to a worker;
        returns (payloads, queue_depth_after). Expired leases are
        swept first, so a dead worker's requests re-enter the queue
        before anyone else goes hungry."""
        now = time.time() if now is None else now
        self._expire_leases(now)
        out: list[dict] = []
        with self._lock:
            w = self._workers.setdefault(
                int(worker_rank), {"last_seen": now, "served": 0}
            )
            w["last_seen"] = now
            while self._queue and len(out) < max(int(max_requests), 0):
                rid = self._queue.pop(0)
                rec = self._requests[rid]
                rec["state"] = "leased"
                rec["worker"] = int(worker_rank)
                rec["attempts"] += 1
                rec["lease_deadline"] = now + self._lease_timeout
                payload = dict(rec["payload"])
                # the ORIGINAL submit instant rides the lease so the
                # worker's TTFT measures queue + re-queue time too
                payload["submit_t"] = rec["submit_t"]
                out.append(payload)
            depth = len(self._queue)
        if out:
            telemetry.gauge_set("serve.queue.depth", float(depth))
        return out, depth

    def sweep(self, now: float | None = None):
        """Expire stale leases (re-queue exactly once / fail loudly).
        Runs inside every lease and summary call, and the master's SLO
        watchdog drives it once per diagnosis sweep — so a pool whose
        LAST worker died (nobody left to lease) still re-queues and
        eventually fails its wedged requests instead of holding them
        in ``leased`` forever."""
        self._expire_leases(time.time() if now is None else now)

    def _expire_leases(self, now: float):
        """Re-queue (exactly once) or fail requests whose leaseholder
        went silent. Called from every lease/status/watchdog sweep."""
        requeued: list[str] = []
        failed: list[str] = []
        with self._lock:
            for rid, rec in self._requests.items():
                if rec["state"] != "leased":
                    continue
                if now < rec["lease_deadline"]:
                    continue
                stale_worker = rec["worker"]
                rec["worker"] = -1
                rec["lease_deadline"] = 0.0
                if rec["attempts"] < self._max_attempts:
                    rec["state"] = "queued"
                    self._queue.append(rid)
                    requeued.append(rid)
                else:
                    rec["state"] = "failed"
                    rec["finish_reason"] = (
                        f"lease expired {rec['attempts']}x "
                        f"(last worker {stale_worker})"
                    )
                    self._finished_order.append(rid)
                    failed.append(rid)
            self._requeues += len(requeued)
            self._prune_finished()
            depth = len(self._queue)
        if requeued or failed:
            # refresh the shipped gauge: after a worker death this is
            # exactly the moment the real queue jumps, and an operator
            # watching qdep must see it without waiting for a lease
            telemetry.gauge_set("serve.queue.depth", float(depth))
        for rid in requeued:
            logger.warning("serve: lease expired, re-queued %s", rid)
            telemetry.event("serve.request.requeued", request=rid)
            telemetry.counter_inc("serve.requests", state="requeued")
        for rid in failed:
            # the never-silent contract: a dropped request is a LOUD
            # ledger state + event + counter, not an absence
            logger.error("serve: request %s FAILED (lease expired "
                         "beyond max attempts)", rid)
            telemetry.event("serve.request.failed", request=rid)
            telemetry.counter_inc("serve.requests", state="failed")

    # ------------------------------------------------------------- result

    def complete(self, request_id: str, worker_rank: int, tokens,
                 finish_reason: str = "",
                 now: float | None = None) -> bool:
        """A worker finished a request. Only the CURRENT leaseholder's
        report lands; anything else (zombie leaseholder after a
        re-queue, duplicate report) is acknowledged-and-dropped so the
        request is served exactly once."""
        now = time.time() if now is None else now
        accepted = False
        with self._lock:
            rec = self._requests.get(str(request_id))
            w = self._workers.setdefault(
                int(worker_rank), {"last_seen": now, "served": 0}
            )
            w["last_seen"] = now
            if rec is not None and rec["state"] == "leased" and \
                    rec["worker"] == int(worker_rank):
                rec["state"] = "done"
                rec["tokens"] = list(tokens or ())
                rec["finish_reason"] = finish_reason or "done"
                rec["done_t"] = now
                rec["lease_deadline"] = 0.0
                w["served"] += 1
                self._finished_order.append(str(request_id))
                self._prune_finished()
                accepted = True
        if accepted:
            telemetry.counter_inc("serve.requests", state="done")
        else:
            telemetry.counter_inc("serve.requests", state="stale_report")
        return accepted

    def _prune_finished(self):
        """Caller holds the lock. Evict the oldest finished records
        past the retention cap — an evicted id fetches as ``unknown``
        (and a re-submit of it would be served again; clients that
        care fetch before the retention horizon)."""
        while len(self._finished_order) > self._max_finished:
            rid = self._finished_order.pop(0)
            rec = self._requests.get(rid)
            if rec is not None and rec["state"] in ("done", "failed"):
                del self._requests[rid]

    # -------------------------------------------------------------- reads

    def fetch(self, request_id: str) -> dict:
        with self._lock:
            rec = self._requests.get(str(request_id))
            if rec is None:
                return {"state": "unknown", "tokens": [],
                        "finish_reason": ""}
            return {
                "state": rec["state"],
                "tokens": list(rec["tokens"]),
                "finish_reason": rec["finish_reason"],
            }

    def queue_depth(self) -> int:
        with self._lock:
            return len(self._queue)

    def pool_size(self, now: float | None = None) -> int:
        """Workers with recent lease/report activity — the live decode
        pool as the ledger observes it (a chaos-killed worker ages out
        within ``worker_ttl``)."""
        now = time.time() if now is None else now
        with self._lock:
            return sum(
                1 for w in self._workers.values()
                if now - w["last_seen"] <= self._worker_ttl
            )

    def counts(self) -> dict:
        with self._lock:
            out = {"queued": 0, "leased": 0, "done": 0, "failed": 0}
            attempts = 0
            for rec in self._requests.values():
                out[rec["state"]] = out.get(rec["state"], 0) + 1
                attempts = max(attempts, rec["attempts"])
            out["requeued_total"] = self._requeues
            # the exactly-once proof surface: never beyond the lease +
            # one re-queue the cap allows
            out["max_attempts_seen"] = attempts
            return out

    # -------------------------------------------- failover durability

    def export_state(self) -> dict:
        """Rides the master state snapshot (like rendezvous/brain
        state) so a restarted master still owns every in-flight
        request — the 'never silently dropped' promise must survive a
        master failover, not just a worker death."""
        with self._lock:
            return {
                "requests": {
                    rid: dict(rec, payload=dict(rec["payload"]),
                              tokens=list(rec["tokens"]))
                    for rid, rec in self._requests.items()
                },
                "queue": list(self._queue),
                "finished_order": list(self._finished_order),
                "workers": {
                    str(r): dict(w) for r, w in self._workers.items()
                },
                "requeues": self._requeues,
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._requests = {
                str(rid): dict(rec)
                for rid, rec in (state.get("requests") or {}).items()
            }
            self._queue = [str(r) for r in state.get("queue") or ()]
            self._finished_order = [
                str(r) for r in state.get("finished_order") or ()
            ]
            self._workers = {
                int(r): dict(w)
                for r, w in (state.get("workers") or {}).items()
            }
            self._requeues = int(state.get("requeues", 0))
        logger.info(
            "serving ledger restored: %d request(s), %d queued",
            len(self._requests), len(self._queue),
        )

    def summary(self, now: float | None = None) -> dict:
        """Dashboard / obs_report payload."""
        now = time.time() if now is None else now
        self._expire_leases(now)
        counts = self.counts()
        with self._lock:
            workers = {
                str(rank): {
                    "served": w["served"],
                    "idle_s": round(max(now - w["last_seen"], 0.0), 3),
                }
                for rank, w in sorted(self._workers.items())
            }
            depth = len(self._queue)
        return {
            "queue_depth": depth,
            "pool_size": self.pool_size(now),
            "counts": counts,
            "workers": workers,
        }
