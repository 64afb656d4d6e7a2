"""Decode worker: one member of the elastic serving pool (port of
dlrover_tpu/serving/worker.py).

A decode worker is to serving what the training agent is to training —
it joins the SAME master through the SAME doors: rendezvous (the
``decode-pool`` node group), telemetry snapshot shipping (its TTFT /
throughput series land in the master's metrics store and on
``/metrics`` with a per-worker source), diagnosis polling (which also
pumps the master's rate-limited brain sweep), and chaos sites (the
``serve.step`` seam is where the ``serve-kill`` schedule lands).
Failover, chaos kills, tracing and the flight recorder therefore apply
unmodified — there is no serving-only control plane.

The loop per iteration:

1. hit the ``serve.step`` chaos seam (a scheduled fault here is a
   worker death: the loop aborts WITHOUT reporting, so the master's
   lease expiry must re-queue everything in flight);
2. lease as many queued requests as it has free slots;
3. run one continuous-batching scheduler step (admit + decode +
   evict);
4. report finished sequences; ship a telemetry snapshot every few
   steps.

The worker talks through a small client seam so the same code runs
in-process against a bare servicer (tests, the chaos harness) or over
the real RPC plane (``MasterClient`` grew the matching serve_*
methods).
"""

from __future__ import annotations

import os
import threading
import time

from dlrover_tpu_torch.common import messages as msg
from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.chaos import ChaosError, chaos_point
from dlrover_tpu_torch.common.constants import RendezvousName
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.serving.scheduler import (
    ContinuousBatchingScheduler,
    ServeRequest,
)

logger = get_logger(__name__)

# ship the worker registry's snapshot to the master every N loop steps
SHIP_EVERY = 8
# poll the master diagnosis (which pumps the brain sweep) every N steps
DIAGNOSE_EVERY = 16
IDLE_SLEEP_S = 0.002


class LocalServingClient:
    """In-process client: drives the REAL servicer dispatch arms with
    the real message types, minus the socket — what the tier-1 smoke
    and the chaos harness use (MasterClient is the wire twin)."""

    def __init__(self, servicer, node_rank: int):
        self._servicer = servicer
        self.node_rank = int(node_rank)

    def join_rendezvous(self) -> bool:
        ok = bool(self._servicer.report(
            "decode", self.node_rank,
            msg.JoinRendezvousRequest(
                node_id=self.node_rank,
                node_rank=self.node_rank,
                local_world_size=1,
                rdzv_name=RendezvousName.DECODE_POOL,
                node_ip="127.0.0.1",
            ),
        ))
        # one world poll forms the pool round, so the membership view
        # (latest_members, failover snapshot) reflects this worker
        self._servicer.get(
            "decode", self.node_rank,
            msg.CommWorldRequest(
                node_id=self.node_rank,
                rdzv_name=RendezvousName.DECODE_POOL,
            ),
        )
        return ok

    def serve_lease(self, max_requests: int) -> list[dict]:
        lease = self._servicer.get(
            "decode", self.node_rank,
            msg.ServeLeaseRequest(
                node_rank=self.node_rank, max_requests=max_requests
            ),
        )
        return list(lease.requests) if lease is not None else []

    def serve_report_result(self, request_id: str, tokens,
                            finish_reason: str) -> bool:
        return bool(self._servicer.report(
            "decode", self.node_rank,
            msg.ServeResultReport(
                request_id=request_id,
                node_rank=self.node_rank,
                tokens=list(tokens),
                finish_reason=finish_reason,
            ),
        ))

    def report_telemetry(self, snapshot: dict) -> bool:
        return bool(self._servicer.report(
            "decode", self.node_rank,
            msg.TelemetrySnapshot(
                node_id=self.node_rank, payload=snapshot
            ),
        ))

    def poll_diagnosis(self):
        return self._servicer.get(
            "decode", self.node_rank,
            msg.DiagnosisRequest(node_rank=self.node_rank),
        )


class RpcServingClient:
    """The wire twin of :class:`LocalServingClient`: the same worker
    seam over a real :class:`~dlrover_tpu_torch.agent.master_client.
    MasterClient` RPC connection (production deployment and the
    process-separated drives)."""

    def __init__(self, master_client, node_rank: int):
        self._client = master_client
        self.node_rank = int(node_rank)

    def join_rendezvous(self) -> bool:
        ok = self._client.join_rendezvous(
            self.node_rank, 1, RendezvousName.DECODE_POOL
        )
        # one world poll forms the pool round (membership view)
        self._client.get_comm_world(
            RendezvousName.DECODE_POOL, self.node_rank
        )
        return bool(ok)

    def serve_lease(self, max_requests: int) -> list[dict]:
        return self._client.serve_lease(max_requests)

    def serve_report_result(self, request_id: str, tokens,
                            finish_reason: str) -> bool:
        return bool(self._client.serve_report_result(
            request_id, tokens, finish_reason
        ))

    def report_telemetry(self, snapshot: dict) -> bool:
        return bool(self._client.report_telemetry(snapshot))

    def poll_diagnosis(self):
        return self._client.get_diagnosis()


class DecodeWorker:
    """One pool member: owns a decode engine + scheduler + its OWN
    telemetry registry (per-worker source on every shipped series)."""

    def __init__(
        self,
        client,
        engine,
        rank: int,
        source: str | None = None,
        ship_every: int = SHIP_EVERY,
        diagnose_every: int = DIAGNOSE_EVERY,
        idle_sleep_s: float = IDLE_SLEEP_S,
        now_fn=time.monotonic,
    ):
        self.client = client
        self.rank = int(rank)
        self.registry = telemetry.TelemetryRegistry(
            source=source or f"decode-{rank}-{os.getpid()}"
        )
        self.scheduler = ContinuousBatchingScheduler(
            engine, registry=self.registry, rng_seed=1000 + rank,
            now_fn=now_fn, worker_label=str(rank),
        )
        self._engine = engine
        self._ship_every = max(int(ship_every), 1)
        self._diagnose_every = max(int(diagnose_every), 1)
        self._idle_sleep = idle_sleep_s
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self._steps = 0
        self.crashed = False
        self.abandoned: list[str] = []
        self.finished: list = []

    # ----------------------------------------------------------- lifecycle

    def start(self):
        self.client.join_rendezvous()
        self.registry.event("serve.worker.start", rank=self.rank)
        self._thread = threading.Thread(
            target=self._run, name=f"decode-worker-{self.rank}",
            daemon=True,
        )
        self._thread.start()

    def stop(self, timeout: float = 30.0):
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)

    def join(self, timeout: float = 30.0):
        if self._thread is not None:
            self._thread.join(timeout)

    def idle(self) -> bool:
        return (
            self.scheduler.queue_depth() == 0
            and self.scheduler.live() == 0
        )

    # ---------------------------------------------------------------- loop

    def _run(self):
        try:
            while not self._stop.is_set():
                self.step()
                if self.idle():
                    time.sleep(self._idle_sleep)
        except ChaosError as e:
            # an injected worker death: abort WITHOUT reporting or
            # draining — everything in flight stays leased on the
            # master until the lease expires and re-queues it
            self.crashed = True
            self.abandoned = self.scheduler.abandon()
            logger.warning(
                "decode worker %d killed by chaos (%s): abandoning "
                "%d request(s) un-reported", self.rank, e,
                len(self.abandoned),
            )
        finally:
            # crash-path flush mirrors the agent's: the worker's last
            # snapshot must reach the operator even on a chaos death
            self._ship()

    def step(self) -> list:
        """One worker iteration; also the unit the chaos schedule
        counts (``site="serve.step"``, ctx rank/step)."""
        self._steps += 1
        live = self.scheduler.live()
        # ``verb`` tells idle spins from serving steps so a schedule
        # can land a deterministic kill mid-service ("serve-kill")
        chaos_point(
            "serve.step", rank=self.rank, step=self._steps,
            verb="serving" if live else "idle",
        )
        free = self._engine.slots - live
        if free > 0:
            for payload in self.client.serve_lease(free):
                self.scheduler.submit(ServeRequest.from_payload(payload))
        finished = self.scheduler.step()
        for fin in finished:
            self.client.serve_report_result(
                fin.request_id, fin.tokens, fin.finish_reason
            )
        self.finished.extend(finished)
        if finished:
            self.registry.gauge_set(
                "serve.worker.completed_total",
                float(len(self.finished)),
            )
        if self._steps % self._ship_every == 0:
            self._ship()
        if self._steps % self._diagnose_every == 0:
            try:
                self.client.poll_diagnosis()
            except ChaosError:
                raise
            except Exception:  # noqa: BLE001 - diagnosis is advisory;
                # a flaky poll must not kill the serving loop
                logger.warning("diagnosis poll failed", exc_info=True)
        return finished

    def _ship(self):
        try:
            snap = self.registry.snapshot()
            if snap:
                self.client.report_telemetry(snap)
        except Exception:  # noqa: BLE001 - shipping is best-effort;
            # the serving loop (or the crash path) must not die on it
            logger.warning("telemetry ship failed", exc_info=True)
