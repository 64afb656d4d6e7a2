"""Control-plane message dataclasses (the wire protocol).

Equivalent capability: reference dlrover/python/common/grpc.py:129-450 —
~45 pickled dataclass message types carried by a 2-RPC (report/get)
protocol. Same two-verb shape here: every client interaction is either a
``report`` (fire-and-ack) or a ``get`` (request-response).

Drift discipline: every dataclass here must have a live endpoint —
``tools/dlint`` (DL006) statically checks that anything the client
sends has a servicer dispatch arm and that no dead types linger (ten
never-referenced reference-parity placeholders were deleted when the
checker landed).

The PyTorch port's copy of dlrover_tpu/common/messages.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class Message:
    """Base class: anything sent over the control plane."""


# --------------------------------------------------------------------------
# generic / envelope
# --------------------------------------------------------------------------


@dataclass
class Response(Message):
    success: bool = True
    reason: str = ""


# --------------------------------------------------------------------------
# data sharding: tasks & shards
# --------------------------------------------------------------------------


@dataclass
class Shard(Message):
    name: str = ""
    start: int = 0
    end: int = 0
    record_indices: list = field(default_factory=list)


@dataclass
class Task(Message):
    task_id: int = -1
    shard: Shard = field(default_factory=Shard)
    task_type: str = ""

    @property
    def exists(self) -> bool:
        return self.task_id >= 0


@dataclass
class TaskRequest(Message):
    dataset_name: str = ""


@dataclass
class TaskResult(Message):
    dataset_name: str = ""
    task_id: int = -1
    err_message: str = ""


@dataclass
class DatasetShardParams(Message):
    batch_size: int = 0
    num_epochs: int = 1
    dataset_size: int = 0
    shuffle: bool = False
    num_minibatches_per_shard: int = 2
    dataset_name: str = ""
    task_type: str = ""
    storage_type: str = ""
    dataset_type: str = "table"


@dataclass
class ShardCheckpointRequest(Message):
    dataset_name: str = ""


@dataclass
class ShardCheckpoint(Message):
    content: str = ""


@dataclass
class DatasetTaskEnd(Message):
    dataset_name: str = ""


# --------------------------------------------------------------------------
# rendezvous
# --------------------------------------------------------------------------


@dataclass
class JoinRendezvousRequest(Message):
    node_id: int = 0
    node_rank: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""
    node_ip: str = ""
    # newest locally-restorable checkpoint step (-1 = none) and the
    # full set of restorable steps this host could load right now. The
    # master broadcasts the NEWEST step common to every member of the
    # formed round — a step some host lacks must never be forced, or
    # that host silently restores something older and the world splits.
    verified_ckpt_step: int = -1
    verified_ckpt_steps: list = field(default_factory=list)
    # join-time hardware probe (agent/probe.py run_probe): per-leg
    # millisecond timings the master's health gate judges against the
    # fleet median and this host's own persisted fingerprint before
    # admission. Empty = no probe ran (old agents, probe disabled):
    # the gate admits, preserving the pre-health-plane behavior.
    probe_report: dict = field(default_factory=dict)


@dataclass
class VerifiedStepsReport(Message):
    """Refresh one node's restorable-step set WITHOUT joining — the
    agent's post-failover re-registration (a join would dissolve the
    restored round and force a worker restart)."""

    node_rank: int = 0
    rdzv_name: str = ""
    steps: list = field(default_factory=list)


@dataclass
class CommWorldRequest(Message):
    node_id: int = 0
    rdzv_name: str = ""


@dataclass
class CommWorld(Message):
    """The assigned world for a rendezvous round.

    ``world`` maps node_rank -> local_world_size. For the TPU backend the
    master also designates the JAX coordination-service address
    (rank-0 host) — this replaces the torch TCPStore bootstrap.
    """

    rdzv_name: str = ""
    round: int = 0
    group: int = 0
    world: dict = field(default_factory=dict)
    coordinator_addr: str = ""
    # master-brokered restore-step consensus: the NEWEST checkpoint
    # step restorable on every member of the round (-1 = no forcing:
    # some member reported nothing, or no common step exists)
    restore_step: int = -1
    # reshape-first elasticity: per-member verdict for THIS round —
    # node_rank -> "reshape" (the host rode through the membership
    # change; its agent signals the live workers to rebuild the mesh in
    # process) | "restart" (fresh worker processes). ``departed`` maps
    # ranks that left the round to HOW they left: "drained" (host alive
    # at the drain point, shards readable device-to-device) vs "dead"
    # (its exclusively-held shards are lost; checkpoint fallback).
    verdicts: dict = field(default_factory=dict)
    departed: dict = field(default_factory=dict)


@dataclass
class DrainNodeRequest(Message):
    """Graceful scale-in: the platform scaler (or a preempted node's
    own agent, ahead of its shutdown) announces that ``node_rank`` is
    leaving the job while its host is still ALIVE. The rendezvous
    manager records the departure as "drained" — survivors reshape in
    place reading the leaver's shards device-to-device — instead of
    the "dead" a heartbeat-timeout removal forces (checkpoint fallback
    for anything the leaver exclusively held)."""

    node_rank: int = 0


@dataclass
class PreemptNoticeRequest(Message):
    """A doomed host relays its announced preemption (maintenance /
    spot notice, simulated by the ``preempt.notice`` chaos action):
    the platform will kill it at ``deadline``. The master's repair
    brain answers with a directive — ``drain`` means: checkpoint,
    report the drain, stop workers cleanly, and let survivors reshape
    around you before the kill lands."""

    node_rank: int = 0
    deadline: float = 0.0
    lead_s: float = 0.0


@dataclass
class PreemptNoticeDirective(Message):
    """The brain's answer to a preemption notice. ``action`` is
    ``"drain"`` (execute the predictive drain) or ``"none"`` (brain
    disabled / no plan — the unannounced-kill fallback path stands).
    ``plan_id`` is stable across re-sends of the same notice, so a
    master failover mid-plan re-serves the identical plan."""

    action: str = "none"
    plan_id: str = ""
    deadline: float = 0.0


@dataclass
class WaitingNodeNumRequest(Message):
    node_id: int = 0
    local_world_size: int = 1
    rdzv_name: str = ""


@dataclass
class WaitingNodeNum(Message):
    waiting_num: int = 0


# --------------------------------------------------------------------------
# node health / network (ICI/DCN mesh) check
# --------------------------------------------------------------------------


@dataclass
class NodeCheckResultRequest(Message):
    """Per-node result of one device-mesh probe round (matmul + collective
    timing). Equivalent of the reference report_network_status."""

    node_id: int = 0
    normal: bool = True
    elapsed_time: float = 0.0
    round: int = 0


@dataclass
class NetworkReadyRequest(Message):
    pass


@dataclass
class NetworkCheckResult(Message):
    normal: bool = True
    reason: str = ""
    nodes: list = field(default_factory=list)


@dataclass
class StragglerExistRequest(Message):
    pass


@dataclass
class HostProbeReport(Message):
    """In-band hardware re-probe result (agent monitor loop, governed
    cadence): the same per-leg report shipped at join, folded into the
    master's per-host fingerprint store so a sustained degradation
    becomes a ``diagnosis.hw_degraded`` verdict mid-run."""

    node_rank: int = 0
    report: dict = field(default_factory=dict)


@dataclass
class NodeHealthRequest(Message):
    """Query the health gate's standing verdict for one host — polled
    by an agent whose join did not land in a round, to tell a filling
    round apart from its own quarantine (and learn the re-probe
    backoff)."""

    node_rank: int = 0


@dataclass
class NodeHealthVerdict(Message):
    """The gate's answer: ``verdict`` is "pass" | "quarantine" |
    "refuse" | "unknown" (never probed). ``retry_after_s`` is the
    remaining backoff before a quarantined host's re-probe will be
    considered."""

    verdict: str = "unknown"
    reason: str = ""
    retry_after_s: float = 0.0
    strikes: int = 0


@dataclass
class NodeFailure(Message):
    node_id: int = 0
    error_data: str = ""
    level: str = ""
    restart_count: int = 0


# --------------------------------------------------------------------------
# node lifecycle / heartbeat / resource stats
# --------------------------------------------------------------------------


@dataclass
class HeartBeat(Message):
    node_id: int = 0
    timestamp: float = 0.0


@dataclass
class HeartbeatResponse(Message):
    action: str = ""  # "" | "restart" | "stop"


@dataclass
class ResourceStats(Message):
    node_id: int = 0
    cpu_percent: float = 0.0
    memory_mb: int = 0
    tpu_stats: list = field(default_factory=list)


@dataclass
class NodeMeta(Message):
    node_type: str = ""
    node_id: int = 0
    node_rank: int = -1
    addr: str = ""
    memory: int = 0
    cpu: float = 0.0
    tpu_chips: int = 0


# --------------------------------------------------------------------------
# training progress / metrics
# --------------------------------------------------------------------------


@dataclass
class GlobalStep(Message):
    timestamp: float = 0.0
    step: int = 0


# --------------------------------------------------------------------------
# elasticity / parallel config
# --------------------------------------------------------------------------


@dataclass
class DataLoaderConfig(Message):
    dataloader_name: str = ""
    batch_size: int = 0
    num_workers: int = 0
    pin_memory: bool = False
    version: int = 0


@dataclass
class ParallelConfigRequest(Message):
    pass


@dataclass
class ParallelConfig(Message):
    dataloader: DataLoaderConfig = field(default_factory=DataLoaderConfig)
    restart: bool = False
    # TPU: the mesh/sharding strategy the master asks workers to adopt on
    # the next restart (serialized accel.Strategy), if any.
    strategy: str = ""


@dataclass
class RdzvParamsReport(Message):
    """Agent-side rendezvous parameters (--nnodes lo:hi elasticity)."""

    min_nodes: int = 1
    max_nodes: int = 1
    waiting_timeout: float = 30.0
    node_unit: int = 1


@dataclass
class StreamingFeed(Message):
    """Producer reports new records (or end) of a streaming dataset."""

    dataset_name: str = ""
    count: int = 0
    end: bool = False


@dataclass
class PsVersionRequest(Message):
    # "global" | "local" | "restored" (master ElasticPsService)
    version_type: str = "global"


@dataclass
class PsVersionResponse(Message):
    version: int = 0


@dataclass
class PsVersionReport(Message):
    version_type: str = "local"
    version: int = 0


# --------------------------------------------------------------------------
# checkpoint coordination
# --------------------------------------------------------------------------


@dataclass
class CheckpointSyncRequest(Message):
    """Cross-node agreement that every agent persisted its shards of a
    given step (reference servicer._sync_checkpoint :571)."""

    node_id: int = 0
    step: int = 0


@dataclass
class CheckpointReadyRequest(Message):
    """Host-side all-rank-ready barrier before writing shm (replaces the
    reference's device collective in engine.check_all_rank_ready :51)."""

    node_id: int = 0
    step: int = 0
    ready: bool = True
    group: str = "default"
    world: int = 1


@dataclass
class BarrierResponse(Message):
    passed: bool = False
    # a participant reported ready=False (e.g. shm lock busy): peers
    # should stop waiting instead of burning the whole save timeout
    aborted: bool = False


# --------------------------------------------------------------------------
# elastic serving (continuous-batching decode pool)
# --------------------------------------------------------------------------


@dataclass
class ServeSubmitRequest(Message):
    """A generation request entering the serving front door. The
    master's request ledger (serving/manager.py) owns it from here:
    queued -> leased -> done, with exactly-once re-queue if the
    leasing decode worker dies."""

    request_id: str = ""
    prompt: list = field(default_factory=list)
    max_new_tokens: int = 16
    temperature: float = 0.0
    eos_id: int = -1


@dataclass
class ServeLeaseRequest(Message):
    """A decode worker with free slots pulls queued requests. The
    lease carries a deadline on the master side — a worker that dies
    stops reporting and its leases re-queue."""

    node_rank: int = 0
    max_requests: int = 1


@dataclass
class ServeLease(Message):
    requests: list = field(default_factory=list)  # request payload dicts
    queue_depth: int = 0


@dataclass
class ServeResultReport(Message):
    """A finished continuation. Only the CURRENT leaseholder's report
    lands (double-serve guard); a zombie worker's late report is
    acknowledged-and-dropped."""

    request_id: str = ""
    node_rank: int = 0
    tokens: list = field(default_factory=list)
    finish_reason: str = ""


@dataclass
class ServeStatusRequest(Message):
    pass


@dataclass
class ServeStatus(Message):
    """The ledger summary the dashboard/obs_report render: queue
    depth, live pool size, per-state counts, per-worker served."""

    summary: dict = field(default_factory=dict)


@dataclass
class ServeFetchRequest(Message):
    request_id: str = ""


@dataclass
class ServeResult(Message):
    request_id: str = ""
    state: str = "unknown"  # queued | leased | done | failed | unknown
    tokens: list = field(default_factory=list)
    finish_reason: str = ""


# --------------------------------------------------------------------------
# kv-store (the rendezvous store the workers share)
# --------------------------------------------------------------------------


@dataclass
class KeyValuePair(Message):
    key: str = ""
    value: bytes = b""


@dataclass
class KeyValueGetRequest(Message):
    key: str = ""


@dataclass
class KeyValueAddRequest(Message):
    key: str = ""
    delta: int = 0


@dataclass
class KeyValueAddResult(Message):
    value: int = 0


# --------------------------------------------------------------------------
# job control / sync service
# --------------------------------------------------------------------------


@dataclass
class SyncJoin(Message):
    sync_name: str = ""
    node_id: int = 0
    node_type: str = ""


@dataclass
class SyncFinish(Message):
    sync_name: str = ""


@dataclass
class SyncBarrierRequest(Message):
    sync_name: str = ""
    notify: bool = False


@dataclass
class JobEnd(Message):
    node_id: int = 0
    success: bool = True
    reason: str = ""


@dataclass
class ElasticRunConfigRequest(Message):
    pass


@dataclass
class ElasticRunConfig(Message):
    configs: dict = field(default_factory=dict)


@dataclass
class DiagnosisReport(Message):
    node_id: int = 0
    content: str = ""
    tag: str = ""


@dataclass
class DiagnosisRequest(Message):
    """Query the master's runtime diagnosis (master/diagnosis.py):
    current straggler and hang verdicts. Agents poll it each monitor
    tick; one naming this agent's host as hanging triggers a local
    flight-recorder dump."""

    node_rank: int = -1


@dataclass
class DiagnosisResult(Message):
    # node_rank -> {"phase": blamed phase, "ratio": ..., "z": ...}
    stragglers: dict = field(default_factory=dict)
    # node_rank -> {"stalled_s": ..., "last_step": ...}
    hangs: dict = field(default_factory=dict)
    # SLO watchdog breaches: "<rule>:<source>" -> {"rule": ..., ...}
    # (step-time regression, goodput floor, MFU drop, events dropped)
    slo: dict = field(default_factory=dict)
    # deep-capture directive assigned to the POLLING host (empty when
    # none): {"capture_id", "steps", "reason"} — delivery rides the
    # diagnosis poll agents already make every monitor tick, so a
    # capture needs no extra polling loop
    capture: dict = field(default_factory=dict)
    # sustained hardware degradation (health-plane fingerprints):
    # node_rank -> {"leg": worst leg, "ratio": vs own baseline, ...}
    hw: dict = field(default_factory=dict)


# --------------------------------------------------------------------------
# deep profiling: anomaly-triggered captures
# --------------------------------------------------------------------------


@dataclass
class ProfileCaptureRequest(Message):
    """Operator/tool-initiated deep capture (``tools/obs_report.py
    --capture``): ask the master's CaptureManager to direct
    ``node_rank``'s agent to capture ``steps`` steps of device trace
    plus the flight-recorder payload. Subject to the same rate-limit
    and one-in-flight discipline as anomaly-triggered captures."""

    node_rank: int = -1
    steps: int = 0
    reason: str = "operator"


@dataclass
class ProfileCaptureAck(Message):
    """The admission verdict: refusals carry WHY (cooldown, another
    capture in flight, manager disabled)."""

    capture_id: str = ""
    accepted: bool = False
    reason: str = ""


@dataclass
class CaptureListRequest(Message):
    pass


@dataclass
class CaptureList(Message):
    """The capture ledger (newest first): state machine position,
    artifact path, and the parsed summary incl. the attribution diff
    vs the stored op-cost baseline."""

    captures: list = field(default_factory=list)


@dataclass
class CaptureResultReport(Message):
    """The executing agent's outcome report. Exactly-once on the
    master: only the assigned host's first report lands; duplicates
    are acknowledged-and-dropped."""

    capture_id: str = ""
    node_rank: int = -1
    ok: bool = False
    artifact: str = ""
    summary: dict = field(default_factory=dict)
    error: str = ""


# --------------------------------------------------------------------------
# telemetry (metrics registry snapshots + job-wide report)
# --------------------------------------------------------------------------


@dataclass
class TelemetrySnapshot(Message):
    """One process's cumulative telemetry registry snapshot (see
    common/telemetry.py). Keyed by payload["source"]; re-sends are
    idempotent on the master side."""

    node_id: int = 0
    payload: dict = field(default_factory=dict)


@dataclass
class TelemetryReportRequest(Message):
    pass


@dataclass
class TelemetryReport(Message):
    """Job-wide merged view: goodput ledger, event timeline, metrics
    rollup, and the raw per-source snapshots (for client-side merges)."""

    payload: dict = field(default_factory=dict)


@dataclass
class MetricsQueryRequest(Message):
    """Query the master's tiered metrics store (the live metrics
    plane's history): one metric name across sources, at raw / 10 s /
    1 min resolution. Serves ``obs_report --live`` sparklines without
    re-shipping whole snapshots."""

    name: str = ""
    source: str = ""          # "" = every source
    resolution: str = "raw"   # raw | 10s | 1m
    since: float = 0.0        # wall-clock floor (0 = all retained)
    limit: int = 0            # newest N points (0 = all retained)


@dataclass
class MetricsSeries(Message):
    """Response: list of {source, name, labels, points}. Raw points
    are [t, value]; downsampled points are
    [t0, count, sum, min, max, last] per bucket."""

    series: list = field(default_factory=list)
