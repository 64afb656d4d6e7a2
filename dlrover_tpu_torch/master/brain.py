"""Elastic repair brain: observations become reshape-first ScalePlans.

Equivalent capability: the reference pairs its job master with a Brain
service — a historical-metrics resource optimizer whose scale plans the
operator executes (dlrover/go/brain; SURVEY.md §2.2). This repo owns
both halves it needs: the **sensor** (master/diagnosis.py straggler and
hang verdicts, master/metrics_store.py SLO breaches, the merged
telemetry ledger) and the **actuator** (restart-free reshape via
``RendezvousManager.drain_node`` + per-member reshape verdicts, and the
run-config channel into trainers). This module is the policy loop that
connects them — robustness-first, three policies:

- **Straggler eviction** — a straggler verdict (or a ``step_time``/
  ``mfu`` SLO breach naming the same host) that persists across
  :data:`PERSIST_SWEEPS` diagnosis sweeps, and is not job-wide,
  produces a drain+reshape plan around the slow host. A per-kind
  cooldown and a min-world floor mean the brain can never reshape the
  job to death.
- **Predictive drain** — a ``preempt.notice`` (simulated TPU
  maintenance/spot signal, relayed by the doomed host's agent) turns
  into a drain plan executed BEFORE the deadline kill lands: the agent
  flushes its shm checkpoint to storage and the rendezvous manager
  records a "drained" departure, so survivors reshape in process and
  the whole event lands in the ledger's ``reshape`` bucket instead of
  ``restart``. An unannounced kill keeps the unchanged restart path.
- **Goodput-aware checkpoint cadence** — a controller reading observed
  checkpoint cost and failure inter-arrival from the merged timeline
  and moving ``save_steps`` toward the Young/Daly optimum
  (``sqrt(2 * ckpt_cost * MTBF)``), within configured bounds, pushed
  to trainers over the existing run-config channel.

Every plan is a durable, idempotent state-store mutation: transitions
(``decided -> executing -> done | abandoned``) are WAL-logged with
ABSOLUTE plan state (replay is an upsert), and plans ride the master
snapshot — a master failover mid-plan re-serves the same plan (same
id, keyed dedup) and never double-fires. Actions emit ``brain.plan.*``
timeline events and ``brain.plans`` counters; the HTTP plane and
``obs_report`` render the recent-plan tail.

Lock discipline (dlint DL008 / dtsan): one leaf lock guards the plan
table and policy counters; it is NEVER held across a call into another
component (rendezvous drain, run-config swap, WAL append all happen
outside it).

The PyTorch port's copy of dlrover_tpu/master/brain.py.
"""

from __future__ import annotations

import dataclasses
import math
import os
import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.chaos import chaos_point
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# policy knobs (env-overridable for ops tuning without a deploy)
PERSIST_SWEEPS = int(os.environ.get("DLROVER_BRAIN_PERSIST_SWEEPS", "3"))
COOLDOWN_S = float(os.environ.get("DLROVER_BRAIN_COOLDOWN", "30"))
MIN_WORLD = int(os.environ.get("DLROVER_BRAIN_MIN_WORLD", "2"))
PLAN_TIMEOUT_S = float(os.environ.get("DLROVER_BRAIN_PLAN_TIMEOUT", "120"))
CADENCE_INTERVAL_S = float(
    os.environ.get("DLROVER_BRAIN_CADENCE_INTERVAL", "20")
)
CADENCE_MIN_STEPS = int(os.environ.get("DLROVER_BRAIN_CADENCE_MIN", "1"))
CADENCE_MAX_STEPS = int(os.environ.get("DLROVER_BRAIN_CADENCE_MAX", "500"))
# only republish a cadence that moved by more than this fraction — the
# controller must converge, not thrash trainers with ±1-step updates
CADENCE_DEADBAND = 0.25
# distinct failure instants are clustered within this window (a notice
# followed by its own deadline kill is ONE failure, not two)
_FAILURE_CLUSTER_S = 30.0

# serving pool policy: queue depth above this for PERSIST_SWEEPS
# consecutive sweeps (or a standing serve_* SLO breach) is sustained
# load pressure -> a scale-out plan for the decode pool
SERVE_QUEUE_HOT = int(os.environ.get("DLROVER_BRAIN_SERVE_QUEUE", "8"))
# the serving SLO rules that count as pool pressure through the
# watchdog sensor (metrics_store.SloWatchdog)
_SERVE_SLO_RULES = ("serve_ttft_p99", "serve_queue_depth")

# the run-config key trainers poll for (Trainer._maybe_adopt_cadence)
CADENCE_CONFIG_KEY = "ckpt_save_steps"

PLAN_STATES = ("decided", "executing", "done", "abandoned")


@dataclasses.dataclass
class ScalePlan:
    """One durable brain decision. ``key`` is the idempotency handle:
    while a plan with the same key is standing (decided/executing), a
    re-observed trigger re-serves it instead of minting a sibling."""

    plan_id: str = ""
    kind: str = ""          # evict_straggler | predictive_drain | cadence
    target: int = -1        # node rank (-1: job-wide, e.g. cadence)
    state: str = "decided"
    key: str = ""
    created: float = 0.0
    updated: float = 0.0
    deadline: float = 0.0   # abandon past this wall-clock time
    detail: dict = dataclasses.field(default_factory=dict)

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, payload: dict) -> "ScalePlan":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in payload.items() if k in fields})

    @property
    def standing(self) -> bool:
        return self.state in ("decided", "executing")


def _source_rank(source: str) -> int | None:
    """``<role>-<rank>-<pid>`` -> rank (the TelemetryRegistry source
    convention diagnosis already parses)."""
    parts = str(source).rsplit("-", 2)
    if len(parts) != 3:
        return None
    try:
        return int(parts[1])
    except ValueError:
        return None


class RepairBrain:
    """The policy engine. Rides the DiagnosisManager's rate-limited
    sweep (``sweep``); preemption notices arrive via the servicer
    (``handle_preempt_notice``)."""

    # recent-plan tail length for dashboards/obs_report
    RECENT_PLANS = 16

    def __init__(
        self,
        servicer=None,
        rdzv_manager=None,
        wal_fn=None,
        dirty_fn=None,
        persist_sweeps: int = PERSIST_SWEEPS,
        cooldown_s: float = COOLDOWN_S,
        min_world: int = MIN_WORLD,
        plan_timeout_s: float = PLAN_TIMEOUT_S,
        cadence_interval_s: float = CADENCE_INTERVAL_S,
        cadence_bounds: tuple[int, int] = (
            CADENCE_MIN_STEPS, CADENCE_MAX_STEPS,
        ),
        enabled: bool | None = None,
        serve_queue_hot: int = SERVE_QUEUE_HOT,
    ):
        self._servicer = servicer
        self._rdzv = rdzv_manager
        # durability hooks: the servicer passes its state-store
        # passthroughs; None (no state dir) degrades to in-memory plans
        self._wal_fn = wal_fn
        self._dirty_fn = dirty_fn
        self._persist_sweeps = max(persist_sweeps, 1)
        self._cooldown = cooldown_s
        self._min_world = max(min_world, 1)
        self._plan_timeout = plan_timeout_s
        self._cadence_interval = cadence_interval_s
        self._cadence_bounds = cadence_bounds
        # DLROVER_BRAIN=0 turns every policy off (the "brain off"
        # comparison arm) while keeping the surfaces (summary, events)
        # alive, so on/off runs differ only in decisions taken
        self.enabled = (
            enabled
            if enabled is not None
            else os.environ.get("DLROVER_BRAIN", "1").strip().lower()
            not in ("0", "false", "off", "no")
        )
        # one leaf lock for plan/policy state; NEVER held across a call
        # into another component (rendezvous, run configs, WAL)
        self._lock = threading.Lock()
        self._plans: dict[str, ScalePlan] = {}
        self._seq = 0
        # rank -> consecutive sweeps it was named slow (verdict or SLO)
        self._suspect_streak: dict[int, int] = {}
        # kind -> wall clock of the last plan decided (cooldowns)
        self._last_plan_t: dict[str, float] = {}
        self._last_cadence_t = 0.0
        self._cadence_published = 0
        # serving pool policy: consecutive sweeps the decode queue (or
        # a serve_* SLO breach) showed sustained pressure
        self._serve_queue_hot = max(int(serve_queue_hot), 1)
        self._pool_streak = 0

    # ------------------------------------------------------------ plumbing

    def _wal(self, plan: ScalePlan):
        wal = self._wal_fn
        if wal is not None:
            # absolute plan state + the id counter: replay is an upsert
            # and can never re-mint ids a lost decision already used
            wal("brain_plan", plan=plan.to_json(), brain_seq=self._seq)
        dirty = self._dirty_fn
        if dirty is not None:
            dirty()

    def _emit(self, plan: ScalePlan, transition: str):
        telemetry.event(
            f"brain.plan.{transition}",
            plan=plan.plan_id,
            # NOT ``kind=``: that is the event-kind key itself
            plan_kind=plan.kind,
            target=plan.target,
            **{
                k: v for k, v in plan.detail.items()
                if isinstance(v, (int, float, str, bool))
            },
        )
        telemetry.counter_inc(
            "brain.plans", kind=plan.kind, state=transition
        )
        logger.info(
            "brain plan %s [%s] -> %s (target=%s detail=%s)",
            plan.plan_id, plan.kind, transition, plan.target,
            plan.detail,
        )

    def _decide(
        self, kind: str, target: int, key: str, now: float,
        detail: dict | None = None,
    ) -> tuple[ScalePlan, bool]:
        """Idempotent decide: a STANDING plan with the same key is
        re-served (False = pre-existing); otherwise a new plan is
        minted, WAL-logged and announced."""
        with self._lock:
            for plan in self._plans.values():
                if plan.key == key and plan.standing:
                    return plan, False
            self._seq += 1
            plan = ScalePlan(
                plan_id=f"plan-{self._seq}",
                kind=kind,
                target=target,
                state="decided",
                key=key,
                created=now,
                updated=now,
                deadline=now + self._plan_timeout,
                detail=dict(detail or {}),
            )
            self._plans[plan.plan_id] = plan
            self._last_plan_t[kind] = now
            snapshot = dataclasses.replace(
                plan, detail=dict(plan.detail)
            )
        self._wal(snapshot)
        self._emit(snapshot, "decided")
        return plan, True

    def _transition(self, plan: ScalePlan, state: str, **detail):
        with self._lock:
            if plan.state == state:
                return
            plan.state = state
            plan.updated = time.time()
            plan.detail.update(detail)
            snapshot = dataclasses.replace(
                plan, detail=dict(plan.detail)
            )
        self._wal(snapshot)
        self._emit(snapshot, state)

    # ------------------------------------------------------------- actuator

    def _world_view(self) -> tuple[int, list[int], dict, dict]:
        """(round, members, verdicts, departed) of the latest formed
        round — the brain's picture of who is in the job."""
        rdzv = self._rdzv
        if rdzv is None:
            return 0, [], {}, {}
        round_, members = rdzv.latest_members()
        verdicts, departed = rdzv.round_verdicts(round_)
        return round_, members, verdicts, departed

    def _execute_drain(self, plan: ScalePlan):
        """Fire the actuator: a drain verdict for the target host so
        survivors reshape in process. Idempotent — draining a rank that
        already left the round is a no-op in the rendezvous manager."""
        # plan-execution seam: schedules can error/delay/kill exactly
        # between decision and actuation (the failover window the plan
        # WAL exists for)
        chaos_point("brain.plan", kind=plan.kind, rank=plan.target)
        rdzv = self._rdzv
        if rdzv is not None:
            rdzv.drain_node(plan.target)
        self._transition(plan, "executing")

    # -------------------------------------------------------------- sweep

    def sweep(self, verdicts: dict, now: float | None = None):
        """One policy pass, riding the DiagnosisManager's rate-limited
        check: update suspect streaks, progress standing plans, decide
        evictions, run the cadence controller."""
        now = time.time() if now is None else now
        self._progress_plans(now)
        if not self.enabled:
            return
        self._update_suspects(verdicts)
        self._maybe_evict(now)
        self._maybe_scale_pool(verdicts, now)
        self._maybe_retune_cadence(now)

    def _update_suspects(self, verdicts: dict):
        named: set[int] = set()
        for rank in (verdicts.get("stragglers") or {}):
            named.add(int(rank))
        # an SLO breach naming a specific source's step time / MFU is
        # the same "this host got slow" signal through the other sensor
        for key, info in (verdicts.get("slo") or {}).items():
            if str(info.get("rule", "")) not in (
                "step_time_regression", "mfu_drop",
            ):
                continue
            rank = _source_rank(info.get("source", ""))
            if rank is not None:
                named.add(rank)
        # hardware-degradation verdicts (health plane probe timings)
        # were ALREADY debounced by the health manager's own
        # persistence streak before they surface here, so they enter
        # at eviction strength instead of re-serving the sweeps the
        # probe already counted
        hw_named = {int(r) for r in (verdicts.get("hw") or {})}
        named |= hw_named
        with self._lock:
            for rank in named:
                streak = self._suspect_streak.get(rank, 0) + 1
                if rank in hw_named:
                    streak = max(streak, self._persist_sweeps)
                self._suspect_streak[rank] = streak
            for rank in list(self._suspect_streak):
                if rank not in named:
                    del self._suspect_streak[rank]

    def _maybe_evict(self, now: float):
        round_, members, _verdicts, _departed = self._world_view()
        if not members:
            return
        with self._lock:
            candidates = [
                r for r, streak in self._suspect_streak.items()
                if streak >= self._persist_sweeps and r in members
            ]
            suspects = len(self._suspect_streak)
            last = self._last_plan_t.get("evict_straggler", 0.0)
        if not candidates:
            return
        # job-wide slowness is a job-level event (fleet recompile, bad
        # data feed), not a host to shoot
        if suspects >= len(members):
            return
        if now - last < self._cooldown:
            return
        if len(members) - 1 < self._min_world:
            logger.warning(
                "brain: straggler %s persists but evicting would drop "
                "the world below %d; holding", candidates[0],
                self._min_world,
            )
            return
        target = sorted(candidates)[0]
        plan, _fresh = self._decide(
            "evict_straggler", target,
            key=f"evict:{target}:{round_}", now=now,
            detail={"round": round_, "world": len(members)},
        )
        if plan.standing:
            # re-firing while standing is safe (drain_node of a rank
            # already out of the round is a no-op) and REQUIRED after
            # a failover: the restored rendezvous state may predate
            # the pre-crash drain
            self._execute_drain(plan)

    def _maybe_scale_pool(self, verdicts: dict, now: float):
        """Elasticity driven by LOAD, not failures: sustained decode
        queue depth (or a standing serving SLO breach — TTFT p99 /
        queue ceiling through the watchdog sensor) turns into a
        WAL-durable scale-out plan for the decode pool. The plan's
        actuator is the platform scaler (or the operator) adding a
        worker; it completes when the ledger sees the pool at the
        planned size, and abandons past its deadline like every other
        plan."""
        servicer = self._servicer
        serving = getattr(servicer, "serving", None)
        if serving is None:
            return
        depth = serving.queue_depth()
        slo = verdicts.get("slo") or {}
        hot = depth > self._serve_queue_hot or any(
            str(info.get("rule", "")) in _SERVE_SLO_RULES
            for info in slo.values()
        )
        with self._lock:
            self._pool_streak = self._pool_streak + 1 if hot else 0
            streak = self._pool_streak
            last = self._last_plan_t.get("scale_decode_pool", 0.0)
            # one standing scale-out at a time: the key below is
            # derived from the LIVE pool size, so a pool dip while a
            # plan is pending would otherwise mint a sibling with a
            # different target
            pending = any(
                p.kind == "scale_decode_pool" and p.standing
                for p in self._plans.values()
            )
        if pending:
            return
        if streak < self._persist_sweeps:
            return
        if now - last < self._cooldown:
            return
        pool = serving.pool_size()
        want = pool + 1
        plan, fresh = self._decide(
            "scale_decode_pool", -1,
            # keyed by the target size: re-observed pressure while the
            # scale-out is pending re-serves the same plan instead of
            # minting a sibling every sweep
            key=f"serve_pool:{want}", now=now,
            detail={
                "pool": pool,
                "want": want,
                "queue_depth": depth,
                "slo_keys": ",".join(sorted(
                    k for k, i in slo.items()
                    if str(i.get("rule", "")) in _SERVE_SLO_RULES
                )),
            },
        )
        if fresh:
            telemetry.gauge_set("brain.serve.pool_want", want)

    def _progress_plans(self, now: float):
        """Standing plans complete when a round formed after the
        decision no longer carries the target (or records its drained
        departure / a fresh restart join of its replacement); they
        abandon past their deadline."""
        round_, members, verdicts, departed = self._world_view()
        with self._lock:
            standing = [
                p for p in self._plans.values() if p.standing
            ]
        for plan in standing:
            if plan.kind == "scale_decode_pool":
                serving = getattr(self._servicer, "serving", None)
                want = int(plan.detail.get("want", 0))
                if serving is not None and want and \
                        serving.pool_size() >= want:
                    self._transition(
                        plan, "done", pool=serving.pool_size()
                    )
                    with self._lock:
                        self._pool_streak = 0
                    continue
                if now > plan.deadline:
                    self._transition(
                        plan, "abandoned", reason="timeout"
                    )
                continue
            if plan.kind == "cadence":
                # cadence plans complete at publish time; a standing
                # one (failover inside the decide->publish window whose
                # recompute never re-converges on the same value) only
                # ages out here
                if now > plan.deadline:
                    self._transition(
                        plan, "abandoned", reason="timeout"
                    )
                continue
            decide_round = int(plan.detail.get("round", -1))
            if round_ > decide_round and round_ > 0:
                gone = plan.target not in members
                drained = departed.get(plan.target) == "drained"
                rejoined = verdicts.get(plan.target) == "restart"
                if gone or drained or rejoined:
                    self._transition(
                        plan, "done", completed_round=round_,
                    )
                    with self._lock:
                        self._suspect_streak.pop(plan.target, None)
                    continue
            if now > plan.deadline:
                self._transition(plan, "abandoned", reason="timeout")

    # ------------------------------------------------- predictive drain

    def handle_preempt_notice(
        self, rank: int, deadline: float, lead_s: float = 0.0,
    ) -> dict:
        """A doomed host announced its preemption. Decide (or re-serve
        — same key, same plan id, exactly once) a predictive-drain
        plan, fire the drain verdict so survivors reshape while the
        host checkpoints, and hand the agent its directive."""
        now = time.time()
        telemetry.event(
            "brain.preempt.notice", rank=rank,
            lead=round(max(lead_s, 0.0), 3),
        )
        if not self.enabled:
            return {"action": "none", "plan_id": "", "deadline": deadline}
        round_, members, _v, _d = self._world_view()
        plan, _fresh = self._decide(
            "predictive_drain", int(rank),
            # keyed by (rank, deadline second): a re-sent notice after
            # a master failover re-serves the SAME plan, a later
            # distinct notice for the same host gets a fresh one
            key=f"preempt:{int(rank)}:{int(deadline)}",
            now=now,
            detail={
                "round": round_,
                "deadline_wall": round(deadline, 3),
                "lead_s": round(max(lead_s, 0.0), 3),
            },
        )
        if plan.standing:
            # idempotent re-fire: after a failover the restored
            # rendezvous state may predate the pre-crash drain, so a
            # re-sent notice must re-drive the actuator, never just
            # echo the plan id
            self._execute_drain(plan)
        return {
            "action": "drain",
            "plan_id": plan.plan_id,
            "deadline": deadline,
        }

    # ------------------------------------------------- cadence controller

    def _maybe_retune_cadence(self, now: float):
        with self._lock:
            if now - self._last_cadence_t < self._cadence_interval:
                return
            self._last_cadence_t = now
        servicer = self._servicer
        if servicer is None:
            return
        snaps = servicer.telemetry.snapshots()
        steps = self.compute_cadence(
            snaps, servicer.telemetry.ledger(now=now)
        )
        if steps is None:
            return
        with self._lock:
            published = self._cadence_published
        current = int(
            servicer.get_run_configs().get(CADENCE_CONFIG_KEY, 0) or 0
        )
        baseline = current or published
        if baseline and abs(steps - baseline) <= (
            CADENCE_DEADBAND * baseline
        ):
            return
        plan, _fresh = self._decide(
            "cadence", -1, key=f"cadence:{steps}", now=now,
            detail={"save_steps": steps, "was": baseline},
        )
        if not plan.standing:
            return
        # a STANDING re-served plan publishes too: a master that died
        # between the decision WAL record and the run-config publish
        # restores the plan standing, and re-publishing is idempotent —
        # bailing on "not fresh" would wedge the plan forever
        chaos_point("brain.plan", kind="cadence", rank=-1)
        configs = servicer.get_run_configs()
        configs[CADENCE_CONFIG_KEY] = steps
        servicer.set_run_configs(configs)
        dirty = self._dirty_fn
        if dirty is not None:
            dirty()
        with self._lock:
            self._cadence_published = steps
        telemetry.gauge_set("brain.cadence.save_steps", steps)
        # the run-config swap IS the execution; trainers adopt on their
        # next poll, so the plan is done the moment it is published
        self._transition(plan, "done")

    def compute_cadence(self, snaps, ledger) -> int | None:
        """Young/Daly optimum from OBSERVED history: save_steps ~=
        sqrt(2 * ckpt_cost * MTBF) / step_time. None = not enough
        evidence (no checkpoint cost, no steady steps, or no failure
        ever observed — a config the operator set must not move on
        zero data)."""
        ckpt_durs: list[float] = []
        step_durs: list[float] = []
        failure_ts: list[float] = []
        for snap in snaps:
            for ev in snap.get("events", ()):
                kind = ev.get("kind")
                if kind == "ckpt.save" and ev.get("dur"):
                    ckpt_durs.append(float(ev["dur"]))
                elif kind == "step.end" and ev.get("dur"):
                    step_durs.append(float(ev["dur"]))
                elif kind in ("worker.exit", "preempt.notice") or (
                    kind == "chaos.fire"
                    and ev.get("action") == "kill"
                ):
                    failure_ts.append(float(ev.get("t", 0.0)))
        total_s = float(ledger.get("total_s", 0.0) or 0.0)
        if not ckpt_durs or not step_durs or total_s <= 0:
            return None
        # cluster failure instants: a notice and its own deadline kill
        # are one failure, not two
        failures = 0
        last = -1e18
        for t in sorted(failure_ts):
            if t - last > _FAILURE_CLUSTER_S:
                failures += 1
                last = t
        if failures == 0:
            return None
        mtbf = total_s / failures
        cost = telemetry.median_baseline(ckpt_durs[-64:])
        step_s = telemetry.median_baseline(step_durs[-64:])
        if cost <= 0 or step_s <= 0:
            return None
        interval_s = math.sqrt(2.0 * cost * mtbf)
        lo, hi = self._cadence_bounds
        steps = int(round(interval_s / step_s))
        return max(lo, min(steps, hi))

    # ------------------------------------------------------- durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "seq": self._seq,
                "plans": [
                    p.to_json() for p in self._plans.values()
                ],
                "cadence_published": self._cadence_published,
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._seq = max(self._seq, int(state.get("seq", 0)))
            for payload in state.get("plans") or ():
                plan = ScalePlan.from_json(payload)
                if plan.plan_id:
                    self._plans[plan.plan_id] = plan
            self._cadence_published = int(
                state.get("cadence_published", 0)
            )
        logger.info(
            "brain restored %d plan(s), seq=%d",
            len(state.get("plans") or ()), self._seq,
        )

    def replay_plan(self, payload: dict, seq: int | None = None):
        """WAL replay: absolute plan state, upsert by id — replaying a
        record the snapshot already covers is a no-op by construction
        (same absolute state), and the id counter only moves forward."""
        plan = ScalePlan.from_json(payload)
        if not plan.plan_id:
            return
        with self._lock:
            held = self._plans.get(plan.plan_id)
            if held is None or plan.updated >= held.updated:
                self._plans[plan.plan_id] = plan
            if seq is not None:
                self._seq = max(self._seq, int(seq))
            else:
                try:
                    self._seq = max(
                        self._seq, int(plan.plan_id.split("-")[1])
                    )
                except (IndexError, ValueError):
                    pass

    # -------------------------------------------------------- reporting

    def plans(self) -> list[ScalePlan]:
        with self._lock:
            return sorted(
                self._plans.values(), key=lambda p: p.created
            )

    def recent_plans(self, k: int | None = None) -> list[dict]:
        k = self.RECENT_PLANS if k is None else k
        return [p.to_json() for p in self.plans()[-k:]][::-1]

    def summary(self) -> dict:
        """Dashboard/metrics payload: per-state counts + the recent
        plan tail + the published cadence."""
        plans = self.plans()
        states = {s: 0 for s in PLAN_STATES}
        for p in plans:
            states[p.state] = states.get(p.state, 0) + 1
        with self._lock:
            cadence = self._cadence_published
        return {
            "enabled": self.enabled,
            "states": states,
            "total": len(plans),
            "cadence_save_steps": cadence,
            "recent": self.recent_plans(),
        }
