"""Seeded, deterministic chaos injection.

Equivalent capability: the reference validates fault tolerance with
ad-hoc mocks (``MOCK_ERR_RANK`` in node_check/utils.py:50) and manual
kill experiments; CheckFreq-style checkpoint-consistency work shows that
recovery invariants only hold when failures are injected *systematically*.
This module is the one place every fault comes from: named **fault
sites** threaded through the control plane (``rpc.send``, ``rpc.recv``,
``ipc.request``, ``agent.spawn``, ``ckpt.write``, ``ckpt.manifest``,
``ckpt.save``, ``rdzv.join``, ``master.kill``, ``elastic.signal``,
``elastic.reshape``, ``preempt.notice``, ``brain.plan``,
``serve.admit``, ``serve.step``, ``probe.degrade``) consult a
seeded schedule
that can drop or
delay RPC frames, kill or hang a process at a chosen step, tear a
checkpoint payload mid-shard, bit-flip persisted bytes — or announce a
preemption: the ``notice`` action (simulated TPU maintenance/spot
signal) records a pending-preemption notice with a seeded lead time
and arms a timer that kills the process at the deadline whether or not
anyone listened. Consumers (the training agent's monitor loop) poll
:func:`take_preempt_notice` and get the lead window to checkpoint and
drain; an unconsumed notice is just an unannounced kill.

Determinism contract: a schedule carries one ``seed``; every rule draws
from its own ``random.Random`` derived from (seed, rule index), so the
fire pattern depends only on the schedule and the per-site call
sequence — never on thread interleaving across *different* rules, wall
time, or PYTHONHASHSEED.

No-op contract: unless ``DLROVER_CHAOS`` is set (read ONCE at import),
``chaos_point``/``chaos_transform`` are a module-global load plus an
``is None`` branch — no env reads, no locks, no registry work in the
hot path. Production binaries pay one predictable branch (plus the
call-site kwargs) per site, all of which sit on paths already dominated
by socket or disk IO.

Enabling: ``DLROVER_CHAOS`` may be inline JSON (``{"seed":7,"rules":
[...]}``), ``@/path/to/schedule.json``, or the name of a schedule in
:data:`NAMED_SCHEDULES`. In-process tests use :func:`install` /
:func:`uninstall`; subprocess workers inherit the env var and arm
themselves at import.

Rule fields (all optional except ``site`` and ``action``)::

    site:   fault-site name, e.g. "rpc.send"
    action: drop | disconnect | delay | hang | kill | error | notice
            | degrade                  (degrade: hardware-degradation
            sites, e.g. "probe.degrade" inside the health probe's
            timed legs — sleeps ``delay`` seconds scaled by a seeded
            per-rule jitter, so a rank-anchored rule makes exactly
            that host's measured timings look slow)
            | tear | bitflip           (tear/bitflip: transform sites)
    prob:   fire probability per matching call (default 1.0, seeded)
    step:   only fire when the site reports this training step
    verb:   only fire for this RPC verb ("get"/"report")
    msg:    only fire for these message type names (str or list)
    rank:   only fire when the site reports this node rank (preempt
            notices target one host of a multi-host schedule)
    at:     only fire once the site reports ``elapsed`` >= this many
            seconds (sites that pass elapsed time, e.g. the agent's
            preempt.notice poll) — time-anchored events stay aligned
            across comparison arms whose step rates differ
    after:  skip the first N matching calls
    every:  fire on the first eligible call and every k-th thereafter
            (eligible calls 1, 1+k, 1+2k, ...; default 1 = all)
    max:    stop after this many fires (default unlimited)
    delay:  seconds for delay/hang (default 0.2 / 3600)
    frac:   fraction of payload kept by tear (default 0.5)
    exit_code: status for kill (default 137)
    lead:   notice lead time in seconds — a number, or [lo, hi] for a
            seeded-deterministic draw from the rule's own RNG
            (default 10.0)
    enforce: notice only — False records the notice without arming the
            deadline kill timer (in-process policy tests; default True)

The PyTorch port's copy of dlrover_tpu/common/chaos.py: the same
sites, actions and ``DLROVER_CHAOS`` schedules.
"""

from __future__ import annotations

import json
import os
import random
import threading
import time
from collections import deque

from dlrover_tpu_torch.common import telemetry, tracing
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

ENV_VAR = "DLROVER_CHAOS"

_HANG_SECONDS = 3600.0
_KILL_EXIT_CODE = 137


class ChaosError(ConnectionError):
    """Injected transport-level fault.

    Subclasses ConnectionError so every existing retry/reconnect path
    treats an injected drop exactly like a real dead peer — the whole
    point is to exercise those paths, not to add a parallel one."""


class ChaosRule:
    """One (site, action) schedule entry with its own seeded RNG."""

    _CONTROL_ACTIONS = (
        "drop", "disconnect", "delay", "hang", "kill", "error",
        "notice", "degrade",
    )
    _TRANSFORM_ACTIONS = ("tear", "bitflip")

    def __init__(self, spec: dict, seed: int, index: int):
        self.site = spec["site"]
        self.action = spec["action"]
        if self.action not in (
            self._CONTROL_ACTIONS + self._TRANSFORM_ACTIONS
        ):
            raise ValueError(f"unknown chaos action {self.action!r}")
        self.prob = float(spec.get("prob", 1.0))
        self.step = spec.get("step")
        self.verb = spec.get("verb")
        msg = spec.get("msg")
        self.msg = (msg,) if isinstance(msg, str) else (
            tuple(msg) if msg else None
        )
        self.after = int(spec.get("after", 0))
        self.every = max(int(spec.get("every", 1)), 1)
        self.max_fires = spec.get("max")
        self.delay = float(
            spec.get(
                "delay", _HANG_SECONDS if self.action == "hang" else 0.2
            )
        )
        self.frac = float(spec.get("frac", 0.5))
        self.exit_code = int(spec.get("exit_code", _KILL_EXIT_CODE))
        self.rank = spec.get("rank")
        self.at = spec.get("at")
        # notice lead: a number, or [lo, hi] drawn from the rule RNG at
        # fire time (seeded-deterministic like every other draw here)
        self.lead = spec.get("lead", 10.0)
        self.enforce = bool(spec.get("enforce", True))
        # rule-local RNG: interleaving with OTHER rules can't perturb
        # this rule's draw sequence
        self._rng = random.Random(seed * 1000003 + index)
        self._calls = 0
        self._fires = 0

    def _matches_ctx(self, ctx: dict) -> bool:
        if self.step is not None and ctx.get("step") != self.step:
            return False
        if self.verb is not None and ctx.get("verb") != self.verb:
            return False
        if self.msg is not None and ctx.get("msg") not in self.msg:
            return False
        if self.rank is not None and ctx.get("rank") != self.rank:
            return False
        if self.at is not None and float(
            ctx.get("elapsed", 0.0) or 0.0
        ) < float(self.at):
            return False
        return True

    def draw_lead(self) -> float:
        """Notice lead time for THIS fire: fixed, or a seeded draw
        from [lo, hi] — rule-local RNG, so the lead pattern replays
        exactly with the schedule."""
        if isinstance(self.lead, (list, tuple)):
            lo, hi = float(self.lead[0]), float(self.lead[1])
            return lo + (hi - lo) * self._rng.random()
        return float(self.lead)

    def should_fire(self, ctx: dict) -> bool:
        """Call-counting + probability draw; caller holds registry lock."""
        if not self._matches_ctx(ctx):
            return False
        if self.max_fires is not None and self._fires >= self.max_fires:
            return False
        self._calls += 1
        if self._calls <= self.after:
            return False
        if (self._calls - self.after - 1) % self.every != 0:
            return False
        if self.prob < 1.0 and self._rng.random() >= self.prob:
            return False
        self._fires += 1
        return True

    # ----------------------------------------------------------- actions

    def apply(self, site: str, ctx: dict):
        if self.action in ("drop", "disconnect", "error"):
            raise ChaosError(
                f"chaos[{self.action}] at {site} (ctx={ctx})"
            )
        if self.action in ("delay", "hang"):
            time.sleep(self.delay)
            return
        if self.action == "degrade":
            # scaled perturbation, not a fixed stall: the sleep jitters
            # around ``delay`` via the rule's own RNG, so a degraded
            # host's probe legs look *noisily* slow (like real thermal
            # or HBM trouble) while the fire pattern stays replayable
            time.sleep(self.delay * (0.75 + 0.5 * self._rng.random()))
            return
        if self.action == "kill":
            logger.warning(
                "chaos[kill] at %s (ctx=%s): exiting %d",
                site, ctx, self.exit_code,
            )
            try:
                # os._exit skips atexit AND signal handlers: dump the
                # flight recorder (last spans/events + thread stacks)
                # and persist the telemetry snapshot NOW, or the kill
                # (and everything before it) vanishes from both the
                # merged timeline and the post-mortem
                from dlrover_tpu_torch.common import flight

                flight.dump("chaos-kill", site=site, chaos_ctx=ctx)
                telemetry.flush()
            except Exception:  # noqa: BLE001 - dying anyway
                pass
            os._exit(self.exit_code)

    def apply_transform(self, data, site: str, ctx: dict):
        raw = bytes(data)
        if self.action == "tear":
            keep = int(len(raw) * self.frac)
            logger.warning(
                "chaos[tear] at %s: truncating %d -> %d bytes (ctx=%s)",
                site, len(raw), keep, ctx,
            )
            return raw[:keep]
        if self.action == "bitflip":
            if not raw:
                return raw
            pos = self._rng.randrange(len(raw))
            flipped = bytearray(raw)
            flipped[pos] ^= 0x40
            logger.warning(
                "chaos[bitflip] at %s: byte %d of %d (ctx=%s)",
                site, pos, len(raw), ctx,
            )
            return bytes(flipped)
        # a control action listed on a transform site degrades to its
        # control behavior (kill/hang during a write is a legit tear)
        self.apply(site, ctx)
        return bytes(data)


class ChaosRegistry:
    """Process-global schedule: all sites consult one instance."""

    # recent-fires tail kept for assertions; counts are exact forever
    MAX_FIRED_LOG = 1024

    def __init__(self, schedule: dict):
        self.seed = int(schedule.get("seed", 0))
        self.rules = [
            ChaosRule(spec, self.seed, i)
            for i, spec in enumerate(schedule.get("rules", []))
        ]
        self._lock = threading.Lock()
        # (site, action, ctx) tail so tests/tools can assert what fired
        # — BOUNDED: an hours-long soak with a probability rule must not
        # grow agent memory linearly with fires
        self.fired: "deque[tuple[str, str, dict]]" = deque(
            maxlen=self.MAX_FIRED_LOG
        )
        self._counts: dict[str, int] = {}
        # announced preemptions: notices recorded by the "notice"
        # action, consumed (once each) via take_preempt_notice; the
        # deadline kill timers so uninstall() can disarm them
        self._notices: list[dict] = []
        self._timers: list[threading.Timer] = []

    def _select(self, site: str, ctx: dict) -> list[ChaosRule]:
        with self._lock:
            out = []
            for rule in self.rules:
                if rule.site != site:
                    continue
                if rule.should_fire(ctx):
                    self.fired.append((site, rule.action, dict(ctx)))
                    key = f"{site}:{rule.action}"
                    self._counts[key] = self._counts.get(key, 0) + 1
                    # tag the fire with the ACTIVE trace/span: a fault
                    # injected mid-restore (or mid-rendezvous) is then
                    # attributable to the exact span it perturbed in
                    # the obs_report --trace view
                    span_ctx = tracing.current() or {}
                    telemetry.event(
                        "chaos.fire", site=site, action=rule.action,
                        step=ctx.get("step"),
                        trace=span_ctx.get("trace", ""),
                        span=span_ctx.get("span", ""),
                    )
                    telemetry.counter_inc(
                        "chaos.fires", site=site, action=rule.action
                    )
                    out.append(rule)
            return out

    def fire(self, site: str, ctx: dict):
        # apply OUTSIDE the lock: delay/hang must not serialize other
        # sites, and kill would orphan the lock
        for rule in self._select(site, ctx):
            if rule.action == "notice":
                self._schedule_preemption(rule, site, ctx)
            else:
                rule.apply(site, ctx)

    def transform(self, site: str, data, ctx: dict):
        for rule in self._select(site, ctx):
            data = rule.apply_transform(data, site, ctx)
        return data

    def summary(self) -> dict:
        with self._lock:
            return dict(self._counts)

    # ------------------------------------------- announced preemptions

    def _schedule_preemption(self, rule: ChaosRule, site: str, ctx: dict):
        """The ``notice`` action: record a pending-preemption notice
        with a seeded lead, and (unless ``enforce: false``) arm a
        timer that kills this process at the deadline — the kill lands
        whether or not anyone consumed the notice, exactly like a real
        maintenance/spot preemption."""
        lead = rule.draw_lead()
        notice = {
            "site": site,
            "deadline": time.time() + lead,
            "lead": lead,
            "exit_code": rule.exit_code,
            "ctx": dict(ctx),
            "taken": False,
        }
        with self._lock:
            self._notices.append(notice)
        logger.warning(
            "chaos[notice] at %s: preemption announced, kill in %.2fs "
            "(enforce=%s, ctx=%s)", site, lead, rule.enforce, ctx,
        )
        telemetry.event(
            "chaos.preempt.notice", site=site, lead=round(lead, 3),
            rank=ctx.get("rank"), enforced=rule.enforce,
        )
        if rule.enforce:
            timer = threading.Timer(
                lead, self._preempt_kill, args=(notice,)
            )
            timer.daemon = True
            with self._lock:
                self._timers.append(timer)
            timer.start()

    def _preempt_kill(self, notice: dict):
        logger.warning(
            "chaos[notice] deadline reached: exiting %d",
            notice["exit_code"],
        )
        try:
            # same crash-path contract as the kill action: dump the
            # flight record and persist the telemetry snapshot NOW —
            # the deadline kill (and everything before it) must survive
            # into the merged timeline either way
            from dlrover_tpu_torch.common import flight

            telemetry.event(
                "chaos.fire", site=notice["site"], action="kill",
                announced=True,
            )
            flight.dump(
                "chaos-preempt", site=notice["site"],
                deadline=notice["deadline"],
            )
            telemetry.flush()
        except Exception:  # noqa: BLE001 - dying anyway
            pass
        os._exit(notice["exit_code"])

    def take_preempt_notice(self) -> dict | None:
        """Consume the oldest unconsumed preemption notice (None when
        none stands). Consuming does NOT disarm the deadline kill —
        the host still dies on schedule; the notice only buys the lead
        window to checkpoint and drain."""
        with self._lock:
            for n in self._notices:
                if not n["taken"]:
                    n["taken"] = True
                    return dict(n)
        return None

    def pending_preempt_deadline(self) -> float | None:
        """Earliest unexpired announced-kill deadline, or None."""
        now = time.time()
        with self._lock:
            pending = [
                n["deadline"] for n in self._notices
                if n["deadline"] > now
            ]
        return min(pending) if pending else None

    def cancel_preemptions(self):
        """Disarm every pending deadline kill (uninstall/tests)."""
        with self._lock:
            timers, self._timers = self._timers, []
        for t in timers:
            t.cancel()


# -------------------------------------------------------------------------
# module-global arming
# -------------------------------------------------------------------------

_REGISTRY: ChaosRegistry | None = None

# dtsan's schedule explorer treats every chaos site as a preemption
# point: the fault sites already mark exactly the control-plane seams
# (RPC frames, WAL appends, shm saves, rendezvous joins) where an
# interleaving can change the outcome. Same no-op contract as the
# registry: a module-global load plus an ``is None`` branch.
_YIELD_HOOK = None


def set_yield_hook(hook):
    """Install (or clear, with None) the schedule-explorer callback
    invoked as ``hook(site, ctx)`` at every chaos site."""
    global _YIELD_HOOK
    _YIELD_HOOK = hook


def chaos_point(site: str, **ctx):
    """Control-flow fault site. No-op unless a schedule is installed."""
    hook = _YIELD_HOOK
    if hook is not None:
        hook(site, ctx)
    reg = _REGISTRY
    if reg is None:
        return
    reg.fire(site, ctx)


def chaos_transform(site: str, data, **ctx):
    """Byte-mutating fault site (checkpoint payloads, manifests).
    Returns ``data`` unchanged (same object, no copy) when disarmed."""
    hook = _YIELD_HOOK
    if hook is not None:
        hook(site, ctx)
    reg = _REGISTRY
    if reg is None:
        return data
    return reg.transform(site, data, ctx)


def active_registry() -> ChaosRegistry | None:
    return _REGISTRY


def install(schedule: dict | str) -> ChaosRegistry:
    """Arm a schedule in this process (tests/tools). ``schedule`` may be
    a dict, inline JSON, ``@path``, or a :data:`NAMED_SCHEDULES` key."""
    global _REGISTRY
    if _REGISTRY is not None:
        # replacing a schedule must not leave the OLD registry's armed
        # deadline kills behind — an orphaned notice timer would take
        # the process down mid-way through the next schedule
        _REGISTRY.cancel_preemptions()
    _REGISTRY = ChaosRegistry(resolve_schedule(schedule))
    logger.warning(
        "chaos armed: seed=%d rules=%d",
        _REGISTRY.seed, len(_REGISTRY.rules),
    )
    return _REGISTRY


def uninstall():
    global _REGISTRY
    if _REGISTRY is not None:
        # an in-process test uninstalling a schedule must not leave an
        # armed deadline kill behind to take the test runner down later
        _REGISTRY.cancel_preemptions()
    _REGISTRY = None


def take_preempt_notice() -> dict | None:
    """Consume the oldest unconsumed announced-preemption notice in
    this process (None when disarmed or none stands)."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.take_preempt_notice()


def pending_preempt_deadline() -> float | None:
    """Earliest unexpired announced-kill deadline (None when disarmed
    or nothing is pending)."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.pending_preempt_deadline()


def resolve_schedule(spec: dict | str) -> dict:
    if isinstance(spec, dict):
        return spec
    spec = spec.strip()
    if spec in NAMED_SCHEDULES:
        return NAMED_SCHEDULES[spec]
    if spec.startswith("@"):
        with open(spec[1:]) as f:
            return json.load(f)
    return json.loads(spec)


def install_from_env() -> ChaosRegistry | None:
    """One env read, at import time — never in the hot path."""
    spec = os.environ.get(ENV_VAR, "")
    if not spec:
        return None
    try:
        return install(spec)
    except Exception as e:  # noqa: BLE001 - bad JSON, missing keys,
        # wrong top-level type, unreadable @file ... a malformed
        # schedule must not take the job down with it (this runs at
        # import time in EVERY process)
        logger.error("ignoring malformed %s=%r: %s", ENV_VAR, spec, e)
        return None


# -------------------------------------------------------------------------
# named schedules (tools/chaos_run.py + docs)
# -------------------------------------------------------------------------

# ``desc`` is documentation for ``tools/chaos_run.py --list``;
# ChaosRegistry only reads ``seed``/``rules`` and ignores it.
NAMED_SCHEDULES: dict[str, dict] = {
    # kill the worker right after it finishes the step-5 shm save; the
    # agent restarts it and it must resume from step 5
    "worker-kill": {
        "desc": "kill the worker after the step-5 shm save; the agent "
        "restarts it and it must resume from step 5 bit-correct",
        "seed": 7,
        "rules": [
            {"site": "ckpt.save", "action": "kill", "step": 5},
        ],
    },
    # flaky control plane while the world forms: drop the 1st, 3rd and
    # 5th rendezvous RPCs; the RetryPolicy must ride it out.
    # Deterministic counting, not probability — the rendezvous window
    # is only a handful of calls and a replay must actually flap.
    "rdzv-flap": {
        "desc": "drop a deterministic burst of rendezvous RPCs; the "
        "unified RetryPolicy must ride it out and still form the world",
        "seed": 11,
        "rules": [
            {
                "site": "rpc.send",
                "action": "drop",
                "msg": ["JoinRendezvousRequest", "CommWorldRequest"],
                "every": 2,
                "max": 3,
            },
        ],
    },
    # tear the final persisted checkpoint mid-shard: restore must fall
    # back to the newest verified step instead of loading torn bytes
    "torn-ckpt": {
        "desc": "tear the step-8 persisted checkpoint mid-shard; "
        "restore must fall back to the newest verified step",
        "seed": 13,
        "rules": [
            {"site": "ckpt.write", "action": "tear", "step": 8},
        ],
    },
    # bit-flip the newest manifest: verification must reject the step
    "manifest-bitflip": {
        "desc": "bit-flip the step-8 shard manifest; verification must "
        "reject the step and restore the previous verified one",
        "seed": 17,
        "rules": [
            {"site": "ckpt.manifest", "action": "bitflip", "step": 8},
        ],
    },
    # flap membership against a live worker: the first two membership
    # changes (scale-in drain, scale-out adopt) must ride IN PROCESS —
    # zero worker restarts — then a kill lands mid-reshard on the third
    # and the agent must fall back to the classic restart path with
    # every dataset shard still served exactly once. The scale events
    # themselves are driven by the harness (tools/chaos_run.py
    # ``_run_scale_flap``); the schedule contributes the mid-reshape
    # kill. ``after: 2`` counts the worker-side ``reshard`` seams: the
    # flap's two in-process adoptions pass clean, the third dies.
    "scale-flap": {
        "desc": "flap membership: scale-in drain + scale-out adopt ride "
        "in process (zero worker restarts), then a kill mid-reshard "
        "must recover via the restart path with exactly-once shards",
        "seed": 23,
        "rules": [
            {
                "site": "elastic.reshape",
                "action": "kill",
                "verb": "reshard",
                "after": 2,
                "max": 1,
            },
        ],
    },
    # a compressed "week" of production faults against the repair
    # brain: an ANNOUNCED preemption (host rank 1 gets a notice with a
    # seeded 2-3 s lead — brain-on pre-drains it into the reshape
    # bucket, brain-off eats the unannounced-kill fallback) and a hard
    # unannounced kill (host rank 0, the restart path). The persistent
    # straggler (brain evicts it) and the scale-out joiner are driven
    # by the harness (tools/chaos_run.py ``_run_week``), which runs
    # the same seed brain-on vs brain-off and publishes
    # goodput_brain_on_pct / goodput_brain_off_pct /
    # preempt_notice_saved_s.
    "week-in-the-life": {
        "desc": "mixed week: announced preemption (brain pre-drains "
        "into the reshape bucket), a hard kill, an injected persistent "
        "straggler the brain evicts, and a scale-out — run brain-on vs "
        "brain-off on one seed, publishing goodput_brain_on/off_pct "
        "and preempt_notice_saved_s",
        "seed": 31,
        "rules": [
            # time-anchored (``at`` = seconds of host uptime), NOT
            # call-counted: the brain's own actions change the step
            # rate, and the on/off arms must experience the same
            # faults at the same times to be comparable
            {
                "site": "preempt.notice",
                "action": "notice",
                "rank": 1,
                "at": 4.0,
                "max": 1,
                "lead": [2.0, 3.0],
            },
            {
                "site": "preempt.notice",
                "action": "kill",
                "rank": 0,
                "at": 14.0,
                "max": 1,
            },
        ],
    },
    # kill one decode worker mid-sweep: the serving arm's availability
    # proof. The worker dies on its 4th SERVING step (rank 1, counted
    # on the worker's own call sequence — deterministic per schedule),
    # abandoning its leased requests un-reported; the master's lease
    # expiry must re-queue each of them exactly once onto the
    # survivors, throughput degrades instead of requests dropping, and
    # the ledger ends with zero failed / zero double-served requests.
    # Driven by tools/chaos_run.py ``_run_serve_kill``, which publishes
    # serve_tokens_per_s / serve_ttft_p50_ms / serve_ttft_p99_ms /
    # serve_goodput_pct (gated by tools/bench_diff.py).
    "serve-kill": {
        "desc": "kill one decode worker mid-sweep; its leased requests "
        "must re-queue exactly once onto the survivors — throughput "
        "degrades, nothing is dropped or double-served; publishes the "
        "serve_* bench keys",
        "seed": 41,
        "rules": [
            {
                "site": "serve.step",
                "action": "error",
                "rank": 1,
                "verb": "serving",
                "after": 3,
                "max": 1,
            },
        ],
    },
    # a degraded host meets the health gate: host 3 joins with a
    # chaos-inflated probe (every leg's timed window eats a seeded
    # ~0.4 s degrade sleep) and must be quarantined at the door —
    # never entering a round; host 1 joins clean, then its in-band
    # re-probes run degraded, so the fingerprint regression becomes a
    # diagnosis.hw_degraded verdict and the brain drains it with zero
    # survivor restarts. ``max: 6`` bounds host 3's affliction to two
    # probes (3 legs each): its backoff re-probe comes back clean and
    # the gate re-admits it. Driven by tools/chaos_run.py
    # ``_run_bad_host``, which publishes probe_join_overhead_s /
    # bad_host_quarantine_s (gated by tools/bench_diff.py).
    "bad-host": {
        "desc": "degrade host 3's join probe (quarantined at the door, "
        "re-admitted after its backoff re-probe comes back clean) and "
        "host 1's in-band re-probes (hw_degraded verdict -> brain "
        "drain+reshape, zero survivor restarts); publishes "
        "probe_join_overhead_s / bad_host_quarantine_s",
        "seed": 37,
        "rules": [
            {
                "site": "probe.degrade",
                "action": "degrade",
                "rank": 3,
                "delay": 0.4,
                "max": 6,
            },
            {
                "site": "probe.degrade",
                "action": "degrade",
                "rank": 1,
                "delay": 0.4,
                "after": 3,
            },
        ],
    },
    # kill the MASTER mid-job (on the 7th dataset task request, before
    # it dispatches); a supervisor restarts it with --restore-state and
    # the job must finish with every shard accounted exactly once, no
    # worker restart, and the outage in the ledger's restart bucket
    "master-kill": {
        "desc": "kill the master mid-job; restarted from its durable "
        "state it must resume with every shard exactly once and no "
        "worker restart",
        "seed": 29,
        "rules": [
            {
                "site": "master.kill",
                "action": "kill",
                "msg": ["TaskRequest"],
                "after": 6,
                "max": 1,
            },
        ],
    },
}


install_from_env()
