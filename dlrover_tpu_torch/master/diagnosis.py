"""Master-side runtime diagnosis: stragglers and hangs, with blame.

Equivalent capability: the reference stack diagnoses a slow/stuck job
from two directions — xpu_timer's per-process timing hooks feeding an
out-of-process exporter, and the master's straggler check over probe
round times (rdzv_manager._detect_stragglers :505). The probe-time rule
only sees dedicated network-check rounds, so during *training* the
``check_straggler`` RPC answered from an always-empty set. This module
closes that gap: it consumes what the agents already ship —

- **per-host, per-phase TimerRing aggregates** (``timer.phase.*``
  gauges published by :class:`~dlrover_tpu_torch.agent.monitor.
  TimerRingExporter`, relayed through the normal telemetry path), and
- **per-host ``step.end`` / ``span`` timeline events** from worker
  snapshots (plus the SpeedMonitor's per-node step reports as a
  second, RPC-timestamped source),

and turns them into live verdicts:

- **Straggler**: a host whose step time is an outlier across the fleet
  — z-score above :data:`STRAGGLER_ZSCORE` when >= 3 hosts report, or
  the reference's > :data:`STRAGGLER_RATIO` x median rule (for 2 hosts
  the faster host is the baseline, mirroring
  ``rendezvous.get_stragglers``). The verdict carries a **blamed
  phase**: the phase (``data_wait`` / ``compute`` / ``ckpt``) whose
  excess over the fleet median explains the most of the host's gap.
- **Hang**: a host whose last ``step.end`` is older than
  :data:`HANG_FACTOR` x the fleet median step time (with an absolute
  floor — a 50 ms-step toy job must not flag a 2 s GC pause), while at
  least one step was ever seen from it.

Verdicts are emitted as ``diagnosis.straggler`` / ``diagnosis.hang``
timeline events (master registry, so they ride the merged job
timeline) and served to agents via the ``DiagnosisRequest`` RPC — an
agent told its own host is hanging dumps its flight recorder.

Checks are pull-driven and rate-limited (:data:`CHECK_INTERVAL`): the
servicer triggers them from heartbeats and diagnosis/straggler queries,
so an idle master does no background scanning and a busy one amortizes
one fleet scan across many queries.

The PyTorch port's copy of dlrover_tpu/master/diagnosis.py.
"""

from __future__ import annotations

import os
import threading
import time

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# straggler thresholds (env-overridable for ops tuning without a deploy)
STRAGGLER_RATIO = float(os.environ.get("DLROVER_DIAG_RATIO", "2.0"))
STRAGGLER_ZSCORE = float(os.environ.get("DLROVER_DIAG_ZSCORE", "2.0"))
# hang = no step.end for this many median step times ...
HANG_FACTOR = float(os.environ.get("DLROVER_DIAG_HANG_FACTOR", "10.0"))
# ... but never less than this many seconds (toy jobs with ms steps)
HANG_FLOOR_S = float(os.environ.get("DLROVER_DIAG_HANG_FLOOR", "15.0"))
CHECK_INTERVAL = 2.0

# TimerRing tag -> blame bucket. Anything checkpoint-shaped collapses
# to "ckpt"; the residual of the step not explained by data_wait/ckpt
# is "compute" (the jitted step itself).
_PHASE_BLAME = {
    "data_wait": "data_wait",
    "ckpt_shm": "ckpt",
    "ckpt_persist": "ckpt",
    "compile": "compute",
    "step": "compute",
}


def _source_rank(snap: dict) -> int | None:
    """Parse the node rank out of a registry source name
    (``<role>-<rank>-<pid>``, see TelemetryRegistry). None when the
    source doesn't follow the convention (tools, tests)."""
    parts = str(snap.get("source", "")).rsplit("-", 2)
    if len(parts) != 3:
        return None
    try:
        return int(parts[1])
    except ValueError:
        return None


# fleet-baseline convention shared with rendezvous.get_stragglers —
# one definition (common/telemetry.py) so the probe-round and runtime
# straggler rules cannot drift
_median = telemetry.median_baseline


def _mean_std(values):
    n = len(values)
    if n == 0:
        return 0.0, 0.0
    mean = sum(values) / n
    var = sum((v - mean) ** 2 for v in values) / n
    return mean, var ** 0.5


class DiagnosisManager:
    """Consumes the master's merged telemetry; produces live
    straggler/hang verdicts with a blamed phase."""

    def __init__(
        self,
        job_telemetry,
        speed_monitor=None,
        ratio: float = STRAGGLER_RATIO,
        zscore: float = STRAGGLER_ZSCORE,
        hang_factor: float = HANG_FACTOR,
        hang_floor_s: float = HANG_FLOOR_S,
        check_interval: float = CHECK_INTERVAL,
        slo_watchdog=None,
        brain=None,
        capture=None,
        health=None,
    ):
        self._telemetry = job_telemetry
        self._speed_monitor = speed_monitor
        # the SLO watchdog (master/metrics_store.SloWatchdog) rides
        # this manager's rate-limited sweep: breaches are a diagnosis
        # verdict like stragglers/hangs, not a separate scanner thread
        self.slo = slo_watchdog
        # the repair brain (master/brain.py) rides the same sweep:
        # fresh verdicts feed its policies AFTER the manager's lock is
        # released (its actuators call into other components)
        self.brain = brain
        # the deep-capture manager (master/capture.py) rides it too:
        # a breach/straggler verdict becomes a capture directive for
        # the blamed host, rate-limited by the manager itself
        self.capture = capture
        # the hardware health plane (master/health.py) surfaces its
        # sustained in-band degradations through this sweep: they
        # become ``hw`` verdicts the brain drains like stragglers
        self.health = health
        self._ratio = ratio
        self._zscore = zscore
        self._hang_factor = hang_factor
        self._hang_floor = hang_floor_s
        self._interval = check_interval
        self._lock = threading.Lock()
        self._last_check = 0.0
        # rank -> {"phase": str, "ratio": float, "z": float, ...}
        self._stragglers: dict[int, dict] = {}
        # rank -> {"stalled_s": float, "last_step": int, ...}
        self._hangs: dict[int, dict] = {}
        # rank -> {"leg": str, "ratio": float, "streak": int, ...}
        self._hw: dict[int, dict] = {}

    # ------------------------------------------------------------ inputs

    def host_phase_stats(self, snaps=None) -> dict[int, dict[str, float]]:
        """rank -> {phase_tag: avg_ms} from the ``timer.phase.*``
        gauges every agent's TimerRingExporter publishes. The recent
        window (``timer.phase.recent_avg_ms``) wins over the lifetime
        average — a host that *became* slow must not hide behind hours
        of healthy history."""
        out: dict[int, dict[str, float]] = {}
        lifetime: dict[int, dict[str, float]] = {}
        for snap in (
            snaps if snaps is not None else self._telemetry.snapshots()
        ):
            rank = _source_rank(snap)
            if rank is None:
                continue
            for g in snap.get("gauges", ()):
                phase = g.get("labels", {}).get("phase")
                if not phase:
                    continue
                if g["name"] == "timer.phase.recent_avg_ms":
                    out.setdefault(rank, {})[phase] = float(g["value"])
                elif g["name"] == "timer.phase.avg_ms":
                    lifetime.setdefault(rank, {})[phase] = float(
                        g["value"]
                    )
        for rank, phases in lifetime.items():
            for phase, v in phases.items():
                out.setdefault(rank, {}).setdefault(phase, v)
        return out

    def host_step_activity(self, snaps=None) -> dict[int, dict]:
        """rank -> {"last_t": wall, "last_step": int, "durs": [s...]}
        from worker ``step.end`` events."""
        out: dict[int, dict] = {}
        for snap in (
            snaps if snaps is not None else self._telemetry.snapshots()
        ):
            if snap.get("role") != "worker":
                continue
            rank = _source_rank(snap)
            if rank is None:
                continue
            entry = out.setdefault(
                rank, {"last_t": 0.0, "last_step": -1, "durs": []}
            )
            for ev in snap.get("events", ()):
                if ev.get("kind") != "step.end":
                    continue
                t = float(ev.get("t", 0.0))
                if t > entry["last_t"]:
                    entry["last_t"] = t
                    entry["last_step"] = int(ev.get("step", -1))
                dur = ev.get("dur")
                if dur:
                    entry["durs"].append(float(dur))
        return out

    # ----------------------------------------------------------- verdicts

    def detect_stragglers(self, snaps=None) -> dict[int, dict]:
        """Per-phase step-time outlier detection across hosts.

        A host is flagged when its total step time is an outlier
        (z-score with >= 3 hosts, ratio-over-median always); the blamed
        phase is the one whose excess over the fleet median explains
        the most of the host's gap.
        """
        stats = self.host_phase_stats(snaps)
        steps = {
            r: p["step"] for r, p in stats.items() if p.get("step", 0) > 0
        }
        if len(steps) < 2:
            return {}
        values = list(steps.values())
        baseline = _median(values)
        mean, std = _mean_std(values)
        out: dict[int, dict] = {}
        for rank, step_ms in steps.items():
            z = (step_ms - mean) / std if std > 0 else 0.0
            ratio = step_ms / baseline if baseline > 0 else 0.0
            flagged = (baseline > 0 and ratio > self._ratio) or (
                len(steps) >= 3 and z > self._zscore and ratio > 1.25
            )
            if not flagged:
                continue
            out[rank] = {
                "phase": self._blame(rank, stats),
                "ratio": round(ratio, 3),
                "z": round(z, 3),
                "step_ms": round(step_ms, 3),
                "median_ms": round(baseline, 3),
            }
        return out

    def _blame(self, rank: int, stats: dict[int, dict]) -> str:
        """The phase whose excess over the fleet median explains the
        most of this host's step-time gap. Phases are collapsed to
        blame buckets (data_wait / ckpt / compute); 'compute' is the
        residual when no sub-phase stands out — the jitted step itself
        is slow (bad chip, thermal, contention)."""
        mine = stats.get(rank, {})
        excess: dict[str, float] = {}
        for phase, bucket in _PHASE_BLAME.items():
            if bucket == "compute" and phase == "step":
                continue  # total step time is the signal, not a blame
            x = mine.get(phase)
            if x is None:
                continue
            others = [
                s[phase] for r, s in stats.items()
                if r != rank and phase in s
            ]
            if not others:
                continue
            med = _median(others)
            excess[bucket] = excess.get(bucket, 0.0) + max(x - med, 0.0)
        sub_total = sum(excess.values())
        step_excess = 0.0
        if "step" in mine:
            others = [
                s["step"] for r, s in stats.items()
                if r != rank and "step" in s
            ]
            if others:
                step_excess = max(mine["step"] - _median(others), 0.0)
        # the step-time gap not explained by data_wait/ckpt is compute
        excess["compute"] = excess.get("compute", 0.0) + max(
            step_excess - sub_total, 0.0
        )
        if not any(v > 0 for v in excess.values()):
            return "compute"
        return max(excess.items(), key=lambda kv: kv[1])[0]

    def detect_hangs(self, now: float | None = None, snaps=None
                     ) -> dict[int, dict]:
        now = time.time() if now is None else now
        activity = self.host_step_activity(snaps)
        all_durs = [d for e in activity.values() for d in e["durs"]]
        median_step = _median(all_durs)
        threshold = max(
            self._hang_factor * median_step, self._hang_floor
        )
        out: dict[int, dict] = {}
        for rank, entry in activity.items():
            if entry["last_t"] <= 0:
                continue  # never stepped: startup, not a hang
            stalled = now - entry["last_t"]
            if stalled > threshold:
                out[rank] = {
                    "stalled_s": round(stalled, 3),
                    "last_step": entry["last_step"],
                    "threshold_s": round(threshold, 3),
                    "median_step_s": round(median_step, 3),
                }
        # The telemetry view is only as fresh as the worker's flush
        # cadence (every log_steps steps), so master-clock staleness
        # alone would flag every sparse-flushing healthy host. The
        # per-node GlobalStep stamps are much fresher (workers publish
        # runtime metrics every step; agents relay each monitor tick):
        # freshest-wins merge — a recent GlobalStep VETOES a stale-
        # telemetry hang, and nodes only the speed monitor knows about
        # are added via stalled_nodes (which carries its own
        # everyone-stalled guard).
        progress = (
            self._speed_monitor.node_progress()
            if self._speed_monitor is not None else {}
        )
        for (_ntype, nid), (t, _step) in progress.items():
            if nid in out and now - t <= threshold:
                del out[nid]
        if self._speed_monitor is not None:
            for (ntype, nid) in self._speed_monitor.stalled_nodes(
                threshold, now=now
            ):
                # the live dict may have gained entries since the
                # snapshot above (concurrent GlobalStep reports): a
                # node we hold no stamp for is skipped this sweep
                stamp = progress.get((ntype, nid))
                if nid not in out and stamp is not None:
                    t, step = stamp
                    out[nid] = {
                        "stalled_s": round(now - t, 3),
                        "last_step": step,
                        "threshold_s": round(threshold, 3),
                        "median_step_s": round(median_step, 3),
                        "source": f"speed-monitor:{ntype}",
                    }
        # everyone-stalled = a job-level event (fleet-wide recompile,
        # synchronous checkpoint, rendezvous), not per-node blame —
        # SpeedMonitor.all_worker_hanged owns that signal. A single
        # host (or a single survivor) still gets flagged.
        if len(out) >= 2 and set(out) == {
            r for r, e in activity.items() if e["last_t"] > 0
        } | {nid for (_, nid) in progress}:
            return {}
        return out

    # -------------------------------------------------------------- check

    def check(self, now: float | None = None, force: bool = False) -> dict:
        """Run (rate-limited) straggler + hang detection; emit
        ``diagnosis.*`` timeline events on every NEW verdict and a
        ``diagnosis.clear`` when a host recovers."""
        now = time.time() if now is None else now
        with self._lock:
            if not force and now - self._last_check < self._interval:
                return {
                    "stragglers": dict(self._stragglers),
                    "hangs": dict(self._hangs),
                    "slo": (
                        self.slo.breaches() if self.slo is not None
                        else {}
                    ),
                    "hw": dict(self._hw),
                }
            self._last_check = now
            snaps = self._telemetry.snapshots()
            stragglers = self.detect_stragglers(snaps)
            hangs = self.detect_hangs(now, snaps)
            slo = {}
            if self.slo is not None:
                try:
                    slo = self.slo.check(now)
                except Exception:  # noqa: BLE001 - a watchdog bug must
                    # not take straggler/hang detection down with it
                    logger.exception("SLO watchdog sweep failed")
            for rank, info in stragglers.items():
                if rank not in self._stragglers:
                    logger.warning(
                        "straggler diagnosed: rank %s %s", rank, info
                    )
                    telemetry.event(
                        "diagnosis.straggler", rank=rank, **info
                    )
            for rank, info in hangs.items():
                if rank not in self._hangs:
                    logger.error(
                        "hang diagnosed: rank %s %s", rank, info
                    )
                    telemetry.event("diagnosis.hang", rank=rank, **info)
            hw = {}
            if self.health is not None:
                try:
                    hw = self.health.hw_degraded()
                except Exception:  # noqa: BLE001 - same contract as
                    # the watchdog: a health-plane bug must not take
                    # straggler/hang detection down with it
                    logger.exception("health sweep failed")
            for rank, info in hw.items():
                if rank not in self._hw:
                    logger.error(
                        "hardware degradation diagnosed: rank %s %s",
                        rank, info,
                    )
                    telemetry.event(
                        "diagnosis.hw_degraded", rank=rank, **info
                    )
            for rank in set(self._stragglers) - set(stragglers):
                telemetry.event(
                    "diagnosis.clear", rank=rank, what="straggler"
                )
            for rank in set(self._hangs) - set(hangs):
                telemetry.event(
                    "diagnosis.clear", rank=rank, what="hang"
                )
            for rank in set(self._hw) - set(hw):
                telemetry.event(
                    "diagnosis.clear", rank=rank, what="hw"
                )
            self._stragglers = stragglers
            self._hangs = hangs
            self._hw = hw
            result = {
                "stragglers": dict(stragglers),
                "hangs": dict(hangs),
                "slo": slo,
                "hw": dict(hw),
            }
        # the brain runs OUTSIDE the manager lock: its policies call
        # into other components (rendezvous drain, run configs, WAL),
        # and only fresh (non-cached) sweeps feed it — the rate limit
        # above is also the brain's
        brain = self.brain
        if brain is not None:
            try:
                brain.sweep(result, now)
            except Exception:  # noqa: BLE001 - a policy bug must not
                # take straggler/hang detection down with it
                logger.exception("brain sweep failed")
        capture = self.capture
        if capture is not None:
            try:
                capture.on_sweep(result, now)
            except Exception:  # noqa: BLE001 - same contract as the
                # brain: a capture-trigger bug must not take
                # straggler/hang detection down with it
                logger.exception("capture sweep failed")
        return result

    def stragglers(self) -> dict[int, dict]:
        return self.check()["stragglers"]

    def hangs(self) -> dict[int, dict]:
        return self.check()["hangs"]
