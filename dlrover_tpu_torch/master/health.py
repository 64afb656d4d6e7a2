"""Hardware health plane, master half: probe gate + host fingerprints.

Equivalent capability: the reference's node check is a binary door —
``NetworkCheckElasticAgent`` runs the probe payload and the master's
pairing logic kills hosts that fail it. This module upgrades the door
to a *graded* gate fed by the per-leg timings agents ship at join
(``JoinRendezvousRequest.probe_report``, agent/probe.py):

- **Gate** (:meth:`HostHealthManager.gate`): every join's probe report
  is judged against the fleet (per-leg median over the admitted hosts'
  fingerprints, > :data:`RATIO` x = degraded — the same 2x constant the
  straggler blamer uses) AND against the host's own persisted baseline
  ("this host's HBM degraded 30% since last week" vs "the workload
  changed"). Decision matrix:

  =============================  =============================
  probe outcome                  verdict
  =============================  =============================
  no report / no baselines       pass (bootstrap / old agent)
  clean vs fleet AND self        pass (report folds into the
                                 fingerprint EWMA)
  degraded (> RATIO x)           quarantine: parked in the
                                 waiting set, re-probe after a
                                 doubling backoff
  severe (> REFUSE_RATIO x),     refuse: rejected at the door,
  probe error, or >=             longer backoff before a fresh
  REFUSE_STRIKES strikes         probe is considered
  =============================  =============================

  A parked host is never in the rendezvous waiting set, so it cannot
  dissolve (flap) a formed round; while its backoff stands the gate
  re-serves the SAME verdict without re-judging — including across a
  master failover (the waiting set and fingerprints ride the snapshot
  and a ``health`` WAL op).

- **Fingerprints**: per-host EWMA of each leg (the OpCostBaseline
  idiom: fold only healthy samples at :data:`EWMA`, freeze on
  regression so a degrading host cannot normalize its own decay) plus
  a bounded recent-value history for dashboard sparklines.

- **Continuous checks** (:meth:`observe`): the agent's governed
  in-band re-probe feeds the same store; a degradation sustained for
  :data:`PERSIST_OBS` consecutive observations surfaces through
  :meth:`hw_degraded`, which the DiagnosisManager turns into
  ``diagnosis.hw_degraded`` verdicts and the RepairBrain into its
  existing drain+reshape plan.

Lock discipline (dlint DL008): one leaf lock; never held across the
WAL/dirty callbacks into the state store.

The PyTorch port's copy of dlrover_tpu/master/health.py.
"""

from __future__ import annotations

import os
import threading
import time

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.telemetry import median_baseline
from dlrover_tpu_torch.master.diagnosis import STRAGGLER_RATIO

logger = get_logger(__name__)

# degraded threshold: the straggler blamer's fleet-relative constant
# (env DLROVER_DIAG_RATIO) — one knob, so the probe-gate and runtime
# straggler rules cannot drift apart
RATIO = STRAGGLER_RATIO
# outright refusal: this much above baseline (or an errored probe)
REFUSE_RATIO = float(
    os.environ.get("DLROVER_HEALTH_REFUSE_RATIO", str(2 * RATIO))
)
# consecutive bad probes before quarantine hardens into refuse
REFUSE_STRIKES = int(os.environ.get("DLROVER_HEALTH_REFUSE_STRIKES", "3"))
# re-probe backoff: base * 2^(strikes-1), capped — quarantined hosts
# re-probe on THIS schedule instead of hammering the join path
BACKOFF_S = float(os.environ.get("DLROVER_HEALTH_BACKOFF", "30"))
BACKOFF_CAP_S = float(os.environ.get("DLROVER_HEALTH_BACKOFF_CAP", "600"))
# refusals wait this many extra backoff doublings before re-judging
_REFUSE_BACKOFF_FACTOR = 4.0
# in-band observations a degradation must persist before it becomes a
# diagnosis verdict (mirrors the brain's PERSIST_SWEEPS discipline)
PERSIST_OBS = int(os.environ.get("DLROVER_HEALTH_PERSIST_OBS", "3"))
# absolute slack under which a ratio never counts: probe legs are
# milliseconds-scale, where scheduler noise is proportionally huge —
# 2x of 5 ms is jitter, 2x of 500 ms is a sick device
SLACK_MS = float(os.environ.get("DLROVER_HEALTH_SLACK_MS", "25"))
# EWMA weight of a fresh healthy sample (OpCostBaseline's constant)
EWMA = 0.25
# recent per-leg values kept per host (dashboard sparklines)
HISTORY_LEN = 32

_LEGS = ("hbm", "matmul", "collective")


class HostHealthManager:
    """Gate + fingerprint store + quarantine waiting set."""

    def __init__(
        self,
        ratio: float = RATIO,
        refuse_ratio: float = REFUSE_RATIO,
        refuse_strikes: int = REFUSE_STRIKES,
        backoff_s: float = BACKOFF_S,
        backoff_cap_s: float = BACKOFF_CAP_S,
        persist_obs: int = PERSIST_OBS,
        wal_fn=None,
        dirty_fn=None,
    ):
        self._ratio = ratio
        self._refuse_ratio = max(refuse_ratio, ratio)
        self._refuse_strikes = max(refuse_strikes, 1)
        self._backoff = backoff_s
        self._backoff_cap = backoff_cap_s
        self._persist_obs = max(persist_obs, 1)
        # durability hooks (the servicer's state-store passthroughs);
        # None degrades to in-memory verdicts, like the brain's plans
        self._wal_fn = wal_fn
        self._dirty_fn = dirty_fn
        self._lock = threading.Lock()
        # host -> {"legs": {leg: ewma_ms}, "history": {leg: [ms...]},
        #          "samples": n, "updated": wall}
        self._fingerprints: dict[int, dict] = {}
        # the quarantine waiting set: host -> {"verdict", "reason",
        # "strikes", "until", "t"} — a standing entry is re-served
        # verbatim until its backoff expires
        self._quarantine: dict[int, dict] = {}
        # continuous-check streaks: host -> {"streak", "leg", "ratio"}
        self._degraded: dict[int, dict] = {}

    # ------------------------------------------------------------ plumbing

    def _persist(self):
        """WAL the ABSOLUTE health state (replay is an upsert) and
        dirty the snapshot — called after every gate/observe mutation,
        outside the lock."""
        wal = self._wal_fn
        if wal is not None:
            wal("health", state=self.export_state())
        dirty = self._dirty_fn
        if dirty is not None:
            dirty()

    @staticmethod
    def _legs_of(report: dict) -> dict[str, float]:
        legs = report.get("legs") or {}
        return {
            k: float(v) for k, v in legs.items()
            if isinstance(v, (int, float)) and float(v) > 0
        }

    def _judge_locked(
        self, rank: int, legs: dict[str, float]
    ) -> tuple[float, str, str]:
        """(worst ratio, blamed leg, basis) of this report against the
        fleet median (other hosts' fingerprints) and the host's own
        baseline. Ratio 0.0 = nothing to judge against (bootstrap)."""
        worst, blamed, basis = 0.0, "", ""
        for leg, mine in legs.items():
            fleet = [
                fp["legs"][leg]
                for r, fp in self._fingerprints.items()
                if r != rank and fp["legs"].get(leg, 0) > 0
            ]
            if fleet:
                med = median_baseline(fleet)
                if (
                    med > 0
                    and mine - med >= SLACK_MS
                    and mine / med > worst
                ):
                    worst, blamed, basis = mine / med, leg, "fleet"
            own = self._fingerprints.get(rank, {}).get("legs", {})
            base = own.get(leg, 0)
            if (
                base > 0
                and mine - base >= SLACK_MS
                and mine / base > worst
            ):
                worst, blamed, basis = mine / base, leg, "self"
        return worst, blamed, basis

    def _record_locked(self, rank: int, legs: dict, degraded: bool):
        """History always (the sparkline must show the anomaly); the
        EWMA folds only healthy samples — freeze-on-regression, so a
        slowly dying host cannot normalize its own decay."""
        fp = self._fingerprints.setdefault(
            rank, {"legs": {}, "history": {}, "samples": 0, "updated": 0.0}
        )
        for leg, ms in legs.items():
            hist = fp["history"].setdefault(leg, [])
            hist.append(round(ms, 3))
            del hist[:-HISTORY_LEN]
            if not degraded:
                prev = fp["legs"].get(leg)
                fp["legs"][leg] = round(
                    ms if prev is None else (1 - EWMA) * prev + EWMA * ms,
                    3,
                )
        if not degraded:
            fp["samples"] += 1
        fp["updated"] = time.time()

    def _backoff_for(self, strikes: int, refused: bool) -> float:
        backoff = self._backoff * (2 ** max(strikes - 1, 0))
        if refused:
            backoff *= _REFUSE_BACKOFF_FACTOR
        return min(backoff, self._backoff_cap)

    @staticmethod
    def _served(standing: dict, now: float) -> dict:
        """A waiting-set entry shaped for the wire (NodeHealthVerdict's
        exact fields — internal keys like ``until`` stay here)."""
        return {
            "verdict": standing["verdict"],
            "reason": standing["reason"],
            "strikes": standing["strikes"],
            "retry_after_s": round(
                max(standing["until"] - now, 0.0), 3
            ),
        }

    # ---------------------------------------------------------------- gate

    def gate(self, rank: int, report: dict, now: float | None = None
             ) -> dict:
        """Admission decision for one join. Returns the verdict dict
        served to ``NodeHealthRequest`` polls: ``{"verdict": "pass" |
        "quarantine" | "refuse", "reason", "retry_after_s",
        "strikes"}``. Only "pass" lets the join reach the rendezvous
        manager — anything else parks the host here."""
        now = time.time() if now is None else now
        rank = int(rank)
        legs = self._legs_of(report or {})
        error = str((report or {}).get("error", ""))
        with self._lock:
            standing = self._quarantine.get(rank)
            if standing is not None and now < standing["until"]:
                # backoff still running: re-serve the SAME verdict —
                # the waiting set exists precisely so a retrying host
                # cannot flap the round (or extract a fresh judgement
                # by re-rolling its probe)
                return self._served(standing, now)
            if not legs and not error:
                # old agent / probe disabled: the gate cannot judge
                # what was never measured — admit (pre-health-plane
                # behavior), clearing any expired quarantine
                self._quarantine.pop(rank, None)
                return {
                    "verdict": "pass", "reason": "no probe report",
                    "retry_after_s": 0.0, "strikes": 0,
                }
            worst, leg, basis = self._judge_locked(rank, legs)
            strikes = (standing or {}).get("strikes", 0)
            if error:
                verdict, reason = "refuse", f"probe error: {error}"
            elif worst > self._refuse_ratio or (
                worst > self._ratio and strikes + 1 >= self._refuse_strikes
            ):
                verdict = "refuse"
                reason = (
                    f"{leg} {worst:.1f}x {basis} baseline"
                )
            elif worst > self._ratio:
                verdict = "quarantine"
                reason = f"{leg} {worst:.1f}x {basis} baseline"
            else:
                verdict, reason = "pass", ""
            if verdict == "pass":
                # "cleared" marks a re-admission after a standing
                # quarantine — the servicer turns it into a timeline
                # event so offline reports see the recovery too
                cleared = self._quarantine.pop(rank, None) is not None
                self._degraded.pop(rank, None)
                self._record_locked(rank, legs, degraded=False)
                out = {
                    "verdict": "pass", "reason": "",
                    "retry_after_s": 0.0, "strikes": 0,
                    "cleared": cleared,
                }
            else:
                strikes += 1
                until = now + self._backoff_for(
                    strikes, verdict == "refuse"
                )
                entry = {
                    "verdict": verdict,
                    "reason": reason,
                    "strikes": strikes,
                    "until": round(until, 3),
                    "t": round(now, 3),
                }
                self._quarantine[rank] = entry
                self._record_locked(rank, legs, degraded=True)
                out = self._served(entry, now)
        if out["verdict"] == "pass":
            logger.info("health gate: host %d admitted", rank)
        else:
            logger.warning(
                "health gate: host %d %s (%s), re-probe in %.0fs",
                rank, out["verdict"], out["reason"],
                out["retry_after_s"],
            )
        self._persist()
        return out

    def verdict(self, rank: int, now: float | None = None) -> dict:
        """The standing verdict for one host (NodeHealthRequest poll).
        Read-only: never mutates the waiting set."""
        now = time.time() if now is None else now
        with self._lock:
            standing = self._quarantine.get(int(rank))
            if standing is None:
                known = int(rank) in self._fingerprints
                return {
                    "verdict": "pass" if known else "unknown",
                    "reason": "",
                    "retry_after_s": 0.0,
                    "strikes": 0,
                }
            return self._served(standing, now)

    # ---------------------------------------------------- continuous checks

    def observe(self, rank: int, report: dict, now: float | None = None):
        """Fold one in-band re-probe into the fingerprint store and
        advance the degradation streak. Quiet on healthy samples."""
        now = time.time() if now is None else now
        rank = int(rank)
        legs = self._legs_of(report or {})
        if not legs:
            return
        with self._lock:
            worst, leg, basis = self._judge_locked(rank, legs)
            degraded = worst > self._ratio
            self._record_locked(rank, legs, degraded=degraded)
            if degraded:
                entry = self._degraded.setdefault(
                    rank, {"streak": 0, "leg": "", "ratio": 0.0}
                )
                entry["streak"] += 1
                entry["leg"] = leg
                entry["ratio"] = round(worst, 3)
                entry["basis"] = basis
                streak = entry["streak"]
            else:
                self._degraded.pop(rank, None)
                streak = 0
        if streak:
            logger.warning(
                "health: host %d %s %.1fx %s baseline "
                "(observation %d/%d)",
                rank, leg, worst, basis, streak, self._persist_obs,
            )
        self._persist()

    def hw_degraded(self) -> dict[int, dict]:
        """Hosts whose in-band degradation persisted PERSIST_OBS
        consecutive observations — the DiagnosisManager serves these as
        ``hw`` verdicts and the brain drains them."""
        with self._lock:
            return {
                rank: {
                    "leg": e["leg"],
                    "ratio": e["ratio"],
                    "basis": e.get("basis", ""),
                    "streak": e["streak"],
                }
                for rank, e in self._degraded.items()
                if e["streak"] >= self._persist_obs
            }

    # ------------------------------------------------------------ reporting

    def quarantined(self) -> dict[int, dict]:
        with self._lock:
            return {r: dict(e) for r, e in self._quarantine.items()}

    def summary(self, now: float | None = None) -> dict:
        """Dashboard payload: per-host fingerprint (EWMA legs + recent
        sparkline values), standing verdict, degradation streaks."""
        now = time.time() if now is None else now
        with self._lock:
            hosts = {}
            for rank, fp in self._fingerprints.items():
                standing = self._quarantine.get(rank)
                hosts[str(rank)] = {
                    "legs": dict(fp["legs"]),
                    "history": {
                        leg: list(v) for leg, v in fp["history"].items()
                    },
                    "samples": fp["samples"],
                    "updated": fp["updated"],
                    "verdict": (
                        standing["verdict"] if standing else "pass"
                    ),
                    "reason": standing["reason"] if standing else "",
                    "retry_after_s": round(
                        max(standing["until"] - now, 0.0), 3
                    ) if standing else 0.0,
                    "strikes": standing["strikes"] if standing else 0,
                    "degraded_streak": self._degraded.get(
                        rank, {}
                    ).get("streak", 0),
                }
            # a quarantined host may predate any accepted fingerprint
            for rank, standing in self._quarantine.items():
                hosts.setdefault(str(rank), {
                    "legs": {}, "history": {}, "samples": 0,
                    "updated": standing["t"],
                    "verdict": standing["verdict"],
                    "reason": standing["reason"],
                    "retry_after_s": round(
                        max(standing["until"] - now, 0.0), 3
                    ),
                    "strikes": standing["strikes"],
                    "degraded_streak": 0,
                })
            return {
                "hosts": hosts,
                "quarantined": sorted(self._quarantine),
            }

    # ------------------------------------------------------- durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "fingerprints": {
                    str(r): {
                        "legs": dict(fp["legs"]),
                        "history": {
                            leg: list(v)
                            for leg, v in fp["history"].items()
                        },
                        "samples": fp["samples"],
                        "updated": fp["updated"],
                    }
                    for r, fp in self._fingerprints.items()
                },
                "quarantine": {
                    str(r): dict(e)
                    for r, e in self._quarantine.items()
                },
                "degraded": {
                    str(r): dict(e)
                    for r, e in self._degraded.items()
                },
            }

    def restore_state(self, state: dict):
        """Absolute-state restore (snapshot section AND the ``health``
        WAL op replay — upsert semantics, so over-replaying the WAL
        tail around a snapshot boundary is a no-op)."""
        with self._lock:
            for r, fp in (state.get("fingerprints") or {}).items():
                self._fingerprints[int(r)] = {
                    "legs": {
                        k: float(v)
                        for k, v in (fp.get("legs") or {}).items()
                    },
                    "history": {
                        k: [float(x) for x in v]
                        for k, v in (fp.get("history") or {}).items()
                    },
                    "samples": int(fp.get("samples", 0)),
                    "updated": float(fp.get("updated", 0.0)),
                }
            for r, e in (state.get("quarantine") or {}).items():
                self._quarantine[int(r)] = dict(e)
            for r, e in (state.get("degraded") or {}).items():
                self._degraded[int(r)] = dict(e)
        logger.info(
            "health restored: %d fingerprint(s), %d quarantined",
            len(state.get("fingerprints") or {}),
            len(state.get("quarantine") or {}),
        )
