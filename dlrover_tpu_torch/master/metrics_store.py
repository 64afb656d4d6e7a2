"""Master-side metrics store: per-(source, metric) time series with
tiered downsampling, plus the SLO watchdog that turns them into
operator-facing breach verdicts.

Equivalent capability: the reference DLRover's Brain service keeps a
runtime-metrics datastore the optimization algorithms query over time
windows; our telemetry merge (``common/telemetry.JobTelemetry``) only
ever held the LATEST cumulative snapshot per source — no history, so
"this run got slower" was invisible until someone diffed two offline
reports. This module is the history:

- **Ingestion** rides the existing telemetry relay: every gauge a
  process sets carries a bounded time-series ring in its snapshot
  (``TelemetryRegistry._series``), and the servicer feeds those points
  — full snapshots and deltas alike — into the store. Points are
  deduplicated by per-source sample sequence, so re-sent snapshots
  (agent re-registration, post-failover full re-sends) are idempotent.
- **Tiered downsampling** bounds memory: the newest points stay raw
  (``RAW_MAXLEN`` per series), and every point also folds into 10 s and
  1 min aggregate buckets (count/sum/min/max/last) with their own
  bounded rings — a day-long run keeps minutes of raw detail and hours
  of aggregate trend per metric.
- **Failover durability**: ``export_state``/``restore_state`` ride the
  PR-5 master state snapshot, so a restarted master resumes with its
  history (and its dedup high-water marks) intact.
- **Query** over the existing RPC plane (``MetricsQueryRequest``) and
  the read-only HTTP plane (``/series.json``).

The :class:`SloWatchdog` below consumes the store plus the merged
ledger and raises ``slo.breach`` events through the PR-6 diagnosis
pipeline, so SLO regressions land next to straggler/hang verdicts.

The PyTorch port's copy of dlrover_tpu/master/metrics_store.py.
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

# newest raw points kept per (source, metric, labels) series
RAW_MAXLEN = 1024
# downsampling tiers: resolution name -> (bucket seconds, buckets kept)
TIERS = {
    "10s": (10.0, 360),   # ~1 hour of 10 s aggregates
    "1m": (60.0, 360),    # ~6 hours of 1 min aggregates
}
RESOLUTIONS = ("raw",) + tuple(TIERS)
# total series cap: every worker restart is a NEW source (role-rank-
# pid), so a long elastic job accumulates dead sources forever without
# an eviction bound — the stalest series (oldest newest-point) goes
MAX_SERIES = 4096


def _labels_key(labels: dict) -> tuple:
    return tuple(sorted((labels or {}).items()))


class MetricsStore:
    """Bounded per-(source, metric) series with tiered downsampling."""

    def __init__(
        self,
        raw_maxlen: int = RAW_MAXLEN,
        tiers=None,
        max_series: int = MAX_SERIES,
    ):
        self._lock = threading.Lock()
        self._raw_maxlen = raw_maxlen
        self._tiers = dict(tiers if tiers is not None else TIERS)
        self._max_series = max_series
        # (source, name, labels_key) -> series entry
        self._series: dict[tuple, dict] = {}

    def _entry(self, key: tuple) -> dict:
        entry = self._series.get(key)
        if entry is None:
            if len(self._series) >= self._max_series:
                # evict the stalest series (oldest newest-point):
                # typically a dead worker incarnation's leftovers
                stalest = min(
                    self._series,
                    key=lambda k: self._series[k]["last_t"],
                )
                del self._series[stalest]
            entry = self._series[key] = {
                "last_sseq": 0,
                "last_t": 0.0,
                "raw": deque(maxlen=self._raw_maxlen),
                "tiers": {
                    res: deque(maxlen=keep)
                    for res, (_step, keep) in self._tiers.items()
                },
            }
        return entry

    # ------------------------------------------------------------- ingest

    def ingest_snapshot(self, snap: dict) -> int:
        """Fold one telemetry snapshot's (full or delta) series points
        in. Idempotent: each source's points carry a monotonic sample
        seq, and only points above the series' high-water mark land —
        a re-sent full snapshot after re-registration adds nothing
        twice. Returns the number of NEW points ingested."""
        if not isinstance(snap, dict) or not snap.get("source"):
            return 0
        source = str(snap["source"])
        added = 0
        with self._lock:
            for s in snap.get("series") or ():
                key = (source, s["name"], _labels_key(s.get("labels")))
                entry = self._entry(key)
                for p in s.get("points") or ():
                    try:
                        sseq, t, _mono, value = p
                    except (TypeError, ValueError):
                        continue
                    if sseq <= entry["last_sseq"]:
                        continue
                    entry["last_sseq"] = sseq
                    entry["last_t"] = max(entry["last_t"], float(t))
                    entry["raw"].append((float(t), float(value)))
                    self._fold(entry, float(t), float(value))
                    added += 1
        return added

    def _fold(self, entry: dict, t: float, value: float):
        for res, (step, _keep) in self._tiers.items():
            t0 = (t // step) * step
            ring = entry["tiers"][res]
            agg = ring[-1] if ring else None
            if agg is None or agg["t0"] != t0:
                ring.append({
                    "t0": t0, "count": 1, "sum": value,
                    "min": value, "max": value, "last": value,
                })
            else:
                agg["count"] += 1
                agg["sum"] += value
                agg["min"] = min(agg["min"], value)
                agg["max"] = max(agg["max"], value)
                agg["last"] = value

    # -------------------------------------------------------------- query

    def names(self) -> list[dict]:
        with self._lock:
            return [
                {"source": src, "name": name, "labels": dict(labels)}
                for (src, name, labels) in sorted(self._series)
            ]

    def query(
        self,
        name: str,
        source: str | None = None,
        labels: dict | None = None,
        resolution: str = "raw",
        since: float = 0.0,
        limit: int = 0,
    ) -> list[dict]:
        """Matching series, each as ``{source, name, labels, points}``.

        ``resolution="raw"`` points are ``[t, value]``; tier points are
        ``[t0, count, sum, min, max, last]`` (one per bucket). ``since``
        filters by wall-clock; ``limit`` keeps the newest N points."""
        if resolution not in RESOLUTIONS:
            raise ValueError(
                f"resolution {resolution!r} not in {RESOLUTIONS}"
            )
        want_labels = _labels_key(labels) if labels else None
        out = []
        with self._lock:
            for (src, nm, lbl), entry in sorted(self._series.items()):
                if nm != name:
                    continue
                if source is not None and src != source:
                    continue
                if want_labels is not None and lbl != want_labels:
                    continue
                if resolution == "raw":
                    points = [
                        [t, v] for t, v in entry["raw"] if t >= since
                    ]
                else:
                    points = [
                        [a["t0"], a["count"], a["sum"], a["min"],
                         a["max"], a["last"]]
                        for a in entry["tiers"][resolution]
                        if a["t0"] >= since
                    ]
                if limit > 0:
                    points = points[-limit:]
                out.append({
                    "source": src, "name": nm, "labels": dict(lbl),
                    "points": points,
                })
        return out

    def latest(self, name: str) -> dict[str, float]:
        """source -> newest raw value of ``name`` (dashboard tiles)."""
        out: dict[str, float] = {}
        with self._lock:
            for (src, nm, _lbl), entry in self._series.items():
                if nm == name and entry["raw"]:
                    out[src] = entry["raw"][-1][1]
        return out

    # -------------------------------------------- failover durability

    def export_state(self) -> dict:
        with self._lock:
            return {
                "series": [
                    {
                        "source": src,
                        "name": name,
                        "labels": list(labels),
                        "last_sseq": entry["last_sseq"],
                        "last_t": entry["last_t"],
                        "raw": [list(p) for p in entry["raw"]],
                        "tiers": {
                            res: [dict(a) for a in ring]
                            for res, ring in entry["tiers"].items()
                        },
                    }
                    for (src, name, labels), entry
                    in sorted(self._series.items())
                ],
            }

    def restore_state(self, state: dict):
        with self._lock:
            self._series = {}
            for s in state.get("series") or ():
                key = (
                    s["source"], s["name"],
                    tuple(tuple(kv) for kv in s.get("labels") or ()),
                )
                entry = self._entry(key)
                entry["last_sseq"] = int(s.get("last_sseq", 0))
                entry["last_t"] = float(s.get("last_t", 0.0))
                for p in s.get("raw") or ():
                    entry["raw"].append((float(p[0]), float(p[1])))
                for res, ring in (s.get("tiers") or {}).items():
                    dst = entry["tiers"].get(res)
                    if dst is None:
                        continue  # tier config changed across versions
                    for a in ring:
                        dst.append(dict(a))


# -------------------------------------------------------------------------
# SLO watchdog
# -------------------------------------------------------------------------

# env-overridable thresholds (ops tuning without a deploy)
STEP_REGRESSION_RATIO = float(
    os.environ.get("DLROVER_SLO_STEP_RATIO", "1.5")
)
GOODPUT_MIN = float(os.environ.get("DLROVER_SLO_GOODPUT", "0.5"))
GOODPUT_MIN_RUNTIME_S = float(
    os.environ.get("DLROVER_SLO_MIN_RUNTIME", "120")
)
MFU_DROP_RATIO = float(os.environ.get("DLROVER_SLO_MFU_DROP", "0.6"))
SLO_WINDOW = int(os.environ.get("DLROVER_SLO_WINDOW", "8"))
# serving SLOs: a TTFT p99 ceiling per decode worker and a sustained
# request-queue-depth ceiling on the master ledger — the two rules the
# repair brain's pool-scaling policy listens to
SERVE_TTFT_P99_S = float(
    os.environ.get("DLROVER_SLO_SERVE_TTFT", "2.0")
)
SERVE_QUEUE_DEPTH_MAX = int(
    os.environ.get("DLROVER_SLO_SERVE_QUEUE", "16")
)
# a TTFT series whose newest point is older than this is a dead/idle
# worker's leftovers, not a live latency signal: without the guard a
# chaos-killed worker's frozen breaching series would stand forever
# and feed the brain an endless scale-out streak
SERVE_TTFT_STALE_S = float(
    os.environ.get("DLROVER_SLO_SERVE_TTFT_STALE", "60")
)

# the gauges the rolling rules watch (emitted by trainer.py every step)
STEP_GAUGE = "train.step.last_s"
MFU_GAUGE = "train.mfu"
# per-worker TTFT gauge the serving scheduler sets on every admission
SERVE_TTFT_GAUGE = "serve.ttft.last_s"

_median = telemetry.median_baseline
_quantile = telemetry.nearest_rank_percentile


class SloWatchdog:
    """Rolling SLO rules over the metrics store + merged ledger.

    Six rules, each keyed so a breach can clear independently:

    - ``step_time:<source>`` — the rolling median of the newest
      ``window`` step durations exceeds ``ratio`` x the median of the
      preceding history (a host/job that *got slower*, regardless of
      the fleet — the straggler check needs a peer to compare against,
      this one only needs the run's own past).
    - ``goodput`` — the job-wide ledger's goodput ratio is below the
      floor after a minimum runtime (startup compile must not breach).
    - ``mfu:<source>`` — rolling-median ``train.mfu`` fell below
      ``drop_ratio`` x its own earlier baseline.
    - ``events_dropped:<source>`` — a source's bounded event ring is
      overwriting its tail on two consecutive sweeps (sustained loss:
      its merged timeline is silently incomplete).
    - ``serve_ttft:<source>`` — a decode worker's TTFT p99 over its
      newest ``serve.ttft.last_s`` points exceeds the ceiling (the
      serving arm's latency SLO).
    - ``serve_queue`` — the master's decode-request queue depth stayed
      above its ceiling for the whole window (sustained overload — the
      repair brain's pool-scaling trigger).

    New breaches emit ``slo.breach`` timeline events (master registry,
    so they ride the merged job timeline next to ``diagnosis.*``
    verdicts); recoveries emit ``slo.clear``.
    """

    def __init__(
        self,
        store: MetricsStore,
        job_telemetry,
        step_ratio: float = STEP_REGRESSION_RATIO,
        goodput_min: float = GOODPUT_MIN,
        goodput_min_runtime_s: float = GOODPUT_MIN_RUNTIME_S,
        mfu_drop_ratio: float = MFU_DROP_RATIO,
        window: int = SLO_WINDOW,
        serving=None,
        serve_ttft_p99_s: float = SERVE_TTFT_P99_S,
        serve_queue_depth_max: int = SERVE_QUEUE_DEPTH_MAX,
    ):
        self._store = store
        self._telemetry = job_telemetry
        self._step_ratio = step_ratio
        self._goodput_min = goodput_min
        self._goodput_min_runtime = goodput_min_runtime_s
        self._mfu_drop = mfu_drop_ratio
        self._window = max(window, 2)
        # the serving request ledger (serving/manager.py); None on a
        # master without a serving arm — the serve rules just idle
        self._serving = serving
        self._serve_ttft_p99 = serve_ttft_p99_s
        self._serve_queue_max = serve_queue_depth_max
        # queue-depth samples taken once per check (sustained = every
        # sample of the newest window above the ceiling)
        self._queue_hist: deque = deque(maxlen=64)
        self._breaches: dict[str, dict] = {}
        # source -> events_dropped seen on the previous sweep
        self._prev_dropped: dict[str, int] = {}

    # ------------------------------------------------------------- rules

    def _rolling_windows(self, name: str):
        """Yield (source, baseline_median, recent_median) for every
        series of ``name`` with enough history: recent = the newest
        ``window`` raw points, baseline = the (up to 8x window) points
        before them."""
        w = self._window
        for series in self._store.query(name, resolution="raw"):
            vals = [v for _t, v in series["points"]]
            if len(vals) < 2 * w:
                continue
            recent = vals[-w:]
            baseline = vals[-9 * w:-w]
            yield (
                series["source"], _median(baseline), _median(recent),
            )

    def _check_step_time(self, breaches: dict):
        for source, base, recent in self._rolling_windows(STEP_GAUGE):
            if base > 0 and recent > self._step_ratio * base:
                breaches[f"step_time:{source}"] = {
                    "rule": "step_time_regression",
                    "source": source,
                    "recent_median_s": round(recent, 6),
                    "baseline_median_s": round(base, 6),
                    "ratio": round(recent / base, 3),
                    "threshold": self._step_ratio,
                }

    def _check_mfu(self, breaches: dict):
        for source, base, recent in self._rolling_windows(MFU_GAUGE):
            if base > 0 and recent < self._mfu_drop * base:
                breaches[f"mfu:{source}"] = {
                    "rule": "mfu_drop",
                    "source": source,
                    "recent_median": round(recent, 6),
                    "baseline_median": round(base, 6),
                    "ratio": round(recent / base, 3),
                    "threshold": self._mfu_drop,
                }

    def _check_goodput(self, breaches: dict, now: float):
        ledger = self._telemetry.ledger(now=now)
        total = ledger.get("total_s", 0.0)
        if total < self._goodput_min_runtime:
            return
        goodput = ledger.get("goodput", 0.0)
        if goodput < self._goodput_min:
            cats = ledger.get("categories", {})
            worst = max(
                (c for c in cats if c != "productive"),
                key=lambda c: cats[c],
                default="idle",
            )
            breaches["goodput"] = {
                "rule": "goodput_below_threshold",
                "goodput": round(goodput, 4),
                "threshold": self._goodput_min,
                "total_s": round(total, 3),
                "dominant_loss": worst,
            }

    def _check_serve_ttft(self, breaches: dict, now: float):
        """Per-worker TTFT p99 ceiling over the newest raw points of
        the ``serve.ttft.last_s`` gauge each decode worker ships.
        Series gone stale (dead or idle worker) are skipped so their
        frozen history cannot hold a breach standing forever."""
        for series in self._store.query(
            SERVE_TTFT_GAUGE, resolution="raw"
        ):
            points = series["points"][-64:]
            if points and now - points[-1][0] > SERVE_TTFT_STALE_S:
                continue
            vals = [v for _t, v in points]
            if len(vals) < self._window:
                continue
            p99 = _quantile(vals, 0.99)
            if p99 > self._serve_ttft_p99:
                breaches[f"serve_ttft:{series['source']}"] = {
                    "rule": "serve_ttft_p99",
                    "source": series["source"],
                    "ttft_p99_s": round(p99, 6),
                    "threshold_s": self._serve_ttft_p99,
                    "samples": len(vals),
                }

    def _check_serve_queue(self, breaches: dict):
        """Sustained decode-queue depth: every sample of the newest
        window above the ceiling (one submit burst the pool absorbs is
        not a breach; a queue the pool never drains is)."""
        serving = self._serving
        if serving is None:
            return
        # drive the ledger's lease-expiry sweep from the master's own
        # pulse: even with ZERO surviving workers (nobody left to
        # lease), wedged requests re-queue / fail here instead of
        # sitting in "leased" forever — and the re-queued depth is
        # what this rule then prices
        sweep = getattr(serving, "sweep", None)
        if sweep is not None:
            sweep()
        self._queue_hist.append(int(serving.queue_depth()))
        w = self._window
        if len(self._queue_hist) < w:
            return
        recent = list(self._queue_hist)[-w:]
        if min(recent) > self._serve_queue_max:
            breaches["serve_queue"] = {
                "rule": "serve_queue_depth",
                "depth": recent[-1],
                "min_over_window": min(recent),
                "threshold": self._serve_queue_max,
                "window": w,
            }

    def _check_events_dropped(self, breaches: dict):
        current: dict[str, int] = {}
        for snap in self._telemetry.snapshots():
            source = snap.get("source")
            dropped = int(snap.get("events_dropped", 0) or 0)
            current[source] = dropped
            # the counter is cumulative and never resets, so "still
            # nonzero" would turn one early burst into a permanent
            # breach. Sustained loss = the count GREW since the
            # previous sweep (loss is active right now); a burst that
            # stopped clears on the next sweep — the one-time warning
            # surface is obs_report's events_dropped banner.
            prev = self._prev_dropped.get(source)
            if prev is not None and dropped > prev:
                breaches[f"events_dropped:{source}"] = {
                    "rule": "events_dropped",
                    "source": source,
                    "dropped": dropped,
                    "dropped_since_last_sweep": dropped - prev,
                }
        self._prev_dropped = current

    # ------------------------------------------------------------- check

    def check(self, now: float | None = None) -> dict[str, dict]:
        """Run every rule; emit ``slo.breach``/``slo.clear`` events on
        transitions; return the standing breaches (keyed as above)."""
        now = time.time() if now is None else now
        breaches: dict[str, dict] = {}
        self._check_step_time(breaches)
        self._check_mfu(breaches)
        self._check_goodput(breaches, now)
        self._check_serve_ttft(breaches, now)
        self._check_serve_queue(breaches)
        self._check_events_dropped(breaches)
        for key, info in breaches.items():
            if key not in self._breaches:
                logger.warning("SLO breach %s: %s", key, info)
                telemetry.event("slo.breach", key=key, **info)
        for key, info in self._breaches.items():
            if key not in breaches:
                telemetry.event(
                    "slo.clear", key=key, rule=info.get("rule", "")
                )
        self._breaches = breaches
        return dict(breaches)

    def breaches(self) -> dict[str, dict]:
        return dict(self._breaches)
