"""Unified in-process telemetry: metrics registry + event timeline +
goodput accounting.

Equivalent capability: the reference gets operator-facing observability
from two stacks — the brain's metric collectors (dlrover/python/master/
stats) feeding its optimization algorithms, and the xpu_timer shm ring ->
Prometheus export for per-kernel timing. Our reproduction had fragments
of both (trainer/profiler.py XPlane traces, agent/monitor.py resource
samples, master/stats.py runtime history) but no shared registry, no
cross-layer event timeline, and no way to answer "what fraction of
wall-clock was productive training vs. rendezvous/restart/checkpoint
stalls". This module is that shared layer:

- **Metrics registry**: counters, gauges, histograms with fixed bucket
  boundaries (Prometheus ``le`` convention), thread-safe, dependency-free.
- **Event timeline**: ``event(kind, **fields)`` appends a monotonic- and
  wall-timestamped record to a bounded ring; events with a ``dur`` field
  double as attributed wall-clock intervals.
- **Snapshots**: each process serializes its registry to JSON
  (cumulative, idempotent to re-merge); agents ship snapshots to the
  master over the existing RPC path, and/or flush them to
  ``DLROVER_TELEMETRY_DIR`` so they survive the process.
- **Goodput ledger**: :func:`goodput_ledger` sweeps the merged timeline
  and attributes every second of job wall-clock to one of
  ``{productive, compile, checkpoint, restart, rendezvous, idle}``.
  Categories sum to the total span by construction (idle is the
  uncovered remainder; overlaps resolve by fixed priority).

No-op contract (mirrors :mod:`dlrover_tpu.common.chaos`): when disabled
(``DLROVER_TELEMETRY=0``, read ONCE at import) every module-level hook is
a module-global load plus an ``is None`` branch — no locks, no dict work,
no registry machinery. Enabled (the default), the cost per hook is one
lock + one dict update, on paths already dominated by socket/disk/device
IO.

Reserved event fields: ``seq``, ``t`` (wall clock, merge ordering),
``mono`` (monotonic, in-process durations), ``kind``, ``dur`` (seconds;
makes the event an attributable interval ``[t - dur, t]``).
"""

from __future__ import annotations

import atexit
import bisect
import json
import os
import threading
import time
from collections import deque

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

ENV_VAR = "DLROVER_TELEMETRY"        # "0"/"false"/"off" disables
ENV_DIR = "DLROVER_TELEMETRY_DIR"    # set => flush() writes snapshots here
ENV_ROLE = "DLROVER_TELEMETRY_ROLE"  # worker | agent | master (labeling)

SNAPSHOT_FORMAT = 1
MAX_EVENTS = 4096
# per-gauge time-series ring length: enough for a live dashboard's
# recent-history sparkline at per-step cadence without letting a
# thousand-gauge process grow its snapshot unboundedly
SERIES_MAXLEN = 256

# Latency-shaped defaults: sub-ms RPCs through multi-minute restores.
DEFAULT_BUCKETS = (
    0.001, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0, 60.0, 120.0, 300.0,
)


def _key(name: str, labels: dict) -> tuple:
    return (name, tuple(sorted(labels.items())))


# the ONE place that knows the snapshot-file naming convention — flush,
# the agent's relay, and from_dir all build on these two helpers, so a
# rename can never silently decouple writers from readers
_SNAPSHOT_PREFIX = "telemetry_"
_SNAPSHOT_SUFFIX = ".json"


def snapshot_filename(source: str) -> str:
    return f"{_SNAPSHOT_PREFIX}{source}{_SNAPSHOT_SUFFIX}"


def snapshot_files(path: str):
    """Yield ``(file_path, source)`` for every snapshot file in a
    telemetry directory (empty when the dir is absent)."""
    try:
        names = sorted(os.listdir(path))
    except OSError:
        return
    for name in names:
        if not (
            name.startswith(_SNAPSHOT_PREFIX)
            and name.endswith(_SNAPSHOT_SUFFIX)
        ):
            continue
        source = name[len(_SNAPSHOT_PREFIX):-len(_SNAPSHOT_SUFFIX)]
        yield os.path.join(path, name), source


class _Histogram:
    """Fixed-boundary histogram. Bucket ``i`` counts observations with
    ``value <= bounds[i]`` (Prometheus ``le``); the last bucket is +Inf."""

    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds):
        self.bounds = tuple(float(b) for b in bounds)
        if list(self.bounds) != sorted(set(self.bounds)):
            raise ValueError(f"bucket bounds must be sorted unique: {bounds}")
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, value: float):
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.count += 1


def median_baseline(values) -> float:
    """The fleet-baseline convention shared by the probe-round
    straggler rule (``rendezvous.get_stragglers``) and the runtime
    diagnosis (``master/diagnosis.py``): true median (middle value, or
    mean of the two middles), EXCEPT with exactly two hosts the faster
    one is the baseline — otherwise the slow host's own time dominates
    the median and a >k x-median rule can never fire. One definition so
    the two rules cannot drift."""
    values = sorted(values)
    n = len(values)
    if not n:
        return 0.0
    if n == 2:
        return values[0]
    if n % 2 == 1:
        return values[n // 2]
    return (values[n // 2 - 1] + values[n // 2]) / 2


def nearest_rank_percentile(values, q: float) -> float:
    """Nearest-rank percentile (q in [0, 1]) of an unsorted iterable,
    0.0 when empty. One definition shared by the serving SLO rule
    (``metrics_store.SloWatchdog``) and the load generator's headline
    TTFT keys (``serving/loadgen.py``) so the gate and the bench can
    never drift."""
    ordered = sorted(values)
    if not ordered:
        return 0.0
    k = min(int(q * len(ordered)), len(ordered) - 1)
    return float(ordered[k])


# how many trailing points of each gauge series ride a flight-recorder
# or capture artifact: the quantitative lead-up to a crash/anomaly
# (step-time, MFU, HBM trend), without shipping whole rings
SERIES_TAIL_POINTS = 32


def series_tail(series_list, n: int = SERIES_TAIL_POINTS) -> list:
    """Trim a snapshot's ``series`` section to the newest ``n`` points
    per series. One definition shared by the flight recorder and the
    deep-capture artifact writer so post-mortems carry the same
    quantitative tail everywhere."""
    out = []
    for s in series_list or ():
        points = list(s.get("points") or ())[-n:]
        if points:
            out.append({
                "name": s.get("name"),
                "labels": dict(s.get("labels") or {}),
                "points": points,
            })
    return out


def sum_bucket_counts(hists):
    """Element-wise sum of le-bucket histogram series (snapshot-dict
    shape: ``{"bounds": [...], "counts": [...]}``). The first series'
    bounds win; series with mismatched bounds are skipped rather than
    mis-merged. Returns ``(bounds, counts)`` — ``(None, None)`` when
    the input is empty. Shared by every surface that collapses
    per-label series into one quantile (bench, obs_report)."""
    hists = list(hists)
    if not hists:
        return None, None
    bounds = hists[0]["bounds"]
    counts = [0] * (len(bounds) + 1)
    for h in hists:
        if h["bounds"] != bounds:
            continue
        counts = [a + b for a, b in zip(counts, h["counts"])]
    return bounds, counts


def hist_quantile(bounds, counts, q: float) -> float:
    """Estimate the ``q``-quantile (0..1) of a le-bucket histogram by
    linear interpolation inside the containing bucket (the Prometheus
    ``histogram_quantile`` rule).

    ``counts`` has ``len(bounds) + 1`` entries, the last being +Inf.
    Observations in the +Inf bucket clamp to the last finite bound (no
    upper edge to interpolate toward); an empty histogram returns NaN.
    """
    bounds = list(bounds)
    counts = list(counts)
    total = sum(counts)
    if total <= 0 or not bounds:
        return float("nan")
    q = min(max(q, 0.0), 1.0)
    target = q * total
    cum = 0.0
    for i, c in enumerate(counts):
        prev_cum = cum
        cum += c
        if cum < target or c == 0:
            continue
        if i >= len(bounds):
            return float(bounds[-1])  # +Inf bucket: clamp
        lo = bounds[i - 1] if i > 0 else 0.0
        hi = bounds[i]
        return lo + (hi - lo) * ((target - prev_cum) / c)
    return float(bounds[-1])


class TelemetryRegistry:
    """One per process. All hooks funnel here; ``snapshot()`` serializes
    the whole state (cumulative — re-merging the same snapshot is
    idempotent on the receiving side)."""

    def __init__(self, source: str | None = None):
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, _Histogram] = {}
        self._events: deque = deque(maxlen=MAX_EVENTS)
        self._dropped = 0
        self._seq = 0
        # per-gauge time-series rings: every gauge_set appends a
        # (sample_seq, wall, mono, value) point so consumers get recent
        # HISTORY (sparklines, downsampling, SLO baselines), not just
        # the latest value. sample_seq is the delta-shipping cursor —
        # points above the last acked seq are the only ones re-sent.
        self._series: dict[tuple, deque] = {}
        self._sample_seq = 0
        self.created = time.time()
        self.created_mono = time.monotonic()
        self.role = os.environ.get(ENV_ROLE, "proc")
        # NODE rank, not global worker RANK: every diagnosis consumer
        # (straggler/hang verdicts, exclude_straggler, flight-dump
        # targeting) operates in the node-rank domain, and with
        # nproc_per_node > 1 the two differ — keying worker snapshots
        # by global RANK would blame the wrong host. The pid keeps
        # sources unique across a node's workers and restarts.
        rank = os.environ.get("NODE_RANK") or os.environ.get("RANK") or "0"
        self.source = source or f"{self.role}-{rank}-{os.getpid()}"

    # ------------------------------------------------------------- metrics

    def counter_inc(self, name: str, value: float = 1.0, /, **labels):
        key = _key(name, labels)
        with self._lock:
            self._counters[key] = self._counters.get(key, 0.0) + value

    def gauge_set(self, name: str, value: float, /, **labels):
        key = _key(name, labels)
        with self._lock:
            self._gauges[key] = float(value)
            ring = self._series.get(key)
            if ring is None:
                ring = self._series[key] = deque(maxlen=SERIES_MAXLEN)
            self._sample_seq += 1
            ring.append((
                self._sample_seq, time.time(), time.monotonic(),
                float(value),
            ))

    def observe(self, name: str, value: float, /, buckets=None, **labels):
        key = _key(name, labels)
        with self._lock:
            hist = self._hists.get(key)
            if hist is None:
                hist = self._hists[key] = _Histogram(
                    buckets or DEFAULT_BUCKETS
                )
            hist.observe(float(value))

    # ------------------------------------------------------------ timeline

    def event(self, kind: str, /, **fields):
        with self._lock:
            self._seq += 1
            if len(self._events) == MAX_EVENTS:
                self._dropped += 1
            self._events.append({
                "seq": self._seq,
                "t": time.time(),
                "mono": time.monotonic(),
                "kind": kind,
                **fields,
            })

    # ------------------------------------------------------------ snapshot

    @staticmethod
    def _metric_list(d: dict) -> list:
        return [
            {"name": name, "labels": dict(labels), "value": value}
            for (name, labels), value in sorted(d.items())
        ]

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot_locked()

    def snapshot_best_effort(self, lock_timeout: float = 1.0) -> dict:
        """Snapshot that can run in a SIGNAL HANDLER: a handler runs on
        the main thread between bytecodes, so if the signal interrupted
        this very thread inside a registry hook, ``snapshot()`` would
        self-deadlock on the non-reentrant lock. Bounded acquire, then
        a lockless read as last resort — a torn copy of a dying
        process's metrics beats a process that never dies."""
        acquired = self._lock.acquire(timeout=max(lock_timeout, 0.0))
        try:
            try:
                return self._snapshot_locked()
            except RuntimeError:
                # the unlocked read raced a writer (deque/dict mutated
                # during iteration): degrade to the envelope alone
                pass
        finally:
            if acquired:
                self._lock.release()
        return {
            "format": SNAPSHOT_FORMAT,
            "source": self.source,
            "role": self.role,
            "pid": os.getpid(),
            "created": self.created,
            "now": time.time(),
            "counters": [], "gauges": [], "histograms": [],
            "series": [], "events": [], "events_dropped": self._dropped,
        }

    def _snapshot_locked(self) -> dict:
        return {
            "format": SNAPSHOT_FORMAT,
            "source": self.source,
            "role": self.role,
            "pid": os.getpid(),
            "created": self.created,
            "now": time.time(),
            "counters": self._metric_list(self._counters),
            "gauges": self._metric_list(self._gauges),
            "histograms": [
                {
                    "name": name,
                    "labels": dict(labels),
                    "bounds": list(h.bounds),
                    "counts": list(h.counts),
                    "sum": h.sum,
                    "count": h.count,
                }
                for (name, labels), h in sorted(self._hists.items())
            ],
            "series": [
                {
                    "name": name,
                    "labels": dict(labels),
                    # [sample_seq, wall, mono, value] per point
                    "points": [list(p) for p in ring],
                }
                for (name, labels), ring in sorted(self._series.items())
            ],
            "sample_seq": self._sample_seq,
            "events": [dict(e) for e in self._events],
            # no silent truncation: the ring is bounded, and a merge
            # must be able to tell "quiet" from "overwrote the tail"
            "events_dropped": self._dropped,
        }

    def flush(self, path: str | None = None) -> str | None:
        """Write the snapshot JSON atomically. Default destination is
        ``$DLROVER_TELEMETRY_DIR/telemetry_<source>.json``; without a
        directory (and no explicit path) this is a no-op — the registry
        stays purely in-memory."""
        if path is None:
            out_dir = os.environ.get(ENV_DIR, "")
            if not out_dir:
                return None
            os.makedirs(out_dir, exist_ok=True)
            path = os.path.join(out_dir, snapshot_filename(self.source))
        snap = self.snapshot()
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            with open(tmp, "w") as f:
                json.dump(snap, f)
            os.replace(tmp, path)
        except OSError as e:
            logger.warning("telemetry flush to %s failed: %s", path, e)
            return None
        return path


# -------------------------------------------------------------------------
# module-global arming (the chaos-style no-op pattern)
# -------------------------------------------------------------------------

_REGISTRY: TelemetryRegistry | None = None


def counter_inc(name: str, value: float = 1.0, /, **labels):
    reg = _REGISTRY
    if reg is None:
        return
    reg.counter_inc(name, value, **labels)


def gauge_set(name: str, value: float, /, **labels):
    reg = _REGISTRY
    if reg is None:
        return
    reg.gauge_set(name, value, **labels)


def observe(name: str, value: float, /, buckets=None, **labels):
    reg = _REGISTRY
    if reg is None:
        return
    reg.observe(name, value, buckets, **labels)


def event(kind: str, /, **fields):
    reg = _REGISTRY
    if reg is None:
        return
    reg.event(kind, **fields)


def snapshot() -> dict | None:
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.snapshot()


def snapshot_best_effort(lock_timeout: float = 1.0) -> dict | None:
    """Signal-handler-safe snapshot (see
    :meth:`TelemetryRegistry.snapshot_best_effort`)."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.snapshot_best_effort(lock_timeout)


def flush(path: str | None = None) -> str | None:
    """Persist this process's snapshot (no-op when disabled or when no
    ``DLROVER_TELEMETRY_DIR``/path is configured). Crash-path callers
    (e.g. a chaos ``kill``) invoke this right before ``os._exit``."""
    reg = _REGISTRY
    if reg is None:
        return None
    return reg.flush(path)


def active_registry() -> TelemetryRegistry | None:
    return _REGISTRY


def enable(source: str | None = None) -> TelemetryRegistry:
    """(Re-)arm a fresh registry in this process (tests/tools)."""
    global _REGISTRY
    _REGISTRY = TelemetryRegistry(source)
    return _REGISTRY


def disable():
    global _REGISTRY
    _REGISTRY = None


def install_from_env() -> TelemetryRegistry | None:
    """One env read, at import time — never in the hot path. Telemetry is
    ON by default (pure in-memory, bounded); ``DLROVER_TELEMETRY=0``
    turns every hook into a global-load + is-None branch."""
    if os.environ.get(ENV_VAR, "1").strip().lower() in (
        "0", "false", "off", "no",
    ):
        disable()
        return None
    return enable()


# -------------------------------------------------------------------------
# goodput accounting
# -------------------------------------------------------------------------

CATEGORIES = (
    "productive", "compile", "checkpoint", "reshape", "restart",
    "rendezvous", "idle",
)

# kind -> ledger category, for events that carry a ``dur`` interval.
# NOTE ckpt.persist (the agent daemon's async shm->storage copy) is
# deliberately absent: it overlaps training and costs no goodput; only
# the trainer-side save pause (ckpt.save) and the blocking end-of-run
# persist wait (ckpt.persist.wait) do.
EVENT_CATEGORY = {
    "step.end": "productive",
    "compile": "compile",
    "ckpt.save": "checkpoint",
    "ckpt.persist.wait": "checkpoint",
    "ckpt.restore": "restart",
    # the restore pipeline's blocking device-transfer barrier: without
    # its own (checkpoint-priority) interval the multi-minute H2D wait
    # of a standalone restore would sweep into ``idle``; inside a full
    # ckpt.restore interval it claims checkpoint over the coarser
    # restart attribution, so the transfer leg stays visible
    "ckpt.restore.h2d": "checkpoint",
    "rdzv.wait": "rendezvous",
    # in-process mesh reshape on a membership change (drain -> reshard
    # -> resume, no process restart): its own bucket so the goodput
    # ledger can price a scale event at seconds instead of burying it
    # in ``restart``
    "elastic.reshape": "reshape",
    # the doomed host's half of an announced-preemption drain
    # (checkpoint flush + drained departure + clean worker stop): part
    # of the planned scale event, priced with it — and the marker the
    # incarnation-gap sweep below uses to re-charge the teardown gap
    # from ``restart`` to ``reshape``
    "elastic.drained": "reshape",
    # the agent's master-outage ride-through: emitted with the outage
    # duration once the (restarted) master answers again. Charged to
    # ``restart`` — anything workers productively overlapped still wins
    # by sweep priority, so only the genuinely stalled span is billed.
    "master.restart": "restart",
    "master.lost": "restart",
}

# overlap resolution, highest first (a checkpoint pause inside a step
# window counts as checkpoint only if the step didn't claim it; the
# agent's rendezvous wait must show through the coarse dead-worker
# restart gap it sits inside; a reshape's internal checkpoint pull
# (``ckpt.restore``/``.h2d`` sub-intervals) stays charged to the
# reshape, which is why reshape outranks checkpoint)
_PRIORITY = (
    "productive", "compile", "reshape", "checkpoint", "rendezvous",
    "restart",
)

# a drained-departure marker claims an incarnation gap when it falls
# inside the gap or this many seconds before it (the agent emits the
# marker after stopping its workers, so the worker's last event can
# slightly precede it — and the checkpoint-flush leg of the drain runs
# before the marker lands)
_DRAIN_GAP_SLACK_S = 30.0


def _interval_events(snap: dict):
    for ev in snap.get("events", ()):
        cat = EVENT_CATEGORY.get(ev.get("kind"))
        dur = ev.get("dur")
        if cat is None or not dur or dur <= 0:
            continue
        t = float(ev["t"])
        yield (t - float(dur), t, cat)


def goodput_ledger(snapshots, now: float | None = None) -> dict:
    """Attribute job wall-clock to goodput categories.

    The span runs from the earliest event interval start to the latest
    event time (or ``now`` when given, for live jobs). Gaps between
    successive *worker* incarnations (kill -> next worker process) are
    attributed to ``restart`` unless a higher-priority interval (e.g.
    the agent's ``rdzv.wait``) covers them. A single sweep resolves
    overlaps by fixed priority, so the categories sum to the span
    exactly.

    Multi-node note: the sweep collapses concurrent nodes onto one
    timeline (a utilization view — "was ANYONE productive"); per-node
    ledgers come from calling this with one node's snapshots.
    """
    intervals: list[tuple[float, float, str]] = []
    tmin = tmax = None
    worker_ranges = []
    drained_marks: list[float] = []
    for snap in snapshots:
        events = snap.get("events") or []
        times = [float(e["t"]) for e in events]
        if times:
            lo, hi = min(times), max(times)
            tmin = lo if tmin is None else min(tmin, lo)
            tmax = hi if tmax is None else max(tmax, hi)
            if snap.get("role") == "worker":
                worker_ranges.append((lo, hi))
        for ev in events:
            # agent/host-emitted drained markers: an announced
            # preemption whose predictive drain SUCCEEDED (checkpoint
            # flushed, departure reported) — the teardown gap it
            # brackets is a planned scale event, not a restart
            if ev.get("kind") == "elastic.drained":
                drained_marks.append(float(ev["t"]))
        for iv in _interval_events(snap):
            intervals.append(iv)
            tmin = iv[0] if tmin is None else min(tmin, iv[0])
    if tmin is None:
        return {
            "start": 0.0, "end": 0.0, "total_s": 0.0,
            "categories": {c: 0.0 for c in CATEGORIES},
            "goodput": 0.0,
        }
    end = max(tmax, now) if now is not None else tmax
    # dead-worker gaps: between one worker incarnation's last activity
    # and the next incarnation's first — restart time, unless something
    # more specific (rendezvous) claims part of it. EXCEPT a gap a
    # drained-departure marker brackets: a notice-then-teardown whose
    # predictive drain succeeded used to be charged to ``restart`` all
    # the same, which made announced preemptions look exactly as
    # expensive as unannounced ones — that gap is the planned scale
    # event and accounts as ``reshape``. A marker must sit near the
    # GAP'S START (within the slack window either side) and each
    # marker claims at most one gap, so one drain cannot whitewash a
    # later unrelated restart. (Collapsed-timeline caveat: like the
    # rest of this utilization view, a drained marker from a
    # CONCURRENT node's event can claim an unrelated gap; per-node
    # ledgers disambiguate.)
    worker_ranges.sort()
    drained_marks.sort()
    for (prev_lo, prev_hi), (next_lo, _next_hi) in zip(
        worker_ranges, worker_ranges[1:]
    ):
        if next_lo > prev_hi:
            cat = "restart"
            hi_bound = min(next_lo, prev_hi + _DRAIN_GAP_SLACK_S)
            for i, d in enumerate(drained_marks):
                if prev_hi - _DRAIN_GAP_SLACK_S <= d <= hi_bound:
                    cat = "reshape"
                    del drained_marks[i]  # one claim per marker
                    break
            intervals.append((prev_hi, next_lo, cat))

    totals = _sweep(intervals, tmin, end)
    total = end - tmin
    return {
        "start": tmin,
        "end": end,
        "total_s": total,
        "categories": totals,
        "goodput": (totals["productive"] / total) if total > 0 else 0.0,
    }


def _sweep(intervals, lo: float, hi: float) -> dict:
    """Boundary sweep: each instant gets its highest-priority active
    category (idle when none). O(n log n); exact partition of [lo, hi]."""
    totals = {c: 0.0 for c in CATEGORIES}
    if hi <= lo:
        return totals
    deltas: dict[float, dict[str, int]] = {}
    for start, end, cat in intervals:
        start, end = max(start, lo), min(end, hi)
        if end <= start:
            continue
        deltas.setdefault(start, {}).setdefault(cat, 0)
        deltas[start][cat] += 1
        deltas.setdefault(end, {}).setdefault(cat, 0)
        deltas[end][cat] -= 1
    active = {c: 0 for c in _PRIORITY}
    prev = lo
    for t in sorted(deltas):
        if t > prev:
            cat = next(
                (c for c in _PRIORITY if active.get(c, 0) > 0), "idle"
            )
            totals[cat] += t - prev
            prev = t
        for cat, d in deltas[t].items():
            active[cat] = active.get(cat, 0) + d
    if hi > prev:
        cat = next((c for c in _PRIORITY if active.get(c, 0) > 0), "idle")
        totals[cat] += hi - prev
    return totals


# -------------------------------------------------------------------------
# delta-encoded shipping (agent -> master)
# -------------------------------------------------------------------------
#
# Snapshots are cumulative, so a 1000-agent fleet re-sending its whole
# registry every tick is O(fleet x registry) on the master. A delta
# carries only what changed since the last ACKED snapshot: metrics as
# full cumulative per-key values (per-key replacement is idempotent),
# events above the acked seq, series points above the acked sample_seq.
# The chain is integrity-checked by ``base_now``: a delta only applies
# to the exact snapshot it was diffed against, so a master that lost
# state (failover onto an older snapshot, restart from nothing) rejects
# the delta and the sender falls back to one full re-send.


def _metric_map(entries) -> dict:
    return {_key(m["name"], m["labels"]): m for m in entries or ()}


def _changed_metrics(base_entries, cur_entries, same) -> list:
    base = _metric_map(base_entries)
    out = []
    for key, m in _metric_map(cur_entries).items():
        prev = base.get(key)
        if prev is None or not same(prev, m):
            out.append(m)
    return out


def snapshot_delta(base: dict, cur: dict) -> dict:
    """Diff two cumulative snapshots of the SAME source (``base`` the
    last one the receiver acked, ``cur`` the fresh one) into a delta
    payload ``apply_delta`` can merge. Registries are append-only, so
    the diff is purely "new or changed" — keys never disappear."""
    if base.get("source") != cur.get("source"):
        raise ValueError(
            f"delta across sources: {base.get('source')!r} vs "
            f"{cur.get('source')!r}"
        )
    base_event_seq = max(
        (e.get("seq", 0) for e in base.get("events") or ()), default=0
    )
    base_sample_seq = base.get("sample_seq", 0)
    series = []
    for s in cur.get("series") or ():
        points = [p for p in s["points"] if p[0] > base_sample_seq]
        if points:
            series.append({
                "name": s["name"], "labels": s["labels"],
                "points": points,
            })
    return {
        "format": cur.get("format", SNAPSHOT_FORMAT),
        "source": cur["source"],
        "role": cur.get("role"),
        "pid": cur.get("pid"),
        "created": cur.get("created"),
        "now": cur.get("now"),
        "delta": True,
        "base_now": base.get("now"),
        "counters": _changed_metrics(
            base.get("counters"), cur.get("counters"),
            lambda a, b: a["value"] == b["value"],
        ),
        "gauges": _changed_metrics(
            base.get("gauges"), cur.get("gauges"),
            lambda a, b: a["value"] == b["value"],
        ),
        "histograms": _changed_metrics(
            base.get("histograms"), cur.get("histograms"),
            lambda a, b: a["counts"] == b["counts"]
            and a["sum"] == b["sum"],
        ),
        "series": series,
        "sample_seq": cur.get("sample_seq", 0),
        "events": [
            e for e in cur.get("events") or ()
            if e.get("seq", 0) > base_event_seq
        ],
        "events_dropped": cur.get("events_dropped", 0),
    }


def apply_delta(base: dict | None, delta: dict) -> dict | None:
    """Merge a delta onto the held snapshot for its source. Returns the
    merged cumulative snapshot, or None when the delta's base is not
    what we hold (lost state / missed ack): the caller must reject it
    so the sender re-sends a full snapshot.

    The merged state is trimmed to the SAME bounds the source registry
    enforces (MAX_EVENTS, SERIES_MAXLEN per key), which is what makes
    delta shipping provably equivalent to full-snapshot shipping."""
    if (
        base is None
        or base.get("source") != delta.get("source")
        or base.get("now") != delta.get("base_now")
    ):
        return None
    merged = dict(base)
    for field in ("now", "pid", "sample_seq", "events_dropped"):
        if field in delta:
            merged[field] = delta[field]
    merged.pop("delta", None)
    merged.pop("base_now", None)
    for section in ("counters", "gauges", "histograms"):
        held = _metric_map(merged.get(section))
        held.update(_metric_map(delta.get(section)))
        merged[section] = [held[k] for k in sorted(held)]
    held_series = {
        _key(s["name"], s["labels"]): s
        for s in merged.get("series") or ()
    }
    for s in delta.get("series") or ():
        key = _key(s["name"], s["labels"])
        prev = held_series.get(key)
        points = (list(prev["points"]) if prev else []) + list(
            s["points"]
        )
        held_series[key] = {
            "name": s["name"], "labels": s["labels"],
            "points": points[-SERIES_MAXLEN:],
        }
    merged["series"] = [held_series[k] for k in sorted(held_series)]
    events = list(merged.get("events") or ()) + list(
        delta.get("events") or ()
    )
    merged["events"] = events[-MAX_EVENTS:]
    return merged


# -------------------------------------------------------------------------
# master-side merge (the job-wide view)
# -------------------------------------------------------------------------


class JobTelemetry:
    """Merges per-process snapshots into a job-wide timeline + ledger.

    Lives in the master servicer (fed by ``TelemetrySnapshot`` reports)
    and in ``tools/obs_report.py`` (fed by snapshot files). Merging is
    idempotent: snapshots are cumulative and keyed by source, and a
    re-registered agent re-sending an old snapshot can never roll a
    newer one back."""

    def __init__(self):
        self._lock = threading.Lock()
        self._snaps: dict[str, dict] = {}

    def update(self, snap) -> bool:
        if not isinstance(snap, dict) or not snap.get("source"):
            return False
        source = str(snap["source"])
        with self._lock:
            existing = self._snaps.get(source)
            if snap.get("delta"):
                merged = apply_delta(existing, snap)
                if merged is None:
                    # base mismatch (we restarted, restored an older
                    # snapshot, or never saw this source): refuse —
                    # the False ack tells the sender to re-send full
                    return False
                self._snaps[source] = merged
                return True
            if existing is not None and existing.get("now", 0.0) > snap.get(
                "now", 0.0
            ):
                return False  # stale re-send (agent re-registration)
            self._snaps[source] = snap
            return True

    def snapshots(self) -> list[dict]:
        with self._lock:
            return list(self._snaps.values())

    def merged_events(self, snaps=None) -> list[dict]:
        """All sources' events, source-tagged, wall-clock ordered."""
        out = []
        for snap in snaps if snaps is not None else self.snapshots():
            for ev in snap.get("events", ()):
                tagged = dict(ev)
                tagged["source"] = snap["source"]
                out.append(tagged)
        out.sort(key=lambda e: (e.get("t", 0.0), e.get("seq", 0)))
        return out

    def ledger(self, now: float | None = None) -> dict:
        return goodput_ledger(self.snapshots(), now=now)

    def events_dropped(self, snaps=None) -> dict:
        """source -> events lost to its bounded ring (nonzero only).
        Any entry here means that source's merged timeline is
        INCOMPLETE — consumers must surface it loudly."""
        return {
            s["source"]: s.get("events_dropped", 0)
            for s in (snaps if snaps is not None else self.snapshots())
            if s.get("events_dropped", 0)
        }

    def metrics_rollup(self, snaps=None) -> dict:
        """Counters summed across sources; gauges latest-source-wins;
        histograms merged bucket-wise (matching bounds)."""
        counters: dict[tuple, float] = {}
        gauges: dict[tuple, tuple[float, float]] = {}  # key -> (now, v)
        hists: dict[tuple, dict] = {}
        for snap in snaps if snaps is not None else self.snapshots():
            snap_now = snap.get("now", 0.0)
            for c in snap.get("counters", ()):
                key = _key(c["name"], c["labels"])
                counters[key] = counters.get(key, 0.0) + c["value"]
            for g in snap.get("gauges", ()):
                key = _key(g["name"], g["labels"])
                if key not in gauges or gauges[key][0] <= snap_now:
                    gauges[key] = (snap_now, g["value"])
            for h in snap.get("histograms", ()):
                key = _key(h["name"], h["labels"])
                agg = hists.get(key)
                if agg is None or agg["bounds"] != h["bounds"]:
                    if agg is not None:
                        logger.warning(
                            "histogram %s: mismatched bounds across "
                            "sources; keeping the newer series", h["name"],
                        )
                    hists[key] = {
                        "bounds": list(h["bounds"]),
                        "counts": list(h["counts"]),
                        "sum": h["sum"],
                        "count": h["count"],
                    }
                else:
                    agg["counts"] = [
                        a + b for a, b in zip(agg["counts"], h["counts"])
                    ]
                    agg["sum"] += h["sum"]
                    agg["count"] += h["count"]
        return {
            "counters": [
                {"name": n, "labels": dict(l), "value": v}
                for (n, l), v in sorted(counters.items())
            ],
            "gauges": [
                {"name": n, "labels": dict(l), "value": v}
                for (n, l), (_, v) in sorted(gauges.items())
            ],
            "histograms": [
                {"name": n, "labels": dict(l), **h}
                for (n, l), h in sorted(hists.items())
            ],
        }

    def report(self, now: float | None = None) -> dict:
        """The operator-facing payload the servicer serves and
        ``tools/obs_report.py`` renders. Built from ONE snapshot-set
        copy, so a concurrent agent update cannot tear the report (a
        timeline source missing from "sources"/"snapshots")."""
        snaps = self.snapshots()
        return {
            "sources": sorted(s["source"] for s in snaps),
            "ledger": goodput_ledger(snaps, now=now),
            "timeline": self.merged_events(snaps),
            "metrics": self.metrics_rollup(snaps),
            # sources whose bounded event ring overwrote its tail: any
            # nonzero entry means the merged timeline above is
            # INCOMPLETE for that source, and consumers (obs_report,
            # the SLO watchdog) must say so loudly rather than let a
            # truncated timeline read as a complete one
            "events_dropped": self.events_dropped(snaps),
            "snapshots": {s["source"]: s for s in snaps},
        }

    @classmethod
    def from_dir(cls, path: str) -> "JobTelemetry":
        """Build from snapshot files (the flush side-channel; survives
        every process of the job)."""
        jt = cls()
        for fpath, _source in snapshot_files(path):
            try:
                with open(fpath) as f:
                    jt.update(json.load(f))
            except (OSError, ValueError) as e:
                logger.warning(
                    "skipping unreadable snapshot %s: %s", fpath, e
                )
        return jt


# -------------------------------------------------------------------------
# rendering (shared by tools/obs_report.py and tools/chaos_run.py)
# -------------------------------------------------------------------------


def format_report(report: dict, timeline_tail: int = 40) -> str:
    lines = []
    ledger = report.get("ledger", {})
    total = ledger.get("total_s", 0.0)
    lines.append("=== goodput ledger ===")
    lines.append(f"total wall-clock: {total:.3f}s  "
                 f"(goodput {ledger.get('goodput', 0.0) * 100:.1f}%)")
    for cat in CATEGORIES:
        secs = ledger.get("categories", {}).get(cat, 0.0)
        pct = (secs / total * 100) if total > 0 else 0.0
        lines.append(f"{secs:10.3f}s  {pct:5.1f}%  {cat}")
    timeline = report.get("timeline", [])
    lines.append("")
    lines.append(f"=== event timeline (last {min(timeline_tail, len(timeline))}"
                 f" of {len(timeline)}) ===")
    t0 = timeline[0]["t"] if timeline else 0.0
    for ev in timeline[-timeline_tail:]:
        extras = {
            k: v for k, v in ev.items()
            if k not in ("seq", "t", "mono", "kind", "source")
        }
        extra_s = " ".join(
            f"{k}={v:.3f}" if isinstance(v, float) else f"{k}={v}"
            for k, v in extras.items()
        )
        lines.append(
            f"+{ev['t'] - t0:9.3f}s  {ev.get('source', '?'):<24} "
            f"{ev['kind']:<20} {extra_s}"
        )
    metrics = report.get("metrics", {})
    counters = metrics.get("counters", [])
    if counters:
        lines.append("")
        lines.append("=== counters ===")
        for c in counters:
            label_s = ",".join(f"{k}={v}" for k, v in c["labels"].items())
            lines.append(f"{c['value']:10.0f}  {c['name']}"
                         + (f"{{{label_s}}}" if label_s else ""))
    gauges = metrics.get("gauges", [])
    if gauges:
        lines.append("")
        lines.append("=== gauges ===")
        for g in gauges:
            label_s = ",".join(f"{k}={v}" for k, v in g["labels"].items())
            lines.append(f"{g['value']:14.3f}  {g['name']}"
                         + (f"{{{label_s}}}" if label_s else ""))
    hists = metrics.get("histograms", [])
    if hists:
        lines.append("")
        lines.append("=== histograms (ms) ===")
        lines.append(
            f"{'obs':>8}  {'avg':>9}  {'p50':>9}  {'p95':>9}  "
            f"{'p99':>9}  name"
        )
        for h in hists:
            label_s = ",".join(f"{k}={v}" for k, v in h["labels"].items())
            avg = h["sum"] / h["count"] if h["count"] else 0.0
            # quantiles interpolated within le-buckets, not raw bucket
            # counts: the operator-facing latency surface
            p50, p95, p99 = (
                hist_quantile(h["bounds"], h["counts"], q)
                for q in (0.5, 0.95, 0.99)
            )
            lines.append(
                f"{h['count']:8d}  {avg * 1e3:9.3f}  {p50 * 1e3:9.3f}  "
                f"{p95 * 1e3:9.3f}  {p99 * 1e3:9.3f}  {h['name']}"
                + (f"{{{label_s}}}" if label_s else "")
            )
    profile = report.get("profile")
    if profile:
        lines.append("")
        lines.append("=== profiled step breakdown (XPlane trace) ===")
        lines.append(
            f"total self time {profile.get('total_ms_per_step', 0.0):.1f} "
            f"ms/step over {profile.get('steps', 1)} step(s)"
        )
        for cat, ms in sorted(
            profile.get("by_category", {}).items(), key=lambda kv: -kv[1]
        ):
            lines.append(f"{ms:8.2f} ms/step  {cat}")
    return "\n".join(lines)


install_from_env()
# flush is a no-op unless DLROVER_TELEMETRY_DIR is set; with it set, a
# cleanly exiting process (incl. SystemExit) leaves its final snapshot
# behind without every caller remembering to flush
atexit.register(flush)
