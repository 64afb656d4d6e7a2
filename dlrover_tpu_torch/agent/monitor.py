"""Agent-side monitors: node resources + training heartbeats.

Equivalent capability: reference dlrover/python/elastic_agent/monitor/
resource.py:86 (ResourceMonitor: psutil + accelerator stats ->
report_used_resource) and monitor/training.py:77 (TorchTrainingMonitor:
heartbeats + per-step metrics file).

The PyTorch port's copy of dlrover_tpu/agent/monitor.py. The card's
stats come from ``nvidia-smi`` (NVML), never from torch: the agent
process must not create a CUDA context, which would hold device memory
for the whole job and tie the agent's life to the device's.
"""

from __future__ import annotations

import json
import os
import subprocess
import threading
import time

from dlrover_tpu_torch.common.constants import ConfigPath, JobConstant
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.retry import NonCriticalGuard

logger = get_logger(__name__)


def get_process_cpu_percent() -> float:
    try:
        import psutil

        return psutil.cpu_percent(interval=None)
    except Exception:  # noqa: BLE001
        return 0.0


def get_used_memory_mb() -> int:
    try:
        import psutil

        return int(psutil.virtual_memory().used / (1024 * 1024))
    except Exception:  # noqa: BLE001
        return 0


_GPU_QUERY = ("index", "memory.used", "memory.total", "utilization.gpu")


def get_gpu_stats() -> list:
    """Best-effort per-card stats through ``nvidia-smi`` (no CUDA
    context); empty without the tool or a card."""
    try:
        out = subprocess.run(
            ["nvidia-smi", f"--query-gpu={','.join(_GPU_QUERY)}",
             "--format=csv,noheader,nounits"],
            capture_output=True, text=True, timeout=10, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError):
        return []
    stats = []
    for line in out.strip().splitlines():
        try:
            index, used, total, util = (
                float(v) for v in line.split(",")
            )
        except ValueError:
            continue  # "[N/A]" fields
        stats.append({
            "index": int(index),
            "memory_used_gb": used * (1 << 20) / 1e9,
            "memory_total_gb": total * (1 << 20) / 1e9,
            "utilization_pct": util,
        })
    return stats


class ResourceMonitor:
    """Periodically reports host CPU/mem (+ card stats) to the master."""

    # Stats are best-effort, but a healed partition must bring them
    # back: the guard is a circuit breaker (many misses to trip, then
    # periodic half-open probes), never a permanent off-switch —
    # permanently silent step/resource reports could later be misread
    # by the master as a job-wide hang.
    _MAX_MISSES = 20
    _COOLDOWN = 300.0

    def __init__(self, master_client, interval=JobConstant.MONITOR_INTERVAL):
        self._client = master_client
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self._guard = NonCriticalGuard(
            "resource-monitor",
            max_consecutive_failures=self._MAX_MISSES,
            cooldown=self._COOLDOWN,
        )
        self.report_gpu = False

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="resource-monitor", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self._guard.run(
                    lambda: self._client.report_used_resource(
                        get_process_cpu_percent(),
                        get_used_memory_mb(),
                        get_gpu_stats() if self.report_gpu else [],
                    )
                )
            except Exception:  # noqa: BLE001
                pass
            self._stopped.wait(self._interval)


class HeartbeatReporter:
    """Agent heartbeat loop; the master's heartbeat-timeout monitor
    declares the node dead if these stop arriving.

    Tracks consecutive transport-level misses so the agent can tell a
    dead/restarting MASTER (every heartbeat's whole retry budget
    exhausted) from a transient blip, and enter its ride-through path
    instead of letting workers discover the outage one RPC at a time."""

    # misses before ``master_unreachable`` flips: each miss already
    # burned a full RetryPolicy budget, so 2 in a row is a real outage
    UNREACHABLE_MISSES = 2

    def __init__(self, master_client, interval=JobConstant.MONITOR_INTERVAL):
        self._client = master_client
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: threading.Thread | None = None
        self.action = ""
        self.misses = 0

    @property
    def master_unreachable(self) -> bool:
        return self.misses >= self.UNREACHABLE_MISSES

    def reset_misses(self):
        self.misses = 0

    def start(self):
        self._thread = threading.Thread(
            target=self._loop, name="heartbeat", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                resp = self._client.report_heart_beat()
                self.misses = 0
                if resp.action:
                    self.action = resp.action
            except (ConnectionError, OSError):
                self.misses += 1
            except Exception:  # noqa: BLE001
                pass
            self._stopped.wait(self._interval)


class TrainingMetricsReporter:
    """Relays per-step metrics a worker writes to the runtime-metrics
    file up to the master (global step -> speed monitor)."""

    # circuit breaker, not a kill switch: see ResourceMonitor
    _MAX_MISSES = 20
    _COOLDOWN = 300.0

    def __init__(self, master_client, interval=JobConstant.MONITOR_INTERVAL):
        self._client = master_client
        self._interval = interval
        self._stopped = threading.Event()
        self._last_step = -1
        self._guard = NonCriticalGuard(
            "metrics-reporter",
            max_consecutive_failures=self._MAX_MISSES,
            cooldown=self._COOLDOWN,
        )
        self._path = os.environ.get(
            ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.RUNTIME_METRICS
        )

    def start(self):
        threading.Thread(
            target=self._loop, name="metrics-reporter", daemon=True
        ).start()

    def stop(self):
        self._stopped.set()

    def _report_once(self):
        if not os.path.exists(self._path):
            return
        with open(self._path) as f:
            metrics = json.load(f)
        step = int(metrics.get("step", -1))
        if step > self._last_step:
            self._client.report_global_step(
                step, metrics.get("timestamp", time.time())
            )
            self._last_step = step

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self._guard.run(self._report_once)
            except Exception:  # noqa: BLE001
                pass
            self._stopped.wait(self._interval)


class TelemetryReporter:
    """Ships telemetry snapshots to the master on a cadence: this
    process's own registry, plus any snapshot files other processes of
    this host (workers) flushed into ``DLROVER_TELEMETRY_DIR`` — the
    workers have no control-plane client, so the agent is their relay.
    Each tick also re-flushes the local snapshot so the on-disk copy
    used by ``tools/obs_report.py --dir`` stays fresh.

    Shipping is DELTA-ENCODED: after a source's full snapshot was acked
    once, later ticks send only what changed since that ack
    (``telemetry.snapshot_delta``) — the wire and master-merge cost
    scale with activity, not registry size. A rejected delta (master
    failover lost our base, re-registration) drops the cursor so the
    next tick re-sends the full snapshot; an unchanged registry sends
    nothing at all.

    Best-effort like the other stats reporters: a NonCriticalGuard
    circuit breaker, never a training stall."""

    # circuit breaker, not a kill switch: see ResourceMonitor
    _MAX_MISSES = 20
    _COOLDOWN = 300.0

    def __init__(self, master_client, interval=JobConstant.MONITOR_INTERVAL):
        self._client = master_client
        self._interval = interval
        self._stopped = threading.Event()
        self._guard = NonCriticalGuard(
            "telemetry-reporter",
            max_consecutive_failures=self._MAX_MISSES,
            cooldown=self._COOLDOWN,
        )
        # source -> last shipped (mtime, size): only changed files go out
        self._shipped: dict = {}
        # source -> last ACKED full snapshot (the delta base). Bounded
        # by what this host itself produces (own registry + its
        # workers' snapshot files).
        self._acked: dict = {}

    def reset_shipped(self):
        """Forget what was shipped — after a master failover the new
        incarnation's merge may predate snapshots this host already
        sent, so re-send everything (FULL, not deltas against a base
        the new master never saw) on the next tick."""
        self._shipped = {}
        self._acked = {}

    def start(self):
        threading.Thread(
            target=self._loop, name="telemetry-reporter", daemon=True
        ).start()

    def stop(self):
        self._stopped.set()

    def _ship(self, snap: dict) -> bool:
        """Send one source's cumulative snapshot, delta-encoded when a
        base was acked. Returns True when the master accepted it (the
        acked base advances); a rejected/failed delta clears the base
        so the next attempt is a full re-send."""
        from dlrover_tpu_torch.common import telemetry

        source = snap.get("source")
        base = self._acked.get(source)
        payload = snap
        if base is not None:
            payload = telemetry.snapshot_delta(base, snap)
            if not (
                payload["counters"] or payload["gauges"]
                or payload["histograms"] or payload["series"]
                or payload["events"]
            ):
                return True  # nothing changed: keep the old base
        ok = self._guard.run(
            lambda: self._client.report_telemetry(payload)
        )
        if ok:
            self._acked[source] = snap
        elif base is not None:
            self._acked.pop(source, None)
        return bool(ok)

    def report_once(self, swallow: bool = False):
        from dlrover_tpu_torch.common import telemetry

        try:
            telemetry.flush()
            snap = telemetry.snapshot()
            if snap is not None:
                self._ship(snap)
            own = snap["source"] if snap else None
            for path, source in self._snapshot_files(own):
                try:
                    stat = os.stat(path)
                    stamp = (stat.st_mtime, stat.st_size)
                    if self._shipped.get(source) == stamp:
                        continue
                    with open(path) as f:
                        payload = json.load(f)
                except (OSError, ValueError):
                    continue  # torn write / vanished file: next tick
                if self._ship(payload):
                    self._shipped[source] = stamp
        except Exception:  # noqa: BLE001 - relaying telemetry must
            # never take the agent down — but a silently dead reporter
            # would contradict this layer's whole purpose, so say so
            logger.warning(
                "telemetry report tick failed", exc_info=True
            )
            if not swallow:
                raise

    @staticmethod
    def _snapshot_files(own_source):
        from dlrover_tpu_torch.common import telemetry

        out_dir = os.environ.get(telemetry.ENV_DIR, "")
        if not out_dir:
            return
        for path, source in telemetry.snapshot_files(out_dir):
            if own_source is not None and source == own_source:
                continue  # already shipped straight from memory
            yield path, source

    def _loop(self):
        while not self._stopped.is_set():
            self.report_once(swallow=True)
            self._stopped.wait(self._interval)


class TimerRingExporter:
    """Drains the shared timing ring and exports per-tag aggregates —
    the out-of-process half of the xpu_timer capability (reference
    atorch/dev/xpu_timer: in-proc hook -> shm -> brpc/Prometheus
    exporter; here: StepTimer -> shm ring -> JSON file + logs)."""

    def __init__(self, interval=JobConstant.MONITOR_INTERVAL,
                 out_path: str | None = None):
        self._interval = interval
        self._stopped = threading.Event()
        self._out_path = out_path or os.path.join(
            os.path.dirname(ConfigPath.RUNTIME_METRICS),
            "timer_stats.json",
        )
        self._timer = None
        self._totals: dict = {}
        self._export_lock = threading.Lock()

    def start(self):
        threading.Thread(
            target=self._loop, name="timer-exporter", daemon=True
        ).start()

    def stop(self):
        self._stopped.set()

    def _ensure_timer(self):
        if self._timer is None:
            from dlrover_tpu_torch.trainer.timer import get_step_timer

            self._timer = get_step_timer()
        return self._timer

    def export_once(self) -> dict:
        """Drain + aggregate; returns {tag_name: {count, avg_ms, max_ms}}.
        Thread-safe: the /metrics endpoint and the export loop may both
        call this."""
        with self._export_lock:
            return self._export_once_locked()

    def _export_once_locked(self) -> dict:
        from dlrover_tpu_torch.common import telemetry
        from dlrover_tpu_torch.trainer.timer import Tag

        try:
            records = self._ensure_timer().drain()
        except Exception:  # noqa: BLE001 - ring not created yet
            return {}
        recent: dict = {}
        for tag, _start, dur in records:
            agg = self._totals.setdefault(
                tag, {"count": 0, "total_ns": 0, "max_ns": 0}
            )
            agg["count"] += 1
            agg["total_ns"] += dur
            agg["max_ns"] = max(agg["max_ns"], dur)
            r = recent.setdefault(tag, {"count": 0, "total_ns": 0})
            r["count"] += 1
            r["total_ns"] += dur
        stats = {
            Tag.NAMES.get(tag, str(tag)): {
                "count": a["count"],
                "avg_ms": round(a["total_ns"] / a["count"] / 1e6, 3),
                "max_ms": round(a["max_ns"] / 1e6, 3),
            }
            for tag, a in self._totals.items()
        }
        # publish the aggregates into this agent's telemetry registry:
        # the TelemetryReporter relays them to the master, where
        # master/diagnosis.py z-scores them ACROSS hosts — the
        # out-of-process half of the xpu_timer capability becomes a
        # fleet-wide straggler signal, not just a local JSON file.
        # recent_avg = the window drained THIS tick, so a host that
        # becomes slow shows up immediately instead of diluting into
        # its lifetime average.
        for name, agg in stats.items():
            telemetry.gauge_set(
                "timer.phase.avg_ms", agg["avg_ms"], phase=name
            )
            telemetry.gauge_set(
                "timer.phase.max_ms", agg["max_ms"], phase=name
            )
            telemetry.gauge_set(
                "timer.phase.count", agg["count"], phase=name
            )
        for tag, r in recent.items():
            telemetry.gauge_set(
                "timer.phase.recent_avg_ms",
                round(r["total_ns"] / r["count"] / 1e6, 3),
                phase=Tag.NAMES.get(tag, str(tag)),
            )
        if records:
            os.makedirs(os.path.dirname(self._out_path), exist_ok=True)
            tmp = f"{self._out_path}.tmp.{os.getpid()}"
            with open(tmp, "w") as f:
                json.dump(stats, f)
            os.replace(tmp, self._out_path)
        return stats

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self.export_once()
            except Exception:  # noqa: BLE001
                pass
            self._stopped.wait(self._interval)


class MetricsEndpoint:
    """HTTP ``/metrics`` in Prometheus text exposition format.

    Equivalent capability: reference xpu_timer's brpc/Prometheus export
    (atorch/dev/xpu_timer/xpu_timer/common/manager.cc) — something a
    cluster monitoring stack can actually scrape, instead of (only) the
    JSON file the TimerRingExporter writes. Serves the timer aggregates
    plus the worker's latest global step and host resource gauges."""

    def __init__(self, exporter: TimerRingExporter | None = None,
                 host: str = "0.0.0.0", port: int = 0):
        self._exporter = exporter
        self._host = host
        self._port = port
        self._server = None
        self.port = 0  # actual bound port after start()

    # ------------------------------------------------------------ render

    def render(self) -> str:
        lines = []

        def metric(name, help_, mtype, samples):
            lines.append(f"# HELP {name} {help_}")
            lines.append(f"# TYPE {name} {mtype}")
            for labels, value in samples:
                label_s = (
                    "{" + ",".join(
                        f'{k}="{v}"' for k, v in labels.items()
                    ) + "}" if labels else ""
                )
                lines.append(f"{name}{label_s} {value}")

        stats = self._exporter.export_once() if self._exporter else {}
        if stats:
            metric(
                "dlrtpu_timer_events_total",
                "Timed events per tag (from the shm timing ring)",
                "counter",
                [({"tag": t}, a["count"]) for t, a in stats.items()],
            )
            metric(
                "dlrtpu_timer_avg_ms",
                "Average duration per tag in milliseconds",
                "gauge",
                [({"tag": t}, a["avg_ms"]) for t, a in stats.items()],
            )
            metric(
                "dlrtpu_timer_max_ms",
                "Max duration per tag in milliseconds",
                "gauge",
                [({"tag": t}, a["max_ms"]) for t, a in stats.items()],
            )
        path = os.environ.get(
            ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.RUNTIME_METRICS
        )
        try:
            with open(path) as f:
                rt = json.load(f)
            metric(
                "dlrtpu_global_step", "Latest reported training step",
                "gauge", [({}, int(rt.get("step", 0)))],
            )
        except Exception:  # noqa: BLE001 - no worker progress yet
            pass
        kpath = os.environ.get(
            ConfigPath.ENV_KERNEL_METRICS, ConfigPath.KERNEL_METRICS
        )
        try:
            with open(kpath) as f:
                kern = json.load(f)
            ops = kern.get("top_ops") or []
            if ops:
                # per-op self time from the latest XPlane step window
                # (trainer/profiler.py publish_kernel_stats) — the
                # online xpu_timer-style named-kernel export
                metric(
                    "dlrtpu_kernel_self_ms",
                    "Top HLO ops by self time per step (XPlane window)",
                    "gauge",
                    [
                        ({"op": o["op"], "category": o["category"]},
                         o["self_ms_per_step"])
                        for o in ops
                    ],
                )
        except Exception:  # noqa: BLE001 - no profiled window yet
            pass
        metric(
            "dlrtpu_host_memory_used_mb", "Host memory in use",
            "gauge", [({}, get_used_memory_mb())],
        )
        return "\n".join(lines) + "\n"

    # ------------------------------------------------------------- serve

    def start(self) -> int:
        import http.server

        endpoint = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 - stdlib API
                path = self.path.split("?", 1)[0].rstrip("/")
                if path not in ("", "/metrics"):
                    self.send_response(404)
                    self.end_headers()
                    return
                body = endpoint.render().encode()
                self.send_response(200)
                self.send_header(
                    "Content-Type",
                    "text/plain; version=0.0.4; charset=utf-8",
                )
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._port), Handler
        )
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, name="metrics-http",
            daemon=True,
        ).start()
        logger.info("/metrics endpoint on port %d", self.port)
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


def write_runtime_metrics(step: int, **extra):
    """Called from the training loop (worker side) to publish progress."""
    path = os.environ.get(
        ConfigPath.ENV_RUNTIME_METRICS, ConfigPath.RUNTIME_METRICS
    )
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({"step": step, "timestamp": time.time(), **extra}, f)
    os.replace(tmp, path)
