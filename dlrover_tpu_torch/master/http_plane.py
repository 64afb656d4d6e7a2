"""Read-only HTTP plane on the master: the live operator surface.

Equivalent capability: the reference exports runtime metrics to a
Prometheus/Grafana stack (xpu_timer's brpc exporter, the Brain's
datastore dashboards). Here one stdlib ``ThreadingHTTPServer`` thread
on the master serves:

- ``/metrics`` — the job-wide merged telemetry in Prometheus text
  exposition format (counters summed across sources, gauges per-source
  with a ``source`` label, histograms bucket-merged, the goodput
  ledger, standing SLO breaches) — something a cluster monitoring
  stack can scrape mid-run.
- ``/report.json`` — the same payload ``tools/obs_report.py`` renders
  (goodput ledger + merged timeline + metrics rollup), for dashboards
  and the report tool's ``--live`` mode.
- ``/series.json?name=...[&source=...][&res=raw|10s|1m][&since=...]``
  — the metrics store's time series (tiered downsampling).
- ``/`` — a self-contained HTML dashboard that polls the two JSON
  endpoints: live step time, goodput mix, per-host MFU, and the
  reshape/restart/SLO event tail.

Strictly read-only: GET only, no mutation reachable from here; the
control plane stays on the RPC servicer. Binds 127.0.0.1 by default —
exposing it wider is an explicit deployment decision.

The PyTorch port's copy of dlrover_tpu/master/http_plane.py.
"""

from __future__ import annotations

import json
import re
import threading
from urllib.parse import parse_qs, urlparse

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(name: str, prefix: str = "dlrtpu_") -> str:
    return prefix + _NAME_RE.sub("_", name)


def _prom_label_value(value) -> str:
    return (
        str(value)
        .replace("\\", r"\\")
        .replace('"', r"\"")
        .replace("\n", r"\n")
    )


def _prom_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(
        f'{_NAME_RE.sub("_", str(k))}="{_prom_label_value(v)}"'
        for k, v in sorted(labels.items())
    )
    return "{" + inner + "}"


def render_prometheus(servicer) -> str:
    """The merged job view in Prometheus text exposition format 0.0.4.

    Counters are summed across sources and histograms bucket-merged
    (the rollup view); gauges keep a ``source`` label so per-host
    signals (MFU, HBM, step time) stay per-host on the scrape side.
    """
    tele = servicer.telemetry
    snaps = tele.snapshots()
    rollup = tele.metrics_rollup(snaps)
    lines: list[str] = []

    def family(name, help_, mtype):
        lines.append(f"# HELP {name} {help_}")
        lines.append(f"# TYPE {name} {mtype}")

    emitted_help: set[str] = set()

    def sample(name, labels, value, help_, mtype):
        if name not in emitted_help:
            emitted_help.add(name)
            family(name, help_, mtype)
        lines.append(f"{name}{_prom_labels(labels)} {value}")

    for c in rollup.get("counters", ()):
        sample(
            _prom_name(c["name"]) + "_total", c["labels"], c["value"],
            f"counter {c['name']} summed across sources", "counter",
        )
    for snap in snaps:
        for g in snap.get("gauges", ()):
            labels = dict(g["labels"])
            labels["source"] = snap["source"]
            sample(
                _prom_name(g["name"]), labels, g["value"],
                f"gauge {g['name']} (per source)", "gauge",
            )
    for h in rollup.get("histograms", ()):
        name = _prom_name(h["name"])
        if name not in emitted_help:
            emitted_help.add(name)
            family(
                name, f"histogram {h['name']} merged across sources",
                "histogram",
            )
        cum = 0
        for bound, count in zip(h["bounds"], h["counts"]):
            cum += count
            labels = dict(h["labels"])
            labels["le"] = repr(float(bound))
            lines.append(f"{name}_bucket{_prom_labels(labels)} {cum}")
        labels = dict(h["labels"])
        labels["le"] = "+Inf"
        lines.append(
            f"{name}_bucket{_prom_labels(labels)} {h['count']}"
        )
        lines.append(
            f"{name}_sum{_prom_labels(h['labels'])} {h['sum']}"
        )
        lines.append(
            f"{name}_count{_prom_labels(h['labels'])} {h['count']}"
        )
    ledger = tele.ledger()
    for cat, secs in ledger.get("categories", {}).items():
        sample(
            "dlrtpu_goodput_seconds", {"category": cat}, secs,
            "wall-clock seconds attributed per goodput category",
            "gauge",
        )
    sample(
        "dlrtpu_goodput_ratio", {}, ledger.get("goodput", 0.0),
        "fraction of job wall-clock spent productive", "gauge",
    )
    for source, dropped in tele.events_dropped(snaps).items():
        sample(
            "dlrtpu_events_dropped", {"source": source}, dropped,
            "timeline events lost to the source's bounded ring",
            "gauge",
        )
    watchdog = getattr(servicer.diagnosis, "slo", None)
    if watchdog is not None:
        for key, info in watchdog.breaches().items():
            sample(
                "dlrtpu_slo_breach",
                {"key": key, "rule": info.get("rule", "")}, 1,
                "standing SLO breaches (1 per active breach)", "gauge",
            )
    serving = getattr(servicer, "serving", None)
    if serving is not None:
        s = serving.summary()
        sample(
            "dlrtpu_serve_queue_depth", {}, s.get("queue_depth", 0),
            "decode requests queued on the master ledger", "gauge",
        )
        sample(
            "dlrtpu_serve_pool_size", {}, s.get("pool_size", 0),
            "decode workers with recent lease/report activity",
            "gauge",
        )
        for state, n in sorted((s.get("counts") or {}).items()):
            sample(
                "dlrtpu_serve_requests", {"state": str(state)}, n,
                "serving requests by ledger state", "gauge",
            )
        for rank, w in sorted((s.get("workers") or {}).items()):
            sample(
                "dlrtpu_serve_worker_served", {"worker": rank},
                w.get("served", 0),
                "requests served per decode worker", "gauge",
            )
    capture = getattr(servicer, "capture", None)
    if capture is not None:
        s = capture.summary()
        for state, n in sorted((s.get("states") or {}).items()):
            sample(
                "dlrtpu_prof_captures", {"state": str(state)}, n,
                "deep-capture ledger records by state", "gauge",
            )
    brain = getattr(servicer, "brain", None)
    if brain is not None:
        s = brain.summary()
        for state, n in sorted(s.get("states", {}).items()):
            sample(
                "dlrtpu_brain_plans", {"state": state}, n,
                "repair-brain ScalePlans by state", "gauge",
            )
        if s.get("cadence_save_steps"):
            sample(
                "dlrtpu_brain_cadence_save_steps", {},
                s["cadence_save_steps"],
                "brain-published checkpoint cadence (save_steps)",
                "gauge",
            )
    return "\n".join(lines) + "\n"


class MasterHttpPlane:
    """The read-only HTTP thread. ``port=0`` binds an ephemeral port
    (exposed as ``self.port`` after ``start()``)."""

    def __init__(self, servicer, host: str = "127.0.0.1", port: int = 0):
        self._servicer = servicer
        self._host = host
        self._port = port
        self._server = None
        self.port = 0

    # ---------------------------------------------------------- payloads

    def report_payload(self) -> dict:
        # fold the master's own registry first, exactly like the RPC
        # telemetry query: rendezvous/diagnosis/SLO events live here
        from dlrover_tpu_torch.common import telemetry as _telemetry

        local_snap = _telemetry.snapshot()
        if local_snap is not None:
            self._servicer.telemetry.update(local_snap)
            self._servicer.metrics_store.ingest_snapshot(local_snap)
        report = self._servicer.telemetry.report()
        report.pop("snapshots", None)  # input detail, not operator output
        verdicts = self._servicer.diagnosis.check()
        report["diagnosis"] = {
            "stragglers": verdicts.get("stragglers", {}),
            "hangs": verdicts.get("hangs", {}),
            "hw": verdicts.get("hw", {}),
        }
        report["slo"] = verdicts.get("slo", {})
        brain = getattr(self._servicer, "brain", None)
        report["brain"] = brain.summary() if brain is not None else {}
        serving = getattr(self._servicer, "serving", None)
        report["serving"] = (
            serving.summary() if serving is not None else {}
        )
        capture = getattr(self._servicer, "capture", None)
        report["captures"] = (
            capture.summary() if capture is not None else {}
        )
        # per-host hardware health: fingerprint EWMAs + recent leg
        # history (the dashboard's sparkline source), standing
        # gate verdicts, quarantine set
        health = getattr(self._servicer, "health", None)
        report["health"] = (
            health.summary() if health is not None else {}
        )
        return report

    def captures_payload(self, query: dict) -> dict:
        """The deep-capture ledger: every record (newest first) with
        its artifact path and attribution diff; ``?id=`` narrows to
        one record (the "download" of its full summary payload)."""
        capture = getattr(self._servicer, "capture", None)
        if capture is None:
            return {"captures": []}
        records = capture.list()
        want = (query.get("id") or [""])[0]
        if want:
            records = [r for r in records if r["id"] == want]
        return {
            "captures": records,
            **capture.summary(),
        }

    def series_payload(self, query: dict) -> dict:
        name = (query.get("name") or [""])[0]
        if not name:
            return {
                "names": self._servicer.metrics_store.names(),
            }
        source = (query.get("source") or [None])[0]
        res = (query.get("res") or ["raw"])[0]
        since = float((query.get("since") or ["0"])[0])
        limit = int((query.get("limit") or ["0"])[0])
        return {
            "name": name,
            "resolution": res,
            "series": self._servicer.metrics_store.query(
                name, source=source, resolution=res, since=since,
                limit=limit,
            ),
        }

    # ------------------------------------------------------------- serve

    def start(self) -> int:
        import http.server

        plane = self

        class Handler(http.server.BaseHTTPRequestHandler):
            def _send(self, code, body: bytes, ctype: str):
                self.send_response(code)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def do_GET(self):  # noqa: N802 - stdlib API
                parsed = urlparse(self.path)
                path = parsed.path.rstrip("/")
                try:
                    if path == "/metrics":
                        self._send(
                            200,
                            render_prometheus(plane._servicer).encode(),
                            "text/plain; version=0.0.4; charset=utf-8",
                        )
                    elif path == "/report.json":
                        self._send(
                            200,
                            json.dumps(plane.report_payload()).encode(),
                            "application/json",
                        )
                    elif path == "/series.json":
                        self._send(
                            200,
                            json.dumps(plane.series_payload(
                                parse_qs(parsed.query)
                            )).encode(),
                            "application/json",
                        )
                    elif path == "/captures.json":
                        self._send(
                            200,
                            json.dumps(plane.captures_payload(
                                parse_qs(parsed.query)
                            )).encode(),
                            "application/json",
                        )
                    elif path == "":
                        self._send(
                            200, DASHBOARD_HTML.encode(),
                            "text/html; charset=utf-8",
                        )
                    else:
                        self._send(404, b"not found\n", "text/plain")
                except Exception as e:  # noqa: BLE001 - a broken render
                    # must return 500, not kill the serving thread
                    logger.warning("http plane %s failed: %s", path, e)
                    try:
                        self._send(
                            500, f"{type(e).__name__}: {e}\n".encode(),
                            "text/plain",
                        )
                    except OSError:
                        pass

            def log_message(self, *args):  # quiet
                pass

        self._server = http.server.ThreadingHTTPServer(
            (self._host, self._port), Handler
        )
        self.port = self._server.server_address[1]
        threading.Thread(
            target=self._server.serve_forever, name="master-http",
            daemon=True,
        ).start()
        logger.info(
            "master HTTP plane on http://%s:%d (read-only: /metrics, "
            "/report.json, /series.json, dashboard at /)",
            self._host, self.port,
        )
        return self.port

    def stop(self):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None


# self-contained dashboard: no external assets, polls the JSON
# endpoints on this same origin. Deliberately plain — the contract is
# "works from any browser that can reach the master port", not a UI
# framework.
DASHBOARD_HTML = """<!doctype html>
<html><head><meta charset="utf-8"><title>dlrover_tpu_torch live</title>
<style>
 body { font: 13px/1.4 monospace; background: #111; color: #ddd;
        margin: 1.2em; }
 h1 { font-size: 15px; } h2 { font-size: 13px; color: #8cf;
      margin: 1em 0 .3em; }
 table { border-collapse: collapse; }
 td, th { padding: 1px 10px 1px 0; text-align: left; }
 .bar { display: inline-block; height: 10px; }
 .ok { color: #8f8; } .bad { color: #f66; }
 canvas { background: #181818; }
 #err { color: #f66; }
</style></head><body>
<h1>dlrover_tpu_torch live metrics
  <span id="stamp" style="color:#888"></span></h1>
<div id="err"></div>
<h2>goodput mix</h2><div id="goodput"></div>
<h2>step time (train.step.last_s, per source)</h2>
<div id="steps"></div>
<h2>MFU (train.mfu, per source)</h2><div id="mfu"></div>
<h2>SLO breaches</h2><div id="slo" class="ok">none</div>
<h2>serving (decode pool)</h2><pre id="serving">no serving arm</pre>
<h2>serving TTFT (serve.ttft.last_s, per worker)</h2>
<div id="ttft"></div>
<h2>deep captures (device-time profiling)</h2>
<pre id="captures">none</pre>
<h2>host health (probe fingerprints)</h2><div id="health">none</div>
<h2>brain (repair plans)</h2><pre id="brain">none</pre>
<h2>recent events (reshape / restart / ckpt / slo / diagnosis / brain)</h2>
<pre id="events"></pre>
<script>
const CAT_COLORS = {productive:'#4a4', compile:'#48c', reshape:'#a6d',
  checkpoint:'#cc4', rendezvous:'#c84', restart:'#c44', idle:'#555'};
function spark(points) {
  const c = document.createElement('canvas');
  c.width = 220; c.height = 28;
  const ctx = c.getContext('2d');
  if (!points.length) return c;
  const vals = points.map(p => p[p.length - 1]);
  const lo = Math.min(...vals), hi = Math.max(...vals);
  ctx.strokeStyle = '#8cf'; ctx.beginPath();
  vals.forEach((v, i) => {
    const x = i / Math.max(vals.length - 1, 1) * (c.width - 2) + 1;
    const y = c.height - 3 -
      (hi > lo ? (v - lo) / (hi - lo) : 0.5) * (c.height - 6);
    i ? ctx.lineTo(x, y) : ctx.moveTo(x, y);
  });
  ctx.stroke();
  return c;
}
async function seriesTable(name, el, fmt) {
  const r = await fetch('/series.json?name=' + name + '&res=raw');
  const data = await r.json();
  const t = document.createElement('table');
  (data.series || []).forEach(s => {
    const row = t.insertRow();
    row.insertCell().textContent = s.source;
    const last = s.points.length ?
      s.points[s.points.length - 1][1] : NaN;
    row.insertCell().textContent = fmt(last);
    row.insertCell().appendChild(spark(s.points));
  });
  el.replaceChildren(t);
}
async function tick() {
  try {
    const r = await fetch('/report.json');
    const rep = await r.json();
    const led = rep.ledger || {categories: {}, total_s: 0};
    const g = document.getElementById('goodput');
    g.replaceChildren();
    const total = led.total_s || 1;
    for (const [cat, secs] of Object.entries(led.categories || {})) {
      const div = document.createElement('div');
      const bar = document.createElement('span');
      bar.className = 'bar';
      bar.style.width = Math.round(secs / total * 400) + 'px';
      bar.style.background = CAT_COLORS[cat] || '#888';
      div.append(bar, ' ' + cat + ' ' + secs.toFixed(1) + 's');
      g.append(div);
    }
    const slo = document.getElementById('slo');
    const breaches = Object.entries(rep.slo || {});
    if (breaches.length) {
      slo.className = 'bad';
      slo.textContent = breaches.map(
        ([k, v]) => k + ' ' + JSON.stringify(v)).join('\\n');
    } else { slo.className = 'ok'; slo.textContent = 'none'; }
    const serving = rep.serving || {};
    const sEl = document.getElementById('serving');
    if (Object.keys(serving).length) {
      const counts = serving.counts || {};
      sEl.textContent =
        'queue=' + (serving.queue_depth || 0) +
        '  pool=' + (serving.pool_size || 0) +
        '  done=' + (counts.done || 0) +
        '  leased=' + (counts.leased || 0) +
        '  failed=' + (counts.failed || 0) +
        '  requeued=' + (counts.requeued_total || 0) +
        '\\n' + Object.entries(serving.workers || {}).map(
          ([rank, w]) => 'worker ' + rank + ': served=' + w.served +
            ' idle=' + w.idle_s + 's').join('\\n');
    }
    const capR = await fetch('/captures.json');
    const caps = (await capR.json()).captures || [];
    const cEl = document.getElementById('captures');
    if (caps.length) {
      cEl.textContent = caps.slice(0, 8).map(c => {
        const attr = ((c.summary || {}).attribution || [])[0];
        const diff = attr && attr.delta_pct != null
          ? '  ' + attr.category + ' ' +
            (attr.delta_pct > 0 ? '+' : '') + attr.delta_pct +
            '% vs baseline' : '';
        return c.id + '  host=' + c.rank + '  [' + c.state + ']  ' +
          c.reason + diff;
      }).join('\\n');
    }
    const health = rep.health || {};
    const hEl = document.getElementById('health');
    const hosts = Object.entries(health.hosts || {});
    if (hosts.length) {
      const t = document.createElement('table');
      hosts.forEach(([rank, h]) => {
        const row = t.insertRow();
        const bad = h.verdict !== 'pass';
        const cell = row.insertCell();
        cell.textContent = 'host ' + rank + '  [' + h.verdict + ']' +
          (bad ? '  ' + h.reason : '') +
          (h.degraded_streak ? '  streak=' + h.degraded_streak : '');
        cell.className = bad ? 'bad' : 'ok';
        for (const [leg, ms] of Object.entries(h.legs || {})) {
          const lc = row.insertCell();
          lc.textContent = leg + ' ' + ms.toFixed(1) + 'ms';
          lc.appendChild(spark(
            (h.history[leg] || []).map(v => [v])));
        }
      });
      hEl.replaceChildren(t);
    }
    const brain = rep.brain || {};
    const plans = brain.recent || [];
    const bEl = document.getElementById('brain');
    if (plans.length) {
      bEl.textContent =
        'enabled=' + brain.enabled +
        (brain.cadence_save_steps ?
          '  cadence save_steps=' + brain.cadence_save_steps : '') +
        '\\n' + plans.map(p =>
          p.plan_id + '  ' + p.kind +
          (p.target >= 0 ? ' rank=' + p.target : '') +
          '  [' + p.state + ']  ' +
          new Date(p.updated * 1000).toISOString().slice(11, 19)
        ).join('\\n');
    } else {
      bEl.textContent = 'enabled=' + (brain.enabled !== false) +
        '  (no plans yet)';
    }
    const interesting = /^(elastic\\.|master\\.|ckpt\\.restore|rdzv\\.|slo\\.|diagnosis\\.|brain\\.|preempt\\.|serve\\.)/;
    const evs = (rep.timeline || []).filter(
      e => interesting.test(e.kind)).slice(-25);
    document.getElementById('events').textContent = evs.map(e =>
      new Date(e.t * 1000).toISOString().slice(11, 19) + '  ' +
      (e.source || '?') + '  ' + e.kind).join('\\n');
    await seriesTable('train.step.last_s',
      document.getElementById('steps'),
      v => (v * 1000).toFixed(1) + ' ms');
    await seriesTable('train.mfu', document.getElementById('mfu'),
      v => (v * 100).toFixed(2) + ' %');
    await seriesTable('serve.ttft.last_s',
      document.getElementById('ttft'),
      v => (v * 1000).toFixed(1) + ' ms');
    document.getElementById('stamp').textContent =
      ' @ ' + new Date().toISOString().slice(11, 19);
    document.getElementById('err').textContent = '';
  } catch (e) {
    document.getElementById('err').textContent = 'poll failed: ' + e;
  }
}
tick(); setInterval(tick, 2000);
</script></body></html>
"""
