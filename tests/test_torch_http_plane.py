"""The port's read-only HTTP plane held against the JAX package's on the
CPU: both packages' servicers take the same telemetry snapshots (two
workers, an agent's master-outage ride-through, a failed retry budget),
each serves them through its own ``MasterHttpPlane``, and the
``/metrics`` exposition text must be equal byte for byte, and the
``/report.json``, ``/series.json`` and ``/captures.json`` payloads equal
as decoded JSON. The dashboard differs only in its title, which names
the package."""

import json
import urllib.error
import urllib.request

import pytest

from dlrover_tpu.common import messages as jax_msg
from dlrover_tpu.common import telemetry as jax_telemetry
from dlrover_tpu.master.http_plane import MasterHttpPlane as JaxPlane
from dlrover_tpu.master.servicer import MasterServicer as JaxServicer
from dlrover_tpu_torch.common import messages as port_msg
from dlrover_tpu_torch.common import telemetry as port_telemetry
from dlrover_tpu_torch.master.http_plane import MasterHttpPlane as PortPlane
from dlrover_tpu_torch.master.servicer import MasterServicer as PortServicer

PLANES = {
    "jax": (JaxServicer, JaxPlane, jax_msg),
    "port": (PortServicer, PortPlane, port_msg),
}


def snapshots() -> list:
    """Snapshots as the agents ship them, made once through the port's
    registry (both servicers take the same dicts)."""
    out = []
    for rank, step_s in ((0, 0.011), (1, 0.019)):
        reg = port_telemetry.TelemetryRegistry(f"worker-{rank}-4{rank}")
        reg.role = "worker"
        for i in range(20):
            reg.gauge_set("train.step.last_s", step_s * (1 + i % 3))
            reg.gauge_set("train.mfu", 0.4 - 0.01 * rank)
            reg.counter_inc("steps")
            reg.counter_inc("retry.attempt_failed", op="get_task")
            reg.observe("lat", 0.01 * i, buckets=(0.05, 0.2))
            reg.event("step.end", step=i, dur=step_s)
        out.append(json.loads(json.dumps(reg.snapshot())))
    agent = port_telemetry.TelemetryRegistry("agent-0-7")
    agent.role = "agent"
    agent.event("master.unreachable", restart=0)
    agent.event("master.restart", dur=2.5, addr="127.0.0.1:1")
    agent.counter_inc("retry.exhausted", op="ping")
    out.append(json.loads(json.dumps(agent.snapshot())))
    return out


@pytest.fixture
def planes():
    # neither package's own process registry is folded in: the planes
    # see only the shipped snapshots
    saved = (jax_telemetry._REGISTRY, port_telemetry._REGISTRY)
    jax_telemetry._REGISTRY = port_telemetry._REGISTRY = None
    snaps = snapshots()
    started = {}
    try:
        for name, (servicer_cls, plane_cls, msg) in PLANES.items():
            servicer = servicer_cls()
            for snap in snaps:
                assert servicer.report(
                    "worker", 0, msg.TelemetrySnapshot(payload=snap))
            plane = plane_cls(servicer)
            plane.start()
            started[name] = plane
        yield started
    finally:
        for plane in started.values():
            plane.stop()
        jax_telemetry._REGISTRY, port_telemetry._REGISTRY = saved


def fetch(plane, path) -> bytes:
    with urllib.request.urlopen(
            f"http://127.0.0.1:{plane.port}{path}", timeout=10) as resp:
        return resp.read()


def test_metrics_text_equals_jax(planes):
    got = {name: fetch(plane, "/metrics").decode()
           for name, plane in planes.items()}
    assert got["port"] == got["jax"]
    text = got["port"]
    assert 'dlrtpu_train_mfu{source="worker-1-41"} 0.39' in text
    assert "dlrtpu_steps_total 40.0" in text
    assert 'dlrtpu_goodput_seconds{category="restart"}' in text


@pytest.mark.parametrize("path", [
    "/report.json",
    "/series.json",
    "/series.json?name=train.step.last_s&res=raw",
    "/series.json?name=train.step.last_s&res=10s&source=worker-0-40",
    "/series.json?name=train.mfu&res=1m",
    "/captures.json",
])
def test_json_endpoints_equal_jax(planes, path):
    got = {name: json.loads(fetch(plane, path))
           for name, plane in planes.items()}
    assert got["port"] == got["jax"]
    assert got["port"]


def test_dashboard_and_unknown_paths(planes):
    pages = {name: fetch(plane, "/").decode()
             for name, plane in planes.items()}
    assert "dlrover_tpu_torch live" in pages["port"]
    assert pages["port"].replace("dlrover_tpu_torch live",
                                 "dlrover_tpu live") == pages["jax"]
    for plane in planes.values():
        with pytest.raises(urllib.error.HTTPError) as err:
            fetch(plane, "/etc/passwd")
        assert err.value.code == 404
