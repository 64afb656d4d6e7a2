"""Cluster monitor: watches the cluster and feeds the brain datastore.

Equivalent capability: the reference's k8smonitor process
(dlrover/go/brain/cmd/k8smonitor/main.go + platform/k8s watchers) — a
standalone deployment that watches ElasticJob/pod events cluster-wide
and persists node/job state into the brain's store, so the optimize
algorithms see history from EVERY job, not only those that reported
metrics themselves.

TPU redesign: a polling monitor over the stdlib REST client (the same
three pod verbs the scheduler uses — no client-go informer machinery).
Each sweep aggregates the pods of every labelled job into one metrics
record (worker count, phase histogram, OOM flags from container status)
and persists it keyed by the job's uid label. Runnable standalone::

    python -m dlrover_tpu_torch.brain.monitor --db /data/brain.db \
        --interval 30

or embedded next to the brain service (``ClusterMonitor(store, client)``
+ ``start()``).

The PyTorch port's copy of dlrover_tpu/brain/monitor.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

import threading
from typing import Optional

from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

JOB_LABEL = "elasticjob-name"


def _pod_oom(pod: dict) -> bool:
    status = pod.get("status", {})
    for cs in status.get("containerStatuses", []) or []:
        term = (cs.get("lastState", {}) or {}).get("terminated", {}) or {}
        if term.get("reason") == "OOMKilled":
            return True
        term = (cs.get("state", {}) or {}).get("terminated", {}) or {}
        if term.get("reason") == "OOMKilled":
            return True
    return False


def snapshot_jobs(client) -> dict[str, dict]:
    """One cluster sweep: job uid -> aggregated metrics record."""
    pods = client.list_pods("")
    if isinstance(pods, dict):
        items = pods.get("items", [])
    elif isinstance(pods, list):
        items = pods
    else:
        items = getattr(pods, "items", None) or []
    jobs: dict[str, dict] = {}
    for pod in items:
        d = pod.to_dict() if hasattr(pod, "to_dict") else pod
        meta = d.get("metadata", {})
        labels = meta.get("labels", {}) or {}
        job = labels.get(JOB_LABEL)
        if not job:
            continue
        uid = labels.get("job-uid", job)
        rec = jobs.setdefault(uid, {
            "job_name": job,
            "worker_count": 0,
            "running": 0,
            "failed": 0,
            "oom": 0,
        })
        rec["worker_count"] += 1
        phase = (d.get("status", {}) or {}).get("phase", "")
        if phase == "Running":
            rec["running"] += 1
        elif phase == "Failed":
            rec["failed"] += 1
        if _pod_oom(d):
            rec["oom"] += 1
    return jobs


class ClusterMonitor:
    """Periodic sweep -> MetricsStore.persist per job."""

    def __init__(self, store: MetricsStore, client,
                 interval: float = 30.0):
        self._store = store
        self._client = client
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def poll_once(self) -> int:
        jobs = snapshot_jobs(self._client)
        for uid, rec in jobs.items():
            name = rec.pop("job_name")
            self._store.persist(uid, name, rec)
        return len(jobs)

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="cluster-monitor", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                n = self.poll_once()
                logger.debug("cluster sweep: %d jobs", n)
            except Exception:  # noqa: BLE001 - API hiccups
                logger.exception("cluster sweep failed")
            self._stopped.wait(self._interval)


def main(argv=None):
    import argparse

    from dlrover_tpu_torch.scheduler.rest_client import RestK8sClient

    parser = argparse.ArgumentParser(description="brain cluster monitor")
    parser.add_argument("--db", default="brain.db")
    parser.add_argument("--interval", type=float, default=30.0)
    parser.add_argument("--namespace", default="default")
    args = parser.parse_args(argv)

    store = MetricsStore(args.db)
    client = RestK8sClient(namespace=args.namespace)
    monitor = ClusterMonitor(store, client, interval=args.interval)
    logger.info("cluster monitor sweeping every %.0fs", args.interval)
    try:
        # the class loop already catches transient API errors — a lone
        # apiserver hiccup must not kill the deployment
        monitor._loop()
        return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
