"""ElasticJob operator: a reconciler for ElasticJob custom resources.

Equivalent capability: the reference's Go operator
(dlrover/go/operator/pkg/controllers/elasticjob_controller.go) — on a
new ElasticJob CR it creates the job-master pod (createEasydlMaster);
while the job runs it syncs job state from the pods; on completion or
failure it stops the remaining pods (stopRunningPods). The master pod
then owns everything else (worker creation, scaling, relaunch) — the
operator never manages workers directly, and neither does this one.

TPU redesign: a small Python control loop over the stdlib REST client
(the same three pod verbs + generic CR verbs the scheduler already
uses) instead of controller-runtime. Reconciliation is level-based:
every sweep lists ElasticJob CRs and pods and drives each job toward
its desired state, so missed events don't matter. Runnable standalone::

    python -m dlrover_tpu_torch.scheduler.operator --namespace default

The ScalePlan half of the reference operator pair lives in the master
(master/scaleplan_watcher.py), matching the reference split where
scaleplan_controller.go merely relays plans the master executes.

The PyTorch port's copy of dlrover_tpu/scheduler/operator.py: the master
pod runs the port's master (``dlrover_tpu_torch.master.main``).
"""

from __future__ import annotations

import threading
from typing import Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.scheduler.crd import ElasticJobSpec

logger = get_logger(__name__)

JOBS_PLURAL = "elasticjobs"
JOB_LABEL = "elasticjob-name"
ROLE_LABEL = "node-type"
MASTER_ROLE = NodeType.MASTER
MANAGED_BY_LABEL = "managed-by"
MANAGED_BY = "dlrover-operator"
DEFAULT_MASTER_IMAGE = "dlrover-tpu:latest"
DEFAULT_MASTER_COMMAND = [
    "python", "-m", "dlrover_tpu_torch.master.main",
    "--platform", "kubernetes",
]


def master_pod_name(job_name: str) -> str:
    return f"{job_name}-master"


def build_master_pod(manifest: dict,
                     master_image: str = DEFAULT_MASTER_IMAGE) -> dict:
    """Master pod spec for an ElasticJob manifest (the
    NewMasterTemplateToJob analogue): the CR's ``master`` replica spec
    overrides image/resources when present."""
    spec = ElasticJobSpec.from_manifest(manifest)
    meta = manifest.get("metadata", {})
    job_name = spec.job_name or meta.get("name", "")
    master_spec = spec.replica_specs.get("master")
    image = getattr(master_spec, "image", "") or master_image
    resources = {}
    if master_spec is not None:
        if getattr(master_spec, "cpu", 0):
            resources["cpu"] = master_spec.cpu
        if getattr(master_spec, "memory_mb", 0):
            resources["memory"] = f"{master_spec.memory_mb}Mi"
    node_num = 0
    worker_spec = spec.replica_specs.get("worker")
    if worker_spec is not None:
        node_num = int(getattr(worker_spec, "replicas", 0) or 0)
    container = {
        "name": "main",
        "image": image,
        "command": DEFAULT_MASTER_COMMAND + [
            "--job_name", job_name,
            "--node_num", str(node_num),
        ],
        "env": [
            {"name": "DLROVER_TPU_JOB_NAME", "value": job_name},
            {"name": "DLROVER_TPU_NAMESPACE",
             "value": meta.get("namespace", "default")},
        ],
    }
    if resources:
        container["resources"] = {
            "requests": resources, "limits": resources,
        }
    return {
        "apiVersion": "v1",
        "kind": "Pod",
        "metadata": {
            "name": master_pod_name(job_name),
            "namespace": meta.get("namespace", "default"),
            "labels": {
                JOB_LABEL: job_name,
                ROLE_LABEL: MASTER_ROLE,
                MANAGED_BY_LABEL: MANAGED_BY,
            },
        },
        "spec": {
            "restartPolicy": "Never",
            "containers": [container],
        },
    }


class ElasticJobOperator:
    """Level-based reconciler: ElasticJob CRs -> master pods.

    Per sweep, for every ElasticJob CR:
    - no master pod and the job is not finished -> create it;
    - job phase Succeeded/Failed (status.phase on the CR) -> stop the
      job's remaining pods (the reference's stopRunningPods);
    and any master pod whose CR is GONE is garbage-collected along
    with the job's workers (cascading delete without owner refs).
    """

    def __init__(self, client, interval: float = 3.0,
                 master_image: str = DEFAULT_MASTER_IMAGE):
        self._client = client
        self._interval = interval
        self._master_image = master_image
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        # jobs this operator instance has seen as CRs: GC also covers
        # a job whose managed master pod is already gone (workers
        # alone carry no managed-by label)
        self._managed_jobs: set[str] = set()

    # ---------------------------------------------------------- sweeps

    def reconcile_once(self) -> dict:
        """One reconciliation sweep; returns action counts (testable)."""
        actions = {"created": 0, "stopped": 0, "gc": 0}
        jobs = {
            m.get("metadata", {}).get("name", ""): m
            for m in self._client.list_custom_resources(JOBS_PLURAL)
        }
        pods = self._client.list_pods("")
        items = getattr(pods, "items", None) or []
        by_job: dict[str, list] = {}
        for pod in items:
            d = pod.to_dict() if hasattr(pod, "to_dict") else pod
            labels = d.get("metadata", {}).get("labels", {}) or {}
            job = labels.get(JOB_LABEL)
            if job:
                by_job.setdefault(job, []).append(d)

        self._managed_jobs.update(jobs)
        for job_name, manifest in jobs.items():
            phase = (manifest.get("status", {}) or {}).get("phase", "")
            job_pods = by_job.get(job_name, [])
            has_master = any(
                p.get("metadata", {}).get("labels", {}).get(ROLE_LABEL)
                == MASTER_ROLE
                for p in job_pods
            )
            if phase in ("Succeeded", "Failed"):
                for p in job_pods:
                    name = p.get("metadata", {}).get("name", "")
                    if name:
                        self._client.delete_pod(name)
                        actions["stopped"] += 1
                continue
            if not has_master:
                pod = build_master_pod(manifest, self._master_image)
                logger.info(
                    "creating master pod %s for ElasticJob %s",
                    pod["metadata"]["name"], job_name,
                )
                self._client.create_pod(pod)
                actions["created"] += 1

        # cascade: pods of DELETED jobs — but only jobs this operator
        # manages (their master pod carries the managed-by label).
        # Operator-less deployments (a master started directly, no CR)
        # share the elasticjob-name label and must never be collected.
        for job_name, job_pods in by_job.items():
            if job_name in jobs:
                continue
            managed = job_name in self._managed_jobs or any(
                p.get("metadata", {}).get("labels", {}).get(
                    MANAGED_BY_LABEL) == MANAGED_BY
                for p in job_pods
            )
            if not managed:
                continue
            for p in job_pods:
                name = p.get("metadata", {}).get("name", "")
                if name:
                    logger.info(
                        "garbage-collecting pod %s (ElasticJob %s "
                        "deleted)", name, job_name,
                    )
                    self._client.delete_pod(name)
                    actions["gc"] += 1
        return actions

    # ------------------------------------------------------- lifecycle

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="elasticjob-operator", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    def _loop(self):
        while not self._stopped.is_set():
            try:
                self.reconcile_once()
            except Exception:  # noqa: BLE001 - API hiccups
                logger.exception("elasticjob reconcile failed")
            self._stopped.wait(self._interval)


def main(argv=None):
    import argparse

    from dlrover_tpu_torch.scheduler.rest_client import RestK8sClient

    parser = argparse.ArgumentParser(description="ElasticJob operator")
    parser.add_argument("--namespace", default="default")
    parser.add_argument("--interval", type=float, default=3.0)
    parser.add_argument("--master-image", default=DEFAULT_MASTER_IMAGE)
    args = parser.parse_args(argv)

    client = RestK8sClient(namespace=args.namespace)
    op = ElasticJobOperator(
        client, interval=args.interval, master_image=args.master_image
    )
    logger.info(
        "elasticjob operator reconciling every %.0fs", args.interval
    )
    try:
        op._loop()
        return 0
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    raise SystemExit(main())
