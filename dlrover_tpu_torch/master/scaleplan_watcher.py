"""ScalePlan custom-resource watch loop (manual scaling via kubectl).

Equivalent capability: the reference master watches user-submitted
ScalePlan CRs and feeds them into the node manager
(dlrover/python/master/watcher/k8s_watcher.py:226 K8sScalePlanWatcher,
node/dist_job_manager.py:402 _process_manual_scale). A user runs
``kubectl apply -f scaleplan.yaml`` and the job resizes without touching
the RPC surface.

TPU redesign: the operator-less master polls the CR list through the
stdlib REST client (no client-go informer machinery); each unseen
manifest is parsed with ``ScalePlanSpec.from_manifest`` and applied
through the SAME ``execute_job_optimization_plan`` path the auto-scaler
uses, then the CR is deleted to acknowledge it (the reference instead
patches a Succeeded condition; deletion keeps the stdlib surface to
three verbs and makes the ack observable with ``kubectl get``).

The PyTorch port's copy of dlrover_tpu/master/scaleplan_watcher.py.
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

from dlrover_tpu_torch.common.constants import NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.resource import ResourcePlan
from dlrover_tpu_torch.scheduler.crd import ScalePlanSpec

logger = get_logger(__name__)

PLURAL = "scaleplans"


def plan_from_spec(spec: ScalePlanSpec) -> ResourcePlan:
    """ScalePlanSpec -> the auto-scaler's ResourcePlan currency."""
    from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource

    groups = {}
    for node_type, count in spec.replica_counts.items():
        groups[node_type] = NodeGroupResource(
            count=int(count), node_resource=NodeResource()
        )
    node_resources = {
        name: NodeResource(
            cpu=float(r.get("cpu", 0) or 0),
            memory=int(r.get("memory", 0) or 0),
        )
        for name, r in spec.node_resources.items()
    }
    return ResourcePlan(
        node_group_resources=groups, node_resources=node_resources
    )


class ScalePlanWatcher:
    """Polls ScalePlan CRs for this job and applies manual plans.

    ``apply_fn`` receives a ResourcePlan (defaults to the job's
    auto-scaler ``execute_job_optimization_plan``).
    """

    def __init__(
        self,
        job_name: str,
        client,
        apply_fn: Callable[[ResourcePlan], None],
        interval: float = 3.0,
    ):
        self._job_name = job_name
        self._client = client
        self._apply_fn = apply_fn
        self._interval = interval
        self._stopped = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._seen: set[str] = set()

    def start(self):
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._loop, name="scaleplan-watcher", daemon=True
        )
        self._thread.start()

    def stop(self):
        self._stopped.set()

    # ------------------------------------------------------------------

    def _loop(self):
        import urllib.error

        while not self._stopped.is_set():
            try:
                self.poll_once()
            except urllib.error.HTTPError as e:
                if e.code == 404:
                    # the ScalePlan CRD is not installed on this
                    # cluster: manual scaling via CRs is unavailable —
                    # say so once and stop polling instead of spamming
                    # a 404 traceback every interval forever
                    logger.warning(
                        "scaleplans CRD not found (HTTP 404); disabling "
                        "the ScalePlan watcher"
                    )
                    return
                logger.exception("scaleplan poll failed")
            except Exception:  # noqa: BLE001 - API server hiccups
                logger.exception("scaleplan poll failed")
            self._stopped.wait(self._interval)

    def poll_once(self) -> int:
        """One list+apply pass; returns the number of plans applied."""
        manifests = self._client.list_custom_resources(
            PLURAL, label_selector=f"elasticjob-name={self._job_name}"
        )
        applied = 0
        for manifest in manifests:
            meta = manifest.get("metadata", {})
            key = (
                f"{meta.get('name', '')}"
                f"@{meta.get('resourceVersion', '')}"
            )
            if key in self._seen:
                continue
            spec = ScalePlanSpec.from_manifest(manifest)
            if spec.job_name and spec.job_name != self._job_name:
                continue
            if not spec.manual:
                # auto plans come from the brain/auto-scaler; the CR
                # channel is the manual-override path (reference
                # k8s_watcher.py:251 filters on manual-scaling too)
                self._seen.add(key)
                continue
            plan = plan_from_spec(spec)
            logger.info(
                "applying ScalePlan %s: replicas=%s overrides=%s",
                meta.get("name"), spec.replica_counts,
                list(spec.node_resources),
            )
            self._apply_fn(plan)
            self._seen.add(key)
            applied += 1
            try:
                self._client.delete_custom_resource(
                    PLURAL, meta.get("name", "")
                )
            except Exception:  # noqa: BLE001 - ack is best-effort
                logger.warning(
                    "could not delete applied ScalePlan %s",
                    meta.get("name"),
                )
        return applied


def worker_count_plan(count: int) -> ResourcePlan:
    """Convenience: a plan that just resizes the worker group."""
    from dlrover_tpu_torch.common.node import NodeGroupResource, NodeResource

    return ResourcePlan(
        node_group_resources={
            NodeType.WORKER: NodeGroupResource(
                count=count, node_resource=NodeResource()
            )
        }
    )
