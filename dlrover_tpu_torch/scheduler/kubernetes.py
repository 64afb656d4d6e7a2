"""Kubernetes platform backend: pod scaler + pod watcher.

Equivalent capability: reference dlrover/python/scheduler/kubernetes.py
(k8sClient singleton :121, K8sElasticJob :363, K8sJobArgs :392) and
dlrover/python/master/scaler/pod_scaler.py:76 /
watcher/k8s_watcher.py:155 (PodWatcher).

The ``kubernetes`` Python client is an optional dependency: everything
here is importable without it, and construction raises a clear error when
it is absent (without a k8s client or cluster the structure is
exercised through the fake client in tests, matching the reference's
mock_k8s_client pattern).

The PyTorch port's copy of dlrover_tpu/scheduler/kubernetes.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common.constants import (
    NodeEnv,
    NodeEventType,
    NodeStatus,
    NodeType,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node
from dlrover_tpu_torch.master.job_manager import NodeEvent

logger = get_logger(__name__)

_POD_STATUS_MAP = {
    "Pending": NodeStatus.PENDING,
    "Running": NodeStatus.RUNNING,
    "Succeeded": NodeStatus.SUCCEEDED,
    "Failed": NodeStatus.FAILED,
    "Unknown": NodeStatus.UNKNOWN,
}


def _require_k8s():
    try:
        from kubernetes import client, config, watch  # noqa: F401

        return client, config, watch
    except ImportError as e:  # pragma: no cover - env without k8s
        raise RuntimeError(
            "the kubernetes Python client is required for --platform k8s"
        ) from e


class K8sClient:
    """Thin singleton wrapper over the k8s API (pods + CRDs).

    Tests monkey-patch the instance's methods — the reference's
    mock_k8s_client pattern (test_utils.py:246)."""

    _instance = None
    _lock = threading.Lock()

    def __init__(self, namespace: str = "default"):
        client, config, watch = _require_k8s()
        try:
            config.load_incluster_config()
        except Exception:  # noqa: BLE001
            config.load_kube_config()
        self.namespace = namespace
        self.core_api = client.CoreV1Api()
        self.custom_api = client.CustomObjectsApi()
        self._watch = watch

    @classmethod
    def singleton_instance(cls, namespace: str = "default") -> "K8sClient":
        with cls._lock:
            if cls._instance is None:
                cls._instance = cls(namespace)
            return cls._instance

    def create_pod(self, pod_spec) -> bool:
        self.core_api.create_namespaced_pod(self.namespace, pod_spec)
        return True

    def delete_pod(self, name: str) -> bool:
        self.core_api.delete_namespaced_pod(name, self.namespace)
        return True

    def list_pods(self, label_selector: str):
        return self.core_api.list_namespaced_pod(
            self.namespace, label_selector=label_selector
        )

    def watch_pods(self, label_selector: str, timeout: int):
        w = self._watch.Watch()
        return w.stream(
            self.core_api.list_namespaced_pod,
            self.namespace,
            label_selector=label_selector,
            timeout_seconds=timeout,
        )


def pod_to_node(pod) -> Node | None:
    """Map a k8s Pod object to the internal Node model."""
    labels = (pod.metadata.labels or {}) if pod.metadata else {}
    node_type = labels.get("node-type", NodeType.WORKER)
    try:
        node_id = int(labels.get("node-id", "-1"))
        rank = int(labels.get("rank-index", node_id))
    except ValueError:
        return None
    status = _POD_STATUS_MAP.get(
        pod.status.phase if pod.status else "Unknown", NodeStatus.UNKNOWN
    )
    node = Node(node_type, node_id, status=status, rank_index=rank)
    node.name = pod.metadata.name if pod.metadata else None
    node.host_ip = pod.status.host_ip if pod.status else None
    return node


class PodScaler:
    """Creates/deletes worker pods to match the requested plan
    (reference pod_scaler.py:76 with its background creation queue)."""

    def __init__(self, job_name: str, k8s_client, pod_template=None):
        self._job_name = job_name
        self._client = k8s_client
        self._pod_template = pod_template or {}
        self._create_queue: list[Node] = []
        self._queue_lock = threading.Lock()
        self._stopped = threading.Event()
        self._thread = threading.Thread(
            target=self._periodic_create_pods,
            name="pod-creater",
            daemon=True,
        )
        self._thread.start()

    def scale(self, nodes: dict[int, Node]):
        with self._queue_lock:
            for node in nodes.values():
                if node.status == NodeStatus.INITIAL:
                    self._create_queue.append(node)

    def relaunch(self, old_node: Node, new_node: Node):
        if old_node.name:
            try:
                self._client.delete_pod(old_node.name)
            except Exception as e:  # noqa: BLE001
                logger.warning("delete pod %s failed: %s", old_node.name, e)
        with self._queue_lock:
            self._create_queue.append(new_node)

    def remove_node(self, node: Node):
        """Scale-in: delete the node's pod (and drop any queued creation)."""
        with self._queue_lock:
            self._create_queue = [
                n for n in self._create_queue
                if not (n.type == node.type and n.id == node.id)
            ]
        name = node.name or f"{self._job_name}-{node.type}-{node.id}"
        try:
            self._client.delete_pod(name)
        except Exception as e:  # noqa: BLE001
            logger.warning("delete pod %s failed: %s", name, e)

    def _periodic_create_pods(self):
        while not self._stopped.is_set():
            node = None
            with self._queue_lock:
                if self._create_queue:
                    node = self._create_queue.pop(0)
            if node is None:
                time.sleep(3)
                continue
            try:
                self._client.create_pod(self._build_pod_spec(node))
                node.update_status(NodeStatus.PENDING)
                node.create_time = time.time()
            except Exception as e:  # noqa: BLE001
                logger.warning(
                    "create pod for node %s failed: %s; requeue", node.id, e
                )
                with self._queue_lock:
                    self._create_queue.append(node)
                time.sleep(5)

    def _build_pod_spec(self, node: Node) -> dict:
        name = f"{self._job_name}-{node.type}-{node.id}"
        spec = {
            "apiVersion": "v1",
            "kind": "Pod",
            "metadata": {
                "name": name,
                "labels": {
                    "app": "dlrover-tpu",
                    "elasticjob-name": self._job_name,
                    "node-type": node.type,
                    "node-id": str(node.id),
                    "rank-index": str(node.rank_index),
                },
            },
            # real API servers require spec.containers[]; the template
            # is the main-container template (image/command/resources)
            "spec": {
                "restartPolicy": "Never",
                "containers": [dict(self._pod_template)],
            },
        }
        container = spec["spec"]["containers"][0]
        container.setdefault("name", "main")
        env = container.setdefault("env", [])
        env.extend(
            [
                {"name": NodeEnv.NODE_ID, "value": str(node.id)},
                {"name": NodeEnv.NODE_RANK, "value": str(node.rank_index)},
                {"name": NodeEnv.NODE_TYPE, "value": node.type},
                {"name": NodeEnv.JOB_NAME, "value": self._job_name},
            ]
        )
        return spec

    def stop(self):
        self._stopped.set()


class PodWatcher:
    """Streams pod events as NodeEvents (reference k8s_watcher.py:155)."""

    def __init__(self, job_name: str, k8s_client):
        self._job_name = job_name
        self._client = k8s_client
        self._selector = f"elasticjob-name={job_name}"

    def list(self) -> list[Node]:
        nodes = []
        pods = self._client.list_pods(self._selector)
        for pod in getattr(pods, "items", []):
            node = pod_to_node(pod)
            if node is not None:
                nodes.append(node)
        return nodes

    def watch(self, timeout: int = 60):
        for event in self._client.watch_pods(self._selector, timeout):
            etype = event.get("type", "MODIFIED")
            node = pod_to_node(event.get("object"))
            if node is None:
                continue
            if etype not in (
                NodeEventType.ADDED,
                NodeEventType.MODIFIED,
                NodeEventType.DELETED,
            ):
                etype = NodeEventType.MODIFIED
            yield NodeEvent(etype, node)


def new_pod_scaler_and_watcher(job_args):
    """An explicit DLROVER_TPU_K8S_API endpoint always uses the stdlib
    REST client (it must win even when the kubernetes package is
    installed but has no kubeconfig); otherwise the official client,
    with an in-cluster REST fallback when the package is absent — lean
    TPU images ship without it."""
    import os

    from dlrover_tpu_torch.scheduler.rest_client import RestK8sClient

    if os.environ.get("DLROVER_TPU_K8S_API"):
        logger.info("using the REST client (DLROVER_TPU_K8S_API set)")
        client = RestK8sClient(namespace=job_args.namespace)
    else:
        try:
            client = K8sClient.singleton_instance(job_args.namespace)
        except RuntimeError:
            if not os.environ.get("KUBERNETES_SERVICE_HOST"):
                raise
            logger.info(
                "kubernetes package absent; using the REST client"
            )
            client = RestK8sClient(namespace=job_args.namespace)
    scaler = PodScaler(job_args.job_name, client)
    watcher = PodWatcher(job_args.job_name, client)
    return scaler, watcher
