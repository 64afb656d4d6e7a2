"""Ray platform backend: actor-based scaling/watching.

Equivalent capability: reference dlrover/python/scheduler/ray.py:51
(`RayClient`/`RayElasticJob`/`RayJobArgs`) and master/scaler/
ray_scaler.py:39 (`ActorScaler`) + watcher/ray_watcher.py:80
(`ActorWatcher`).

Ray is optional (not in the base image): everything degrades to a clear
ImportError at use time, and the factory only offers this backend when
ray imports.

The PyTorch port's copy of dlrover_tpu/scheduler/ray.py; its actors live
in the ``dlrover_tpu_torch`` namespace, apart from a JAX run's.
"""

from __future__ import annotations

import time

from dlrover_tpu_torch.common.constants import NodeStatus, NodeType
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.node import Node

logger = get_logger(__name__)


def _require_ray():
    try:
        import ray  # noqa: F401

        return ray
    except ImportError as e:  # pragma: no cover - ray absent in CI
        raise ImportError(
            "the ray platform backend needs the 'ray' package"
        ) from e


def ray_available() -> bool:
    try:
        import ray  # noqa: F401

        return True
    except ImportError:
        return False


class _ActorRunner:
    """Actor body: runs the worker entrypoint once; liveness of the
    actor process is the node's liveness."""

    def __init__(self, entrypoint, env):
        self._entrypoint = entrypoint
        self._env = env
        self._state = "created"

    def run(self):
        self._state = "running"
        try:
            return self._entrypoint(self._env)
        finally:
            self._state = "done"

    def status(self):
        return self._state

    def ping(self):
        return True


class RayClient:
    """Thin wrapper over ray actor lifecycle for worker nodes."""

    def __init__(self, namespace: str = "dlrover_tpu_torch"):
        self._ray = _require_ray()
        self.namespace = namespace
        self._actors: dict[str, object] = {}

    def create_actor(self, name: str, entrypoint, env: dict,
                     num_cpus: float = 1.0, resources=None):
        ray = self._ray
        # A surviving detached actor (master restarted; workers lived
        # on) is adopted ONLY if it is alive and still running its
        # entrypoint; a corpse or an idle finished actor is killed and
        # recreated — otherwise relaunch would mark the node PENDING
        # with no worker process behind it.
        existing = self.get_actor(name)
        if existing is not None:
            try:
                state = ray.get(
                    existing.status.remote(), timeout=10
                )
            except Exception:  # noqa: BLE001 - dead/foreign actor
                state = None
            if state == "running":
                self._actors[name] = existing
                return existing
            try:
                ray.kill(existing)
            except Exception:  # noqa: BLE001
                pass
        # a CLASS-based remote: plain-function ray.remote would make a
        # task (no name/namespace, not kill-able/get_actor-able).
        # detached lifetime: workers survive a master restart; the
        # namespace-wide list keeps them reachable afterwards.
        actor = ray.remote(
            num_cpus=num_cpus, resources=resources or {}
        )(_ActorRunner).options(
            name=name, namespace=self.namespace, lifetime="detached"
        ).remote(entrypoint, env)
        actor.run.remote()
        self._actors[name] = actor
        return actor

    def get_actor(self, name: str):
        """Live actor handle or None (namespace-scoped)."""
        try:
            return self._ray.get_actor(name, namespace=self.namespace)
        except ValueError:
            return None

    def delete_actor(self, name: str):
        ray = self._ray
        actor = self._actors.pop(name, None) or self.get_actor(name)
        if actor is not None:
            ray.kill(actor)

    def list_actors(self) -> list[str]:
        """Names of live actors in our namespace (survives a client
        restart — backed by ray's named-actor registry, with the local
        cache as fallback when the util API is unavailable)."""
        try:
            from ray.util import list_named_actors

            named = list_named_actors(all_namespaces=True)
            return [
                a["name"] for a in named
                if a.get("namespace") == self.namespace
            ]
        except Exception:  # noqa: BLE001 - older ray / not connected
            return list(self._actors)


class ActorScaler:
    """Scaler API over ray actors (reference ActorScaler)."""

    def __init__(self, job_name: str, client: RayClient, entrypoint,
                 env_fn=None):
        self._job_name = job_name
        self._client = client
        self._entrypoint = entrypoint
        self._env_fn = env_fn or (lambda node: {})

    def _actor_name(self, node: Node) -> str:
        return f"{self._job_name}-{node.type}-{node.id}"

    def scale(self, nodes: dict[int, Node]):
        for node in nodes.values():
            if node.status == NodeStatus.INITIAL:
                self._client.create_actor(
                    self._actor_name(node), self._entrypoint,
                    self._env_fn(node),
                )
                node.update_status(NodeStatus.PENDING)
                node.create_time = time.time()

    def relaunch(self, old_node: Node, new_node: Node):
        self._client.delete_actor(self._actor_name(old_node))
        self.scale({new_node.id: new_node})

    def remove_node(self, node: Node):
        self._client.delete_actor(self._actor_name(node))

    def stop(self):
        pass


class ActorWatcher:
    """Lists actor liveness as Node states (reference ActorWatcher)."""

    def __init__(self, job_name: str, client: RayClient):
        self._job_name = job_name
        self._client = client

    def list(self) -> list[Node]:
        nodes = []
        for name in self._client.list_actors():
            parts = name.rsplit("-", 2)
            if len(parts) != 3 or parts[0] != self._job_name:
                continue
            node_type, node_id = parts[1], int(parts[2])
            # namespace-scoped lookup: a live actor in our namespace is
            # a running node
            status = (
                NodeStatus.RUNNING
                if self._client.get_actor(name) is not None
                else NodeStatus.FAILED
            )
            nodes.append(Node(node_type, node_id, status=status))
        return nodes

    def watch(self, timeout: int = 60):
        """Poll-based watch: yields NodeEvents for state changes."""
        from dlrover_tpu_torch.master.job_manager import NodeEvent
        from dlrover_tpu_torch.common.constants import NodeEventType

        seen: dict[tuple, str] = {}
        deadline = time.time() + timeout
        while time.time() < deadline:
            for node in self.list():
                key = (node.type, node.id)
                if seen.get(key) != node.status:
                    seen[key] = node.status
                    yield NodeEvent(NodeEventType.MODIFIED, node)
            time.sleep(5)


def new_actor_scaler_and_watcher(job_args, entrypoint, env_fn=None):
    client = RayClient(namespace=job_args.namespace)
    scaler = ActorScaler(
        job_args.job_name, client, entrypoint, env_fn
    )
    watcher = ActorWatcher(job_args.job_name, client)
    return scaler, watcher


def run_worker_actor(env: dict):  # pragma: no cover - needs ray runtime
    """Default actor entrypoint: exec the worker command from env."""
    import os
    import subprocess

    cmd = env.pop("DLROVER_TPU_WORKER_CMD", "")
    merged = {**os.environ, **env}
    return subprocess.call(cmd, shell=True, env=merged)
