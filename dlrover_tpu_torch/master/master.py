"""Job masters: local (single host, in-process or subprocess) and
distributed (one master per job on a cluster).

Equivalent capability: reference dlrover/python/master/local_master.py:38
(LocalJobMaster) and dist_master.py:86 (DistributedJobMaster, run loop
:211-269 — early stop / all-workers-exited / hang detection / task done).

The PyTorch port's copy of dlrover_tpu/master/master.py.
"""

from __future__ import annotations

import threading
import time

from dlrover_tpu_torch.common.constants import (
    JobConstant,
    JobExitReason,
    NodeType,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.job_manager import (
    DistributedJobManager,
    LocalJobManager,
)
from dlrover_tpu_torch.master.elastic_ps import ElasticPsService
from dlrover_tpu_torch.master.kvstore import KVStoreService, SyncService
from dlrover_tpu_torch.master.paral_tuner import ParalConfigGenerator
from dlrover_tpu_torch.master.stats import JobMetricCollector
from dlrover_tpu_torch.master.rendezvous import (
    ElasticTrainingRendezvousManager,
    NetworkCheckRendezvousManager,
)
from dlrover_tpu_torch.master.servicer import create_master_service
from dlrover_tpu_torch.master.shard.task_manager import TaskManager

logger = get_logger(__name__)


class JobMaster:
    def prepare(self):
        raise NotImplementedError

    def run(self):
        raise NotImplementedError

    def stop(self):
        raise NotImplementedError


def _setup_state_store(master, state_dir, restore_state):
    """Bind a MasterStateStore to a constructed master's components and
    (optionally) restore the previous incarnation's control-plane
    state. Returns ``(store | None, restored)``."""
    if not state_dir:
        return None, False
    from dlrover_tpu_torch.master.state_store import MasterStateStore

    store = MasterStateStore(state_dir)
    store.bind(
        task_manager=master.task_manager,
        rdzv_managers=master.rdzv_managers,
        kv_store=master.kv_store,
        sync_service=master.sync_service,
        servicer=master.servicer,
        port=master.port,
    )
    restored = False
    if restore_state:
        restored = store.restore()
    else:
        # a NEW job on a reused state dir must not inherit the previous
        # job's shard progress
        store.reset()
    master.servicer.state_store = store
    return store, restored


def _setup_http_plane(servicer, http_port):
    """The read-only live-metrics HTTP thread (/metrics, /report.json,
    /series.json, dashboard). ``None`` = disabled; ``0`` = ephemeral
    port (``master.http_plane.port`` after prepare)."""
    if http_port is None or http_port < 0:
        return None
    from dlrover_tpu_torch.master.http_plane import MasterHttpPlane

    return MasterHttpPlane(servicer, port=http_port)


class LocalJobMaster(JobMaster):
    """Single-host master: task manager + rendezvous + kv-store served over
    the local control-plane port. Used by ``tpu-run`` when no cluster
    master exists (reference _launch_dlrover_local_master path)."""

    def __init__(
        self, port: int, job_args=None,
        state_dir: str | None = None, restore_state: bool = False,
        http_port: int | None = None,
    ):
        self._job_args = job_args
        self.task_manager = TaskManager()
        self.job_manager = LocalJobManager(
            job_args, self.task_manager.speed_monitor
        )
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING: (
                ElasticTrainingRendezvousManager()
            ),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.elastic_ps_service = ElasticPsService()
        self._server, self.servicer = create_master_service(
            port,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            elastic_ps_service=self.elastic_ps_service,
        )
        self.state_store, self._restored = _setup_state_store(
            self, state_dir, restore_state
        )
        self.http_plane = _setup_http_plane(self.servicer, http_port)
        self.paral_generator = ParalConfigGenerator(
            self.job_manager,
            self.task_manager.speed_monitor,
            self.task_manager,
        )

    @property
    def port(self) -> int:
        return self._server.port

    @property
    def addr(self) -> str:
        return f"127.0.0.1:{self.port}"

    def prepare(self):
        node_num = getattr(self._job_args, "node_num", 1) or 1
        if not self._restored:
            # a restored master keeps its persisted rendezvous params
            # (elastic jobs may have reported non-default ones)
            for mgr in self.rdzv_managers.values():
                mgr.update_rdzv_params(
                    min_nodes=node_num,
                    max_nodes=node_num,
                    waiting_timeout=JobConstant.RDZV_JOIN_TIMEOUT_DEFAULT,
                    node_unit=1,
                )
        self.task_manager.start()
        self.job_manager.start()
        if getattr(self._job_args, "auto_tunning", False):
            self.paral_generator.start()
        if self.state_store is not None:
            self.state_store.start()
        if self.http_plane is not None:
            self.http_plane.start()
        self._server.start()
        logger.info("LocalJobMaster serving on %s", self.addr)

    def run(self):
        from dlrover_tpu_torch.common import telemetry

        tasks_done_at = 0.0
        last_flush = 0.0
        try:
            while True:
                # periodic flush: tpu-run terminates this subprocess
                # with SIGTERM (no atexit), and the master's rendezvous
                # events must survive into the post-run obs report.
                # Same cadence as the other reporters — a full-registry
                # serialization every second would be pure waste.
                if time.time() - last_flush >= JobConstant.MONITOR_INTERVAL:
                    telemetry.flush()
                    last_flush = time.time()
                if self.servicer.job_ended:
                    logger.info("job ended, master exiting")
                    return 0 if self.servicer.job_success else 1
                if self.task_manager.finished():
                    # Grace period: workers are still draining their last
                    # batch and the agent still needs the control plane to
                    # report job end — don't yank it away immediately.
                    if tasks_done_at == 0.0:
                        tasks_done_at = time.time()
                        logger.info("all dataset tasks finished")
                    elif time.time() - tasks_done_at > 60:
                        return 0
                else:
                    # A requeued task revived the job; restart the grace
                    # window from scratch when it finishes again.
                    tasks_done_at = 0.0
                time.sleep(1)
        except KeyboardInterrupt:
            return 0
        finally:
            self.stop()

    def stop(self):
        self.paral_generator.stop()
        self.task_manager.stop()
        self.job_manager.stop()
        if self.state_store is not None:
            self.state_store.stop()
        if self.http_plane is not None:
            self.http_plane.stop()
        self._server.stop()
        from dlrover_tpu_torch.common import telemetry

        telemetry.flush()


class DistributedJobMaster(JobMaster):
    """One master per multi-node job. Holds the distributed job manager
    (node monitoring/relaunch via a platform scaler+watcher), rendezvous,
    sharding, metrics; runs the 30s supervision loop."""

    def __init__(
        self, port: int, job_args, scaler=None, watcher=None,
        state_dir: str | None = None, restore_state: bool = False,
        http_port: int | None = None,
    ):
        self._job_args = job_args
        self.task_manager = TaskManager()
        self.job_manager = DistributedJobManager(
            job_args,
            self.task_manager.speed_monitor,
            scaler=scaler,
            watcher=watcher,
        )
        self.rdzv_managers = {
            RendezvousName.ELASTIC_TRAINING: (
                ElasticTrainingRendezvousManager()
            ),
            RendezvousName.NETWORK_CHECK: NetworkCheckRendezvousManager(),
        }
        self.kv_store = KVStoreService()
        self.sync_service = SyncService()
        self.elastic_ps_service = ElasticPsService()
        self.metric_collector = JobMetricCollector(
            self.job_manager, self.task_manager.speed_monitor
        )
        self._server, self.servicer = create_master_service(
            port,
            task_manager=self.task_manager,
            job_manager=self.job_manager,
            rdzv_managers=self.rdzv_managers,
            kv_store=self.kv_store,
            sync_service=self.sync_service,
            elastic_ps_service=self.elastic_ps_service,
            job_metric_collector=self.metric_collector,
        )
        self.state_store, self._restored = _setup_state_store(
            self, state_dir, restore_state
        )
        self.http_plane = _setup_http_plane(self.servicer, http_port)
        # Dead nodes must leave rendezvous waiting sets and give their
        # in-flight shards back (code-review finding: these existed but
        # were never wired).
        self.job_manager.add_node_exit_callback(self._on_node_exit)
        # Periodic worker-count healing (reference job_auto_scaler.py:254);
        # quantized to node_unit so partial TPU slices are never requested.
        from dlrover_tpu_torch.master.auto_scaler import (
            AllreduceTrainingAutoScaler,
        )

        self.auto_scaler = AllreduceTrainingAutoScaler(
            self.job_manager,
            scaler=scaler,
            target_worker_num=getattr(job_args, "node_num", 0) or 0,
            node_unit=getattr(job_args, "node_unit", 1) or 1,
        )
        # Manual scaling via ScalePlan CRs (reference k8s_watcher.py:226):
        # only meaningful when the scaler talks to a real API server.
        self.scaleplan_watcher = None
        k8s_client = getattr(scaler, "_client", None)
        self._k8s_client = k8s_client
        if k8s_client is not None and hasattr(
            k8s_client, "list_custom_resources"
        ):
            from dlrover_tpu_torch.master.scaleplan_watcher import (
                ScalePlanWatcher,
            )

            def _apply(plan, _self=self):
                _self.auto_scaler.execute_job_optimization_plan(plan)
                group = plan.node_group_resources.get(NodeType.WORKER)
                if group is not None:
                    _self.auto_scaler.on_group_count_applied(group.count)

            self.scaleplan_watcher = ScalePlanWatcher(
                job_args.job_name, k8s_client, _apply
            )
        self.paral_generator = ParalConfigGenerator(
            self.job_manager,
            self.task_manager.speed_monitor,
            self.task_manager,
        )
        self._exit_code = 0
        self._exit_reason = ""

    def _on_node_exit(self, node):
        for mgr in self.rdzv_managers.values():
            mgr.remove_alive_node(node.rank_index)
        self.task_manager.recover_tasks(node.type, node.id)
        self.sync_service.remove_node(node.type, node.id)

    @property
    def port(self) -> int:
        return self._server.port

    def prepare(self):
        node_num = getattr(self._job_args, "node_num", 1) or 1
        if not self._restored:
            for mgr in self.rdzv_managers.values():
                mgr.update_rdzv_params(
                    min_nodes=node_num,
                    max_nodes=node_num,
                    waiting_timeout=JobConstant.RDZV_JOIN_TIMEOUT_DEFAULT,
                    node_unit=1,
                )
        if self.state_store is not None:
            self.state_store.start()
        if self.http_plane is not None:
            self.http_plane.start()
        self._server.start()
        self.task_manager.start()
        self.job_manager.start()
        if getattr(self._job_args, "auto_scaling", True):
            self.auto_scaler.start_auto_scaling()
        if self.scaleplan_watcher is not None:
            self.scaleplan_watcher.start()
        if getattr(self._job_args, "auto_tunning", False):
            self.paral_generator.start()
        self.metric_collector.start()
        logger.info(
            "DistributedJobMaster serving on port %s for job %s",
            self.port,
            self._job_args.job_name,
        )

    def run(self) -> int:
        """Supervision loop (reference dist_master.py:211-269)."""
        from dlrover_tpu_torch.common import telemetry

        try:
            while True:
                time.sleep(JobConstant.SECTION_LOOP_INTERVAL)
                telemetry.flush()  # survive a SIGTERM-without-atexit
                if self.servicer.job_ended:
                    self._exit_code = 0 if self.servicer.job_success else 1
                    self._exit_reason = JobExitReason.SUCCEEDED
                    break
                if self.job_manager.all_workers_exited():
                    if self.job_manager.all_workers_failed():
                        self._exit_code = 1
                        self._exit_reason = JobExitReason.WORKER_ERROR
                    else:
                        self._exit_code = 0
                        self._exit_reason = JobExitReason.SUCCEEDED
                    break
                if self.job_manager.all_running_node_hanged():
                    logger.error("job hang detected, stopping")
                    self._exit_code = 1
                    self._exit_reason = JobExitReason.HANG_ERROR
                    break
                if (
                    self.task_manager.training_started()
                    and self.task_manager.finished()
                ):
                    self._exit_code = 0
                    self._exit_reason = JobExitReason.SUCCEEDED
                    break
            # reached only through a conclusive break above — an
            # interrupt must NOT report a job phase to the operator
            self._job_concluded = True
        except KeyboardInterrupt:
            pass
        finally:
            self.stop()
        self.metric_collector.collect_job_exit(self._exit_reason)
        logger.info(
            "master exiting: code=%s reason=%s",
            self._exit_code,
            self._exit_reason,
        )
        return self._exit_code

    def _report_job_status(self):
        """Patch the ElasticJob CR's status.phase so the operator stops
        the job's pods (elasticjob_controller.go syncs the same field).
        Best-effort: operator-less deployments have no CR."""
        client = self._k8s_client
        if client is None or not hasattr(
            client, "update_custom_resource_status"
        ):
            return
        if not getattr(self, "_job_concluded", False):
            # interrupted mid-run (eviction/SIGINT): the job did NOT
            # finish — reporting Succeeded would make the operator tear
            # down a job that should be relaunched
            return
        phase = "Succeeded" if self._exit_code == 0 else "Failed"
        try:
            client.update_custom_resource_status(
                "elasticjobs", self._job_args.job_name,
                {"phase": phase, "reason": self._exit_reason},
            )
            logger.info("reported ElasticJob status %s", phase)
        except Exception:  # noqa: BLE001 - no CR / no CRD installed
            logger.info(
                "no ElasticJob CR to update (operator-less run)"
            )

    def stop(self):
        self._report_job_status()
        self.metric_collector.stop()
        self.paral_generator.stop()
        if self.scaleplan_watcher is not None:
            self.scaleplan_watcher.stop()
        self.auto_scaler.stop_auto_scaling()
        self.task_manager.stop()
        self.job_manager.stop()
        if self.state_store is not None:
            self.state_store.stop()
        if self.http_plane is not None:
            self.http_plane.stop()
        self._server.stop()
        from dlrover_tpu_torch.common import telemetry

        telemetry.flush()
