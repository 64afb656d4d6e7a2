"""Job masters: local (single host, in-process or subprocess) and
distributed (one master per job on a cluster).

Equivalent capability: reference dlrover/python/master/local_master.py:38
(LocalJobMaster) and dist_master.py:86 (DistributedJobMaster, run loop
:211-269 — early stop / all-workers-exited / hang detection / task done).

The PyTorch port's copy of dlrover_tpu/master/master.py, with the
single-host ``LocalJobMaster``. The cluster master
(``DistributedJobMaster`` with its platform scaler), the master's
state store (failover) and its HTTP plane are not ported yet: asking
for one raises ``NotImplementedError`` naming ROADMAP Queue 1 item 6.
"""

from __future__ import annotations

import time

from dlrover_tpu_torch.common.constants import (
    JobConstant,
    RendezvousName,
)
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.master.job_manager import LocalJobManager
from dlrover_tpu_torch.master.elastic_ps import ElasticPsService
from dlrover_tpu_torch.master.kvstore import KVStoreService, SyncService
from dlrover_tpu_torch.master.paral_tuner import ParalConfigGenerator
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


def unported(what: str) -> NotImplementedError:
    return NotImplementedError(
        f"{what} is not ported yet (ROADMAP Queue 1 item 6)")


def _setup_state_store(master, state_dir, restore_state):
    """``(None, False)`` without a state dir; the master's state store
    (failover) is not ported yet."""
    if not state_dir and not restore_state:
        return None, False
    raise unported("the master state store (--state-dir/--restore-state)")


def _setup_http_plane(servicer, http_port):
    """``None`` when disabled; the read-only HTTP plane is not ported
    yet."""
    if http_port is None or http_port < 0:
        return None
    raise unported("the master HTTP plane (--http-port)")


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
    """The cluster master (one per multi-node job, with a platform scaler
    and watcher): not ported yet."""

    def __init__(self, *args, **kwargs):
        raise unported("DistributedJobMaster (platforms other than local)")
