"""Job arguments & platform-neutral job description.

Equivalent capability: reference dlrover/python/scheduler/job.py
(ElasticJob / JobArgs) — what the master knows about the job it runs.

The PyTorch port's copy of dlrover_tpu/scheduler/job.py.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dlrover_tpu_torch.common.constants import (
    DistributionStrategy,
    NodeType,
    OptimizeMode,
    PlatformType,
)
from dlrover_tpu_torch.common.node import NodeGroupResource


@dataclass
class JobArgs:
    platform: str = PlatformType.LOCAL
    namespace: str = "default"
    job_name: str = "dlrover-tpu-job"
    job_uuid: str = ""
    distribution_strategy: str = DistributionStrategy.SPMD
    optimize_mode: str = OptimizeMode.SINGLE_JOB
    node_num: int = 1
    relaunch_on_worker_failure: int = 3
    relaunch_always: bool = False
    remove_exited_node: bool = True
    cordon_fault_node: bool = False
    # node_type -> NodeGroupResource
    node_args: dict = field(default_factory=dict)

    def initilize(self):  # noqa: D401 - parity with reference spelling
        """Populate from the platform (CRD on k8s, args locally)."""
        if NodeType.WORKER not in self.node_args:
            group = NodeGroupResource.new_empty()
            group.count = self.node_num
            self.node_args[NodeType.WORKER] = group


class ElasticJob:
    """Platform hook points used by scalers (service addresses, names)."""

    def __init__(self, namespace: str, job_name: str):
        self.namespace = namespace
        self.job_name = job_name

    def get_node_name(self, node_type: str, node_id: int) -> str:
        return f"{self.job_name}-{node_type}-{node_id}"

    def get_node_service_addr(self, node_type: str, node_id: int) -> str:
        return ""


def new_job_args(platform: str, job_name: str, namespace="default", **kw):
    args = JobArgs(
        platform=platform, job_name=job_name, namespace=namespace, **kw
    )
    args.initilize()
    return args
