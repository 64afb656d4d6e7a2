"""BrainService: the cluster-level resource optimization service.

Equivalent capability: reference dlrover/go/brain/pkg/server/server.go:39
(`BrainServer` — gRPC persist_metrics/optimize/get_job_metrics backed by
MySQL + pluggable optimizers). Here: an RpcService over the framework's
2-verb protocol, sqlite datastore, algorithms from
dlrover_tpu_torch.brain.algorithms.

The PyTorch port's copy of dlrover_tpu/brain/service.py; like the JAX
package's, it imports no torch. Its messages are this package's classes, so
the service is not wire-compatible with the JAX package's client: each
side's restricted unpickler refuses the other package's classes.
"""

from __future__ import annotations

from dlrover_tpu_torch.brain import messages as bmsg
from dlrover_tpu_torch.brain.algorithms import get_algorithm
from dlrover_tpu_torch.brain.datastore import MetricsStore
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.common.rpc import RpcServer, RpcService

logger = get_logger(__name__)


class BrainService(RpcService):
    def __init__(self, store: MetricsStore | None = None):
        self.store = store or MetricsStore()

    # verb: report --------------------------------------------------------

    def report(self, node_type, node_id, message) -> bool:
        if isinstance(message, bmsg.PersistMetricsRequest):
            self.store.persist(
                message.job_uuid, message.job_name, message.metrics,
                message.timestamp or None,
            )
            return True
        return False

    # verb: get -----------------------------------------------------------

    def get(self, node_type, node_id, message):
        if isinstance(message, bmsg.OptimizeRequest):
            return self._optimize(message)
        if isinstance(message, bmsg.GetJobMetricsRequest):
            return bmsg.JobMetricsResponse(
                records=self.store.job_records(message.job_uuid)
            )
        return None

    def _optimize(self, req: bmsg.OptimizeRequest):
        algo = get_algorithm(req.opt_type)
        if algo is None:
            return bmsg.OptimizeResponse(
                found=False, reason=f"unknown opt_type {req.opt_type!r}"
            )
        try:
            plan = algo(self.store, req)
        except Exception as e:  # noqa: BLE001 - bad history must not 500
            logger.exception("brain algorithm %s failed", req.opt_type)
            return bmsg.OptimizeResponse(found=False, reason=str(e))
        if not plan:
            return bmsg.OptimizeResponse(
                found=False, reason="no applicable history"
            )
        return bmsg.OptimizeResponse(found=True, plan=plan)


def create_brain_service(
    port: int = 0, store: MetricsStore | None = None
) -> tuple[RpcServer, BrainService]:
    service = BrainService(store)
    server = RpcServer(port, service)
    return server, service
