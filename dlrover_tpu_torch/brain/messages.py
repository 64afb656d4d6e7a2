"""Brain RPC messages (persist_metrics / optimize / get_job_metrics).

Equivalent capability: reference dlrover/proto/brain.proto:196 (the Brain
gRPC service) — here the same three verbs ride the framework's pickled-
dataclass 2-RPC protocol (common/rpc.py), like every other control-plane
exchange.

The PyTorch port's copy of dlrover_tpu/brain/messages.py; like the JAX
package's, it imports no torch.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from dlrover_tpu_torch.common.messages import Message


@dataclass
class PersistMetricsRequest(Message):
    job_uuid: str = ""
    job_name: str = ""
    timestamp: float = 0.0
    # free-form: {"worker_count": n, "speed": s, "used_memory_mb": m,
    #             "status": "running|completed|oom", ...}
    metrics: dict = field(default_factory=dict)


@dataclass
class OptimizeRequest(Message):
    job_uuid: str = ""
    job_name: str = ""
    # algorithm name, e.g. "cold_create" | "worker_resource" |
    # "oom_memory" | "worker_count"
    opt_type: str = ""
    config: dict = field(default_factory=dict)


@dataclass
class OptimizeResponse(Message):
    found: bool = False
    # {"worker_count": n, "memory_mb": m, "cpu": c}
    plan: dict = field(default_factory=dict)
    reason: str = ""


@dataclass
class GetJobMetricsRequest(Message):
    job_uuid: str = ""


@dataclass
class JobMetricsResponse(Message):
    records: list = field(default_factory=list)
