"""Trainer-process APIs of the PyTorch port: distributed init from the
agent's env contract, the optimizer factory, and the ``Trainer`` loop
with its ``TrainingArgs`` (elastic data: ``trainer.elastic``)."""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.trainer.optim import build_optimizer  # noqa: F401


def init_distributed(device=None, init_method: str | None = None) -> bool:
    """Join the job's ``torch.distributed`` process group from the agent's
    env contract (the counterpart of the JAX package's
    ``init_distributed``, which calls ``jax.distributed.initialize``).

    ``RANK`` and ``WORLD_SIZE`` give this process's place; the
    rendezvous' coordinator address (``DLROVER_JAX_COORDINATOR_ADDR``,
    host:port) is the store, unless ``init_method`` names another (any
    URL ``init_process_group`` takes, such as ``file://...``). NCCL on
    ``cuda`` (the default device; this process's card is ``LOCAL_RANK``),
    gloo on ``cpu``. A single-process job is a no-op that returns False.
    """
    world = world_size()
    if world <= 1:
        return False
    device = resolve_device(device)
    url = init_method or os.environ[NodeEnv.JAX_COORDINATOR_ADDR]
    if "://" not in url:
        url = f"tcp://{url}"
    if device.type == "cuda":
        torch.cuda.set_device(local_rank())
    dist.init_process_group("nccl" if device.type == "cuda" else "gloo",
                            init_method=url, world_size=world,
                            rank=global_rank())
    return True


def global_rank() -> int:
    return int(os.environ.get(NodeEnv.RANK, "0"))


def world_size() -> int:
    return int(os.environ.get(NodeEnv.WORLD_SIZE, "1"))


def local_rank() -> int:
    return int(os.environ.get(NodeEnv.LOCAL_RANK, "0"))


def node_rank() -> int:
    return int(os.environ.get(NodeEnv.NODE_RANK, "0"))


from dlrover_tpu_torch.trainer.trainer import (  # noqa: E402,F401
    Trainer,
    TrainingArgs,
)
