"""Flash-checkpoint user API.

Equivalent capability: reference dlrover/trainer/torch/flash_checkpoint/
checkpointer.py (Checkpointer ABC :23, StorageType :18) and the per-
framework checkpointers (ddp.py, fsdp.py, megatron.py). One class covers
both here: pick the engine by how the state is sharded.

The PyTorch port's copy of dlrover_tpu/trainer/flash_checkpoint/
checkpointer.py. The JAX one takes the host's place from
``jax.process_index()``/``process_count()``: one JAX process per host.
Torch runs one process per card, so here the host rank is the agent's
``NODE_RANK`` and the host count ``WORLD_SIZE // LOCAL_WORLD_SIZE``,
never the process rank.
"""

from __future__ import annotations

import os

from dlrover_tpu_torch.agent.master_client import MasterClient
from dlrover_tpu_torch.common.constants import NodeEnv
from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
    ReplicatedCheckpointEngine,
    ShardedCheckpointEngine,
)

logger = get_logger(__name__)


class StorageType:
    MEMORY = 0
    DISK = 1


def host_place() -> tuple[int, int]:
    """(host rank, host count) from the agent's env contract: the
    checkpoint's shards are per host, and a host runs
    ``LOCAL_WORLD_SIZE`` processes, one per card."""
    world = int(os.environ.get(NodeEnv.WORLD_SIZE, "1"))
    local = max(int(os.environ.get(NodeEnv.LOCAL_WORLD_SIZE, "1")), 1)
    return (int(os.environ.get(NodeEnv.NODE_RANK, "0")),
            max(world // local, 1))


class Checkpointer:
    """Interface (reference checkpointer.py:23)."""

    def save_checkpoint(self, step, state_dict, path="", storage_type=None):
        raise NotImplementedError

    def load_checkpoint(self, path="", target=None):
        raise NotImplementedError


class FlashCheckpointer(Checkpointer):
    """Asynchronous in-memory checkpointing for trees of tensors.

    Usage:
        ckpt = FlashCheckpointer("/mnt/ckpt", sharded=True)
        ckpt.save_checkpoint(step, {"params": params, "opt": opt_state},
                             storage_type=StorageType.DISK)
        restored, step = ckpt.load_checkpoint(target={"params": params,
                                                      "opt": opt_state})
    """

    def __init__(
        self,
        checkpoint_dir: str,
        sharded: bool = True,
        master_client: MasterClient | None = None,
        local_rank: int | None = None,
        host_rank: int | None = None,
        num_hosts: int | None = None,
        save_timeout: float = 600,
    ):
        if host_rank is None or num_hosts is None:
            host_rank, num_hosts = host_place()
        if local_rank is None:
            local_rank = int(os.environ.get("LOCAL_RANK", "0"))
        if master_client is None:
            master_client = MasterClient.singleton_instance()
        engine_cls = (
            ShardedCheckpointEngine if sharded else ReplicatedCheckpointEngine
        )
        self.engine = engine_cls(
            checkpoint_dir,
            master_client=master_client,
            local_rank=local_rank,
            host_rank=host_rank,
            num_hosts=num_hosts,
            save_timeout=save_timeout,
        )

    def save_checkpoint(
        self, step: int, state_dict, path: str = "", storage_type=None
    ) -> bool:
        if storage_type is None:
            storage_type = StorageType.DISK
        if storage_type == StorageType.MEMORY:
            return self.engine.save_to_memory(step, state_dict)
        return self.engine.save_to_storage(step, state_dict, path)

    def load_checkpoint(self, path: str = "", target=None,
                        zero_copy: bool = False):
        """Restore (shm first, storage fallback).

        ``zero_copy=True``: targetless shm restores return read-only
        views instead of copies — use in the restart flow where the
        state is immediately copied to the device and no save can race
        (engine.load docstring has the validity contract)."""
        return self.engine.load(path, target, zero_copy=zero_copy)

    def latest_step(self) -> int:
        return self.engine.latest_step()

    def wait_latest_checkpoint(self, timeout: float = 300) -> bool:
        return self.engine.wait_for_persist(
            self.engine._latest_step, timeout
        )

    def close(self):
        self.engine.close()
