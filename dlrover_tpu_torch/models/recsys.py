"""Recommender-style model over a (tiered) KvEmbedding table (port of
dlrover_tpu/models/recsys.py).

The embedding table is an ordinary ``[capacity, dim]`` parameter, the
dense tower a two-layer MLP, and the dynamic id -> slot work happens on
the host between steps through :class:`TieredBatchPreparer`, so the
Trainer's step only ever sees slots and a vocabulary far larger than the
device table trains through it.

Usage with the Trainer::

    cfg = RecsysConfig(dim=32, device_capacity=1 << 12)
    kv = make_tiered_embedding(cfg)
    trainer = Trainer(
        recsys_loss_fn(cfg), lambda seed, device: recsys_init(
            cfg, torch.Generator(device).manual_seed(seed), kv),
        recsys_logical_axes(cfg), args, train_data,
        optimizer=group_adam(1e-2), prestep=TieredBatchPreparer(kv),
    )
    # train_data yields {"ids": [B, F] raw int64, "labels": [B] float32}
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor

from dlrover_tpu_torch.ops.sparse_embedding import (
    KvEmbedding,
    TieredKvEmbedding,
)


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    dim: int = 32                 # embedding width
    device_capacity: int = 1 << 12  # rows resident on device
    fields: int = 8               # sparse features per example
    hidden: int = 64              # dense-tower width
    init_scale: float = 0.01
    seed: int = 0


def make_tiered_embedding(config: RecsysConfig) -> TieredKvEmbedding:
    return TieredKvEmbedding(
        dim=config.dim,
        capacity=config.device_capacity,
        init_scale=config.init_scale,
        seed=config.seed,
    )


def recsys_init(config: RecsysConfig, generator: torch.Generator,
                kv: KvEmbedding | None = None, device=None) -> dict:
    """Params: the embedding table + a two-layer dense tower, drawn from
    ``generator`` on ``device`` (the generator's when None)."""
    device = generator.device if device is None else device
    d, h = config.dim, config.hidden
    if kv is not None:
        table = kv.init_table(generator, device)
    else:
        table = torch.randn((config.device_capacity, d), generator=generator,
                            device=device) * config.init_scale

    def normal(*shape):
        return torch.randn(shape, generator=generator, device=device)

    return {
        "table": table,
        "w1": normal(d, h) * (d ** -0.5),
        "b1": torch.zeros((h,), device=device),
        "w2": normal(h, 1) * (h ** -0.5),
        "b2": torch.zeros((1,), device=device),
    }


def recsys_logical_axes(config: RecsysConfig) -> dict:
    return {
        "table": ("vocab", "embed"),
        "w1": ("embed", "mlp"),
        "b1": ("mlp",),
        "w2": ("mlp", None),
        "b2": (None,),
    }


def sigmoid_binary_cross_entropy(logits, labels):
    """optax's form: ``-z log sigmoid(x) - (1 - z) log sigmoid(-x)``."""
    labels = labels.to(logits.dtype)
    return (-labels * F.logsigmoid(logits)
            - (1.0 - labels) * F.logsigmoid(-logits))


def recsys_loss_fn(config: RecsysConfig):
    """Batch ``{"slots": [B, F] int, "labels": [B] float32}`` -> sigmoid
    BCE. ``slots`` are device-table rows: the preparer (or a plain
    ``kv.lookup_slots``) maps raw ids to slots on the host."""

    def loss_fn(params, batch, rng):
        del rng
        vecs = KvEmbedding.embed(params["table"], batch["slots"])
        pooled = vecs.mean(dim=1)                      # [B, D]
        hdn = torch.relu(pooled @ params["w1"] + params["b1"])
        logits = (hdn @ params["w2"] + params["b2"]).squeeze(-1)
        return sigmoid_binary_cross_entropy(logits, batch["labels"]).mean()

    return loss_fn


class TieredBatchPreparer:
    """Host-side pre-step hook: make a raw-id batch device-resident.

    Pops ``batch["ids"]`` (raw int64, any shape), runs
    ``kv.prepare_batch`` against the table param (demoting cold rows to
    the host tier and promoting the batch's spilled rows) and hands back
    the state and the batch with ``"slots"`` in place of ``"ids"``. The
    table and the optimizer's tensors are written in place: the optimizer
    holds them by identity.

    Slot-aligned optimizer state moves with the rows: the tensors of
    ``state.optimizer.state[table]`` whose leading dim is the device
    capacity (``GroupAdam``'s ``steps``, ``mu``, ``nu``; AdamW's
    ``exp_avg``, ``exp_avg_sq``; never a 0-d count), in the JAX
    package's flatten order of the same leaves.

    Plugs into :class:`dlrover_tpu_torch.trainer.Trainer` through its
    ``prestep=`` argument. A table laid out on a DeviceMesh raises
    (ROADMAP Queue 1 item 7).
    """

    def __init__(self, kv: TieredKvEmbedding, table_key: str = "table",
                 ids_key: str = "ids", slots_key: str = "slots"):
        self.kv = kv
        self.table_key = table_key
        self.ids_key = ids_key
        self.slots_key = slots_key

    def state_dict(self) -> dict:
        """Mapper + host-tier state; the Trainer writes this to a sidecar
        at every checkpoint save and restores it on resume, so that the
        restored table meets the slot map it was trained with."""
        return self.kv.state_dict()

    def load_state_dict(self, state: dict):
        self.kv.load_state_dict(state)

    # the JAX package's flatten order of the same leaves (GroupAdamState's
    # fields; optax's mu, nu); a restore may rebuild the state's dict in
    # another key order, so the order goes by name
    _AUX_ORDER = ("steps", "mu", "nu", "exp_avg", "exp_avg_sq",
                  "max_exp_avg_sq", "accum")

    def aux_tensors(self, optimizer, table) -> list:
        """The optimizer's tensors row-aligned with ``table``."""
        if optimizer is None:
            return []
        state = optimizer.state.get(table, {})
        rank = {k: i for i, k in enumerate(self._AUX_ORDER)}
        keys = sorted(state, key=lambda k: (rank.get(k, len(rank)), str(k)))
        return [state[k] for k in keys
                if isinstance(state[k], torch.Tensor) and state[k].dim() >= 1
                and state[k].shape[0] == self.kv.capacity]

    def __call__(self, state, batch, count: bool = True):
        """``count=False`` (the Trainer's eval path) serves the batch
        without recording frequency uses."""
        if self.ids_key not in batch:
            return state, batch
        table = state.params[self.table_key]
        if isinstance(table, DTensor):
            raise NotImplementedError(
                "a tiered embedding table on a DeviceMesh (sharded rows, "
                "per-rank host tiers) is not ported yet (ROADMAP Queue 1 "
                "item 7)")
        batch = dict(batch)
        raw = batch.pop(self.ids_key)
        aux = self.aux_tensors(getattr(state, "optimizer", None), table)
        if aux:
            _, slots, _ = self.kv.prepare_batch(
                table, np.asarray(raw), count=count, aux=aux)
        else:
            _, slots = self.kv.prepare_batch(table, np.asarray(raw),
                                             count=count)
        batch[self.slots_key] = slots
        return state, batch
