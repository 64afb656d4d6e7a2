"""Sparse (CTR-style) training on the PyTorch port: the twin of
examples/kv_ctr_train.py, with the same arguments and the same chain
(``init_distributed``, a ``KvEmbedding`` table, ``group_adam``, a
power-law id stream, a periodic ``evict`` and a final ``export``).

    python -m dlrover_tpu_torch.examples.kv_ctr_train --steps 300

Runs on ``cuda`` unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dlrover_tpu_torch.device import resolve_device


def parse_args(argv=None):
    p = argparse.ArgumentParser("kv_ctr_train")
    p.add_argument("--steps", type=int, default=300)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--capacity", type=int, default=1 << 12)
    p.add_argument("--evict-every", type=int, default=100)
    p.add_argument("--device", default="cuda")
    return p.parse_args(argv)


def main(argv=None, device=None):
    """Train; returns the per-step losses (floats)."""
    args = parse_args(argv)
    device = resolve_device(device or args.device)

    from dlrover_tpu_torch import trainer as torch_trainer

    torch_trainer.init_distributed(device)

    from dlrover_tpu_torch.models.recsys import sigmoid_binary_cross_entropy
    from dlrover_tpu_torch.ops.sparse_embedding import KvEmbedding
    from dlrover_tpu_torch.optimizers import group_adam

    kv = KvEmbedding(dim=args.dim, capacity=args.capacity)
    table = kv.init_table(torch.Generator(device).manual_seed(0))
    table.requires_grad_()
    w = torch.zeros((args.dim, 1), device=device, requires_grad=True)
    opt = group_adam(1e-2)([table, w])
    rs = np.random.RandomState(0)

    def step(slots, labels):
        vecs = KvEmbedding.embed(table, slots)         # [B, F, D]
        logits = (vecs.mean(dim=1) @ w).squeeze(-1)
        loss = sigmoid_binary_cross_entropy(logits, labels).mean()
        loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
        return loss.detach()

    losses = []
    for i in range(args.steps):
        # power-law feature ids: a hot head plus a long cold tail
        raw_ids = (rs.pareto(1.2, size=(64, 8)) * 50).astype(np.int64)
        labels = torch.as_tensor(
            (raw_ids.sum(axis=1) % 2).astype(np.float32), device=device)
        slots = torch.as_tensor(kv.lookup_slots(raw_ids), device=device)
        losses.append(step(slots, labels))
        if (i + 1) % args.evict_every == 0:
            kv.evict(table, threshold=2)
            print(f"step {i+1}: loss={float(losses[-1]):.4f} "
                  f"live_ids={len(kv.mapper)}")
    ids, vecs, freqs = kv.export(table, min_frequency=2)
    print(f"exported {len(ids)} warm embeddings")
    return [float(x) for x in losses]


if __name__ == "__main__":
    main()
