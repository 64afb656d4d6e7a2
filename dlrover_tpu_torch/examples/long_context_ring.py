"""Long-context training with ring attention over a ``seq`` mesh axis, on
the PyTorch port: the twin of examples/long_context_ring.py, with the
same arguments, the same mesh rule and the same tiny Llama.

The sequence is sharded across the seq ranks; each keeps its q shard
resident while k/v travel around the ring (one ``batch_isend_irecv`` a
hop over the DeviceMesh's seq sub-group), and every visible block runs
the ring-block kernels with global-position causal masks
(parallel/sequence.py). On ``n`` ranks the mesh is ``data=n //
seq_shards, seq=seq_shards`` (4 seq ranks when 4 divide ``n``, else 2,
else 1); each data replica reads its rows of the batch, and its seq
ranks slice the same rows' sequence.

    python -m dlrover_tpu_torch.examples.long_context_ring --steps 3

One process per card, joined from the agent's env contract (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK`` and the coordinator's address) unless
the caller has formed the process group: NCCL on ``cuda``;
``main([...], device="cpu")`` runs it on the CPU over gloo.
Prints the mesh, each step's loss and a last line, and returns the
losses.
"""

from __future__ import annotations

import argparse

import numpy as np


def main(argv=None, device=None) -> list:
    parser = argparse.ArgumentParser("long_context_ring")
    parser.add_argument("--steps", type=int, default=3)
    parser.add_argument("--seq-len", type=int, default=512)
    parser.add_argument("--batch-size", type=int, default=2)
    args = parser.parse_args(argv)

    import torch.distributed as dist

    from dlrover_tpu_torch import trainer as torch_trainer
    from dlrover_tpu_torch.device import resolve_device
    from dlrover_tpu_torch.models import (
        LlamaConfig,
        llama_init,
        llama_logical_axes,
        llama_loss_fn,
    )
    from dlrover_tpu_torch.parallel import (
        MeshConfig,
        Strategy,
        auto_accelerate,
        batch_place,
    )
    from dlrover_tpu_torch.trainer import build_optimizer

    device = resolve_device(device)
    if not dist.is_initialized():
        torch_trainer.init_distributed(device)
    n = dist.get_world_size() if dist.is_initialized() else 1
    seq_shards = 4 if n % 4 == 0 else (2 if n % 2 == 0 else 1)
    config = LlamaConfig(
        vocab_size=512, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq_len=args.seq_len, attn_impl="flash",
        remat=False, dtype="float32",
    )
    strategy = Strategy(
        mesh=MeshConfig(data=n // seq_shards, seq=seq_shards),
        compute_dtype="float32", remat="none",
    )
    res = auto_accelerate(
        llama_loss_fn(config),
        lambda seed, dev: llama_init(config, seed, dev),
        # optax.adamw(1e-3)'s decay, 1e-4
        build_optimizer("adamw", 1e-3, weight_decay=1e-4),
        strategy, device=device,
        param_logical_axes=llama_logical_axes(config),
    )
    print(f"mesh: data={n // seq_shards} x seq={seq_shards}, "
          f"sequence {args.seq_len} sharded {args.seq_len // seq_shards}"
          f"/device (ring attention)")

    rng = np.random.RandomState(0)
    tokens = rng.randint(0, config.vocab_size,
                         (args.batch_size, args.seq_len + 1))
    # this replica's rows; its seq ranks slice their shards from them
    index, count = batch_place(strategy.mesh)
    rows = np.split(tokens, count)[index]
    state, losses = res.state, []
    for step in range(args.steps):
        state, metrics = res.train_step(state, {"tokens": rows}, None)
        losses.append(metrics["loss"].item())
        print(f"step {step}: loss={losses[-1]:.4f}")
    assert np.isfinite(losses[-1])
    print("ring-attention training ok")
    return losses


if __name__ == "__main__":
    main()
