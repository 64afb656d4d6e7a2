"""Llama pretraining on the PyTorch port: the twin of
examples/llama_pretrain.py, with the same arguments and the same chain
(``init_distributed``, ``auto_strategy``, ``ElasticSampler`` and
``ElasticDataLoader`` over a seeded synthetic token stream,
``Trainer(...).train()`` through ``auto_accelerate`` and the flash
kernels, with Flash Checkpoint on).

    python -m dlrover_tpu_torch.examples.llama_pretrain --steps 20

One process per card; a job of several takes its place from the agent's
env contract (``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK`` and the
coordinator's address). The state goes to shm every ``--save-steps``
steps and every ``--save-storage-every``-th save (default every one, as
``TrainingArgs``) is persisted under ``--output-dir`` (default
``<temp dir>/dlrover_tpu_torch/llama_pretrain``). A rerun into the same
output dir resumes from the newest step: the shm segment is named for
``ELASTIC_JOB_NAME`` or, without one, for the output dir, and outlives
the run (a killed worker resumes from it), so remove it when done:

    ELASTIC_JOB_NAME=twin python -m dlrover_tpu_torch.examples.llama_pretrain --steps 20
    rm -f /dev/shm/dlrtpu_torch_ckpt_twin_0 /dev/shm/dlrtpu_torch_timer_twin

Under the elastic agent, which restarts a dead worker and keeps its shm
segment (and unlinks it after a clean finish):

    python -m dlrover_tpu_torch.trainer.run --nnodes 1 --nproc_per_node 1 \
        dlrover_tpu_torch/examples/llama_pretrain.py --steps 20

On a process group (one made by the caller, or by ``init_distributed``)
the params are DTensors on the planner's DeviceMesh, and the sampler
takes this rank's replica along the batch axes, so the tensor ranks of
one replica read the same rows.

On the card the twin creates its CUDA context and loads every kernel
library before the Trainer is built, and records the legs of its start
(the port's package imports, ``init_distributed``, the CUDA context, the
kernel load) in a ``worker.startup`` telemetry event.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

import numpy as np
import torch

# when this process had torch imported: a restarted worker's start-up
# legs (process start and import, CUDA init, kernel load) start here
IMPORTED_AT = time.time()


def parse_args(argv=None):
    p = argparse.ArgumentParser("llama_pretrain")
    p.add_argument("--preset", default="nano-350m")
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--batch-size", type=int, default=8)
    p.add_argument("--seq-len", type=int, default=2048)
    p.add_argument("--lr", type=float, default=3e-4)
    p.add_argument("--optimizer", default="adamw",
                   choices=["adamw", "sgd", "agd", "adam8bit"])
    p.add_argument("--output-dir", default=os.path.join(
        tempfile.gettempdir(), "dlrover_tpu_torch", "llama_pretrain"))
    p.add_argument("--save-steps", type=int, default=50)
    p.add_argument("--save-storage-every", type=int, default=1,
                   help="persist every Nth shm save")
    p.add_argument("--search-strategy", action="store_true",
                   help="measured strategy search instead of heuristics")
    return p.parse_args(argv)


def synthetic_token_stream(vocab_size: int, seq_len: int, n_samples: int):
    """Stand-in corpus: replace with your tokenized dataset."""

    class DS:
        def __len__(self):
            return n_samples

        def __getitem__(self, idx):
            rng = np.random.RandomState(idx)
            return rng.randint(
                0, vocab_size, size=(seq_len + 1,), dtype=np.int32
            )

    return DS()


def build_trainer(argv=None, device=None):
    """The example's chain up to its ``Trainer``: distributed init,
    ``auto_strategy`` for the card, the elastic loader over the token
    stream, and the Trainer with Flash Checkpoint on."""
    args = parse_args(argv)

    t0 = time.perf_counter()
    from dlrover_tpu_torch import trainer as torch_trainer
    from dlrover_tpu_torch.common import telemetry
    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.device import resolve_device

    startup = {"imported_at": IMPORTED_AT,
               "restart": int(os.environ.get(NodeEnv.RESTART_COUNT, "0")),
               "package_import_s": time.perf_counter() - t0,
               # the profiling plane is imported where the Trainer is
               # built, not by the package: none of it is in this leg
               "profiling_modules_at_import": sorted(
                   m for m in sys.modules
                   if m.startswith("dlrover_tpu_torch.")
                   and m.rsplit(".", 1)[1] in ("profiling", "profiler",
                                               "trace_summary"))}
    device = resolve_device(device)
    t0 = time.perf_counter()
    if not torch.distributed.is_initialized():
        torch_trainer.init_distributed(device)
    startup["init_distributed_s"] = time.perf_counter() - t0
    if device.type == "cuda":
        from dlrover_tpu_torch.ops import _build

        # the CUDA context, then every kernel library (built where the
        # build dir lacks it) before the first step needs one
        t0 = time.perf_counter()
        torch.empty(1, device=device)
        torch.cuda.synchronize(device)
        startup["cuda_init_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        startup["kernels_built"] = _build.load_all()
        startup["kernel_load_s"] = time.perf_counter() - t0
    telemetry.event("worker.startup", **startup)

    from dlrover_tpu_torch.models import (
        PRESETS,
        llama_init,
        llama_logical_axes,
        llama_loss_fn,
    )
    from dlrover_tpu_torch.parallel import auto_strategy
    from dlrover_tpu_torch.parallel.mesh import batch_place
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.trainer.elastic import (
        ElasticDataLoader,
        ElasticSampler,
    )

    config = PRESETS[args.preset]
    # one card per process; the planner takes the card's memory
    hbm_gb = 16.0
    if device.type == "cuda":
        hbm_gb = torch.cuda.get_device_properties(
            device).total_memory / 2**30
    strategy = auto_strategy(
        max(torch_trainer.world_size(), 1),
        param_count=config.param_count(),
        seq_len=args.seq_len,
        hbm_gb=hbm_gb,
        devices_per_host=max(torch.cuda.device_count(), 1),
    )
    # this rank's replica along the batch axes: a tensor axis' ranks of
    # one replica read the same rows (one process per card, so the rank
    # alone would split them)
    replica, replicas = batch_place(strategy.mesh)

    dataset = synthetic_token_stream(
        config.vocab_size, args.seq_len, n_samples=1 << 16
    )
    loader = ElasticDataLoader(
        dataset,
        batch_size=args.batch_size,
        sampler=ElasticSampler(
            len(dataset),
            num_replicas=replicas,
            rank=replica,
            shuffle=True,
        ),
        collate_fn=lambda rows: {"tokens": np.stack(rows)},
    )

    trainer = Trainer(
        llama_loss_fn(config),
        lambda seed, dev: llama_init(config, seed, dev),
        llama_logical_axes(config),
        TrainingArgs(
            output_dir=args.output_dir,
            max_steps=args.steps,
            num_epochs=1_000_000,  # run the step budget out
            learning_rate=args.lr,
            optimizer=args.optimizer,
            strategy=strategy,
            flash_checkpoint=True,
            save_steps=args.save_steps,
            save_storage_every=args.save_storage_every,
            log_steps=10,
        ),
        train_data=loader,
        device=device,
    )
    return trainer


def main(argv=None, device=None):
    trainer = build_trainer(argv, device)
    state, metrics = trainer.train()
    if "loss" in metrics:
        print(f"done: step={trainer.global_step} "
              f"loss={float(metrics['loss']):.4f}")
    else:
        print(f"done: step={trainer.global_step}, resumed at the last "
              f"step: nothing to train")
    trainer.close()
    return trainer


if __name__ == "__main__":
    main()
