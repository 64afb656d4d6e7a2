"""Coworker preprocessing pipeline on the PyTorch port: the twin of
examples/coworker_pipeline.py.

CPU processes run the preprocessing through
:class:`CoworkerDataService`; the trainer consumes finished batches via
:class:`CoworkerDataset`, and :class:`DevicePrefetcher` copies them to
the card on a side stream ahead of the step, so the card never waits on
Python preprocessing.

Single-machine demo (each role is its own process in production):

    python -m dlrover_tpu_torch.examples.coworker_pipeline

Production layout:
- trainer rank 0 starts ``DataInfoService(port=...)`` and exports the
  address (e.g. through the master kv-store);
- each CPU host runs ``CoworkerDataService(make_iter,
  announce_to=info_addr, advertise_host=<host ip>)``;
- every trainer rank iterates ``DevicePrefetcher(CoworkerDataset(
  info_addr, n_batches=steps))``.

Runs on ``cuda`` unless ``--device cpu`` (or ``main(device="cpu")``)
asks for the CPU.
"""

from __future__ import annotations

import argparse

import numpy as np

from dlrover_tpu_torch.trainer.elastic.coworker import (
    CoworkerDataService,
    CoworkerDataset,
    DataInfoService,
)
from dlrover_tpu_torch.trainer.elastic.prefetch import DevicePrefetcher

VOCAB = 1000
BATCH, SEQ = 8, 128


def make_preprocessing_iter():
    """Stand-in for expensive CPU work (tokenise, pack, augment)."""
    rng = np.random.RandomState(0)
    while True:
        tokens = rng.randint(0, VOCAB, (BATCH, SEQ + 1), dtype=np.int64)
        yield {"tokens": tokens}


def main(argv=None, device=None):
    """Consume ``--steps`` batches; returns the coworkers' stats."""
    p = argparse.ArgumentParser("coworker_pipeline")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    # --- trainer rank 0: announcement queue
    info = DataInfoService()
    info.start()

    # --- CPU hosts: two preprocessing workers
    coworkers = [
        CoworkerDataService(
            make_preprocessing_iter,
            announce_to=info.addr,
            announce_every=2,
            queue_size=8,
        )
        for _ in range(2)
    ]
    for cw in coworkers:
        cw.start()

    # --- trainer: consume the training batches on the card
    try:
        dataset = CoworkerDataset(info.addr, n_batches=args.steps,
                                  prefetch=4)
        feed = DevicePrefetcher(dataset, device=device or args.device)
        for step, batch in enumerate(feed):
            # feed trainer's train_step(state, batch, rng) here
            assert tuple(batch["tokens"].shape) == (BATCH, SEQ + 1)
            if step % 5 == 0:
                print(f"step {step}: batch ready on {batch['tokens'].device} "
                      f"(first id {int(batch['tokens'][0, 0])})")
        stats = [dict(cw.stats) for cw in coworkers]
        print("done; coworker stats:", stats)
        return stats
    finally:
        for cw in coworkers:
            cw.stop()
        info.stop()


if __name__ == "__main__":
    main()
