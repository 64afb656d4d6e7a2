#!/usr/bin/env python3
"""A/B of the port's unsharded Trainer step between this checkout and
another one, say the parent commit unpacked with ``git archive`` into a
gitignored directory, on one GPU:

    python3 trainer_ab.py --other _archive/parent [--pairs 4] [--steps 10]

Each turn is a fresh process that imports ``dlrover_tpu_torch`` from one
checkout and runs the example's chain for nano-350m at full width and
depth: ``auto_strategy`` for the card, B8 S2048, the elastic loader over
the example's token stream, adamw, ``Trainer(...).train()`` for
``--steps`` steps with Flash Checkpoint off; then a bare
``auto_accelerate`` loop over the same batches from the same seed. Turns
alternate (this, other; other, this; ...). Each checkout builds its own
kernels first, both at once.

Each turn prints one JSON line: the Trainer's and the bare loop's ms per
step over steps 2..N (wall clock between synchronizes), the median host
ms inside the Trainer's train step (its enqueue) and between two of its
steps, the peak memory and the losses. The last line but one gives each
side's medians over its turns with their ranges, and the card's name and
power limit as ``nvidia-smi`` reports them. The losses of the two sides
must be equal (the same kernels on the same batches), else it exits 1.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
B, S = 8, 2048
LR = 3e-4


def child(tree: str, steps: int) -> dict:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    import dlrover_tpu_torch

    if not dlrover_tpu_torch.__file__.startswith(tree):
        raise SystemExit(f"imported {dlrover_tpu_torch.__file__}, "
                         f"not the checkout {tree}")
    from dlrover_tpu_torch.common.ipc import PersistentSharedMemory
    from dlrover_tpu_torch.examples.llama_pretrain import (
        synthetic_token_stream,
    )
    from dlrover_tpu_torch.models import PRESETS, llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import auto_accelerate, auto_strategy
    from dlrover_tpu_torch.trainer import (
        Trainer,
        TrainingArgs,
        build_optimizer,
    )
    from dlrover_tpu_torch.trainer.elastic import (
        ElasticDataLoader,
        ElasticSampler,
    )

    if not torch.cuda.is_available():
        raise SystemExit("trainer_ab: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = PRESETS["nano-350m"]
    hbm_gb = torch.cuda.get_device_properties(0).total_memory / 2**30
    strategy = auto_strategy(1, param_count=cfg.param_count(), seq_len=S,
                             hbm_gb=hbm_gb, devices_per_host=1)
    dataset = synthetic_token_stream(cfg.vocab_size, S, n_samples=1 << 16)
    loader = ElasticDataLoader(
        dataset, batch_size=B,
        sampler=ElasticSampler(len(dataset), num_replicas=1, rank=0,
                               shuffle=True),
        collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
    job = os.environ["ELASTIC_JOB_NAME"]
    out = Path(tempfile.mkdtemp(prefix="trainer_ab"))
    os.environ["DLROVER_RUNTIME_METRICS_PATH"] = str(out / "metrics.json")

    def init(seed, device):
        return llama_init(cfg, seed, device)

    try:
        trainer = Trainer(
            llama_loss_fn(cfg), init, None, TrainingArgs(
                output_dir=str(out / "trainer"), max_steps=steps,
                num_epochs=1_000_000, learning_rate=LR, optimizer="adamw",
                strategy=strategy, flash_checkpoint=False, log_steps=10),
            train_data=loader, device="cuda")
        inner, batches, losses, spans = trainer._accel.train_step, [], [], []

        def recording(state, batch, rng):
            t0 = time.perf_counter()
            state, metrics = inner(state, batch, rng)
            spans.append((t0, time.perf_counter()))
            batches.append(batch)
            losses.append(metrics["loss"])
            return state, metrics

        trainer._accel.train_step = recording
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        trainer.train()
        torch.cuda.synchronize()
        t_end = time.perf_counter()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        trainer_ms = (t_end - spans[1][0]) * 1e3 / (steps - 1)
        enqueue = [(b - a) * 1e3 for a, b in spans[1:]]
        gaps = [(spans[i][0] - spans[i - 1][1]) * 1e3
                for i in range(1, len(spans))]
        trainer_losses = [x.item() for x in losses]
        del trainer, inner

        res = auto_accelerate(
            llama_loss_fn(cfg), init,
            build_optimizer("adamw", LR, weight_decay=0.0), strategy,
            device="cuda", seed=0)
        state, starts = res.state, []
        torch.cuda.synchronize()
        for batch in batches:
            starts.append(time.perf_counter())
            state, _ = res.train_step(state, batch, None)
        torch.cuda.synchronize()
        bare_ms = (time.perf_counter() - starts[1]) * 1e3 / (steps - 1)
    finally:
        for name in (f"dlrtpu_torch_ckpt_{job}_0",
                     f"dlrtpu_torch_timer_{job}"):
            try:
                seg = PersistentSharedMemory(name=name)
            except FileNotFoundError:
                continue
            seg.close()
            seg.unlink()
    return {"trainer_ms": trainer_ms, "bare_ms": bare_ms,
            "enqueue_ms_median": statistics.median(enqueue),
            "between_steps_ms_median": statistics.median(gaps),
            "peak_mem_gib": peak_gib, "losses": trainer_losses}


def run_turn(tree: Path, steps: int, n: int) -> dict:
    env = dict(os.environ, ELASTIC_JOB_NAME=f"trainerab{os.getpid()}_{n}")
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--child",
         str(tree), "--steps", str(steps)],
        cwd=tree, env=env, capture_output=True, text=True, timeout=600)
    if proc.returncode:
        sys.stderr.write(proc.stderr[-4000:])
        raise SystemExit(f"trainer_ab: the turn in {tree} exited "
                         f"{proc.returncode}")
    return json.loads(proc.stdout.strip().splitlines()[-1])


def build(trees) -> None:
    code = "from dlrover_tpu_torch.ops import _build; _build.build()"
    procs = [subprocess.Popen([sys.executable, "-c", code], cwd=t)
             for t in trees]
    for proc in procs:
        if proc.wait(timeout=600):
            raise SystemExit("trainer_ab: a kernel build failed")


def main() -> int:
    p = argparse.ArgumentParser("trainer_ab")
    p.add_argument("--other", help="the other checkout's root")
    p.add_argument("--pairs", type=int, default=4)
    p.add_argument("--steps", type=int, default=10)
    p.add_argument("--child", help=argparse.SUPPRESS)
    args = p.parse_args()
    if args.child:
        print(json.dumps(child(os.path.abspath(args.child), args.steps)))
        return 0
    if not args.other:
        p.error("--other is required")
    sides = {"this": HERE, "other": Path(args.other).resolve()}
    build(sides.values())
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    got = {side: [] for side in sides}
    n = 0
    for i in range(args.pairs):
        order = ("this", "other") if i % 2 == 0 else ("other", "this")
        for side in order:
            n += 1
            turn = run_turn(sides[side], args.steps, n)
            got[side].append(turn)
            print(json.dumps({"turn": n, "side": side, **turn}), flush=True)
    summary = {}
    for side, turns in got.items():
        summary[side] = {
            key: {"median": statistics.median(t[key] for t in turns),
                  "min": min(t[key] for t in turns),
                  "max": max(t[key] for t in turns)}
            for key in ("trainer_ms", "bare_ms", "enqueue_ms_median",
                        "between_steps_ms_median", "peak_mem_gib")}
    same = got["this"][0]["losses"] == got["other"][0]["losses"]
    print(json.dumps({"card": card.strip().splitlines()[0],
                      "pairs": args.pairs, "steps": args.steps,
                      "losses_equal": same, **summary}), flush=True)
    print(json.dumps({"ok": same}), flush=True)
    return 0 if same else 1


if __name__ == "__main__":
    sys.exit(main())
