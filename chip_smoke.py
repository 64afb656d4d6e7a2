#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``dlrover_tpu_torch/ops/csrc`` (parallel
   nvcc, sm_90a), with its seconds and the ptxas register report;
3. each attention kernel against its plain PyTorch version in bf16 at
   three shapes (the training slice's B8 H8 S2048 D128, a GQA shape
   H32/KVH8 S1024, a ragged S=1000) and a masked case (the GQA shape
   with a 512-key sliding window and a 128-key prefix): K1-K4 on
   [B, H, S, D] with rope, K9-K11 on [B, S, H*D], per kernel on shared
   inputs and end to end (K1-K4 through flash_attention, K9-K11 and
   K1-K4 through both routes of flash_attention_bshd); at the slice's
   shape each kernel's ms (CUDA-graph replays), its plain version's ms,
   SDPA's ms as the library yardstick (forward and backward from
   CUDA-graph replays, its backward as forward and backward less
   forward), and the bound (bytes or tensor-core operations at the H100
   SXM peaks), K1's time including its rope
   pre-pass, which is also checked against the plain rope and timed
   alone, and K3's and K4's each including the two pre-passes (q and k)
   that the backward runs once for both, also timed alone; at the GQA
   shape K9 against K1 without rope, as the measure of K9's group
   packing, and K10 against K3 and K11 against K4 without rope, the
   same loops, as the cost of their strided [B, S, H*D] tensor maps;
   then each ring-block kernel (K12-K14) against its plain version in
   bf16, for the q shard of ring rank 1 against the kv shards of ranks 1
   (the diagonal), 0 (wholly visible) and 2 (wholly in the future: exact
   zeros and lse -1e30), and K2 on that shard's do and o, every operand
   a shard's view of a whole sequence laid out as the [seq4] run hands
   it to the ring, at the slice's block shape (B8 H8 KVH8, 512-row
   shards), a GQA one (B2 H32 KVH8, 256-row shards) and a ragged one
   (B2 H8 KVH4, 500-row shards); at the slice's block shape, for the
   diagonal and the visible block, each kernel's ms (CUDA-graph
   replays), its plain version's, its bound and SDPA's forward and
   backward (CUDA-graph replays; causal on the diagonal, not on the
   visible block) as the library yardstick;
   ``[kernels-d64]``: K1-K4's head_dim 64 build against its plain
   versions with the same gates, at gpt2-1.5b's attention shape (B8 H25
   S1024 D64, causal, no rope), a roped GQA shape (B2 H16 KVH4 S1024), a
   roped ragged one (S1000) and the masked case on the GQA shape,
   ``flash_attention_bshd`` at head_dim 64 (it must take K1-K4 on
   transposed views, one launch each, and no K9-K11), then at gpt2-1.5b's
   shape each kernel's ms (CUDA-graph replays), its plain version's, its
   bound and SDPA's forward (and its backward beside K2 + K3 + K4) as the
   library yardstick;
4. each optimizer kernel (K5-K8) against its plain version on the
   slice's 12 parameter leaves plus a ragged 1000-element leaf and a
   leaf without a grad (all-zero rows), both given the same rounding
   field; K7/K8 one step from a state made by two plain steps, with
   clipping and weight decay on and then off; then, on the 12 leaves,
   each kernel's ms, its plain version's, its bound and its library
   yardstick (fused torch AdamW for K7, ``torch.mul`` for K6);
5. the training slice: ``auto_accelerate`` on nano-350m at full width
   (16 layers, dim 1024, 8 heads, vocab 32000), B=8, S=2048, lr 3e-4,
   5 steps on one seeded synthetic batch, once with each optimizer:
   adamw (torch.optim.AdamW, the earlier slice; then a profiled step),
   a ``[trainer]`` run, the example's chain
   (dlrover_tpu_torch/examples/llama_pretrain.py): ``auto_strategy(1,
   hbm_gb=the card's memory)``, which must plan remat "none", the
   ``ElasticSampler``/``ElasticDataLoader`` over the example's token
   stream and ``Trainer(...).train()`` for 6 steps, whose losses must
   equal a bare ``auto_accelerate`` loop's on the same batches within
   1e-5 relative, with K1-K4 launched 16 times a step and the
   runtime-metrics file reading step 6 (its ms per step against the bare
   loop's, and the host time per step between two train steps),
   ``[ckpt]``, Flash Checkpoint through the same chain with
   ``flash_checkpoint=True``: an async save on the card followed at once
   by in-place updates must store the pre-update values; 6 steps with
   saves every 2 steps, every 2nd persisted (each save's blocking ms with
   its materialize and fill legs and bytes, each one copied into a
   segment registered with the card; each persist's seconds, and
   one pinned D2H copy of the same bytes as the yardstick; the losses
   equal [trainer]'s, K1-K4 16 launches a step); a second Trainer over a
   fresh engine restores from shm and a third from storage with shm
   unlinked (seconds to the device; every leaf ``torch.equal`` to the
   saved state), and after 2 more steps each their losses must agree
   with the first Trainer's own continuation within 1e-5 (relative); a
   child process killed by ``DLROVER_CHAOS`` right after its step-4 save
   and a second child resuming from the shm segment it left and training
   to step 6 (losses as the first Trainer's; its saves timed); the
   segments and step
   directories removed at the end, also when a check fails,
   ``[agent]``, the control plane: ``python -m
   dlrover_tpu_torch.trainer.run`` (its local master, the elastic agent)
   runs the example for 8 steps with the same saves, the kernels built
   into a fresh ``--compilation-cache-dir``, and a ``DLROVER_CHAOS``
   kill right after the worker's step-4 save; the agent must classify
   the exit, restart the worker once (restart count 1) and exit 0; the
   new incarnation must restore step 4 from the segment the agent's
   saver kept (not from storage), train steps 5-8 with the losses of
   [ckpt]'s uninterrupted run within 1e-5 (relative) and K1-K4 16
   launches a step; the agent must persist a step whose CRC verifies;
   nvidia-smi must never count more CUDA contexts than the live
   workers (and the probe's child) hold; printed: the master's goodput
   ledger, the restart's legs from the kill to the first step (the
   port's package imports, ``init_distributed``, the CUDA context and
   the kernel load each a leg of its own; no profiling module among the
   imports), each save's blocking ms and each persist's seconds; every file, the
   sockets and the segments removed at the end, also when a check fails,
   ``[failover]``, the master survives its own death: ``python -m
   dlrover_tpu_torch.master.main --state-dir D --http-port 0 --addr-file
   F`` dies (a one-shot ``DLROVER_CHAOS`` ``master.kill`` rule) on its 7th
   task request and is restarted with ``--restore-state D`` 1.2 s after
   the agent logged the outage; ``python -m dlrover_tpu_torch.trainer.run
   --network-check`` runs the node check on the card in a child (bf16
   matmul, NCCL all_reduce and all_gather; normal, exited before the
   worker started, the master's verdict normal), then a worker that
   trains nano-350m (B8 S2048, adamw) one step per batch of an
   ``ElasticDataset`` over 192 seeded rows in 12 master-served shuffled
   shards; gated: one death and one restore on the same port, the worker
   never restarted, every row read once, losses within 1e-5 (relative)
   of an uninterrupted run over the same rows in this process, K1-K4 16
   launches a step, the master's /metrics answering before and after
   with the dispatched-task count carried over the restore, the goodput
   ledger charging the outage to ``restart``, no CUDA context beyond the
   worker's and the node check's; printed: the outage, the agent's
   ride-through, the restore, the node check's legs, then a
   ``{"failover": ...}`` line,
   ``[remat-minimal]``, ``[remat-full]`` and ``[remat-offload]``: adamw
   under ``Strategy(remat=...)`` with the model's default per-layer
   "dots_attn" policy, losses within 1e-5 of the adamw run's (remat
   "none") at every step, K1 launched twice per layer and step (the
   strategy's recompute reruns the forward; the per-layer recompute
   takes the saved (o, lse)), K2-K4 once, and "full"'s peak memory below
   "none"'s,
   a ``[bshd]`` run with adamw and ``attn_impl="bshd"`` (K9-K11 and
   K2 on every layer, with a profiled step),
   (a) ``build_optimizer("adam8bit")`` (K5/K6 per leaf),
   (b) ``adam8bit(fused=True)`` with ``Strategy(fused_optim=True)``
   (K8), (c) ``fused_adamw(bits=32)`` (K7). Each run's loss must be
   finite and fall and its launch counts must show the path ran through
   its kernels (16 per step for each attention kernel of its route and
   none of the other route's; K5 = K6 = 12 per step in (a); K8 and K7
   once per step); the losses of [bshd] and (c) must stay within 2e-2 of
   adamw's; before the runs, 2-layer logits of the flash and bshd models,
   and of the model under a seq=4 mesh, are held against plain
   attention; last, a ``[seq4]`` run with adamw and
   ``Strategy(mesh=MeshConfig(seq=4))``: the sequence sharded over 4 ring
   ranks held in this process (the in-process transport), every
   attention on the ring-block kernels (n(n+1)/2 = 10 blocks per layer
   for each of K12-K14, K2 once per rank), losses within 2e-2 of adamw's,
   with a profiled step; then the train step's other options:
   ``[agd]``, ``build_optimizer("agd")`` on the slice's repeated batch
   (``optimizer.step`` device ms and state bytes against adamw's, losses
   finite and falling), then the example's chain with ``--optimizer
   agd`` (5 steps, a cadence save at the last; its ms per step against
   ``[trainer]``'s, K1-K4 16 a step; a fresh Trainer restores the step
   from shm, every leaf ``torch.equal``, and its 2 more steps' losses
   within 1e-5 (relative) of the first Trainer's continuation),
   ``[ce-chunks]``, adamw at ``ce_chunks`` 4 and 8 on the adamw run's
   weights and batch (which is the ce_chunks=1 run): each step's loss
   within 2e-3 (relative) of it, step ms, tokens/s, MFU and peak memory,
   the profiler's CE rows at 4 chunks beside the adamw run's at 1; and
   llama2-1b (dim 2048, 16 layers, mlp 5504) at B4 S2048 with 4 chunks,
   bench.py's headline arm, which must fit the card under remat "none",
   and ``[optimizers]``: 4 steps each of ``mup_adam`` (after
   ``mup_rescale_init``, width_mult 4), ``group_adam``, ``OffloadAdam``
   (its device-to-host wait, host math and host-to-device tail per
   step, its state off the card, the peak memory it saves against
   adamw) and the decoupled WSAM step over torch AdamW (two passes: K1-K4
   32 a step), each with losses finite and falling and K1-K4 16 a step
   per pass; ``[mesh1]``: the data/fsdp/tensor path at one rank, a
   one-rank NCCL process group (``file://`` store) and nano-350m
   through ``auto_accelerate`` under ``MeshConfig(fsdp=-1)`` with its
   logical axes, every param and moment a DTensor on a one-rank
   DeviceMesh (the adamw run's batch: losses within 1e-5 relative of
   it, K1-K4 16 a step; step ms, host enqueue ms and peak memory beside
   the unsharded run's), then the example's chain, whose planner's mesh
   is a DeviceMesh under the one-rank group: a sharded save to shm (its blocking ms), a fresh
   Trainer's restore (every leaf's local shard ``torch.equal``,
   placements kept; its seconds) and 2 more steps within 1e-5
   (relative) of the first Trainer's continuation; the group destroyed
   after; then ``[gpt2]``: gpt2-124m's logits (12 layers, full width,
   head_dim 64) through the flash branch and the bshd route against the
   reference branch; gpt2-1.5b at full width and depth (48 layers, dim
   1600, 25 heads, mlp 6400, vocab 50257) through ``Trainer``: B8 S1024,
   bf16 over f32 masters, remat "none", adamw, 5 steps on one repeated
   seeded batch (losses finite and falling, K1-K4 48 launches a step
   each at head_dim 64 and no other attention kernel; step ms, tokens/s,
   MFU, peak memory); one Flash Checkpoint save of its 18.7 GB state to
   shm, 2 more steps, a fresh engine's restore of the save (every leaf
   ``torch.equal``) and the same 2 steps again, losses within 1e-5
   (relative); a profiled step, whose ``profiled_kernels`` line gives
   K1-K4's device ms and calls by name (as every profiled run's does);
   then serving and RL: ``[serve]``, llama3-8b at full width (32
   layers, dim 4096, 32 heads over 8 kv heads of 128, mlp 14336, vocab
   128256, rope_theta 5e5; 16.06 GB of bf16 weights drawn from a seed)
   in ``DecodeEngine(slots=8, capacity=2048)``, warmed up (every prompt
   bucket, the decode step captured as a CUDA graph): the logits of
   prompts of 100 and 1000 tokens and 16 teacher-forced decode steps
   each against the full forward (K1), and of 8 steps past the ring's
   end against a forward with a 2048-key sliding window, each within 2e-2
   of the largest value or twice the bf16 K1 forward's own distance from
   the f32 forward, whichever is larger; 24 seeded greedy requests
   through the continuous-batching scheduler, at least 2 in one step,
   each bit-equal to itself served alone in the same slot; the decode
   step's ms graph-replayed and eager at 8 live slots and context 2048
   beside its bound, tokens/s, TTFT per bucket, peak memory; then
   ``[serve-pool]``: the port's master (``python -m
   dlrover_tpu_torch.master.main --platform local --port 0``), two
   decode worker processes on the card (nano-350m, 8 slots of 1024, a
   DecodeWorker over RpcServingClient each), a seeded Poisson sweep of
   64 requests through ``MasterClient.serve_submit``, worker 1
   SIGKILLed while it holds requests: every request fetched ``done``
   with a reference engine's tokens, the ledger's failed 0 and attempts
   at most 2, overlap >= 2, no CUDA context left by the workers; the
   serve_* keys (tokens/s, TTFT p50/p99, goodput); then ``[ppo]``:
   ``LMPPOTrainer`` on nano-350m (actor and ref the port's Llama on the
   flash kernels, a linear critic), B8, 128 + 128 tokens sampled at
   temperature 1, 2 iterations: K1 32 launches per ``make_experience``
   and K1-K4 16 each per update, the rollout's logprobs within 2e-2 of
   the teacher-forced ones, finite stats, the actor moved; rollout
   tokens/s, update ms, peak memory; then ``[prof]``: nano-350m (B8
   S2048, bf16, adamw, K1-K4) through ``Trainer`` under the launcher,
   a master of its own with its HTTP plane, and the agent, twice: with
   ``DLROVER_PROF_SAMPLE_STEPS=0`` and ``profile=True`` over 2 steps
   after step 41 (``StepProfiler.assert_ops_present`` must find K1-K4,
   and the agent's ``/metrics`` serve them as ``dlrtpu_kernel_self_ms``),
   then with ``DLROVER_PROF_SAMPLE_STEPS=4``: each sampled window's
   categories and K1-K4 by name (ms, calls), each window's cost (the
   first, cold one apart) and the sampler's overhead over steps 2-40
   against the first run, then from step 41 200 extra bf16 GEMMs of
   8192^3 a step (a device-side step-time regression) until the master's
   SLO watchdog issues a capture directive, the agent relays it, the
   worker captures 2 steps and ``/captures.json`` shows the record done:
   its artifact's merged timeline must hold the host spans and K1-K4's
   CUDA kernel events, and its attribution name matmul against the
   stored baseline; ``[brain]``: ``python -m
   dlrover_tpu_torch.brain.main`` in its own process, a BrainClient
   persisting a record of the second run at each newer step it sees
   (tokens/s, step, the card's peak memory), the ``worker_resource`` and
   ``job_completion`` plans, and a BrainReporter on a dead address beside
   8 steps of nano-350m (no step stalls, the client degrades to instant
   no-ops);
6. one JSON line with every kernel's numbers (K1-K4's head_dim 64
   instantiations as ``<name>_d64``, their launches from ``[gpt2]``),
   then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when CUDA is missing. Longer reports
(per-op profile of one step) go to ``chiprun_out/``. The job's shm
segments are unlinked at the end, also when a phase fails.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import math
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
OUT = ROOT / "chiprun_out"

PEAK_BF16 = 989e12   # H100 SXM dense bf16 tensor-core FLOP/s
PEAK_F32 = 67e12     # H100 SXM f32 FLOP/s outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3 bytes/s

# (B, H, KVH, S): the slice's shape first
SHAPES = {
    "slice": (8, 8, 8, 2048),
    "gqa": (2, 32, 8, 1024),
    "ragged": (2, 8, 4, 1000),
}
HEAD_DIM = 128
# bf16 tolerance against the f32 plain versions, relative to the largest
# reference value: the kernels round roped q/k, P and dS to bf16 before
# the tensor-core products (2^-9 relative each), which plain f32 math
# does not; a wrong mask, tile or stride gives errors of order 1.
REL_TOL = {"o": 2e-2, "delta": 1e-3, "dq": 3e-2, "dk": 3e-2, "dv": 3e-2,
           # K1's rope pre-pass against the plain rope rounded to bf16:
           # both round f32 once, the kernel perhaps after a fused
           # multiply-add, so at most one bf16 step at the largest value
           "k_rope": 2 ** -8}
LSE_ABS_TOL = 2e-2   # lse is log-sum-exp of f32 scores, values ~ log S

KERNEL_INFO = {
    "flash_fwd": ("dlrover_tpu_torch/ops/csrc/flash_fwd.cu",
                  "dlrover_tpu/ops/attention.py:471"),
    "flash_bwd_preprocess": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                             "dlrover_tpu/ops/attention.py:1142"),
    "flash_bwd_dq": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                     "dlrover_tpu/ops/attention.py:973"),
    "flash_bwd_dkv": ("dlrover_tpu_torch/ops/csrc/flash_bwd.cu",
                      "dlrover_tpu/ops/attention.py:1052"),
    "flash_fwd_heads": ("dlrover_tpu_torch/ops/csrc/flash_heads.cu",
                        "dlrover_tpu/ops/attention.py:644"),
    "flash_bwd_dq_heads": ("dlrover_tpu_torch/ops/csrc/flash_heads.cu",
                           "dlrover_tpu/ops/attention.py:719"),
    "flash_bwd_dkv_heads": ("dlrover_tpu_torch/ops/csrc/flash_heads.cu",
                            "dlrover_tpu/ops/attention.py:781"),
    "quantize_int8": ("dlrover_tpu_torch/ops/csrc/optim.cu",
                      "dlrover_tpu/ops/quantization.py:35"),
    "dequantize_int8": ("dlrover_tpu_torch/ops/csrc/optim.cu",
                        "dlrover_tpu/ops/quantization.py:49"),
    "fused_adamw32": ("dlrover_tpu_torch/ops/csrc/optim.cu",
                      "dlrover_tpu/ops/fused_optim.py:166"),
    "fused_adamw8": ("dlrover_tpu_torch/ops/csrc/optim.cu",
                     "dlrover_tpu/ops/fused_optim.py:179"),
    "flash_ring_fwd": ("dlrover_tpu_torch/ops/csrc/flash_ring.cu",
                       "dlrover_tpu/ops/attention.py:1547"),
    "flash_ring_dq": ("dlrover_tpu_torch/ops/csrc/flash_ring.cu",
                      "dlrover_tpu/ops/attention.py:1583"),
    "flash_ring_dkv": ("dlrover_tpu_torch/ops/csrc/flash_ring.cu",
                       "dlrover_tpu/ops/attention.py:1612"),
}
# K1-K4's head_dim 64 instantiations: the same sources and TPU kernels
KERNEL_INFO.update({name + "_d64": KERNEL_INFO[name] for name in (
    "flash_fwd", "flash_bwd_preprocess", "flash_bwd_dq", "flash_bwd_dkv")})
# ring blocks (B, H, KVH, shard length): the slice's block shape first
RING_SHAPES = {
    "ring": (8, 8, 8, 512),
    "ring-gqa": (2, 32, 8, 256),
    "ring-ragged": (2, 8, 4, 500),
}
SEQ = 4  # ranks of the [seq4] run's seq axis
# [kernels-d64]: K1-K4 at head_dim 64, (B, H, KVH, S): gpt2-1.5b's
# attention (B8 S1024, 25 heads, causal, no rope) first, then a GQA and a
# ragged shape, both with rope (the JAX kernels rope at any width)
D64_SHAPES = {
    "gpt2": (8, 25, 25, 1024),
    "gqa": (2, 16, 4, 1024),
    "ragged": (2, 8, 4, 1000),
}

# Optimizer kernels against their plain versions. K5/K6 do the plain
# versions' f32 operations in their order: codes, scales and values must
# be bit-equal. K7 likewise (no FMA contraction on either side), held
# within 1e-6 of the largest value. K8's log codes come through
# expf/logf, whose last bit may differ from torch's exp/log: codes equal
# in at least 99.99% of entries and off by at most 1 elsewhere, scales
# within 1e-6 relative, params within 1e-4 of the step's largest update.
K7_REL_TOL = 1e-6
K8_CODE_MISMATCH = 1e-4
K8_SCALE_REL_TOL = 1e-6
K8_P_TOL = 1e-4
# f32 operations per element of each optimizer kernel's arithmetic (for
# the operations half of the bound; all four are bound by bytes)
OPT_OPS = {"quantize_int8": 7, "dequantize_int8": 1, "fused_adamw32": 14,
           "fused_adamw8": 36}
SLICE_LR = 3e-4
# the masked case: a sliding window and a prefix at the GQA shape
MASKED = {"window": 512, "prefix": 128}
# the attention kernels of each route of the model's attention
FLASH_KERNELS = ("flash_fwd", "flash_bwd_preprocess", "flash_bwd_dq",
                 "flash_bwd_dkv")
HEADS_KERNELS = ("flash_fwd_heads", "flash_bwd_preprocess",
                 "flash_bwd_dq_heads", "flash_bwd_dkv_heads")
RING_KERNELS = ("flash_ring_fwd", "flash_bwd_preprocess", "flash_ring_dq",
                "flash_ring_dkv")
# K1 runs per layer and step under each Strategy.remat, with the model's
# default per-layer "dots_attn" policy: as the JAX package saves, the
# strategy's checkpoint keeps no attention output, so its recompute runs
# the forward again, and the per-layer recompute takes the saved (o, lse)
REMAT_FWD_RUNS = {"none": 1, "minimal": 2, "full": 2, "offload": 2}
TRAINER_STEPS = 6
# [trainer] vs the bare loop (relative), remat vs none (absolute)
LOSS_TOL = 1e-5


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time of fn() over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, iters: int, replays: int = 5) -> list[float]:
    """Device time per call of fn(), one figure per replay of a CUDA graph
    that holds ``iters`` calls. The graph leaves out the host's cost per
    call (argument checks, allocation, the ctypes call), which bounds an
    eager loop of a kernel that runs a few microseconds."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()  # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    per_call = []
    for _ in range(replays):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        per_call.append(start.elapsed_time(end) / iters)
    return per_call


def rope_tables(B, S, dtype, D=HEAD_DIM):
    from dlrover_tpu_torch.models.llama import _rope_tables

    pos = torch.arange(S, device="cuda").expand(B, S)
    cos, sin = _rope_tables(pos, D // 2, 10000.0, dtype)
    return torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)


def make_inputs(shape, seed, D=HEAD_DIM):
    B, H, KVH, S = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn(B, heads, S, D, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(H), randn(KVH), randn(KVH), randn(H)
    cos, sin = rope_tables(B, S, torch.bfloat16, D)
    return q, k, v, do, cos, sin


def rel_err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


class Judge:
    """Holds kernel outputs against plain ones at one case, logging each
    comparison; ``worst`` collects each kernel's largest absolute error
    under its name and ``suffix`` (end-to-end checks are logged and
    judged, not collected)."""

    def __init__(self, name, worst, suffix=""):
        self.name, self.worst, self.failures = name, worst, []
        self.suffix = suffix

    def __call__(self, kernel, what, got, want, collect=True):
        abs_err, rel = rel_err(got, want)
        if collect:
            key = kernel + self.suffix
            self.worst[key] = max(self.worst.get(key, 0.0), abs_err)
        ok = abs_err <= LSE_ABS_TOL if what == "lse" else rel <= REL_TOL[what]
        log(f"  {self.name:6s} {kernel:21s} {what:5s} max_abs_err="
            f"{abs_err:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{self.name}/{kernel}/{what}")

    def done(self):
        torch.cuda.synchronize()
        if self.failures:
            raise SystemExit(f"kernel check failed: {self.failures}")


def check_shape(name, shape, seed, worst, window=None, prefix=None,
                D=HEAD_DIM, rope=True):
    """K1-K4 vs plain versions at one shape of head width ``D`` (with
    rope unless ``rope`` is False; the mask extras when given); fills
    ``worst`` with each kernel's largest absolute error (under
    ``<kernel>_d64`` at D = 64). Returns the inputs for timing."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, cos, sin = make_inputs(shape, seed, D)
    if not rope:
        cos = sin = None
    mask = (True, D ** -0.5, window, prefix)
    judge = Judge(name, worst, "" if D == HEAD_DIM else f"_d{D}")

    # each kernel on shared inputs (the kernel chain's own o/lse/delta)
    o, lse = att.flash_fwd(q, k, v, cos, sin, *mask)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, *mask)
    judge("flash_fwd", "o", o, o_p)
    judge("flash_fwd", "lse", lse, lse_p)
    del o_p, lse_p
    if rope:
        judge("flash_fwd", "k_rope", att.flash_fwd_rope_k(k, cos, sin),
              att._rope(k, cos, sin).to(k.dtype), collect=False)
    delta = att.flash_bwd_preprocess(do, o)
    judge("flash_bwd_preprocess", "delta", delta,
          att.flash_bwd_preprocess_plain(do, o))
    args = (q, k, v, do, lse, delta, cos, sin, *mask)
    judge("flash_bwd_dq", "dq", att.flash_bwd_dq(*args),
          att.flash_bwd_dq_plain(*args))
    dk, dv = att.flash_bwd_dkv(*args)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    judge("flash_bwd_dkv", "dk", dk, dk_p)
    judge("flash_bwd_dkv", "dv", dv, dv_p)
    del dk, dv, dk_p, dv_p

    # end to end through the autograd Function vs the plain chain
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin,
                              window=window, prefix_len=prefix)
    out.backward(do)
    want = plain_chain(q, k, v, do, lambda *a: a + (cos, sin, *mask),
                       att.flash_fwd_plain, att.flash_bwd_preprocess_plain,
                       att.flash_bwd_dq_plain, att.flash_bwd_dkv_plain)
    for what, got, ref in zip(("o", "dq", "dk", "dv"), [out.detach()] + [
            t.grad for t in leaves], want):
        judge("autograd", what, got, ref, collect=False)
    judge.done()
    return q, k, v, do, cos, sin, o, lse, delta


def plain_chain(q, k, v, do, extra, fwd, pre, dq, dkv, split=None):
    """(o, dq, dk, dv) of the plain versions chained as the autograd
    Function chains the kernels; ``extra(*operands)`` appends the
    arguments after q/k/v(/do/lse/delta), ``split`` views o/do for
    delta."""
    o, lse = fwd(*extra(q, k, v))
    views = split or (lambda t: t)
    delta = pre(views(do), views(o))
    args = extra(q, k, v, do, lse, delta)
    return (o, dq(*args), *dkv(*args))


def heads_inputs(shape, seed):
    """make_inputs' q/k/v/do laid out as [B, S, heads * D], contiguous,
    as the bshd model's projections give them."""
    B, H, KVH, S = shape
    return tuple(t.transpose(1, 2).reshape(B, S, -1).contiguous()
                 for t in make_inputs(shape, seed)[:4])


def check_heads(name, shape, seed, worst, window=None, prefix=None):
    """K9-K11 vs plain versions at one shape (the mask extras when
    given), and flash_attention_bshd end to end through both routes
    (K9-K11, and K1-K4 on strided views) vs the plain chain. Returns the
    inputs for timing."""
    from dlrover_tpu_torch.ops import attention as att

    B, H, KVH, S = shape
    q, k, v, do = heads_inputs(shape, seed)
    mask = (True, HEAD_DIM ** -0.5, window, prefix)
    judge = Judge(name, worst)

    def split(t):
        return att._split_heads(t, H)

    o, lse = att.flash_fwd_heads(q, k, v, H, *mask)
    o_p, lse_p = att.flash_fwd_heads_plain(q, k, v, H, *mask)
    judge("flash_fwd_heads", "o", o, o_p)
    judge("flash_fwd_heads", "lse", lse, lse_p)
    del o_p, lse_p
    delta = att.flash_bwd_preprocess(split(do), split(o))
    judge("flash_bwd_preprocess", "delta", delta,
          att.flash_bwd_preprocess_plain(split(do), split(o)))
    args = (q, k, v, do, lse, delta, H, *mask)
    judge("flash_bwd_dq_heads", "dq", att.flash_bwd_dq_heads(*args),
          att.flash_bwd_dq_heads_plain(*args))
    dk, dv = att.flash_bwd_dkv_heads(*args)
    dk_p, dv_p = att.flash_bwd_dkv_heads_plain(*args)
    judge("flash_bwd_dkv_heads", "dk", dk, dk_p)
    judge("flash_bwd_dkv_heads", "dv", dv, dv_p)
    del dk, dv, dk_p, dv_p

    want = plain_chain(q, k, v, do, lambda *a: a + (H, *mask),
                       att.flash_fwd_heads_plain,
                       att.flash_bwd_preprocess_plain,
                       att.flash_bwd_dq_heads_plain,
                       att.flash_bwd_dkv_heads_plain, split)
    for fused, label in ((True, "bshd fused"), (False, "bshd per-head")):
        leaves = [t.view(B, S, -1, HEAD_DIM).clone().requires_grad_()
                  for t in (q, k, v)]
        out = att.flash_attention_bshd(*leaves, fused=fused, window=window,
                                       prefix_len=prefix)
        out.backward(do.view(B, S, H, HEAD_DIM))
        got = [out.detach()] + [t.grad for t in leaves]
        for what, g, ref in zip(("o", "dq", "dk", "dv"), got, want):
            judge(label, what, g.reshape(ref.shape), ref, collect=False)
        del leaves, out, got
    judge.done()
    return q, k, v, do, o, lse, delta


def bounds(shape, D=HEAD_DIM, rope=True):
    """Least time (ms) per kernel at ``shape`` and head width ``D``: the
    larger of bytes moved (each input read once, each output written
    once; K1/K3/K4 read the rope tables when ``rope``) over HBM bandwidth
    and the products' operations over the peak for their type. Causal
    work counts only the S(S+1)/2 visible (query, key) pairs."""
    B, H, KVH, S = shape
    pairs = B * H * S * (S + 1) / 2
    q_b, kv_b, row_b = B * H * S * D * 2, B * KVH * S * D * 2, B * H * S * 4
    tab_b = 2 * B * S * D * 2 if rope else 0
    fwd_b = 2 * q_b + 2 * kv_b + row_b
    dq_b = 3 * q_b + 2 * kv_b + 2 * row_b
    dkv_b = 2 * q_b + 4 * kv_b + 2 * row_b
    work = {
        # (bytes, ops, peak); K9-K11 do K1/K3/K4's work without rope tables
        "flash_fwd": (fwd_b + tab_b, 4 * D * pairs, PEAK_BF16),
        "flash_bwd_preprocess": (2 * q_b + row_b, 2 * B * H * S * D,
                                 PEAK_F32),
        "flash_bwd_dq": (dq_b + tab_b, 6 * D * pairs, PEAK_BF16),
        "flash_bwd_dkv": (dkv_b + tab_b, 8 * D * pairs, PEAK_BF16),
        "flash_fwd_heads": (fwd_b, 4 * D * pairs, PEAK_BF16),
        "flash_bwd_dq_heads": (dq_b, 6 * D * pairs, PEAK_BF16),
        "flash_bwd_dkv_heads": (dkv_b, 8 * D * pairs, PEAK_BF16),
    }
    out = {}
    for name, (nbytes, ops, peak) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / peak * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_kernels(inputs):
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, cos, sin, o, lse, delta = inputs
    scale = HEAD_DIM ** -0.5
    args = (q, k, v, do, lse, delta, cos, sin, True, scale)
    # K2 runs ~20 us, less than its wrapper's host cost, so its three
    # figures are device times of CUDA-graph replays (median of 5)
    k2 = {
        "kernel": graph_ms(lambda: att.flash_bwd_preprocess(do, o), 50),
        "plain": graph_ms(lambda: att.flash_bwd_preprocess_plain(do, o), 10),
        # one library call for delta (bf16 out; the kernel writes f32)
        "library": graph_ms(lambda: torch.linalg.vecdot(do, o, dim=-1), 50),
    }
    log(json.dumps({"flash_bwd_preprocess_graph_replays_ms": k2}))
    k2 = {key: statistics.median(val) for key, val in k2.items()}
    # K1's rope pre-pass alone (part of K1's time below), likewise; and
    # the two that K3 and K4 each run (q and k), part of their times
    prepass = graph_ms(lambda: att.flash_fwd_rope_k(k, cos, sin), 50)
    log(json.dumps({"flash_fwd_rope_k_graph_replays_ms": prepass}))
    bwd_prepass = graph_ms(lambda: (att.flash_fwd_rope_k(q, cos, sin),
                                    att.flash_fwd_rope_k(k, cos, sin)), 50)
    log(json.dumps({"bwd_rope_q_and_k_graph_replays_ms": bwd_prepass}))
    # K1, K3 and K4 (each with its rope pre-passes) from CUDA-graph
    # replays as well (median of 5): an eager loop adds the host's cost
    # per call to the device time
    replays = {
        "flash_fwd": graph_ms(
            lambda: att.flash_fwd(q, k, v, cos, sin, True, scale), 20),
        "flash_bwd_dq": graph_ms(lambda: att.flash_bwd_dq(*args), 20),
        "flash_bwd_dkv": graph_ms(lambda: att.flash_bwd_dkv(*args), 20),
    }
    log(json.dumps({"kernel_graph_replays_ms": {"case": "slice",
                                                **replays}}))
    times = {
        "flash_fwd": (
            statistics.median(replays["flash_fwd"]),
            cuda_ms(lambda: att.flash_fwd_plain(q, k, v, cos, sin, True,
                                                scale), 3)),
        "flash_bwd_preprocess": (k2["kernel"], k2["plain"]),
        "flash_bwd_dq": (
            statistics.median(replays["flash_bwd_dq"]),
            cuda_ms(lambda: att.flash_bwd_dq_plain(*args), 3)),
        "flash_bwd_dkv": (
            statistics.median(replays["flash_bwd_dkv"]),
            cuda_ms(lambda: att.flash_bwd_dkv_plain(*args), 3)),
    }
    # library yardstick: SDPA (flash backend) on pre-roped q/k, its
    # forward from CUDA-graph replays too; timed here only, the port
    # never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr = att._rope(q, cos, sin).to(torch.bfloat16).requires_grad_()
    kr = att._rope(k, cos, sin).to(torch.bfloat16).requires_grad_()
    vr = v.clone().requires_grad_()
    bwd_ms = sdpa_bwd_ms((qr, kr, vr), do, "slice")
    fwd_ms = SDPA_FWD_MS["slice"]
    library = {"flash_fwd": fwd_ms, "flash_bwd_preprocess": k2["library"]}
    prepass_ms = {"flash_fwd": statistics.median(prepass)}
    prepass_ms["flash_bwd_dq"] = prepass_ms["flash_bwd_dkv"] = (
        statistics.median(bwd_prepass))
    return times, library, bwd_ms, prepass_ms


SDPA_FWD_MS: dict = {}  # case -> SDPA's forward, median of graph replays


def sdpa_bwd_ms(leaves, do, label, causal=True):
    """SDPA's backward on the leaves q/k/v with output gradient do: the
    median of 5 CUDA-graph replays of forward and backward together less
    that of the forward alone (a captured backward needs its forward in
    the same capture). Both medians are logged."""
    sdpa = torch.nn.functional.scaled_dot_product_attention
    fwd = graph_ms(lambda: sdpa(*leaves, is_causal=causal), 20)
    both = graph_ms(lambda: torch.autograd.grad(
        sdpa(*leaves, is_causal=causal), leaves, do), 20)
    bwd = statistics.median(both) - statistics.median(fwd)
    log(json.dumps({"sdpa_graph_replays_ms": {
        "case": label, "fwd": fwd, "fwd_and_bwd": both, "bwd": bwd}}))
    # the forward's median, the library yardstick of the forward kernels
    SDPA_FWD_MS[label] = statistics.median(fwd)
    return bwd


def time_heads(inputs):
    """K9-K11's ms and their plain versions' at the slice's shape, and
    SDPA forward / backward on the same rope-free [B, H, S, D] views (the
    library yardstick, timed only)."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, o, lse, delta = inputs
    H = SHAPES["slice"][1]
    args = (q, k, v, do, lse, delta, H, True, HEAD_DIM ** -0.5)
    fwd = (q, k, v, H, True, HEAD_DIM ** -0.5)
    times, replays = {}, {}
    for name, call in (("flash_fwd_heads", fwd), ("flash_bwd_dq_heads", args),
                       ("flash_bwd_dkv_heads", args)):
        kernel, plain = getattr(att, name), getattr(att, name + "_plain")
        replays[name] = graph_ms(lambda: kernel(*call), 20)
        times[name] = (statistics.median(replays[name]),
                       cuda_ms(lambda: plain(*call), 3))
    log(json.dumps({"kernel_graph_replays_ms": {"case": "slice bshd",
                                                **replays}}))
    views = [att._split_heads(t, H).detach().requires_grad_()
             for t in (q, k, v)]
    bwd_ms = sdpa_bwd_ms(views, att._split_heads(do, H), "bshd views")
    return times, {"flash_fwd_heads": SDPA_FWD_MS["bshd views"]}, bwd_ms


def time_packing(shape):
    """At ``shape``, all without rope, on the same data: K9 against K1,
    the measure of K9's group packing (K1 stages each k/v tile once per q
    head, K9 once per GQA group); then K10 against K3 and K11 against K4,
    the same loops, from CUDA-graph replays: the cost of reading
    [B, S, H*D] operands through strided tensor maps."""
    from dlrover_tpu_torch.ops import attention as att

    B, H, KVH, S = shape
    q, k, v, do = make_inputs(shape, 7)[:4]
    scale = HEAD_DIM ** -0.5
    o, lse = att.flash_fwd(q, k, v, None, None, True, scale)
    delta = att.flash_bwd_preprocess(do, o)
    q3, k3, v3, do3 = (t.transpose(1, 2).reshape(B, S, -1).contiguous()
                       for t in (q, k, v, do))
    per_head = (q, k, v, do, lse, delta, None, None, True, scale)
    fused = (q3, k3, v3, do3, lse, delta, H, True, scale)
    ms = {
        "flash_fwd": cuda_ms(lambda: att.flash_fwd(*per_head[:3],
                                                   *per_head[6:]), 20),
        "flash_fwd_heads": cuda_ms(lambda: att.flash_fwd_heads(
            *fused[:3], *fused[6:]), 20),
    }
    log(json.dumps({"group_packing_ms_no_rope": {
        "shape_b_h_kvh_s": list(shape), **ms,
        "fwd_ratio_k9_over_k1": ms["flash_fwd_heads"] / ms["flash_fwd"],
    }}))
    strided = {
        "flash_bwd_dq": graph_ms(lambda: att.flash_bwd_dq(*per_head), 20),
        "flash_bwd_dq_heads": graph_ms(
            lambda: att.flash_bwd_dq_heads(*fused), 20),
        "flash_bwd_dkv": graph_ms(lambda: att.flash_bwd_dkv(*per_head), 20),
        "flash_bwd_dkv_heads": graph_ms(
            lambda: att.flash_bwd_dkv_heads(*fused), 20),
    }
    medians = {name: statistics.median(val) for name, val in strided.items()}
    log(json.dumps({"strided_view_graph_replays_ms_no_rope": {
        "shape_b_h_kvh_s": list(shape), **strided,
        "dq_ratio_k10_over_k3":
            medians["flash_bwd_dq_heads"] / medians["flash_bwd_dq"],
        "ratio_k11_over_k4_medians":
            medians["flash_bwd_dkv_heads"] / medians["flash_bwd_dkv"],
    }}))


def check_bshd_d64(shape, seed):
    """flash_attention_bshd at head_dim 64 with its default fused=True:
    the bhsd route, K1-K4 on the [B, H, S, D] views of the [B, S, H, D]
    operands, as the JAX package routes head_dim % 128 != 0; held against
    the plain chain, and K1-K4 must launch once each, K9-K11 never."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do = make_inputs(shape, seed, 64)[:4]
    mask = (True, 64 ** -0.5, None, None)
    want = plain_chain(q, k, v, do, lambda *a: a + (None, None, *mask),
                       att.flash_fwd_plain, att.flash_bwd_preprocess_plain,
                       att.flash_bwd_dq_plain, att.flash_bwd_dkv_plain)
    leaves = [t.transpose(1, 2).contiguous().requires_grad_()
              for t in (q, k, v)]
    reset_launches()
    out = att.flash_attention_bshd(*leaves)
    out.backward(do.transpose(1, 2))
    counts = launch_counts()
    judge = Judge("d64", {})
    got = [out.detach()] + [t.grad for t in leaves]
    for what, g, ref in zip(("o", "dq", "dk", "dv"), got, want):
        judge("bshd fused", what, g.transpose(1, 2), ref, collect=False)
    judge.done()
    want_counts = {name: int(name in FLASH_KERNELS) for name in
                   FLASH_KERNELS + HEADS_KERNELS}
    got_counts = {name: counts[name] for name in want_counts}
    log(f"  d64    bshd fused launches: {got_counts}")
    if got_counts != want_counts:
        raise SystemExit(f"bshd at head_dim 64 launched {got_counts}, "
                         f"want {want_counts}")


def time_d64(inputs):
    """K1-K4 at gpt2-1.5b's attention shape (head_dim 64, causal, no
    rope): each kernel's ms from CUDA-graph replays (median of 5; the
    kernels run tens of microseconds, near their wrappers' host cost),
    its plain version's, and SDPA's forward as K1's library yardstick and
    its backward from graph replays beside K2 + K3 + K4 (timed here
    only; the port never calls it). Returns (times, library)."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, _cos, _sin, o, lse, delta = inputs
    scale = 64 ** -0.5
    args = (q, k, v, do, lse, delta, None, None, True, scale)
    calls = {
        "flash_fwd": (lambda: att.flash_fwd(q, k, v, None, None, True, scale),
                      lambda: att.flash_fwd_plain(q, k, v, None, None, True,
                                                  scale)),
        "flash_bwd_preprocess": (
            lambda: att.flash_bwd_preprocess(do, o),
            lambda: att.flash_bwd_preprocess_plain(do, o)),
        "flash_bwd_dq": (lambda: att.flash_bwd_dq(*args),
                         lambda: att.flash_bwd_dq_plain(*args)),
        "flash_bwd_dkv": (lambda: att.flash_bwd_dkv(*args),
                          lambda: att.flash_bwd_dkv_plain(*args)),
    }
    replays, times = {}, {}
    for name, (kernel, plain) in calls.items():
        replays[name] = graph_ms(kernel, 20)
        times[name + "_d64"] = (statistics.median(replays[name]),
                                cuda_ms(plain, 3))
    log(json.dumps({"d64_graph_replays_ms": replays}))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    library = {
        "flash_fwd_d64": statistics.median(graph_ms(
            lambda: sdpa(*leaves, is_causal=True), 20)),
        "flash_bwd_preprocess_d64": statistics.median(graph_ms(
            lambda: torch.linalg.vecdot(do, o, dim=-1), 50)),
    }
    sdpa_bwd = sdpa_bwd_ms(leaves, do, "gpt2 d64")
    log(json.dumps({"backward_at_gpt2_shape": {
        "port_bwd_ms": sum(times[n + "_d64"][0] for n in FLASH_KERNELS[1:]),
        "sdpa_bwd_ms": sdpa_bwd}}))
    return times, library


def kernels_d64_phase():
    """[kernels-d64]: K1-K4 at head_dim 64 against their plain versions
    (the D = 128 gates) at gpt2-1.5b's shape (no rope), a roped GQA shape,
    a roped ragged one and the masked case (the GQA shape with MASKED);
    flash_attention_bshd at head_dim 64 through K1-K4; then the times at
    gpt2-1.5b's shape. Returns (worst, times, library, bound), keyed by
    ``<kernel>_d64``."""
    worst: dict[str, float] = {}
    for i, (name, shape) in enumerate(D64_SHAPES.items()):
        inputs = check_shape(name, shape, 20 + i, worst, D=64,
                             rope=name != "gpt2")
        if name == "gpt2":
            gpt2_inputs = inputs
        del inputs
    check_shape("masked", D64_SHAPES["gqa"], 23, worst, D=64, **MASKED)
    check_bshd_d64(D64_SHAPES["gqa"], 24)
    times, library = time_d64(gpt2_inputs)
    del gpt2_inputs
    bound = {name + "_d64": b for name, b in bounds(
        D64_SHAPES["gpt2"], D=64, rope=False).items()
        if name in FLASH_KERNELS}
    torch.cuda.empty_cache()
    return worst, times, library, bound


def ring_inputs(shape, seed):
    """q, k, v, do of a whole sequence of SEQ shards of ``shape``'s
    length, laid out as the [seq4] path hands them to the ring: [B, S,
    heads, D] tensors (the model's layout after rope) seen as [B, heads,
    S, D] views."""
    B, H, KVH, S = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn(B, SEQ * S, heads, HEAD_DIM, generator=gen,
                           device="cuda").to(torch.bfloat16).transpose(1, 2)

    return randn(H), randn(KVH), randn(KVH), randn(H)


def check_ring(name, shape, seed, worst):
    """K12-K14 and K2 vs plain versions for the q shard of ring rank 1
    against the kv shards of ranks 1 (diagonal), 0 (visible) and 2
    (future), each operand a shard's view of the whole sequence as in
    the [seq4] run, with the lse and delta of the ring over the two
    visible blocks (their plain outputs merged as the ring merges them;
    delta from K2 on do's shard and o's shard of a contiguous [B, H, S,
    D] o, as the ring's backward takes them). The future block must give
    exact zeros and lse -1e30. Returns the inputs for timing."""
    from dlrover_tpu_torch.ops import attention as att
    from dlrover_tpu_torch.parallel.sequence import _merge_block

    S = shape[3]
    q_all, k_all, v_all, do_all = ring_inputs(shape, seed)

    def shard(t, rank):
        return t[:, :, rank * S:(rank + 1) * S]

    q, do = shard(q_all, 1), shard(do_all, 1)
    scale = HEAD_DIM ** -0.5
    judge = Judge(name, worst)
    ranks = {"diagonal": 1, "visible": 0, "future": 2}
    plain = {}
    for rel, c in ranks.items():
        k, v = shard(k_all, c), shard(v_all, c)
        o, lse = att.flash_ring_fwd(q, k, v, S, c * S, scale)
        if rel == "future":
            exact = bool((o == 0).all()) and bool((lse == att.NEG_INF).all())
            continue
        o_p, lse_p = att.flash_ring_fwd_plain(q, k, v, S, c * S, scale)
        judge("flash_ring_fwd", "o", o, o_p)
        judge("flash_ring_fwd", "lse", lse, lse_p)
        plain[rel] = (o_p, lse_p)
    o_d, lse_d = plain["diagonal"]
    o_g, lse_g = _merge_block(o_d.float(), lse_d, *plain["visible"])
    o_all = torch.zeros(do_all.shape, dtype=torch.bfloat16, device="cuda")
    o = shard(o_all, 1)
    o.copy_(o_g)
    delta = att.flash_bwd_preprocess(do, o)
    judge("flash_bwd_preprocess", "delta", delta,
          att.flash_bwd_preprocess_plain(do, o))
    del plain, o_d, o_g, o_all, o
    for rel, c in ranks.items():
        args = (q, shard(k_all, c), shard(v_all, c), do, lse_g, delta, S,
                c * S, scale)
        dq = att.flash_ring_dq(*args)
        dk, dv = att.flash_ring_dkv(*args)
        if rel == "future":
            exact = exact and not (dq.any() or dk.any() or dv.any())
            continue
        judge("flash_ring_dq", "dq", dq, att.flash_ring_dq_plain(*args))
        dk_p, dv_p = att.flash_ring_dkv_plain(*args)
        judge("flash_ring_dkv", "dk", dk, dk_p)
        judge("flash_ring_dkv", "dv", dv, dv_p)
        del dq, dk, dv, dk_p, dv_p
    log(f"  {name:6s} future block: o == 0, lse == -1e30, dq = dk = dv = 0 "
        f"{'ok' if exact else 'FAIL'}")
    if not exact:
        judge.failures.append(f"{name}/future")
    judge.done()
    # time_ring runs the diagonal and the visible block on one kv shard
    return q, shard(k_all, 0), shard(v_all, 0), do, lse_g, delta


def ring_bounds(shape, rel):
    """Least time (ms) of each ring-block kernel on one block of
    ``shape``: bytes (bf16 operands read once, o bf16 and lse written
    once; lse/delta read and the f32 dq or dk/dv written once) over HBM
    bandwidth, or the products' operations over the bf16 tensor-core
    peak, counting the visible (query, key) pairs only: S(S+1)/2 per head
    on the diagonal, S^2 on a wholly visible block."""
    B, H, KVH, S = shape
    D = HEAD_DIM
    pairs = B * H * (S * (S + 1) / 2 if rel == "diagonal" else S * S)
    q_b, kv_b, row_b = B * H * S * D * 2, B * KVH * S * D * 2, B * H * S * 4
    work = {
        "flash_ring_fwd": (2 * q_b + 2 * kv_b + row_b, 4 * D * pairs),
        "flash_ring_dq": (4 * q_b + 2 * kv_b + 2 * row_b, 6 * D * pairs),
        "flash_ring_dkv": (2 * q_b + 6 * kv_b + 2 * row_b, 8 * D * pairs),
    }
    out = {}
    for name, (nbytes, ops) in work.items():
        t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_BF16 * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_ring(inputs):
    """K12-K14's ms at the slice's block shape, for the diagonal and the
    wholly visible block: device times of CUDA-graph replays (median of
    5 replays of 20 calls; a block runs tens of microseconds, near the
    wrappers' host cost), the plain versions' from CUDA events, SDPA
    forward and backward on the same q/k/v (is_causal on the diagonal),
    both from CUDA-graph replays, as the library yardstick. Returns
    {rel: {name: (ms, plain, bound, bound_by, library)}}."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, lse, delta = inputs
    S = q.shape[2]
    scale = HEAD_DIM ** -0.5
    sdpa = torch.nn.functional.scaled_dot_product_attention
    report, result = {}, {}
    for rel, k_start in (("diagonal", S), ("visible", 0)):
        fwd = (q, k, v, S, k_start, scale)
        bwd = (q, k, v, do, lse, delta, S, k_start, scale)
        calls = {
            "flash_ring_fwd": (lambda: att.flash_ring_fwd(*fwd),
                               lambda: att.flash_ring_fwd_plain(*fwd)),
            "flash_ring_dq": (lambda: att.flash_ring_dq(*bwd),
                              lambda: att.flash_ring_dq_plain(*bwd)),
            "flash_ring_dkv": (lambda: att.flash_ring_dkv(*bwd),
                               lambda: att.flash_ring_dkv_plain(*bwd)),
        }
        causal = rel == "diagonal"
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        fwd_ms = statistics.median(graph_ms(
            lambda: sdpa(q, k, v, is_causal=causal), 20))
        bwd_ms = sdpa_bwd_ms(leaves, do, f"ring {rel}", causal)
        bound = ring_bounds((q.shape[0], q.shape[1], k.shape[1], S), rel)
        result[rel] = {}
        for name, (kernel, plain) in calls.items():
            replays = graph_ms(kernel, 20)
            result[rel][name] = (
                statistics.median(replays), cuda_ms(plain, 3), *bound[name],
                fwd_ms if name == "flash_ring_fwd" else None)
            report[f"{rel}/{name}"] = {
                "replays_ms": replays, "plain_ms": result[rel][name][1],
                "bound_ms": bound[name][0], "bound_by": bound[name][1]}
            torch.cuda.empty_cache()
        report[f"{rel}/sdpa"] = {"fwd_ms": fwd_ms, "bwd_ms": bwd_ms}
        del leaves
    log(json.dumps({"ring_blocks_at_slice_block_shape": report}))
    return result


def kernel_modules():
    from dlrover_tpu_torch.ops import attention, fused_optim, quantization

    return attention, quantization, fused_optim


def reset_launches() -> None:
    for mod in kernel_modules():
        for kernel in mod.KERNELS:
            kernel.launches = 0


def launch_counts() -> dict:
    from dlrover_tpu_torch.ops import launch_counts as counts

    return counts()


def opt_tree(cfg):
    """The slice's 12 parameter leaves (nano-350m, in the JAX leaf order
    auto_accelerate uses), then a ragged 1000-element leaf and a
    512-element leaf without a grad (its rows stay all zero), with
    seeded grads of a training step's scale."""
    from dlrover_tpu_torch.models import llama_init
    from dlrover_tpu_torch.ops.fused_optim import tree_order

    params = llama_init(cfg, seed=2, device="cuda")
    leaves = [params.pop(name) for name in tree_order(params)]
    gen = torch.Generator(device="cuda").manual_seed(3)
    leaves.append(torch.randn(1000, generator=gen, device="cuda"))
    leaves.append(torch.zeros(512, device="cuda"))
    grads = [torch.randn(p.shape, generator=gen, device="cuda") * 1e-3
             for p in leaves[:-1]] + [None]
    return leaves, grads, gen


def check_quantize(xs, gen, worst, failures):
    """K5 and K6 against their plain versions on every leaf, stochastic
    (shared u) and nearest."""
    from dlrover_tpu_torch.ops import quantization as qz

    code_err = val_err = 0.0
    for x in xs:
        rows = -(-x.numel() // qz.BLOCK)
        u = torch.rand((rows, qz.BLOCK), generator=gen, device="cuda")
        for stochastic in (True, False):
            q, s, shape = qz.quantize_int8(x, u=u, stochastic=stochastic)
            qp, sp = qz.quantize_int8_plain(x, u, stochastic)
            code_err = max(code_err, (q.int() - qp.int()).abs().max().item(),
                           (s - sp).abs().max().item())
            out = qz.dequantize_int8(q, s, shape)
            val_err = max(val_err, (out - qz.dequantize_int8_plain(
                q, s, shape)).abs().max().item())
    worst["quantize_int8"], worst["dequantize_int8"] = code_err, val_err
    for name, err in (("quantize_int8", code_err),
                      ("dequantize_int8", val_err)):
        ok = err == 0.0
        log(f"  optim  {name:21s} max_abs_err={err:.3e} (bit-equal "
            f"required) {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(name)


def fresh_state(bits, rows):
    from dlrover_tpu_torch.ops.quantization import BLOCK

    if bits == 32:
        return [torch.zeros((rows, BLOCK), device="cuda") for _ in range(2)]
    return [torch.zeros((rows, BLOCK), dtype=torch.int8, device="cuda"),
            torch.ones((rows, 1), device="cuda"),
            torch.zeros((rows, BLOCK), dtype=torch.uint8, device="cuda"),
            torch.ones((rows, 1), device="cuda")]


def check_fused(bits, leaves, grads, gen, clip, wd, worst, failures):
    """One K7/K8 step against its plain version from a state made by two
    plain steps; both take the same u."""
    from dlrover_tpu_torch.ops import fused_optim as fo
    from dlrover_tpu_torch.ops.quantization import BLOCK

    meta = fo.flatten_meta(leaves)
    rows = meta.total_rows
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=wd, clip_norm=clip)
    norm = fo._global_norm(grads) if clip is not None else None
    name = f"fused_adamw{bits}"
    kernel, plain = getattr(fo, name), getattr(fo, name + "_plain")

    def step(fn, count, ps, st):
        sc = fo._scalars(count, count + 1, 1e-3, 0.9, 0.999, norm, "cuda")
        u = ([] if bits == 32 else
             [torch.rand((rows, BLOCK), generator=gen, device="cuda")])
        fn(sc, ps, grads, *st, *u, meta, **kw)

    params = [p.clone() for p in leaves]
    state = fresh_state(bits, rows)
    seed = gen.initial_seed()
    for count in range(2):
        step(plain, count, params, state)
    before = [p.clone() for p in params]
    pk, sk = [p.clone() for p in params], [t.clone() for t in state]
    pp, sp = params, state
    gen.manual_seed(seed + 1)
    step(kernel, 2, pk, sk)
    gen.manual_seed(seed + 1)
    step(plain, 2, pp, sp)
    torch.cuda.synchronize()
    label = f"clip={clip} wd={wd}"
    if bits == 32:
        errs = [(a - b).abs().max().item() for a, b in zip(pk + sk, pp + sp)]
        rel = max((a - b).abs().max().item() / b.abs().max().item()
                  for a, b in zip(pk + sk, pp + sp) if b.abs().max() > 0)
        diff = sum(int((a != b).sum()) for a, b in zip(pk + sk, pp + sp))
        ok = rel <= K7_REL_TOL
        worst[name] = max(worst.get(name, 0.0), max(errs))
        log(f"  optim  {name:21s} {label:17s} max_abs_err={max(errs):.3e} "
            f"rel={rel:.3e} differing={diff} {'ok' if ok else 'FAIL'}")
    else:
        p_err = max((a - b).abs().max().item() for a, b in zip(pk, pp))
        moved = max((a - b).abs().max().item() for a, b in zip(pp, before))
        codes = [(sk[i].int() - sp[i].int()).abs() for i in (0, 2)]
        mismatch = max((c != 0).float().mean().item() for c in codes)
        code_max = max(c.max().item() for c in codes)
        scale_rel = max(((sk[i] - sp[i]).abs() / sp[i].abs()).max().item()
                        for i in (1, 3))
        ok = (p_err <= K8_P_TOL * moved and code_max <= 1
              and mismatch <= K8_CODE_MISMATCH
              and scale_rel <= K8_SCALE_REL_TOL)
        worst[name] = max(worst.get(name, 0.0), p_err)
        log(f"  optim  {name:21s} {label:17s} p max_abs_err={p_err:.3e} "
            f"(step {moved:.3e}) codes differing={mismatch:.2e} "
            f"max={code_max} scale_rel={scale_rel:.2e} "
            f"{'ok' if ok else 'FAIL'}")
    if not ok:
        failures.append(f"{name}/{label}")


def opt_bounds(meta):
    """Least time (ms) of each optimizer kernel over the leaves of
    ``meta``: bytes (each input read once, each output written once)
    over HBM bandwidth, or f32 operations over the f32 peak."""
    n = sum(meta.numels)
    rows = meta.total_rows
    elems = rows * 256
    work = {
        "quantize_int8": 4 * n + 4 * elems + elems + 4 * rows,
        "dequantize_int8": elems + 4 * rows + 4 * n,
        "fused_adamw32": 4 * n + 8 * n + 16 * elems,
        "fused_adamw8": 4 * n + 8 * n + 8 * elems + 16 * rows,
    }
    out = {}
    for name, nbytes in work.items():
        t_bytes = nbytes / PEAK_BYTES * 1e3
        t_ops = OPT_OPS[name] * elems / PEAK_F32 * 1e3
        out[name] = (max(t_bytes, t_ops),
                     "bytes" if t_bytes >= t_ops else "operations")
    return out


def time_opt_kernels(leaves, grads, gen):
    """The optimizer kernels' ms at the slice's 12 leaves (the slice's
    settings: lr 3e-4, no clipping, no weight decay): K7/K8 from CUDA
    events around eager loops, K5/K6 (12 launches per step, each a few to
    a few hundred microseconds) from CUDA-graph replays of one step's
    calls. Returns (times, library, bounds)."""
    from dlrover_tpu_torch.ops import fused_optim as fo
    from dlrover_tpu_torch.ops import quantization as qz

    meta = fo.flatten_meta(leaves)
    rows = meta.total_rows
    kw = dict(b1=0.9, b2=0.999, eps=1e-8, weight_decay=0.0, clip_norm=None)
    sc = fo._scalars(2, 3, SLICE_LR, 0.9, 0.999, None, "cuda")
    times, library = {}, {}
    mu, nu = fresh_state(32, rows)
    times["fused_adamw32"] = (
        cuda_ms(lambda: fo.fused_adamw32(sc, leaves, grads, mu, nu, meta,
                                         **kw), 10),
        cuda_ms(lambda: fo.fused_adamw32_plain(sc, leaves, grads, mu, nu,
                                               meta, **kw), 3))
    del mu, nu
    state = fresh_state(8, rows)
    u = torch.rand((rows, qz.BLOCK), generator=gen, device="cuda")
    times["fused_adamw8"] = (
        cuda_ms(lambda: fo.fused_adamw8(sc, leaves, grads, *state, u, meta,
                                        **kw), 10),
        cuda_ms(lambda: fo.fused_adamw8_plain(sc, leaves, grads, *state, u,
                                              meta, **kw), 3))
    u_ms = cuda_ms(lambda: torch.rand((rows, qz.BLOCK), generator=gen,
                                      device="cuda"), 10)
    del state, u
    # the library yardstick for K7: one torch AdamW step over the same
    # tree, fused (one kernel) and foreach (the adamw slice's optimizer)
    for p, g in zip(leaves, grads):
        p.grad = g
    adamw = {}
    for impl in ("fused", "foreach"):
        opt = torch.optim.AdamW(leaves, lr=SLICE_LR, weight_decay=0.0,
                                **{impl: True})
        adamw[impl] = cuda_ms(opt.step, 10)
        del opt
    for p in leaves:
        p.grad = None
    library["fused_adamw32"] = adamw["fused"]
    # K5/K6 per step: one call per leaf, leaf-shaped mu as input
    us = [torch.rand((-(-g.numel() // qz.BLOCK), qz.BLOCK), generator=gen,
                     device="cuda") for g in grads]
    qs = [qz.quantize_int8(g, u=u_i)[:2] for g, u_i in zip(grads, us)]
    graphs = {
        "quantize_int8": (
            lambda: [qz.quantize_int8(g, u=u_i) for g, u_i in zip(grads, us)],
            lambda: [qz.quantize_int8_plain(g, u_i)
                     for g, u_i in zip(grads, us)]),
        "dequantize_int8": (
            lambda: [qz.dequantize_int8(q, s, g.shape)
                     for (q, s), g in zip(qs, grads)],
            lambda: [qz.dequantize_int8_plain(q, s, g.shape)
                     for (q, s), g in zip(qs, grads)]),
    }
    replays = {}
    for name, (kernel, plain) in graphs.items():
        replays[name] = {"kernel": graph_ms(kernel, 5),
                         "plain": graph_ms(plain, 2)}
        torch.cuda.empty_cache()
    replays["dequantize_int8"]["library"] = graph_ms(
        lambda: [torch.mul(q, s) for q, s in qs], 5)
    log(json.dumps({"optim_graph_replays_ms_per_step": replays}))
    for name, r in replays.items():
        times[name] = (statistics.median(r["kernel"]),
                       statistics.median(r["plain"]))
    library["dequantize_int8"] = statistics.median(
        replays["dequantize_int8"]["library"])
    log(json.dumps({"optim_yardsticks_ms": {
        "torch_adamw_fused_step": adamw["fused"],
        "torch_adamw_foreach_step": adamw["foreach"],
        "rand_u_field": u_ms}}))
    return times, library, opt_bounds(meta)


def slice_config():
    """nano-350m at full width: the slice's model."""
    from dlrover_tpu_torch.models import PRESETS

    return PRESETS["nano-350m"]


def optimizer_phase(cfg):
    """Phase 4: returns (worst errors, times, library, bounds)."""
    leaves, grads, gen = opt_tree(cfg)
    worst: dict[str, float] = {}
    failures: list[str] = []
    check_quantize(grads[:-1] + [leaves[-1]], gen, worst, failures)
    for bits in (32, 8):
        for clip, wd in ((1.0, 0.01), (None, 0.0)):
            check_fused(bits, leaves, grads, gen, clip, wd, worst, failures)
            torch.cuda.empty_cache()
    if failures:
        raise SystemExit(f"optimizer kernel check failed: {failures}")
    times, library, bound = time_opt_kernels(leaves[:12], grads[:12], gen)
    return worst, times, library, bound


def synthetic_batch(vocab: int, seq_len: int, batch: int, step: int):
    """Tokens as examples/llama_pretrain.py makes them: sample ``idx`` is
    RandomState(idx).randint(0, vocab, seq_len + 1)."""
    rows = [np.random.RandomState(step * batch + i).randint(
        0, vocab, size=(seq_len + 1,), dtype=np.int32) for i in range(batch)]
    return {"tokens": np.stack(rows)}


def model_check(cfg):
    """Logits of a 2-layer cut of the model: the flash and the bshd
    kernels, and the ring over a seq=4 mesh (4 ranks in this process),
    vs plain attention, same weights, bf16 compute."""
    from dlrover_tpu_torch.models import llama_apply, llama_init
    from dlrover_tpu_torch.parallel import MeshConfig, build_mesh, set_mesh

    small = dataclasses.replace(cfg, n_layers=2)
    params = llama_init(small, seed=1, device="cuda")
    tokens = torch.as_tensor(
        synthetic_batch(cfg.vocab_size, 256, 2, 99)["tokens"][:, :-1],
        device="cuda")
    with torch.no_grad():
        ref = llama_apply(dataclasses.replace(small, attn_impl="reference"),
                          params, tokens)
        for impl in ("flash", "bshd", "seq4"):
            if impl == "seq4":
                set_mesh(build_mesh(MeshConfig(seq=SEQ)))
            out = llama_apply(dataclasses.replace(
                small, attn_impl="flash" if impl == "seq4" else impl),
                params, tokens)
            set_mesh(None)
            abs_err, rel = rel_err(out, ref)
            ok = bool(torch.isfinite(out).all()) and rel <= 5e-2
            log(f"  model logits {impl} vs reference (2 layers, B2 S256): "
                f"max_abs_err={abs_err:.3e} rel={rel:.3e} "
                f"{'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"model check failed ({impl})")


def state_bytes(optimizer, device_only=False) -> int:
    """Bytes of the tensors an optimizer keeps in its state (on the card
    only, with ``device_only``)."""
    def walk(value):
        if isinstance(value, torch.Tensor):
            if device_only and not value.is_cuda:
                return 0
            return value.numel() * value.element_size()
        if isinstance(value, dict):
            return sum(walk(v) for v in value.values())
        return 0

    return sum(walk(v) for v in optimizer.state.values())


def time_optimizer_steps(optimizer) -> list:
    """Record CUDA events around each ``optimizer.step()`` of the run
    (device time from the step's first launch to its last)."""
    events, inner = [], optimizer.step

    def step(*args, **kwargs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner(*args, **kwargs)
        end.record()
        events.append((start, end))
        return out

    optimizer.step = step
    return events


def release() -> None:
    """Free what an earlier run left, so that the next run's peak memory
    is its own."""
    gc.collect()
    torch.cuda.empty_cache()


def attention_launches(cfg, steps, seq=1, fwd_runs=1):
    """The launches of each attention kernel a run of ``steps`` steps
    must show: one per layer and step for the kernels of
    ``cfg.attn_impl``'s route, ``fwd_runs`` for its forward kernel (a
    remat recompute runs it again); under a seq axis of ``seq`` ranks,
    for each ring-block kernel n(n+1)/2 per layer and step (the blocks
    not wholly in a shard's future) and for K2 n (one per rank); none for
    the other routes' kernels."""
    route = FLASH_KERNELS if cfg.attn_impl == "flash" else HEADS_KERNELS
    per_step = {name: 1 for name in route}
    per_step[route[0]] = fwd_runs
    if seq > 1:
        per_step = {name: seq * (seq + 1) // 2 for name in RING_KERNELS}
        per_step["flash_bwd_preprocess"] = seq
    return {name: cfg.n_layers * steps * per_step.get(name, 0)
            for name in dict.fromkeys(FLASH_KERNELS + HEADS_KERNELS
                                      + RING_KERNELS)}


def train_run(cfg, label, factory, strategy, steps=5, B=8, S=2048,
              optimizer=None, fwd_runs=1, init=None, config="nano-350m",
              time_opt=None, axes=None):
    """``steps`` train steps on one repeated seeded batch; returns (res,
    state, batch, losses, launches, summary). Uniform random tokens hold
    nothing a model can learn across batches, so only a repeated batch
    makes a falling loss show that the step learns. ``optimizer`` names
    the optimizer in the summary (default: ``label``); ``init`` replaces
    ``llama_init`` (same signature); ``config`` names the model in the
    summary; ``time_opt`` replaces ``time_optimizer_steps``; ``axes``
    (logical axes by param name) places the params on a DeviceMesh."""
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import auto_accelerate

    res = auto_accelerate(
        llama_loss_fn(cfg),
        init or (lambda seed, device: llama_init(cfg, seed, device)),
        factory, strategy, device="cuda", seed=0, param_logical_axes=axes)
    state = res.state
    opt_events = (time_opt or time_optimizer_steps)(state.optimizer)
    batch = synthetic_batch(cfg.vocab_size, S, B, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    losses, step_s, enqueue_s = [], [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        state, metrics = res.train_step(state, batch, None)
        # the host's time to issue the step (the loss is read after): near
        # the step time, the host and not the device sets the pace
        enqueue_s.append(time.perf_counter() - t0)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = launch_counts()
    peak_bytes = torch.cuda.max_memory_allocated()
    # drop the wrapper: it refers back to the optimizer, and the cycle
    # would keep this run's state alive into the next run's peak
    del state.optimizer.step
    # CUDA event pairs, or legs measured on the host (time_offload_steps)
    opt_ms = [e["ms"] if isinstance(e, dict) else e[0].elapsed_time(e[1])
              for e in opt_events]
    log(f"  [{label}] losses: {losses}")
    log(f"  [{label}] step seconds: {step_s}")
    log(f"  [{label}] optimizer.step ms: {opt_ms}")
    log(f"  [{label}] launches over {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: loss did not fall: {losses}")
    for name, want in attention_launches(cfg, steps, strategy.mesh.seq,
                                         fwd_runs).items():
        if launches[name] != want:
            raise SystemExit(f"{label}: {name} launched {launches[name]} "
                             f"times, want {want}")
    steady = statistics.median(step_s[1:])
    flops = mfu.transformer_step_flops(cfg.param_count(), B * S,
                                       cfg.n_layers, cfg.dim, S)
    summary = {
        "config": config, "attn_impl": cfg.attn_impl,
        "ce_chunks": cfg.ce_chunks,
        "optimizer": optimizer or label, "remat": strategy.remat,
        "batch": B, "seq": S,
        "seq_transport": res.mesh.ring.describe() if res.mesh.ring else None,
        "steps": steps, "step_ms_median_2_to_5": steady * 1e3,
        "host_enqueue_ms_median_2_to_5":
            statistics.median(enqueue_s[1:]) * 1e3,
        "first_step_ms": step_s[0] * 1e3,
        "tokens_per_s": B * S / steady,
        "mfu": mfu.mfu(flops, steady), "mfu_peak_flops": mfu.peak_flops(),
        "peak_mem_gib": peak_bytes / 2**30,
        "opt_state_gb": state_bytes(state.optimizer) / 1e9,
        "opt_state_gb_on_device": state_bytes(state.optimizer,
                                              device_only=True) / 1e9,
        "opt_step_ms_median_2_to_5": statistics.median(opt_ms[1:]),
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    if opt_events and isinstance(opt_events[0], dict):
        summary["opt_step_legs"] = opt_events
    log(json.dumps({"slice": summary}))
    return res, state, batch, losses, launches, summary


def train_slice(steps: int = 5):
    """The adamw run (the earlier slice) with its profile and stream
    losses, the [bshd] run, variants (a), (b), (c), then the [seq4] run.
    Returns each kernel's launch count from the run whose path it is
    on."""
    from dlrover_tpu_torch.optimizers import adam8bit
    from dlrover_tpu_torch.ops.fused_optim import fused_adamw
    from dlrover_tpu_torch.parallel import MeshConfig, Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    cfg = slice_config()
    B, S = 8, 2048
    model_check(cfg)
    res, state, batch, adamw_losses, launches, none_summary = train_run(
        cfg, "adamw", build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none"), steps)
    ce1_rows = profile_step(res, state, batch)
    del res, state
    release()
    trainer_summary, trainer_losses = trainer_run(cfg, B, S)
    release()
    ckpt = ckpt_phase(cfg, trainer_summary, trainer_losses)
    release()
    agent_phase(cfg, ckpt["uninterrupted_losses"])
    release()
    failover_phase(cfg)
    release()
    remat_runs(cfg, steps, adamw_losses, none_summary)

    # the model-native layout: K9-K11 (and K2) on every layer
    bshd = dataclasses.replace(cfg, attn_impl="bshd")
    res, state, batch, losses, counts, _s = train_run(
        bshd, "bshd", build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none"), steps, optimizer="adamw")
    profile_step(res, state, batch, "bshd", top=8)
    del res, state
    release()
    launches.update({name: counts[name] for name in HEADS_KERNELS
                     if name not in FLASH_KERNELS})
    loss_gap("bshd", losses, adamw_losses)

    n_leaves = 12
    variants = (
        ("adam8bit", build_optimizer("adam8bit", SLICE_LR, weight_decay=0.0),
         Strategy(remat="none"),
         {"quantize_int8": n_leaves * steps,
          "dequantize_int8": n_leaves * steps}),
        ("adam8bit_fused", adam8bit(SLICE_LR, fused=True),
         Strategy(remat="none", fused_optim=True), {"fused_adamw8": steps}),
        ("fused_adamw32", fused_adamw(SLICE_LR, bits=32),
         Strategy(remat="none"), {"fused_adamw32": steps}),
    )
    for label, factory, strategy, want in variants:
        res, state, batch, losses, counts, _s = train_run(
            cfg, label, factory, strategy, steps)
        profile_step(res, state, batch, label, top=8)
        del res, state
        release()
        for name in ("quantize_int8", "dequantize_int8", "fused_adamw32",
                     "fused_adamw8"):
            if counts[name] != want.get(name, 0):
                raise SystemExit(f"{label}: {name} launched {counts[name]} "
                                 f"times, want {want.get(name, 0)}")
        launches.update(want)
        if label == "fused_adamw32":
            loss_gap(label, losses, adamw_losses)

    # the sequence sharded over 4 ring ranks in this process: K12-K14 and
    # K2 on every layer
    res, state, batch, losses, counts, _s = train_run(
        cfg, "seq4", build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none", mesh=MeshConfig(seq=SEQ)), steps,
        optimizer="adamw")
    ring = res.mesh.ring
    log(f"  [seq4] {res.strategy.describe(res.mesh)}")
    if ring.kind != "in-process" or ring.ranks != tuple(range(SEQ)):
        raise SystemExit(f"seq4: ran on {ring.describe()}, want the "
                         f"in-process transport with {SEQ} ranks")
    profile_step(res, state, batch, "seq4", top=12)
    del res, state
    release()
    launches.update({name: counts[name] for name in RING_KERNELS
                     if name != "flash_bwd_preprocess"})
    loss_gap("seq4", losses, adamw_losses)

    # the train step's other options: AGD through the example's chain,
    # the chunked CE, and the rest of the optimizers
    agd_phase(cfg, steps, trainer_summary, none_summary)
    release()
    ce_chunk_runs(cfg, steps, adamw_losses, none_summary, ce1_rows)
    optimizer_runs(cfg, none_summary)
    release()
    # the data, fsdp and tensor axes' path: DTensor state on a one-rank
    # NCCL DeviceMesh
    mesh1_phase(cfg, steps, adamw_losses, none_summary)
    return launches


# --------------------------------------------------------------- [mesh1]

MESH1_STEPS = 5
MESH1_MORE = 2


def mesh1_phase(cfg, steps, adamw_losses, none_summary):
    """[mesh1]: the sharded path (parallel/accelerate.py on a DeviceMesh)
    at one rank. A one-rank NCCL process group from a ``file://`` store
    (``init_distributed`` makes none at world 1); then nano-350m through
    ``auto_accelerate`` under ``MeshConfig(fsdp=-1)`` with the logical
    axes, so every param and moment is a DTensor on a one-rank
    DeviceMesh: the repeated batch of the adamw run, losses within
    LOSS_TOL (relative) of that unsharded run, K1-K4 16 a step; then the
    example's chain, the planner's mesh under the same group: a sharded save
    to shm at step MESH1_STEPS, its blocking ms, and a fresh Trainer's
    restore from shm, every leaf ``torch.equal`` (a DTensor's local
    shard, placements kept) and its losses over MESH1_MORE more steps
    within LOSS_TOL of the first Trainer's continuation. The group is
    destroyed at the end, also when a check fails. No fallback: without
    NCCL or a kernel the phase raises."""
    import tempfile

    import torch.distributed as dist

    from dlrover_tpu_torch.models import llama_logical_axes
    from dlrover_tpu_torch.parallel import MeshConfig, Strategy, set_mesh
    from dlrover_tpu_torch.trainer import build_optimizer

    if not dist.is_nccl_available():
        raise SystemExit("mesh1: this torch has no NCCL")
    if dist.is_initialized():
        raise SystemExit("mesh1: a process group already exists")
    store = tempfile.mkdtemp(prefix="mesh1")
    t_phase = time.perf_counter()
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    try:
        res, state, _b, losses, counts, summary = train_run(
            cfg, "mesh1", build_optimizer("adamw", SLICE_LR,
                                          weight_decay=0.0),
            Strategy(remat="none", mesh=MeshConfig(data=1, fsdp=-1)),
            steps, optimizer="adamw", axes=llama_logical_axes(cfg))
        log(f"  [mesh1] {res.strategy.describe(res.mesh)}")
        kinds = {type(p).__name__ for p in state.params.values()}
        moments = {type(m).__name__ for st in state.optimizer.state.values()
                   for k, m in st.items() if k != "step"}
        if kinds != {"DTensor"} or moments != {"DTensor"}:
            raise SystemExit(f"mesh1: params {kinds}, moments {moments}: "
                             "want DTensors")
        profile_step(res, state, _b, "mesh1", top=8)
        del res, state
        release()
        gap = loss_gap("mesh1", losses, adamw_losses, LOSS_TOL,
                       relative=True, to="the unsharded adamw run")
        job = os.environ["ELASTIC_JOB_NAME"]
        with flash_env("mesh1", job):
            chain = mesh1_chain(cfg, CKPT_DIR / "mesh1")
    finally:
        set_mesh(None)
        dist.destroy_process_group()
        import shutil

        shutil.rmtree(store, ignore_errors=True)
    report = {
        "card": CARD["line"], "config": "nano-350m", "batch": 8,
        "seq": 2048, "mesh": {"data": 1, "fsdp": 1},
        "step_ms_median_2_to_5": summary["step_ms_median_2_to_5"],
        "unsharded_step_ms_median_2_to_5": none_summary[
            "step_ms_median_2_to_5"],
        "host_enqueue_ms_median_2_to_5": summary[
            "host_enqueue_ms_median_2_to_5"],
        "unsharded_host_enqueue_ms_median_2_to_5": none_summary[
            "host_enqueue_ms_median_2_to_5"],
        "peak_mem_gib": summary["peak_mem_gib"],
        "unsharded_peak_mem_gib": none_summary["peak_mem_gib"],
        "opt_step_ms_median_2_to_5": summary["opt_step_ms_median_2_to_5"],
        "unsharded_opt_step_ms_median_2_to_5": none_summary[
            "opt_step_ms_median_2_to_5"],
        "launches_per_step": {name: counts[name] // steps
                              for name in FLASH_KERNELS},
        "loss_gap_to_unsharded_relative": gap, "losses": losses,
        **chain, "phase_s": time.perf_counter() - t_phase,
    }
    log(json.dumps({"mesh1": report}))


def mesh1_chain(cfg, run_dir) -> dict:
    """The example's chain on the one-rank mesh: MESH1_STEPS steps with a
    save at the last, a fresh Trainer that restores it from shm."""
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples.llama_pretrain import build_trainer

    def argv(steps):
        out = example_argv(run_dir, steps)
        for flag, value in (("--save-steps", str(MESH1_STEPS)),
                            ("--save-storage-every", "1000")):
            out[out.index(flag) + 1] = value
        return out

    def local_leaves(trainer):
        return {name: (leaf.to_local(), tuple(leaf.placements))
                if isinstance(leaf, DTensor) else (leaf, None)
                for name, leaf in ckpt_leaves(trainer).items()}

    def check(got, want):
        if {k: v[1] for k, v in got.items()} != {
                k: v[1] for k, v in want.items()}:
            raise SystemExit("mesh1: restored placements differ")
        return check_restored("mesh1: restore from shm",
                              {k: v[0] for k, v in got.items()},
                              {k: v[0] for k, v in want.items()})

    a = build_trainer(argv(MESH1_STEPS), device="cuda")
    if a._accel.mesh.device_mesh is None:
        raise SystemExit("mesh1: the example's Trainer has no DeviceMesh")
    losses = record_losses(a)
    saves = []
    inner_save = a.save_checkpoint

    def timed_save(persist=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = inner_save(persist=persist)
        saves.append({"step": a.global_step, "persist": persist,
                      "saved": ok,
                      "blocking_ms": (time.perf_counter() - t0) * 1e3,
                      **a._engine.last_save_stats})
        return ok

    a.save_checkpoint = timed_save
    reset_launches()
    a.train()
    launches = launch_counts()
    for name, want in attention_launches(cfg, MESH1_STEPS).items():
        if launches[name] != want:
            raise SystemExit(f"mesh1 chain: {name} launched "
                             f"{launches[name]} times, want {want}")
    if not saves or not all(r["saved"] for r in saves):
        raise SystemExit(f"mesh1: a save was skipped: {saves}")
    log(f"  [mesh1] saves: {saves}")
    want = local_leaves(a)
    a.close()
    a._engine = None

    AsyncCheckpointSaver.reset()
    b = build_trainer(argv(MESH1_STEPS + MESH1_MORE), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = b.maybe_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != MESH1_STEPS:
        raise SystemExit(f"mesh1: restored step {step}, want {MESH1_STEPS}")
    restored_bytes = check(local_leaves(b), want)
    stats = dict(b._engine.last_restore_stats)
    del want
    b.close()
    b._engine = None
    a.args.max_steps = b.args.max_steps
    a.train()
    ref = [x.item() for x in losses[MESH1_STEPS:]]
    del a
    b_losses = record_losses(b)
    b.train()
    got = [x.item() for x in b_losses]
    log(f"  [mesh1] restore from shm {restore_s:.3f} s ({stats}); after "
        f"it: losses {got}, uninterrupted {ref}")
    if len(got) != MESH1_MORE:
        raise SystemExit(f"mesh1: {len(got)} steps after the restore")
    gap = loss_gap("mesh1-restore", got, ref, LOSS_TOL, relative=True,
                   to="the uninterrupted run")
    del b
    release()
    return {"save_blocking_ms": [r["blocking_ms"] for r in saves],
            "saves": saves, "restore_from_shm_s": restore_s,
            "restore_stats": stats, "restored_bytes": restored_bytes,
            "loss_gap_after_restore": gap}


def loss_gap(label, losses, adamw_losses, limit=2e-2, relative=False,
             to="adamw"):
    """Fail when a run's losses leave the adamw run's (or another run's,
    named by ``to``) by more than ``limit`` at any step (relative to the
    other loss if ``relative``)."""
    gap = max(abs(a - b) / (abs(b) if relative else 1.0)
              for a, b in zip(losses, adamw_losses))
    log(f"  [{label}] largest loss gap to {to}"
        f"{' (relative)' if relative else ''}: {gap:.3e}")
    if gap > limit:
        raise SystemExit(f"{label}: losses {losses} leave adamw's "
                         f"{adamw_losses} by {gap}")
    return gap


def remat_runs(cfg, steps, none_losses, none_summary):
    """[remat-minimal], [remat-full], [remat-offload]: the adamw run under
    each Strategy.remat with the model's default per-layer "dots_attn"
    policy, on the same fixed batch. Losses within LOSS_TOL of the
    remat "none" run's (the adamw run), K1 REMAT_FWD_RUNS[mode] times per
    layer and step, and "full"'s peak memory below "none"'s."""
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    report = {"none": {
        "step_ms_median_2_to_5": none_summary["step_ms_median_2_to_5"],
        "host_enqueue_ms_median_2_to_5":
            none_summary["host_enqueue_ms_median_2_to_5"],
        "peak_mem_gib": none_summary["peak_mem_gib"],
        "flash_fwd_per_step": cfg.n_layers * REMAT_FWD_RUNS["none"]}}
    for mode in ("minimal", "full", "offload"):
        label = f"remat-{mode}"
        res, state, _b, losses, counts, summary = train_run(
            cfg, label, build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
            Strategy(remat=mode), steps, optimizer="adamw",
            fwd_runs=REMAT_FWD_RUNS[mode])
        del res, state
        release()
        gap = loss_gap(label, losses, none_losses, LOSS_TOL,
                       to="remat none")
        report[mode] = {
            "step_ms_median_2_to_5": summary["step_ms_median_2_to_5"],
            "host_enqueue_ms_median_2_to_5":
                summary["host_enqueue_ms_median_2_to_5"],
            "peak_mem_gib": summary["peak_mem_gib"],
            "flash_fwd_per_step": counts["flash_fwd"] // steps,
            "loss_gap": gap}
    log(json.dumps({"remat": report}))
    if not report["full"]["peak_mem_gib"] < report["none"]["peak_mem_gib"]:
        raise SystemExit(f"remat-full: peak {report['full']['peak_mem_gib']} "
                         f"GiB not below none's "
                         f"{report['none']['peak_mem_gib']}")


def trainer_run(cfg, B, S, steps=TRAINER_STEPS):
    """[trainer]: the example's chain on the card. auto_strategy for one
    card of this card's memory (it must plan remat "none"), the elastic
    loader over the example's token stream, Trainer(...).train() for
    ``steps`` steps; then a bare auto_accelerate loop over the same
    batches from the same seed. Fails unless the losses agree within
    LOSS_TOL (relative), K1-K4 ran 16 times a step and the
    runtime-metrics file reads the last step."""
    from dlrover_tpu_torch.examples.llama_pretrain import (
        synthetic_token_stream,
    )
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
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

    hbm_gb = torch.cuda.get_device_properties(0).total_memory / 2**30
    strategy = auto_strategy(1, param_count=cfg.param_count(), seq_len=S,
                             hbm_gb=hbm_gb, devices_per_host=1)
    log(f"  [trainer] auto_strategy(1, hbm_gb={hbm_gb:.2f}): "
        f"{strategy.describe()}")
    if strategy.remat != "none":
        raise SystemExit(f"trainer: auto_strategy planned remat "
                         f"{strategy.remat!r} for nano-350m, want 'none'")
    dataset = synthetic_token_stream(cfg.vocab_size, S, n_samples=1 << 16)
    loader = ElasticDataLoader(
        dataset, batch_size=B,
        sampler=ElasticSampler(len(dataset), num_replicas=1, rank=0,
                               shuffle=True),
        collate_fn=lambda rows: {"tokens": np.stack(rows)}, config_file="")
    metrics_file = OUT / "runtime_metrics.json"
    OUT.mkdir(exist_ok=True)
    os.environ["DLROVER_RUNTIME_METRICS_PATH"] = str(metrics_file)
    trainer = Trainer(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        None, TrainingArgs(
            output_dir=str(OUT / "trainer"), max_steps=steps,
            num_epochs=1_000_000, learning_rate=SLICE_LR, optimizer="adamw",
            strategy=strategy, flash_checkpoint=False, log_steps=10),
        train_data=loader, device="cuda")
    # each step's batch, loss (kept on the device: no host sync) and the
    # host clock at entry to and exit from the train step
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
    reset_launches()
    trainer.train()
    torch.cuda.synchronize()
    t_end = time.perf_counter()
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    trainer_losses = [x.item() for x in losses]
    # the host's time per step in train() outside the train step: from
    # one step's return to the next one's call (loader, span, rng,
    # telemetry, gauges, runtime-metrics file)
    gaps_ms = [(spans[i][0] - spans[i - 1][1]) * 1e3
               for i in range(1, len(spans))]
    trainer_ms = (t_end - spans[1][0]) * 1e3 / (steps - 1)
    step_file = json.loads(metrics_file.read_text())["step"]
    # of the host time between steps, the loader's: the example's
    # stream draws each sample from its own RandomState
    draws = []
    for _ in range(5):
        t0 = time.perf_counter()
        loader.collate_fn([dataset[i] for i in range(B)])
        draws.append((time.perf_counter() - t0) * 1e3)
    del trainer, inner
    release()

    res = auto_accelerate(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        build_optimizer("adamw", SLICE_LR, weight_decay=0.0), strategy,
        device="cuda", seed=0)
    state, bare, starts = res.state, [], []
    torch.cuda.synchronize()
    for batch in batches:
        starts.append(time.perf_counter())
        state, metrics = res.train_step(state, batch, None)
        bare.append(metrics["loss"])
    torch.cuda.synchronize()
    bare_ms = (time.perf_counter() - starts[1]) * 1e3 / (steps - 1)
    bare_losses = [x.item() for x in bare]
    del res, state
    log(f"  [trainer] losses: {trainer_losses}")
    log(f"  [trainer] bare loop losses on the same batches: {bare_losses}")
    log(f"  [trainer] launches over {steps} steps: {launches}")
    summary = {
        "config": "nano-350m", "batch": B, "seq": S, "steps": steps,
        "strategy": strategy.describe(),
        "trainer_ms_per_step_2_to_6": trainer_ms,
        "bare_loop_ms_per_step_2_to_6": bare_ms,
        "trainer_host_ms_between_steps": gaps_ms,
        "trainer_host_ms_between_steps_median": statistics.median(gaps_ms),
        "loader_batch_ms_median": statistics.median(draws),
        "peak_mem_gib": peak_gib, "runtime_metrics_step": step_file,
        "loss_first": trainer_losses[0], "loss_last": trainer_losses[-1]}
    log(json.dumps({"trainer": summary}))
    for name, want in attention_launches(cfg, steps).items():
        if launches[name] != want:
            raise SystemExit(f"trainer: {name} launched {launches[name]} "
                             f"times, want {want}")
    if step_file != steps:
        raise SystemExit(f"trainer: runtime metrics read step {step_file}, "
                         f"want {steps}")
    if not all(math.isfinite(x) for x in trainer_losses):
        raise SystemExit(f"trainer: non-finite loss: {trainer_losses}")
    loss_gap("trainer", trainer_losses, bare_losses, LOSS_TOL, relative=True,
             to="the bare loop")
    return summary, trainer_losses


# ----------------------------------------------- [ce-chunks], [optimizers]

# [ce-chunks]: the chunk counts run at nano-350m beside the adamw run
# (ce_chunks=1), and the llama2-1b arm of bench.py's headline (B4, 4
# chunks); each step's loss within CE_REL_TOL of the ce_chunks=1 run's
CE_CHUNKS = (4, 8)
CE_REL_TOL = 2e-3
HEADLINE = {"preset": "llama2-1b", "batch": 4, "ce_chunks": 4}
# [optimizers]: steps of each run (WSAM and OffloadAdam cost more than a
# step by design) and muP's width multiplier
OPT_STEPS = 4
MUP_WIDTH_MULT = 4.0


def ce_chunk_runs(cfg, steps, adamw_losses, none_summary, ce1_rows):
    """[ce-chunks]: adamw under remat "none" at ce_chunks 4 and 8 on the
    adamw run's weights and batch (that run is the ce_chunks=1 one), each
    loss within CE_REL_TOL (relative) of it, K1-K4 16 a step, the
    profiler's CE rows at 4 chunks beside 1; then llama2-1b at B4 S2048
    with 4 chunks (bench.py's headline arm), which must fit the card."""
    from dlrover_tpu_torch.models import PRESETS
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    report = {"ce_chunks=1": {
        k: none_summary[k] for k in ("step_ms_median_2_to_5", "tokens_per_s",
                                     "mfu", "peak_mem_gib")}}
    report["ce_chunks=1"]["ce_rows"] = ce1_rows
    for n in CE_CHUNKS:
        label = f"ce{n}"
        res, state, batch, losses, _c, summary = train_run(
            dataclasses.replace(cfg, ce_chunks=n), label,
            build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
            Strategy(remat="none"), steps, optimizer="adamw")
        rows = profile_step(res, state, batch, label, top=0) if n == 4 \
            else None
        del res, state
        release()
        report[f"ce_chunks={n}"] = {
            k: summary[k] for k in ("step_ms_median_2_to_5", "tokens_per_s",
                                    "mfu", "peak_mem_gib")}
        report[f"ce_chunks={n}"]["loss_gap"] = loss_gap(
            label, losses, adamw_losses, CE_REL_TOL, relative=True,
            to="ce_chunks=1")
        if rows is not None:
            report[f"ce_chunks={n}"]["ce_rows"] = rows
    big = dataclasses.replace(PRESETS[HEADLINE["preset"]],
                              ce_chunks=HEADLINE["ce_chunks"])
    _r, _s, _b, losses, _c, summary = train_run(
        big, "llama2-1b-ce4", build_optimizer("adamw", SLICE_LR,
                                              weight_decay=0.0),
        Strategy(remat="none"), steps, B=HEADLINE["batch"],
        optimizer="adamw", config=HEADLINE["preset"])
    del _r, _s
    release()
    report["llama2-1b B4 ce4"] = {
        k: summary[k] for k in ("step_ms_median_2_to_5", "tokens_per_s",
                                "mfu", "peak_mem_gib", "opt_state_gb")}
    report["llama2-1b B4 ce4"]["card_gib"] = (
        torch.cuda.get_device_properties(0).total_memory / 2**30)
    log(json.dumps({"ce_chunks": report, "card": CARD["line"]}))


def time_offload_steps(optimizer) -> list:
    """OffloadAdam's legs per step: the device drained first, then the
    step's own wait for the grads' copies to the host, its host math, and
    the tail from its return to the device finishing the copies up and
    the updates (``h2d_tail_ms``); the step's whole time on the host's
    clock as ``ms``."""
    legs, inner = [], optimizer.step

    def step(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = inner(*args, **kwargs)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        legs.append({"ms": (t2 - t0) * 1e3,
                     "d2h_wait_ms": optimizer.last_legs["d2h_wait_s"] * 1e3,
                     "host_math_ms": optimizer.last_legs["host_math_s"] * 1e3,
                     "h2d_tail_ms": (t2 - t1) * 1e3})
        return out

    optimizer.step = step
    return legs


def wsam_run(cfg, steps, B=8, S=2048):
    """The decoupled WSAM step over torch AdamW (remat "none", bf16 over
    f32 masters, as the slice's step): two forward and backward passes a
    step, so K1-K4 32 times a step. Returns (losses, step seconds)."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.optimizers import make_wsam_step_fn
    from dlrover_tpu_torch.parallel import remat as remat_lib

    params = {n: p.requires_grad_() for n, p in
              llama_init(cfg, 0, "cuda").items()}
    base = torch.optim.AdamW(params.values(), lr=SLICE_LR, weight_decay=0.0)
    inner = llama_loss_fn(cfg)

    def loss_fn(p, batch, rng):
        with remat_lib.no_remat():
            return inner({n: t.to(torch.bfloat16) for n, t in p.items()},
                         batch, rng)

    step = make_wsam_step_fn(loss_fn, base, SLICE_LR)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             synthetic_batch(cfg.vocab_size, S, B, 0).items()}
    torch.cuda.synchronize()
    reset_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(step(params, batch, None).item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = launch_counts()
    for name, want in attention_launches(cfg, 2 * steps).items():
        if launches[name] != want:
            raise SystemExit(f"wsam: {name} launched {launches[name]} "
                             f"times, want {want} (two passes a step)")
    del params, base, step
    return losses, step_s


def optimizer_runs(cfg, none_summary):
    """[optimizers]: OPT_STEPS steps each of mup_adam (after
    mup_rescale_init at MUP_WIDTH_MULT), group_adam, OffloadAdam (with
    its legs and the device memory it saves against adamw) and the
    decoupled WSAM step over adamw; losses finite and falling, K1-K4 16
    a step a pass."""
    from dlrover_tpu_torch.models import llama_init, llama_logical_axes
    from dlrover_tpu_torch.optimizers import (
        OffloadAdam,
        group_adam,
        mup_adam,
        mup_rescale_init,
    )
    from dlrover_tpu_torch.parallel import Strategy

    axes = llama_logical_axes(cfg)
    report = {"adamw": {k: none_summary[k] for k in (
        "step_ms_median_2_to_5", "opt_step_ms_median_2_to_5",
        "peak_mem_gib", "opt_state_gb")}}
    runs = (
        ("mup_adam", mup_adam(SLICE_LR, axes, MUP_WIDTH_MULT),
         lambda seed, device: mup_rescale_init(
             llama_init(cfg, seed, device), axes, MUP_WIDTH_MULT), None),
        ("group_adam", group_adam(SLICE_LR), None, None),
        ("offload_adam", lambda params: OffloadAdam(params, lr=SLICE_LR),
         None, time_offload_steps),
    )
    for label, factory, init, time_opt in runs:
        res, state, _b, _l, _c, summary = train_run(
            cfg, label, factory, Strategy(remat="none"), OPT_STEPS,
            init=init, time_opt=time_opt)
        del res, state
        release()
        report[label] = {k: summary[k] for k in (
            "step_ms_median_2_to_5", "opt_step_ms_median_2_to_5",
            "peak_mem_gib", "opt_state_gb", "opt_state_gb_on_device")}
        if label == "offload_adam":
            report[label]["legs"] = summary["opt_step_legs"]
            report[label]["device_mem_saved_gib_vs_adamw"] = (
                none_summary["peak_mem_gib"] - summary["peak_mem_gib"])
            if summary["opt_state_gb_on_device"] != 0:
                raise SystemExit("offload_adam: optimizer state on the card")
    losses, step_s = wsam_run(cfg, OPT_STEPS)
    log(f"  [wsam] losses: {losses}")
    log(f"  [wsam] step seconds: {step_s}")
    if not all(math.isfinite(x) for x in losses) or not losses[-1] < losses[0]:
        raise SystemExit(f"wsam: losses {losses} not finite and falling")
    report["wsam_adamw"] = {
        "step_ms_median_from_2": statistics.median(step_s[1:]) * 1e3,
        "step_ratio_to_adamw": statistics.median(step_s[1:]) * 1e3
        / none_summary["step_ms_median_2_to_5"]}
    release()
    log(json.dumps({"optimizers": report, "card": CARD["line"]}))


# [agd]: the example's chain with --optimizer agd for AGD_STEPS steps, a
# cadence save at the last one (to shm only; the final save persists),
# then a restore into a fresh Trainer and AGD_MORE more steps on each side
AGD_STEPS = 5
AGD_MORE = 2


def agd_argv(out, steps: int) -> list:
    """The example's arguments for [agd]: ``example_argv`` with
    ``--optimizer agd``, a save every AGD_STEPS steps, none persisted but
    the final one."""
    argv = example_argv(out, steps)
    for flag, value in (("--optimizer", "agd"),
                        ("--save-steps", str(AGD_STEPS)),
                        ("--save-storage-every", "1000")):
        argv[argv.index(flag) + 1] = value
    return argv


def agd_phase(cfg, steps, trainer_summary, none_summary):
    """[agd]: first ``build_optimizer("agd")`` in the slice's run (the
    repeated batch: losses finite and falling, K1-K4 16 a step, its
    ``optimizer.step`` device ms and state bytes against the adamw
    run's); then AGD through the example's chain (``build_trainer`` with
    ``--optimizer agd``): ms per step against [trainer]'s adamw, K1-K4 16
    a step, losses finite (the example's stream gives fresh uniform
    tokens every step: nothing to learn beyond their frequencies); a
    fresh Trainer restores the step from shm, every leaf (AGD's moments
    and count among them) ``torch.equal`` to the saved one, and its
    losses over AGD_MORE more steps within LOSS_TOL (relative) of the
    first Trainer's own continuation. Segments and directories removed
    at the end."""
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    _r, _s, _b, _l, _c, summary = train_run(
        cfg, "agd", build_optimizer("agd", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none"), steps)
    del _r, _s
    release()
    job = os.environ["ELASTIC_JOB_NAME"]
    t_phase = time.perf_counter()
    with flash_env("agd", job):
        report = agd_runs(cfg, CKPT_DIR / "agd", trainer_summary,
                          none_summary)
    report["phase_s"] = time.perf_counter() - t_phase
    report["slice_run"] = {k: summary[k] for k in (
        "step_ms_median_2_to_5", "opt_step_ms_median_2_to_5",
        "opt_state_gb", "peak_mem_gib", "loss_first", "loss_last")}
    log(json.dumps({"agd": report}))


def agd_runs(cfg, run_dir, trainer_summary, none_summary) -> dict:
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.examples.llama_pretrain import build_trainer
    from dlrover_tpu_torch.optimizers import AGD

    steps = AGD_STEPS
    a = build_trainer(agd_argv(run_dir, steps), device="cuda")
    if not isinstance(a.state.optimizer, AGD):
        raise SystemExit(f"agd: the Trainer built "
                         f"{type(a.state.optimizer).__name__}")
    opt_events = time_optimizer_steps(a.state.optimizer)
    losses = record_losses(a)
    starts, saves = [], []
    inner_step, inner_save = a._accel.train_step, a.save_checkpoint

    def timed_step(state, batch, rng):
        starts.append(time.perf_counter())
        return inner_step(state, batch, rng)

    def timed_save(persist=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = inner_save(persist=persist)
        saves.append({"step": a.global_step, "persist": persist,
                      "saved": ok, "start": t0,
                      "blocking_ms": (time.perf_counter() - t0) * 1e3})
        return ok

    a._accel.train_step, a.save_checkpoint = timed_step, timed_save
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches()
    a.train()
    launches = launch_counts()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    vals = [x.item() for x in losses]
    # steps 2 to AGD_STEPS, to the cadence save's start (after a sync)
    ms_per_step = (saves[0]["start"] - starts[1]) * 1e3 / (steps - 1)
    del a.state.optimizer.step
    opt_ms = [s.elapsed_time(e) for s, e in opt_events]
    opt_gb = state_bytes(a.state.optimizer) / 1e9
    log(f"  [agd] losses: {vals}")
    log(f"  [agd] optimizer.step ms: {opt_ms}")
    log(f"  [agd] launches over {steps} steps: {launches}")
    for name, want in attention_launches(cfg, steps).items():
        if launches[name] != want:
            raise SystemExit(f"agd: {name} launched {launches[name]} "
                             f"times, want {want}")
    if not all(math.isfinite(x) for x in vals):
        raise SystemExit(f"agd: non-finite loss: {vals}")
    if not all(r["saved"] for r in saves):
        raise SystemExit(f"agd: a save was skipped: {saves}")
    want = ckpt_leaves(a)
    a.close()
    a._engine = None

    AsyncCheckpointSaver.reset()
    b = build_trainer(agd_argv(run_dir, steps + AGD_MORE), device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step = b.maybe_resume()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    if step != steps:
        raise SystemExit(f"agd: restored step {step}, want {steps}")
    restored_bytes = check_restored("agd: restore from shm", ckpt_leaves(b),
                                    want)
    if b.state.optimizer.state["count"] != steps:
        raise SystemExit(f"agd: restored count "
                         f"{b.state.optimizer.state['count']}")
    del want
    b.close()
    b._engine = None
    a.args.max_steps = b.args.max_steps
    a.train()
    ref = [x.item() for x in losses[steps:]]
    del a
    b_losses = record_losses(b)
    b.train()
    got = [x.item() for x in b_losses]
    log(f"  [agd] after the restore: losses {got}, uninterrupted {ref}")
    if len(got) != AGD_MORE:
        raise SystemExit(f"agd: {len(got)} steps after the restore, want "
                         f"{AGD_MORE}")
    gap = loss_gap("agd-restore", got, ref, LOSS_TOL, relative=True,
                   to="the uninterrupted run")
    del b
    release()
    for rec in saves:
        rec.pop("start")
    return {
        "card": CARD["line"], "config": "nano-350m", "batch": 8,
        "seq": 2048, "steps": steps,
        "trainer_ms_per_step_2_to_5": ms_per_step,
        "adamw_trainer_ms_per_step_2_to_6": trainer_summary[
            "trainer_ms_per_step_2_to_6"],
        "opt_step_ms": opt_ms,
        "opt_step_ms_median_2_to_5": statistics.median(opt_ms[1:]),
        "adamw_opt_step_ms_median_2_to_5": none_summary[
            "opt_step_ms_median_2_to_5"],
        "opt_state_gb": opt_gb,
        "adamw_opt_state_gb": none_summary["opt_state_gb"],
        "peak_mem_gib": peak_gib, "saves": saves,
        "restore_from_shm_s": restore_s, "restored_bytes": restored_bytes,
        "loss_gap_after_restore": gap, "losses": vals + ref,
    }


# --------------------------------------------------------------- [ckpt]

# the [ckpt] runs: saves every CKPT_SAVE_STEPS steps, every
# CKPT_STORAGE_EVERY-th one persisted; the in-process run takes
# CKPT_STEPS steps and each resumed Trainer CKPT_MORE more; the killed
# child dies right after its step-CKPT_KILL_STEP save
CKPT_STEPS = 6
CKPT_MORE = 2
CKPT_SAVE_STEPS = 2
CKPT_STORAGE_EVERY = 2
CKPT_KILL_STEP = 4
CKPT_DIR = ROOT / "_ckpt_smoke"
CARD = {"line": ""}  # nvidia-smi's name and power limit, for the records


def example_argv(out, steps: int) -> list:
    """The example's arguments for the slice's run: nano-350m, B=8,
    S=2048, adamw, saves every CKPT_SAVE_STEPS steps."""
    return ["--preset", "nano-350m", "--steps", str(steps),
            "--batch-size", "8", "--seq-len", "2048", "--lr", str(SLICE_LR),
            "--optimizer", "adamw", "--save-steps", str(CKPT_SAVE_STEPS),
            "--save-storage-every", str(CKPT_STORAGE_EVERY),
            "--output-dir", str(out)]


def record_losses(trainer) -> list:
    """Keep each step's loss (on the device: no host sync)."""
    inner, losses = trainer._accel.train_step, []

    def recording(state, batch, rng):
        state, metrics = inner(state, batch, rng)
        losses.append(metrics["loss"])
        return state, metrics

    trainer._accel.train_step = recording
    return losses


def ckpt_leaves(trainer) -> dict:
    """The Trainer's checkpoint tree, flat by leaf name."""
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        _tree_flatten_with_names,
    )

    names, leaves, _ = _tree_flatten_with_names(trainer._ckpt_tree())
    return dict(zip(names, leaves))


def check_restored(label: str, got: dict, want: dict) -> int:
    """Every leaf of the restored tree equal to the saved one, on the same
    device with the same dtype; returns the tree's bytes."""
    if list(got) != list(want):
        raise SystemExit(f"ckpt {label}: restored leaves {list(got)[:4]}... "
                         f"differ from the saved {list(want)[:4]}...")
    nbytes = 0
    for name, w in want.items():
        g = got[name]
        if isinstance(w, torch.Tensor):
            same = (g.device == w.device and g.dtype == w.dtype
                    and torch.equal(g, w))
            nbytes += w.numel() * w.element_size()
        else:
            same = np.array_equal(np.asarray(g), np.asarray(w))
            nbytes += np.asarray(w).nbytes
        if not same:
            raise SystemExit(f"ckpt {label}: restored leaf {name} differs "
                             "from the saved one")
    log(f"  [ckpt] {label}: {len(want)} leaves ({nbytes / 1e9:.3f} GB) "
        "torch.equal to the state saved at its step")
    return nbytes


def pinned_d2h_ms(tensors, chunk=1 << 30) -> float:
    """The yardstick: the same bytes copied card -> pinned host memory back
    to back into one pinned buffer (each tensor in pieces of at most
    ``chunk`` bytes), one synchronisation at the end."""
    pinned = torch.empty(chunk, dtype=torch.uint8, pin_memory=True)
    views = [t.reshape(-1).view(torch.uint8) for t in tensors]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for v in views:
        for pos in range(0, v.numel(), chunk):
            n = min(chunk, v.numel() - pos)
            pinned[:n].copy_(v[pos:pos + n], non_blocking=True)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    del pinned
    return ms


def ckpt_child(spec: dict) -> int:
    """A child of the [ckpt] phase: the example's main() for
    ``spec["steps"]`` steps into ``spec["out"]``, writing the step it
    resumed from, its losses and the kernels' launches to
    ``spec["report"]``. Under a DLROVER_CHAOS kill rule it dies inside
    train() instead."""
    from dlrover_tpu_torch.examples import llama_pretrain
    from dlrover_tpu_torch.ops import _build
    from dlrover_tpu_torch.trainer import Trainer

    _build.build()
    seen = {"saves": []}
    inner, inner_save = Trainer.maybe_resume, Trainer.save_checkpoint

    def maybe_resume(self):
        seen["resumed_from"] = inner(self)
        seen["losses"] = record_losses(self)
        return seen["resumed_from"]

    def save_checkpoint(self, persist=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = inner_save(self, persist=persist)
        if ok:
            seen["saves"].append({
                "step": self.global_step,
                "blocking_ms": (time.perf_counter() - t0) * 1e3,
                **self._engine.last_save_stats})
        return ok

    Trainer.maybe_resume = maybe_resume
    Trainer.save_checkpoint = save_checkpoint
    reset_launches()
    trainer = llama_pretrain.main(example_argv(spec["out"], spec["steps"]),
                                  device="cuda")
    Path(spec["report"]).write_text(json.dumps({
        "resumed_from": seen["resumed_from"],
        "global_step": trainer.global_step,
        "losses": [x.item() for x in seen["losses"]],
        "saves": seen["saves"], "launches": launch_counts()}))
    return 0


def run_child(spec: dict, env: dict, label: str) -> int:
    """Run one child to its end (or its time limit, which kills it)."""
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, str(Path(__file__).resolve()), "--ckpt-child",
         json.dumps(spec)], env=env, cwd=str(ROOT), capture_output=True,
        text=True, timeout=300)
    log(f"  [ckpt] {label}: exit {proc.returncode} after "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (proc.stdout + proc.stderr).splitlines():
        if any(k in line for k in ("chaos[kill]", "resumed from", "saved step",
                                   "persisted step", "Error", "error")):
            log(f"    {line.strip()}")
    return proc.returncode


def unlink_segments(job: str) -> list:
    """Unlink the checkpoint and timer segments of ``job``; returns the
    names that existed."""
    from dlrover_tpu_torch.common.ipc import PersistentSharedMemory

    gone = []
    for name in (f"dlrtpu_torch_ckpt_{job}_0", f"dlrtpu_torch_timer_{job}"):
        try:
            seg = PersistentSharedMemory(name=name)
        except FileNotFoundError:
            continue
        seg.close()
        seg.unlink()
        gone.append(name)
    return gone


def ckpt_phase(cfg, trainer_summary, trainer_losses):
    """[ckpt]: Flash Checkpoint on the card, through the example's chain
    with flash_checkpoint=True.

    First an async save of a 0.57 GB tree on the card followed at once by
    in-place updates must store the pre-update values. A: CKPT_STEPS
    steps with saves, timed per save (the materialize and
    fill legs and the bytes from the engine) and per persist; its losses
    must equal [trainer]'s. B, a second Trainer over a fresh engine,
    restores from shm; C, another, from storage with shm unlinked; each
    restored leaf must be torch.equal to A's (the state of the step
    saved), and after CKPT_MORE more steps each, B's and C's losses must
    agree with A's own continuation within LOSS_TOL (relative). Then a
    child process is killed by DLROVER_CHAOS right after its
    step-CKPT_KILL_STEP save, and a second child resumes from the shm
    segment it left and trains to CKPT_STEPS: its losses must agree with
    A's. The segments and the step directories are removed at the end,
    also when a check fails."""
    from dlrover_tpu_torch import native

    if not native.native_available():
        raise SystemExit("ckpt: the native copy library did not build or "
                         "load; the save would fall back to numpy copies")
    # main() names the job: the segments (and the step timer's ring,
    # which [trainer] created) carry its name
    job = os.environ["ELASTIC_JOB_NAME"]
    t_phase = time.perf_counter()
    with flash_env("ckpt", job):
        report = ckpt_runs(cfg, CKPT_DIR / "run", job, trainer_summary,
                           trainer_losses)
    report["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"ckpt": report}))
    return report


@contextlib.contextmanager
def flash_env(label: str, job: str):
    """A Flash Checkpoint phase's surroundings: its own socket dir, no
    paral-config file, the step directories under CKPT_DIR; at the end,
    also when a check fails, the saver reset, the job's segments
    unlinked, the directories removed and the env put back."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.common.ipc import SOCKET_DIR_ENV

    sockets = tempfile.mkdtemp(prefix="dlck")
    saved_env = {k: os.environ.get(k) for k in
                 (SOCKET_DIR_ENV, "DLROVER_PARAL_CONFIG_PATH")}
    os.environ.update({SOCKET_DIR_ENV: sockets,
                       "DLROVER_PARAL_CONFIG_PATH": ""})
    shutil.rmtree(CKPT_DIR, ignore_errors=True)
    try:
        yield
    finally:
        AsyncCheckpointSaver.reset()
        gone = unlink_segments(job)
        shutil.rmtree(CKPT_DIR, ignore_errors=True)
        shutil.rmtree(sockets, ignore_errors=True)
        for key, value in saved_env.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
        log(f"  [{label}] cleanup: unlinked {gone}, removed "
            f"{CKPT_DIR.name}/")
    if CKPT_DIR.exists() or unlink_segments(job):
        raise SystemExit(f"{label}: the cleanup left segments or step "
                         "directories behind")


def ckpt_async_check(run_dir):
    """An async save followed at once by in-place updates on the compute
    stream stores the values it was called with: the copies run on a
    side stream that the compute stream waits on. Returns the save's
    dispatch ms (what the loop pays) and its total ms."""
    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        ShardedCheckpointEngine,
    )

    engine = ShardedCheckpointEngine(str(run_dir / "async"))
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    state = {"w": torch.randn(1 << 27, device="cuda", generator=gen),
             "h": torch.randn(4096, 4096, device="cuda",
                              generator=gen).bfloat16(),
             "step": torch.tensor(3.0)}
    want = {k: v.clone() for k, v in state.items()}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if not engine.save_to_memory_async(1, state):
        raise SystemExit("ckpt: the async save was skipped")
    dispatch_ms = (time.perf_counter() - t0) * 1e3
    state["w"].add_(1.0)
    state["h"].mul_(2)
    state["step"].add_(1)
    if not engine.wait_for_shm_save(timeout=120):
        raise SystemExit("ckpt: the async save did not finish")
    total_ms = (time.perf_counter() - t0) * 1e3
    restored, step = engine.load(
        target={k: torch.zeros_like(v) for k, v in want.items()})
    bad = [k for k in want if not torch.equal(restored[k], want[k])]
    if step != 1 or bad:
        raise SystemExit(f"ckpt: the async save stored {bad} after the "
                         "in-place update")
    engine.close()
    AsyncCheckpointSaver.reset()
    log(f"  [ckpt] async save of {engine.last_save_stats['bytes'] / 1e9:.3f}"
        f" GB then an in-place update at once: the saved values are the "
        f"pre-update ones (dispatch {dispatch_ms:.1f} ms, done after "
        f"{total_ms:.1f} ms) ({CARD['line']})")
    return {"dispatch_ms": dispatch_ms, "total_ms": total_ms,
            "bytes": engine.last_save_stats["bytes"]}


def ckpt_runs(cfg, run_dir, job, trainer_summary, trainer_losses):
    from dlrover_tpu_torch.agent.ckpt_saver import (
        AsyncCheckpointSaver,
        shm_name,
    )
    from dlrover_tpu_torch.common.ipc import PersistentSharedMemory
    from dlrover_tpu_torch.examples.llama_pretrain import build_trainer

    card = CARD["line"]
    steps = CKPT_STEPS
    async_save = ckpt_async_check(run_dir)
    # A: the run with saves
    a = build_trainer(example_argv(run_dir, steps), device="cuda")
    a_losses = record_losses(a)
    saves, persists, spans = [], [], []
    inner_save, inner_step = a.save_checkpoint, a._accel.train_step

    def timed_save(persist=False):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = inner_save(persist=persist)
        t1 = time.perf_counter()
        rec = {"step": a.global_step, "persist": persist, "saved": ok,
               "blocking_ms": (t1 - t0) * 1e3, "end": t1}
        if ok:
            rec.update(a._engine.last_save_stats)
        saves.append(rec)
        return ok

    def timed_step(state, batch, rng):
        t0 = time.perf_counter()
        out = inner_step(state, batch, rng)
        spans.append((t0, time.perf_counter()))
        return out

    a.save_checkpoint = timed_save
    a._accel.train_step = timed_step
    saver = AsyncCheckpointSaver.get_ckpt_saver()
    inner_persist = saver.save_step_checkpoint

    def timed_persist(event, local_rank):
        t0 = time.perf_counter()
        inner_persist(event, local_rank)
        persists.append({"step": event.step,
                         "seconds": time.perf_counter() - t0})

    saver.save_step_checkpoint = timed_persist
    torch.cuda.synchronize()
    reset_launches()
    t_train = time.perf_counter()
    a.train()
    torch.cuda.synchronize()
    a_train_s = time.perf_counter() - t_train
    launches = launch_counts()
    a_vals = [x.item() for x in a_losses]
    log(f"  [ckpt] A losses: {a_vals}")
    log(f"  [ckpt] A launches over {steps} steps: {launches}")
    for name, want in attention_launches(cfg, steps).items():
        if launches[name] != want:
            raise SystemExit(f"ckpt: {name} launched {launches[name]} "
                             f"times, want {want}")
    loss_gap("ckpt-A", a_vals, trainer_losses, LOSS_TOL, relative=True,
             to="[trainer] (no saves)")
    # the loop with saves, from step 3 (after the first save, which
    # creates the segment) to the end of step 6's cadence save
    cadence = [r for r in saves if r["step"] == steps]
    t_end = max([spans[-1][1]] + [r["end"] for r in cadence[:1]])
    a_ms = (t_end - spans[2][0]) * 1e3 / (steps - 2)
    for rec in saves:
        rec.pop("end")
        log(f"  [ckpt] save {json.dumps(rec)}  ({card})")
    for rec in persists:
        log(f"  [ckpt] persist step {rec['step']}: {rec['seconds']:.3f} s "
            f"({card})")
    done = [r for r in saves if r["saved"]]
    if not done or any(r["card_bytes"] == 0 or not r["registered"]
                       for r in done):
        raise SystemExit(f"ckpt: a save moved no card bytes or copied "
                         f"into an unregistered segment: {saves}")
    want = ckpt_leaves(a)
    state_bytes = done[-1]["bytes"]
    card_tensors = [t for t in want.values()
                    if isinstance(t, torch.Tensor) and t.is_cuda]
    yardstick_ms = pinned_d2h_ms(card_tensors)
    log(f"  [ckpt] yardstick: one pinned D2H copy of the card's "
        f"{sum(t.numel() * t.element_size() for t in card_tensors) / 1e9:.3f}"
        f" GB: {yardstick_ms:.1f} ms ({card})")
    a.close()
    a._engine = None

    # B: a fresh engine restores from shm
    AsyncCheckpointSaver.reset()
    restored = {}
    for label in ("shm", "storage"):
        if label == "storage":
            seg = PersistentSharedMemory(name=shm_name(0))
            seg.close()
            seg.unlink()
            AsyncCheckpointSaver.reset()
        t = build_trainer(example_argv(run_dir, steps + CKPT_MORE),
                          device="cuda")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = t.maybe_resume()
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        stats = {k: v for k, v in t._engine.last_restore_stats.items()
                 if not k.startswith("_")}
        log(f"  [ckpt] restore from {label}: step {step} in {seconds:.3f} s "
            f"to the device, engine legs {stats} ({card})")
        if step != steps:
            raise SystemExit(f"ckpt: restored step {step} from {label}, "
                             f"want {steps}")
        check_restored(f"restore from {label}", ckpt_leaves(t), want)
        t.close()
        t._engine = None
        restored[label] = (t, seconds, stats)
    del want

    # A's own continuation, then B's and C's, CKPT_MORE steps each
    a.args.max_steps = steps + CKPT_MORE
    a.train()
    ref = [x.item() for x in a_losses[steps:]]
    del a
    gaps = {}
    for label, (t, _s, _st) in restored.items():
        losses = record_losses(t)
        t.args.max_steps = steps + CKPT_MORE
        t.train()
        got = [x.item() for x in losses]
        log(f"  [ckpt] after the restore from {label}: losses {got}, "
            f"uninterrupted {ref}")
        gaps[label] = loss_gap(f"ckpt-{label}", got, ref, LOSS_TOL,
                               relative=True, to="the uninterrupted run")
        if len(got) != CKPT_MORE:
            raise SystemExit(f"ckpt: {label} took {len(got)} steps after "
                             f"its restore, want {CKPT_MORE}")
    restore = {k: {"seconds": v[1], **v[2]} for k, v in restored.items()}
    del restored
    release()

    # the kill: a child dies right after its step-4 save, a second one
    # resumes from the shm segment it left
    AsyncCheckpointSaver.reset()
    unlink_segments(job)
    kill_dir = CKPT_DIR / "kill"
    env = dict(os.environ)
    env["DLROVER_CHAOS"] = json.dumps({"seed": 7, "rules": [
        {"site": "ckpt.save", "action": "kill", "step": CKPT_KILL_STEP}]})
    rc = run_child({"steps": CKPT_KILL_STEP, "out": str(kill_dir),
                    "report": str(CKPT_DIR / "killed.json")}, env,
                   "child 1 (DLROVER_CHAOS kill at ckpt.save)")
    if rc != 137:
        raise SystemExit(f"ckpt: the killed child exited {rc}, want 137")
    env.pop("DLROVER_CHAOS")
    report_path = CKPT_DIR / "resumed.json"
    rc = run_child({"steps": steps, "out": str(kill_dir),
                    "report": str(report_path)}, env,
                   "child 2 (resumes from the surviving shm segment)")
    if rc != 0:
        raise SystemExit(f"ckpt: the resuming child exited {rc}")
    child = json.loads(report_path.read_text())
    log(f"  [ckpt] child 2: resumed from step {child['resumed_from']}, "
        f"losses {child['losses']}, launches {child['launches']}")
    for rec in child["saves"]:
        log(f"  [ckpt] child 2 save {json.dumps(rec)}  ({card})")
    if child["resumed_from"] != CKPT_KILL_STEP:
        raise SystemExit(f"ckpt: child 2 resumed from "
                         f"{child['resumed_from']}, want {CKPT_KILL_STEP}")
    if any(child["launches"][n] == 0 for n in FLASH_KERNELS):
        raise SystemExit(f"ckpt: child 2 ran without K1-K4: "
                         f"{child['launches']}")
    kill_gap = loss_gap("ckpt-kill", child["losses"],
                        a_vals[CKPT_KILL_STEP:], LOSS_TOL, relative=True,
                        to="the uninterrupted run")
    steady = [r for r in done if r is not done[0]]
    return {
        "card": card, "config": "nano-350m", "batch": 8, "seq": 2048,
        "steps": steps, "save_steps": CKPT_SAVE_STEPS,
        "save_storage_every": CKPT_STORAGE_EVERY,
        "state_bytes": state_bytes,
        "saves": saves, "persists": persists, "async_save": async_save,
        "blocking_ms_first_save": done[0]["blocking_ms"],
        "blocking_ms_later_saves": [r["blocking_ms"] for r in steady],
        "pinned_d2h_yardstick_ms": yardstick_ms,
        "restore": restore,
        "trainer_ms_per_step_3_to_6_with_saves": a_ms,
        "trainer_ms_per_step_2_to_6_without": trainer_summary[
            "trainer_ms_per_step_2_to_6"],
        "a_train_s_with_final_persist": a_train_s,
        "loss_gap_after_restore": gaps, "loss_gap_after_kill": kill_gap,
        "restarted_worker_saves": child["saves"],
        "uninterrupted_losses": a_vals + ref,
    }



# -------------------------------------------------------------- [agent]

# the [agent] run: the launcher twin with its local master and the
# elastic agent, the example's defaults (nano-350m, B8, S2048, adamw)
# for AGENT_STEPS steps, saves every CKPT_SAVE_STEPS, every
# CKPT_STORAGE_EVERY-th persisted; DLROVER_CHAOS kills incarnation 0
# right after its step-CKPT_KILL_STEP save
AGENT_STEPS = 8
AGENT_TIMEOUT_S = 420


def agent_argv(log_dir, cache_dir) -> list:
    return [sys.executable, "-m", "dlrover_tpu_torch.trainer.run",
            "--nnodes", "1", "--nproc_per_node", "1", "--max-restarts", "1",
            "--log-dir", str(log_dir), "--compilation-cache-dir",
            str(cache_dir), "dlrover_tpu_torch/examples/llama_pretrain.py",
            "--steps", str(AGENT_STEPS), "--save-steps", str(CKPT_SAVE_STEPS),
            "--save-storage-every", str(CKPT_STORAGE_EVERY)]


def process_tree(root: int) -> dict:
    """pid -> command line of ``root`` and every process below it."""
    parents, cmds = {}, {}
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as f:
                stat = f.read()
            with open(f"/proc/{entry}/cmdline", "rb") as f:
                cmd = f.read().replace(b"\0", b" ").decode(errors="replace")
        except OSError:
            continue
        parents[int(entry)] = int(stat.rsplit(")", 1)[1].split()[1])
        cmds[int(entry)] = cmd.strip()
    tree, todo = {}, [root]
    while todo:
        pid = todo.pop()
        if pid in cmds and pid not in tree:
            tree[pid] = cmds[pid]
            todo += [p for p, ppid in parents.items() if ppid == pid]
    return tree


def compute_apps() -> list:
    """(pid, MiB) of every CUDA context nvidia-smi lists. Under gVisor
    nvidia-smi shows every process as pid 1, so the contexts are told
    apart by their count, not by their pids."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid,used_memory",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=30).stdout
    return [tuple(p.strip() for p in line.split(","))
            for line in out.strip().splitlines() if "," in line]


class ContextWatch:
    """Polls, while the launcher runs, the number of CUDA contexts
    nvidia-smi lists against the launcher's processes that may hold one
    (workers, the probe's child), read from /proc before and after each
    listing."""

    def __init__(self, proc):
        import threading

        self.proc = proc
        self.roles: dict = {}      # pid -> agent | master | worker | probe
        # (contexts listed, MiB, holders alive: [(pid, role)])
        self.samples: list = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    def _classify(self) -> set:
        tree = process_tree(self.proc.pid)
        for pid, cmd in tree.items():
            if pid == self.proc.pid:
                role = "agent"
            elif "master.main" in cmd:
                role = "master"
            elif "agent.probe" in cmd:
                role = "probe"
            elif "agent.node_check" in cmd:
                role = "node_check"
            elif "llama_pretrain" in cmd or "failover_worker" in cmd:
                role = "worker"
            else:
                role = "other: " + cmd[:80]
            # a child shows its parent's command line until it execs
            if self.roles.get(pid, "other").startswith("other"):
                self.roles[pid] = role
        return set(tree)

    def _loop(self):
        while not self._stop.is_set():
            before = self._classify()
            apps = compute_apps()
            alive = before | self._classify()
            holders = sorted((pid, self.roles[pid]) for pid in alive
                             if self.roles[pid] in ("worker", "probe",
                                                    "node_check"))
            self.samples.append((len(apps), sum(
                float(mib) for _pid, mib in apps if mib.isdigit()),
                holders))
            self._stop.wait(0.5)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


def telemetry_snapshots(tele_dir) -> list:
    """The snapshots each process flushed to the telemetry dir, as
    (role, source, snapshot), oldest process first."""
    from dlrover_tpu_torch.common import telemetry

    snaps = []
    for path, source in telemetry.snapshot_files(str(tele_dir)):
        with open(path) as f:
            snap = json.load(f)
        snaps.append((snap.get("role"), source, snap))
    return sorted(snaps, key=lambda s: s[2].get("created", 0.0))


def events(snap, kind) -> list:
    return [e for e in snap.get("events", ()) if e.get("kind") == kind]


def one_event(snap, kind, label) -> dict:
    found = events(snap, kind)
    if len(found) != 1:
        raise SystemExit(f"agent: {label} has {len(found)} {kind} events, "
                         "want 1")
    return found[0]


def agent_phase(cfg, uninterrupted):
    """[agent]: the launcher twin, its local master and the elastic agent
    train nano-350m through the example; DLROVER_CHAOS kills the worker
    right after its step-CKPT_KILL_STEP save, the agent restarts it, and
    the new incarnation restores that step from the segment the agent's
    saver kept. ``uninterrupted``: the [ckpt] run's losses of steps 1 to
    AGENT_STEPS, which the resumed steps must equal. Every run file, the
    sockets and the step directories live in one temp dir, removed at
    the end with the job's segments, also when a check fails."""
    import shutil
    import tempfile

    job = os.environ["ELASTIC_JOB_NAME"] + "agent"
    run_tmp = Path(tempfile.mkdtemp(prefix="dlag"))
    t_phase = time.perf_counter()
    try:
        report = agent_run(cfg, run_tmp, job, uninterrupted)
    finally:
        gone = unlink_segments(job)
        shutil.rmtree(run_tmp, ignore_errors=True)
        log(f"  [agent] cleanup: unlinked {gone}, removed {run_tmp}")
    if run_tmp.exists() or unlink_segments(job):
        raise SystemExit("agent: the cleanup left segments or files behind")
    report["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"agent": report}))


def agent_run(cfg, run_tmp, job, uninterrupted) -> dict:
    import re
    import signal

    from dlrover_tpu_torch.agent.ckpt_saver import (
        list_step_numbers,
        verify_step_dir,
    )
    from dlrover_tpu_torch.common.constants import CheckpointConstant

    card = CARD["line"]
    log_dir, tele_dir = run_tmp / "logs", run_tmp / "telemetry"
    cache_dir = run_tmp / "kernels"
    env = dict(os.environ)
    for key in ("DLROVER_TPU_TORCH_SOCKET_DIR", "DLROVER_RUNTIME_METRICS_PATH",
                "DLROVER_PARAL_CONFIG_PATH", "DLROVER_MASTER_ADDR"):
        env.pop(key, None)
    # the run's temp dir holds the example's default output dir, the
    # sockets, the runtime files and the agent's log dir defaults
    env.update({"TMPDIR": str(run_tmp), "ELASTIC_JOB_NAME": job,
                "DLROVER_TELEMETRY_DIR": str(tele_dir),
                "DLROVER_CHAOS": json.dumps({"seed": 7, "rules": [
                    {"site": "ckpt.save", "action": "kill",
                     "step": CKPT_KILL_STEP}]})})
    run_log = run_tmp / "tpu_run.log"
    baseline = len(compute_apps())
    t0 = time.perf_counter()
    with open(run_log, "wb") as out:
        proc = subprocess.Popen(agent_argv(log_dir, cache_dir), cwd=str(ROOT),
                                env=env, stdout=out, stderr=subprocess.STDOUT,
                                start_new_session=True)
    watch = ContextWatch(proc)
    try:
        rc = proc.wait(timeout=AGENT_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        rc = None
    finally:
        watch.stop()
        try:  # the launcher's group: agent, master, workers, probe
            os.killpg(proc.pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
        proc.wait()
    run_s = time.perf_counter() - t0
    text = run_log.read_text(errors="replace")
    log(f"  [agent] tpu-run exit {rc} after {run_s:.1f} s")
    for line in text.splitlines():
        if any(k in line for k in (
                "hardware probe", "rendezvous round", "started ", "exited rc",
                "persisted step", "succeeded", "Error", "error")):
            log(f"    {line.strip()[:240]}")
    worker_logs = sorted(log_dir.glob("worker_*.log"))
    if rc != 0:
        for path in worker_logs:
            log(f"  [agent] {path.name} (tail):")
            for line in path.read_text(errors="replace").splitlines()[-25:]:
                log(f"    {line[:240]}")
        raise SystemExit(f"agent: tpu-run exited {rc}, want 0")
    if "worker 0 exited rc=137" not in text or text.count("started 1 worker") != 2:
        raise SystemExit("agent: the agent did not classify the kill and "
                         "restart the worker once")
    if [p.name for p in worker_logs] != ["worker_0_restart0.log",
                                         "worker_0_restart1.log"]:
        raise SystemExit(f"agent: worker logs {worker_logs}")
    relog = worker_logs[1].read_text(errors="replace")
    log("  [agent] the restarted worker's log:")
    for line in relog.splitlines():
        if any(k in line for k in (
                "auto_strategy", "built mesh", "auto_accelerate ready",
                "checkpoint saver", "libdlrtpu loaded", "restored step",
                "resumed from", "saved step", "done:")):
            log(f"    {line.strip()[:200]}")
    for want in ("checkpoint saver: the agent's",
                 f"restored step {CKPT_KILL_STEP} from shared memory"):
        if want not in relog:
            raise SystemExit(f"agent: the restarted worker's log lacks "
                             f"{want!r}")

    # the launcher's CUDA contexts: never more than its live workers and
    # probe child hold, so none in the agent or the master; and each
    # worker's is seen
    roles = {pid: role for pid, role in watch.roles.items()
             if not role.startswith("other")}
    log(f"  [agent] processes: {roles}")
    over = [s for s in watch.samples if s[0] > baseline + len(s[2])]
    seen = {pid for n, _mib, holders in watch.samples
            if n == baseline + len(holders) for pid, role in holders
            if role == "worker"}
    counts = sorted({(n - baseline, tuple(r for _p, r in holders))
                     for n, _mib, holders in watch.samples})
    log(f"  [agent] CUDA contexts beyond this script's {baseline} over "
        f"{len(watch.samples)} nvidia-smi samples (contexts, holders "
        f"alive): {counts}; most MiB {max(s[1] for s in watch.samples)}")
    workers = {pid for pid, role in roles.items() if role == "worker"}
    if over or seen != workers:
        raise SystemExit(f"agent: contexts beyond the workers' and the "
                         f"probe's: {over[:3]}; workers seen holding one "
                         f"{sorted(seen)} of {sorted(workers)}")

    # the processes' telemetry: two worker incarnations, the agent
    snaps = telemetry_snapshots(tele_dir)
    inc = [s for role, _src, s in snaps if role == "worker"]
    agent = [s for role, _src, s in snaps
             if events(s, "worker.exit")]
    if len(inc) != 2 or len(agent) != 1:
        raise SystemExit(f"agent: telemetry sources "
                         f"{[src for _r, src, _s in snaps]}")
    first, second, agent = inc[0], inc[1], agent[0]
    start0 = one_event(first, "worker.startup", "incarnation 0")
    start1 = one_event(second, "worker.startup", "incarnation 1")
    if (start0["restart"], start1["restart"]) != (0, 1):
        raise SystemExit(f"agent: restart counts {start0['restart']}, "
                         f"{start1['restart']}, want 0, 1")
    restore = one_event(second, "ckpt.restore", "incarnation 1")
    if (restore["step"], restore["source_kind"]) != (CKPT_KILL_STEP, "shm"):
        raise SystemExit(f"agent: incarnation 1 restored {restore}, want "
                         f"step {CKPT_KILL_STEP} from shm")
    losses = {e["step"]: e["loss"] for e in events(second, "train.loss")}
    steps = list(range(CKPT_KILL_STEP + 1, AGENT_STEPS + 1))
    if sorted(losses) != steps:
        raise SystemExit(f"agent: incarnation 1 trained steps "
                         f"{sorted(losses)}, want {steps}")
    got = [losses[s] for s in steps]
    log(f"  [agent] incarnation 1 losses {got}, uninterrupted "
        f"{uninterrupted[CKPT_KILL_STEP:AGENT_STEPS]}")
    gap = loss_gap("agent", got, uninterrupted[CKPT_KILL_STEP:AGENT_STEPS],
                   LOSS_TOL, relative=True, to="the uninterrupted run")
    launches = {g["labels"]["kernel"]: g["value"]
                for g in second.get("gauges", ())
                if g.get("name") == "kernel.launches"}
    want = attention_launches(cfg, len(steps))
    log(f"  [agent] incarnation 1 launches {launches}")
    if any(launches.get(n, 0) != w for n, w in want.items()):
        raise SystemExit(f"agent: incarnation 1 launched {launches}, "
                         f"want {want}")

    # the agent's saver persisted steps that verify
    ckpt_dir = (run_tmp / "dlrover_tpu_torch" / "llama_pretrain"
                / "checkpoints")
    persisted = {}
    for step in list_step_numbers(str(ckpt_dir)):
        step_dir = ckpt_dir / f"{CheckpointConstant.STEP_DIR_PREFIX}{step}"
        persisted[step] = verify_step_dir(str(step_dir), deep=True)
    log(f"  [agent] persisted step dirs (deep CRC verify): {persisted}")
    if not persisted or not all(ok for ok, _why in persisted.values()):
        raise SystemExit(f"agent: persisted steps {persisted}")

    # the restart's legs, from the kill to the first step of incarnation 1
    kill = one_event(first, "chaos.fire", "incarnation 0")["t"]
    noticed = one_event(agent, "worker.exit", "the agent")["t"]
    spawn1 = [e for e in events(agent, "worker.spawn")
              if e.get("restart") == 1]
    rdzv = events(agent, "rdzv.wait")
    step1 = [e for e in events(second, "compile")]
    if len(spawn1) != 1 or len(rdzv) != 2 or len(step1) != 1:
        raise SystemExit(f"agent: spawn {spawn1}, rdzv {rdzv}, first step "
                         f"{step1}")
    spawn1, step1 = spawn1[0]["t"], step1[0]
    restore_start = restore["t"] - restore["dur"]
    legs = {
        "agent_notices_death_s": noticed - kill,
        "re_rendezvous_s": spawn1 - noticed,
        "rdzv_wait_s": rdzv[1]["dur"],
        "process_start_and_import_torch_s": start1["imported_at"] - spawn1,
        # from torch's import to the startup event: the port's package
        # imports, init_distributed, the CUDA context, the kernel load,
        # and what is left between them (argument parsing, the device)
        "package_import_s": start1["package_import_s"],
        "init_distributed_s": start1["init_distributed_s"],
        "cuda_init_s": start1["cuda_init_s"],
        "kernel_load_s": start1["kernel_load_s"],
        "model_and_trainer_build_s": restore_start - start1["t"],
        "restore_from_shm_s": restore["dur"],
        "to_first_step_s": (step1["t"] - step1["dur"]) - restore["t"],
        "first_step_s": step1["dur"],
    }
    legs["startup_rest_s"] = (start1["t"] - start1["imported_at"]) - sum(
        legs[k] for k in ("package_import_s", "init_distributed_s",
                          "cuda_init_s", "kernel_load_s"))
    legs["total_s"] = step1["t"] - kill
    # the profiling plane is imported where the Trainer is built: the
    # package imports hold none of it
    if start1["profiling_modules_at_import"]:
        raise SystemExit(f"agent: the package imports loaded the profiling "
                         f"plane: {start1['profiling_modules_at_import']}")
    log(f"  [agent] profiling modules loaded by the package imports: "
        f"{start1['profiling_modules_at_import']}")
    log(f"  [agent] restart latency {legs['total_s']:.3f} s: "
        f"{json.dumps(legs)} ({card})")
    saves = [{"incarnation": i, "step": e["step"], "blocking_ms":
              e["dur"] * 1e3} for i, s in enumerate(inc)
             for e in events(s, "ckpt.save")]
    persists = [{"step": e["step"], "seconds": e["dur"]}
                for e in events(agent, "ckpt.persist")]
    for rec in saves:
        log(f"  [agent] save {json.dumps(rec)} ({card})")
    for rec in persists:
        log(f"  [agent] persist {json.dumps(rec)} ({card})")
    # the job's ledger: the master's, which the agent queried once the
    # last worker's snapshot had reached it, just before the job's end
    found = re.search(r"job goodput ledger \(master\): (\{.*\})", text)
    if not found:
        raise SystemExit("agent: the agent logged no goodput ledger")
    ledger = json.loads(found.group(1))
    log(f"  [agent] master's ledger at the job's end: {json.dumps(ledger)}")
    cats = ledger.get("categories") or {}
    if not (cats.get("productive", 0) > 0 and cats.get("restart", 0) > 0):
        raise SystemExit(f"agent: the master's ledger {ledger} lacks the "
                         f"training or the restart")
    probe = [line for line in text.splitlines() if "hardware probe" in line]
    return {
        "card": card, "config": "nano-350m", "batch": 8, "seq": 2048,
        "steps": AGENT_STEPS, "kill_after_save_at": CKPT_KILL_STEP,
        "tpu_run_s": run_s,
        "goodput_pct": 100.0 * ledger.get("goodput", 0.0),
        "ledger_s": ledger.get("categories"),
        "ledger_total_s": ledger.get("total_s"),
        "restart_latency": legs,
        "kernel_load_s": {"incarnation_0_cold_cache":
                          start0["kernel_load_s"],
                          "incarnation_1": start1["kernel_load_s"],
                          "built_by_incarnation_0":
                          start0["kernels_built"]},
        "saves": saves, "persists": persists,
        "persisted_steps": sorted(persisted),
        "probe": probe[0].split("hardware probe:", 1)[1].strip()
        if probe else None,
        "cuda_contexts_beyond_workers": len(over),
        "loss_gap": gap,
    }


# -------------------------------------------------------------- [failover]

# the master-served data: FAILOVER_ROWS synthetic rows (row i is
# RandomState(i)'s tokens, as the example makes them) in shards of
# FAILOVER_SHARD (two batches of FAILOVER_B), shuffled by the master; the
# master dies on its (FAILOVER_KILL_AFTER + 1)-th task request and comes
# back from its state dir FAILOVER_OUTAGE_S after the agent saw it gone
FAILOVER_ROWS, FAILOVER_SHARD, FAILOVER_B, FAILOVER_S = 192, 16, 8, 2048
FAILOVER_KILL_AFTER = 6
FAILOVER_OUTAGE_S = 1.2
FAILOVER_TIMEOUT_S = 240
FAILOVER_WORKER = '''
"""[failover]'s worker: nano-350m through auto_accelerate on the card,
one step per batch of an ElasticDataset whose shards the master serves."""
import json, os, sys, time

t_start = time.time()
import numpy as np
import torch

from dlrover_tpu_torch.common import telemetry
from dlrover_tpu_torch.models import PRESETS, llama_init, llama_loss_fn
from dlrover_tpu_torch.ops import launch_counts
from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
from dlrover_tpu_torch.trainer import build_optimizer
from dlrover_tpu_torch.trainer.elastic import ElasticDataset

out, rows, batch, shard, seq, lr = sys.argv[1:7]
rows, batch, shard, seq, lr = (int(rows), int(batch), int(shard),
                               int(seq), float(lr))
cfg = PRESETS["nano-350m"]


class Rows(ElasticDataset):
    def read_sample(self, index):
        return index, np.random.RandomState(index).randint(
            0, cfg.vocab_size, size=(seq + 1,), dtype=np.int32)


ds = Rows("failover", dataset_size=rows, batch_size=batch, epochs=1,
          shuffle=True, num_minibatches_per_shard=shard // batch)
res = auto_accelerate(
    llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
    build_optimizer("adamw", lr, weight_decay=0.0), Strategy(remat="none"),
    device="cuda", seed=0)
state = res.state
torch.cuda.synchronize()
ready = time.time()
steps = []
while True:
    got = []
    for _ in range(batch):
        try:
            got.append(ds[0])
        except IndexError:
            break
    if not got:
        ds.report_all_shards_done()
        break
    t0 = time.time()
    state, metrics = res.train_step(
        state, {"tokens": np.stack([t for _i, t in got])}, None)
    steps.append({"indices": [int(i) for i, _t in got],
                  "loss": metrics["loss"].item(), "t": time.time()})
    telemetry.event("step.end", step=len(steps), dur=time.time() - t0)
    if len(steps) % (shard // batch) == 0:
        ds.report_batch_done()
telemetry.flush()
with open(out, "w") as f:
    json.dump({"pid": os.getpid(), "started": t_start, "ready": ready,
               "steps": steps, "launches": launch_counts()}, f)
'''


def failover_phase(cfg):
    """[failover]: the master survives its own death. ``python -m
    dlrover_tpu_torch.master.main --state-dir D --http-port 0 --addr-file
    F`` with a one-shot ``master.kill`` chaos rule on its 7th task
    request; a supervisor thread here restarts it with ``--restore-state
    D`` (and ``--port 0``, which re-binds the first incarnation's port)
    FAILOVER_OUTAGE_S after the agent logged the outage. The launcher
    twin with ``--network-check`` runs the node check on the card in a
    child, then a worker that trains nano-350m on an ElasticDataset.
    Every run file lives in one temp dir, removed at the end, also when a
    check fails."""
    import shutil
    import tempfile

    job = os.environ["ELASTIC_JOB_NAME"] + "failover"
    run_tmp = Path(tempfile.mkdtemp(prefix="dlfo"))
    t_phase = time.perf_counter()
    try:
        report = failover_run(cfg, run_tmp, job)
    finally:
        gone = unlink_segments(job)
        shutil.rmtree(run_tmp, ignore_errors=True)
        log(f"  [failover] cleanup: unlinked {gone}, removed {run_tmp}")
    if run_tmp.exists():
        raise SystemExit("failover: the cleanup left files behind")
    report["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"failover": report}))


def dispatched_count(http_addr) -> float | None:
    """The master's dispatched-task count on its /metrics page (the
    count of the WAL-append histogram's ``dispatch`` records), after
    /report.json folded the master's own telemetry in; None while it is
    not answering."""
    import urllib.request

    base = f"http://{http_addr}"
    try:
        urllib.request.urlopen(base + "/report.json", timeout=5).read()
        text = urllib.request.urlopen(base + "/metrics", timeout=5).read()
    except OSError:
        return None
    for line in text.decode().splitlines():
        if line.startswith("dlrtpu_master_wal_append_seconds_count") and \
                'op="dispatch"' in line:
            return float(line.rsplit(" ", 1)[1])
    return 0.0


class MasterSupervisor:
    """Runs the master, restarts it from its state dir after it dies,
    and polls its /metrics page throughout."""

    def __init__(self, run_tmp, env, agent_log):
        import threading

        self.state_dir = run_tmp / "master_state"
        self.addr_file = run_tmp / "master_addr"
        self.log_path = run_tmp / "master.log"
        self.env, self.agent_log = env, agent_log
        self.deaths: list = []    # (exit code, time)
        self.restarts: list = []  # {"spawned", "serving", "seen_by_agent"}
        self.readings: list = []  # (incarnation, dispatched count)
        self.proc = self.spawn(restore=False)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)

    def spawn(self, restore: bool):
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.master.main",
               "--port", "0", "--node_num", "1", "--http-port", "0",
               "--addr-file", str(self.addr_file)]
        env = dict(self.env)
        if restore:  # without the chaos rule: the kill is one-shot
            cmd += ["--restore-state", str(self.state_dir)]
        else:
            cmd += ["--state-dir", str(self.state_dir)]
            env["DLROVER_CHAOS"] = json.dumps({"seed": 29, "rules": [{
                "site": "master.kill", "action": "kill",
                "msg": ["TaskRequest"], "after": FAILOVER_KILL_AFTER,
                "max": 1}]})
        with open(self.log_path, "ab") as out:
            return subprocess.Popen(cmd, cwd=str(ROOT), env=env, stdout=out,
                                    stderr=subprocess.STDOUT)

    def lines(self, prefix) -> list:
        return [line.split("=", 1)[1] for line in
                self.log_path.read_text(errors="replace").splitlines()
                if line.startswith(prefix)]

    def wait_serving(self, want: int, limit=60.0) -> float:
        """Seconds until the master has printed its ``want``-th HTTP
        address and its RPC port answers."""
        from dlrover_tpu_torch.common.rpc import addr_connectable

        t0 = time.perf_counter()
        while True:
            if len(self.lines("DLROVER_MASTER_HTTP=")) >= want and \
                    self.addr_file.exists() and \
                    addr_connectable(self.addr_file.read_text(), 0.5):
                return time.perf_counter() - t0
            if self.proc.poll() is not None or \
                    time.perf_counter() - t0 > limit:
                raise SystemExit(
                    f"failover: master {want} never served; log:\n"
                    f"{self.log_path.read_text(errors='replace')[-3000:]}")
            time.sleep(0.02)

    def start(self):
        self._thread.start()

    def _loop(self):
        while not self._stop.is_set():
            rc = self.proc.poll()
            if rc is not None and rc != 0 and len(self.deaths) == len(
                    self.restarts):
                died = time.perf_counter()
                self.deaths.append((rc, died))
                # a real outage: the agent must see it before the master
                # comes back, or nothing rides it through
                seen = None
                while seen is None and time.perf_counter() - died < 20:
                    if "master unreachable at" in self.agent_log.read_text(
                            errors="replace"):
                        seen = time.perf_counter() - died
                    time.sleep(0.02)
                time.sleep(FAILOVER_OUTAGE_S)
                spawned = time.perf_counter()
                self.proc = self.spawn(restore=True)
                try:
                    self.wait_serving(2)
                except SystemExit as e:
                    self.restarts.append({"error": str(e)})
                    return
                self.restarts.append({
                    "agent_saw_outage_s": seen,
                    "outage_s": time.perf_counter() - died,
                    "master_restore_s": time.perf_counter() - spawned})
            http = self.lines("DLROVER_MASTER_HTTP=")
            if self.proc.poll() is None and http:
                count = dispatched_count(http[-1])
                if count is not None:
                    self.readings.append((len(http), count))
            time.sleep(0.05)

    def stop(self):
        self._stop.set()
        if self._thread.is_alive():
            self._thread.join(timeout=60)
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


def failover_run(cfg, run_tmp, job) -> dict:
    import signal

    from dlrover_tpu_torch.common.constants import NodeEnv
    from dlrover_tpu_torch.common.telemetry import JobTelemetry

    card = CARD["line"]
    B, S = FAILOVER_B, FAILOVER_S
    tele_dir, log_dir = run_tmp / "telemetry", run_tmp / "logs"
    script, result = run_tmp / "failover_worker.py", run_tmp / "result.json"
    script.write_text(FAILOVER_WORKER)
    env = dict(os.environ)
    for key in ("DLROVER_TPU_TORCH_SOCKET_DIR", "DLROVER_RUNTIME_METRICS_PATH",
                "DLROVER_PARAL_CONFIG_PATH", "DLROVER_MASTER_ADDR",
                "DLROVER_CHAOS"):
        env.pop(key, None)
    # every run file (sockets, node-check files, runtime files) under the
    # run's temp dir; the workers ride a master outage inside one retry
    # budget; the join-time hardware probe is [agent]'s, not this phase's
    env.update({"TMPDIR": str(run_tmp), "ELASTIC_JOB_NAME": job,
                "DLROVER_TELEMETRY_DIR": str(tele_dir),
                "DLROVER_PROBE_DISABLE": "1",
                "DLROVER_RPC_MAX_ATTEMPTS": "400",
                "DLROVER_RPC_BASE_DELAY": "0.05",
                "DLROVER_RPC_MAX_DELAY": "0.3",
                "DLROVER_RPC_DEADLINE": "60",
                "DLROVER_MASTER_RIDE_POLL": "0.1"})
    master_env = dict(env, DLROVER_TELEMETRY_ROLE="master")
    agent_log = run_tmp / "tpu_run.log"
    agent_log.touch()
    master = MasterSupervisor(run_tmp, master_env, agent_log)
    try:
        master.wait_serving(1)
        addr = master.addr_file.read_text()
        master.start()
        env.update({"DLROVER_MASTER_ADDR": addr,
                    NodeEnv.DLROVER_MASTER_ADDR_FILE: str(master.addr_file)})
        baseline = len(compute_apps())
        t0 = time.perf_counter()
        with open(agent_log, "ab") as out:
            proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.trainer.run",
                 "--network-check", "--nnodes", "1", "--nproc_per_node",
                 "1", "--max-restarts", "1", "--log-dir", str(log_dir),
                 str(script), str(result), str(FAILOVER_ROWS), str(B),
                 str(FAILOVER_SHARD), str(S), str(SLICE_LR)],
                cwd=str(ROOT), env=env, stdout=out,
                stderr=subprocess.STDOUT, start_new_session=True)
        watch = ContextWatch(proc)
        try:
            rc = proc.wait(timeout=FAILOVER_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            watch.stop()
            try:  # the launcher's group: agent, node check, worker
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
    finally:
        master.stop()
    run_s = time.perf_counter() - t0
    text = agent_log.read_text(errors="replace")
    log(f"  [failover] tpu-run exit {rc} after {run_s:.1f} s")
    for line in text.splitlines():
        if any(k in line for k in (
                "node check", "network check", "rendezvous round", "started ",
                "exited rc", "master unreachable", "master back", "succeeded",
                "Error", "error")):
            log(f"    {line.strip()[:240]}")
    mlog = master.log_path.read_text(errors="replace")
    for line in mlog.splitlines():
        if any(k in line for k in ("restored master state", "serving on",
                                   "HTTP plane", "chaos", "exiting")):
            log(f"    master: {line.strip()[:200]}")
    if rc != 0:
        for path in sorted(log_dir.glob("worker_*.log")):
            log(f"  [failover] {path.name} (tail):")
            for line in path.read_text(errors="replace").splitlines()[-25:]:
                log(f"    {line[:240]}")
        raise SystemExit(f"failover: tpu-run exited {rc}, want 0")

    # the node check: on the card, in a child that had exited before the
    # worker started, and the master's verdict normal
    check = json.loads((run_tmp / "dlrover_tpu_torch" / "node_check"
                        / "0.json").read_text())
    legs = check.get("legs", {})
    log(f"  [failover] node check {json.dumps(check)} ({card})")
    ran_on_the_card(check)
    if watch.roles.get(legs["pid"]) != "node_check":
        raise SystemExit(f"failover: the node check's pid {legs['pid']} is "
                         f"not a child the launcher started: {watch.roles}")
    if "network check: the master's verdict is normal" not in text:
        raise SystemExit("failover: the agent logged no normal verdict")
    out = json.loads(result.read_text())
    if not check["ts"] < out["started"]:
        raise SystemExit("failover: the worker started before the node "
                         "check ended")

    # the master: one death, one restore from its state dir, the same
    # port, the worker never restarted
    if [rc_ for rc_, _t in master.deaths] != [137] or \
            len(master.restarts) != 1 or "error" in master.restarts[0]:
        raise SystemExit(f"failover: master deaths {master.deaths}, "
                         f"restarts {master.restarts}")
    restart = master.restarts[0]
    if restart["agent_saw_outage_s"] is None:
        raise SystemExit("failover: the agent never saw the outage")
    if "restored master state" not in mlog or \
            master.addr_file.read_text() != addr:
        raise SystemExit("failover: the master did not come back from its "
                         "state dir on its port")
    workers = sorted(pid for pid, role in watch.roles.items()
                     if role == "worker")
    worker_logs = sorted(p.name for p in log_dir.glob("worker_*.log"))
    if workers != [out["pid"]] or text.count("started 1 worker") != 1 or \
            worker_logs != ["worker_0_restart0.log"]:
        raise SystemExit(f"failover: worker pids {workers} (result's "
                         f"{out['pid']}), logs {worker_logs}")

    # the shards: every row once across the outage
    steps = out["steps"]
    rows = sorted(i for s in steps for i in s["indices"])
    if rows != list(range(FAILOVER_ROWS)) or \
            len(steps) != FAILOVER_ROWS // B:
        raise SystemExit(f"failover: {len(steps)} steps read rows {rows}")

    # /metrics on both sides of the outage, the count continuing
    before = [c for inc, c in master.readings if inc == 1]
    after = [c for inc, c in master.readings if inc == 2]
    shards = FAILOVER_ROWS // FAILOVER_SHARD
    own = shards - FAILOVER_KILL_AFTER  # dispatched by the restored master
    log(f"  [failover] dispatched on /metrics: before {before[-3:]} "
        f"({len(before)} reads), after {after[:3]} ... {after[-3:]} "
        f"({len(after)} reads)")
    if not before or not after or after != sorted(after) or \
            not after[0] > 0 or not after[-1] > own:
        raise SystemExit(f"failover: /metrics before {before}, after "
                         f"{after}: the dispatched count did not continue "
                         f"past the restored master's own {own}")

    # the losses: an uninterrupted run over the same rows in this process
    ref_losses = failover_reference(cfg, [s["indices"] for s in steps], S)
    gap = loss_gap("failover", [s["loss"] for s in steps], ref_losses,
                   LOSS_TOL, relative=True, to="the uninterrupted run")
    want = attention_launches(cfg, len(steps))
    launches = out["launches"]
    log(f"  [failover] worker launches {launches}")
    if any(launches.get(n, 0) != w for n, w in want.items()):
        raise SystemExit(f"failover: worker launched {launches}, want {want}")

    # the ledger charges the outage to restart
    report = JobTelemetry.from_dir(str(tele_dir)).report()
    ledger = report["ledger"]
    ride = [e for e in report["timeline"] if e["kind"] == "master.restart"
            and e.get("dur")]
    log(f"  [failover] ledger {json.dumps(ledger)}")
    if not (ledger["categories"].get("restart", 0) > 0
            and ledger["categories"].get("productive", 0) > 0
            and len(ride) == 1):
        raise SystemExit(f"failover: the ledger {ledger} and ride-through "
                         f"events {ride} do not charge the outage")

    # CUDA contexts: never more than the live workers and node-check
    # children hold
    over = [s for s in watch.samples if s[0] > baseline + len(s[2])]
    counts = sorted({(n - baseline, tuple(r for _p, r in holders))
                     for n, _mib, holders in watch.samples})
    log(f"  [failover] CUDA contexts beyond this script's {baseline} "
        f"(contexts, holders alive): {counts}")
    if over:
        raise SystemExit(f"failover: contexts beyond the workers' and the "
                         f"node check's: {over[:3]}")
    return {
        "card": card, "config": "nano-350m", "batch": B, "seq": S,
        "rows": FAILOVER_ROWS, "shards": shards, "steps": len(steps),
        "tpu_run_s": run_s, "outage_s": restart["outage_s"],
        "agent_saw_outage_s": restart["agent_saw_outage_s"],
        "agent_ride_through_s": ride[0]["dur"],
        "master_restore_s": restart["master_restore_s"],
        "node_check": {"matmul_ms": legs["matmul_ms"],
                       "all_reduce_ms": legs["all_reduce_ms"],
                       "all_gather_ms": legs["all_gather_ms"],
                       "total_s": check["elapsed"]},
        "dispatched_before": before[-1], "dispatched_after": after[-1],
        "worker_ready_s": out["ready"] - out["started"],
        "loss_gap": gap,
        "launches": {n: launches.get(n, 0) for n in FLASH_KERNELS},
        "ledger_s": ledger["categories"],
        "cuda_contexts_beyond_holders": len(over),
    }


def ran_on_the_card(check):
    """The node check's record: normal, on this card through NCCL, with
    timed matmul, all_reduce and all_gather legs."""
    legs = check.get("legs", {})
    if not (check["normal"] and legs.get("device") == "cuda"
            and legs.get("backend") == "nccl"
            and legs.get("kind") == torch.cuda.get_device_name(0)
            and legs.get("matmul_ms", 0) > 0
            and legs.get("all_reduce_ms", 0) > 0
            and legs.get("all_gather_ms", 0) > 0):
        raise SystemExit(f"failover: the node check {check} did not run "
                         f"normal on the card")


def failover_reference(cfg, order, S) -> list:
    """The worker's run without the outage: the same model, seed and
    optimizer over the same rows in the same order, in this process."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.trainer import build_optimizer

    res = auto_accelerate(
        llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
        build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none"), device="cuda", seed=0)
    state, losses = res.state, []
    for indices in order:
        tokens = np.stack([np.random.RandomState(i).randint(
            0, cfg.vocab_size, size=(S + 1,), dtype=np.int32)
            for i in indices])
        state, metrics = res.train_step(state, {"tokens": tokens}, None)
        losses.append(metrics["loss"].item())
    del res, state
    release()
    return losses


# ------------------------------------------------------------------ [gpt2]

# gpt2-1.5b at full width and depth (48 layers, dim 1600, 25 heads of 64,
# mlp 6400, vocab 50257) through Trainer: B8 at the preset's max_seq_len,
# bf16 over f32 masters, remat "none", adamw; then GPT2_MORE more steps
# after a save, twice: the Trainer's own continuation and the one after
# the restore
GPT2_PRESET = "gpt2-1.5b"
GPT2_B, GPT2_S, GPT2_STEPS, GPT2_MORE = 8, 1024, 5, 2


def gpt2_logits_check():
    """gpt2-124m (12 layers, full width) logits on the card through the
    flash branch (K1-K4 at head_dim 64) and the bshd route (K1-K4 on
    transposed views at this width) against the reference branch, same
    weights, bf16 compute, B2 S512."""
    from dlrover_tpu_torch.models import GPT2_PRESETS, gpt2_apply, gpt2_init

    cfg = GPT2_PRESETS["gpt2-124m"]
    params = gpt2_init(cfg, seed=1, device="cuda")
    tokens = torch.as_tensor(
        synthetic_batch(cfg.vocab_size, 512, 2, 98)["tokens"][:, :-1],
        device="cuda")
    with torch.no_grad():
        ref = gpt2_apply(dataclasses.replace(cfg, attn_impl="reference"),
                         params, tokens)
        for impl in ("flash", "bshd"):
            reset_launches()
            out = gpt2_apply(dataclasses.replace(cfg, attn_impl=impl),
                             params, tokens)
            k1 = launch_counts()["flash_fwd"]
            abs_err, rel = rel_err(out, ref)
            ok = (bool(torch.isfinite(out).all()) and rel <= 5e-2
                  and k1 == cfg.n_layers)
            log(f"  [gpt2] logits gpt2-124m {impl} vs reference (12 layers, "
                f"B2 S512): max_abs_err={abs_err:.3e} rel={rel:.3e} "
                f"K1 launches={k1} {'ok' if ok else 'FAIL'}")
            if not ok:
                raise SystemExit(f"gpt2 logits check failed ({impl})")


def gpt2_phase() -> dict:
    """[gpt2]: the logits check, then gpt2-1.5b through Trainer on one
    repeated seeded batch for GPT2_STEPS steps (the launches counted from
    0 over exactly these steps: K1-K4 once per layer and step, no other
    attention kernel; losses finite and falling); step ms (median of
    steps 2-5, each step ended by a sync), tokens/s, MFU (6N plus the
    causal attention term, common/mfu.py's peak) and peak GiB. Then the
    checkpoint leg: one Flash Checkpoint save of the state to shm, the
    Trainer's own GPT2_MORE more steps, a fresh engine's restore of the
    save into the Trainer (every leaf torch.equal to the saved state) and
    the same GPT2_MORE steps again, whose losses must agree within
    LOSS_TOL (relative); last a profiled step. Returns the run's launch
    counts."""
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.models import GPT2_PRESETS, gpt2_init, gpt2_loss_fn
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.trainer.flash_checkpoint.engine import (
        ShardedCheckpointEngine,
    )

    gpt2_logits_check()
    release()
    cfg = GPT2_PRESETS[GPT2_PRESET]
    B, S, steps = GPT2_B, GPT2_S, GPT2_STEPS
    batch = synthetic_batch(cfg.vocab_size, S, B, 0)
    job = os.environ["ELASTIC_JOB_NAME"]
    t_phase = time.perf_counter()
    with flash_env("gpt2", job):
        run_dir = CKPT_DIR / "gpt2"
        trainer = Trainer(
            gpt2_loss_fn(cfg), lambda seed, device: gpt2_init(cfg, seed,
                                                              device),
            None, TrainingArgs(
                output_dir=str(run_dir), max_steps=steps, num_epochs=1,
                learning_rate=SLICE_LR, optimizer="adamw",
                strategy=Strategy(remat="none"), flash_checkpoint=False,
                log_steps=0),
            train_data=[batch] * (steps + GPT2_MORE), device="cuda")
        inner, losses, step_s = trainer._accel.train_step, [], []

        def timed(state, batch, rng):
            t0 = time.perf_counter()
            state, metrics = inner(state, batch, rng)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            return state, metrics

        trainer._accel.train_step = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer.train()
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"  [gpt2] losses: {losses}")
        log(f"  [gpt2] step seconds: {step_s}")
        log(f"  [gpt2] launches over {steps} steps: {launches}")
        want = {name: cfg.n_layers * steps * int(name in FLASH_KERNELS)
                for name in FLASH_KERNELS + HEADS_KERNELS + RING_KERNELS}
        for name, n in want.items():
            if launches[name] != n:
                raise SystemExit(f"gpt2: {name} launched {launches[name]} "
                                 f"times, want {n}")
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"gpt2: non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"gpt2: loss did not fall: {losses}")
        steady = statistics.median(step_s[1:])
        flops = mfu.transformer_step_flops(cfg.param_count(), B * S,
                                           cfg.n_layers, cfg.dim, S)
        summary = {
            "config": GPT2_PRESET, "n_layers": cfg.n_layers, "dim": cfg.dim,
            "n_heads": cfg.n_heads, "head_dim": cfg.head_dim,
            "params": cfg.param_count(), "batch": B, "seq": S,
            "optimizer": "adamw", "remat": "none", "steps": steps,
            "step_ms_median_2_to_5": steady * 1e3,
            "first_step_ms": step_s[0] * 1e3,
            "tokens_per_s": B * S / steady, "mfu": mfu.mfu(flops, steady),
            "mfu_peak_flops": mfu.peak_flops(), "peak_mem_gib": peak_gib,
            "loss_first": losses[0], "loss_last": losses[-1],
        }

        # the checkpoint leg
        trainer._engine = ShardedCheckpointEngine(str(run_dir / "checkpoints"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ok = trainer.save_checkpoint(persist=False)
        torch.cuda.synchronize()
        save_s = time.perf_counter() - t0
        stats = dict(trainer._engine.last_save_stats)
        log(f"  [gpt2] save to shm at step {steps}: {save_s:.3f} s {stats}")
        if not ok or not stats.get("registered"):
            raise SystemExit(f"gpt2: the save was skipped or copied into an "
                             f"unregistered segment: {ok} {stats}")
        # host copies (the optimizer's step counts already live on the
        # host, where the continuation updates them in place)
        saved = {name: leaf.to("cpu", copy=True)
                 if isinstance(leaf, torch.Tensor)
                 else np.array(leaf, copy=True)
                 for name, leaf in ckpt_leaves(trainer).items()}
        trainer.close()
        trainer._engine = None
        trainer.args.max_steps = steps + GPT2_MORE
        trainer.train()
        ref = losses[steps:]

        trainer._engine = ShardedCheckpointEngine(str(run_dir / "checkpoints"))
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step = trainer.maybe_resume()
        torch.cuda.synchronize()
        restore_s = time.perf_counter() - t0
        if step != steps or trainer.global_step != steps:
            raise SystemExit(f"gpt2: restored step {step}, want {steps}")
        got = ckpt_leaves(trainer)
        if list(got) != list(saved):
            raise SystemExit("gpt2: the restored tree's leaves differ from "
                             "the saved tree's")
        nbytes = 0
        for name, w in saved.items():
            g = got[name]
            if isinstance(w, torch.Tensor):
                same = g.dtype == w.dtype and torch.equal(g, w.to(g.device))
                nbytes += w.numel() * w.element_size()
            else:
                same = np.array_equal(np.asarray(g), w)
            if not same:
                raise SystemExit(f"gpt2: restored leaf {name} differs from "
                                 "the saved one")
        log(f"  [gpt2] restore from shm: {restore_s:.3f} s, {len(saved)} "
            f"leaves ({nbytes / 1e9:.3f} GB) torch.equal to the state saved "
            f"at step {steps}")
        del saved, got
        trainer.close()
        trainer._engine = None
        trainer.train()
        again = losses[steps + GPT2_MORE:]
        log(f"  [gpt2] losses after the restore: {again} (the Trainer's own "
            f"continuation: {ref})")
        gap = loss_gap("gpt2 restore", again, ref, LOSS_TOL, relative=True,
                       to="the continuation without a restore")
        trainer._accel.train_step = inner
        profile_step(trainer._accel, trainer.state, batch, "gpt2", top=12)
        del trainer, inner
        release()
    summary["ckpt"] = {"state_gb": nbytes / 1e9, "save_s": save_s,
                       **{k: stats[k] for k in ("materialize_s", "fill_s",
                                                "registered")},
                       "restore_s": restore_s, "loss_gap": gap}
    summary["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"gpt2": summary}))
    return launches


def profiled_kernels(averages, label, busy_us) -> dict:
    """The hand-written kernels' device ms and calls in a profiled step,
    found by name whatever their rank in the table (the rope pre-pass
    ``flash_fwd_rope_k`` counted on its own), and the attention kernels'
    sum and share of the device's busy time."""
    from torch.autograd import DeviceType

    names = sorted({name.removesuffix("_d64") for name in KERNEL_INFO}
                   | {"flash_fwd_rope_k"})
    rows = {}
    for name in names:
        pattern = re.compile(rf"\b{name}_kernel\b")
        found = [e for e in averages if e.device_type == DeviceType.CUDA
                 and pattern.search(e.key)]
        if found:
            rows[name] = {
                "calls": sum(e.count for e in found),
                "device_ms": sum(e.self_device_time_total
                                 for e in found) / 1e3}
    attention_ms = sum(r["device_ms"] for n, r in rows.items()
                       if n.startswith("flash_"))
    return {"run": label, "kernels": rows, "attention_ms": attention_ms,
            "attention_share_of_busy": attention_ms * 1e3 / busy_us}


def profile_step(res, state, batch, label="adamw", top=16):
    """Per-op device time of one more step, written to chiprun_out/
    (``profile_step.txt`` for adamw, ``profile_step_<label>.txt``
    otherwise); the first ``top`` rows are logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res.train_step(state, batch, None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    # device busy time: the device's own events (kernels, copies, sets),
    # as the table's "Self CUDA time total" counts them. CPU-side rows
    # such as "Command Buffer Full" (the host waiting on a full launch
    # queue) show the kernels launched under them as their own device
    # time, so they are left out
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    # the loss's rows: logsumexp and its backward (one call), or the
    # chunked CE's forward and backward (the function's own rows, their
    # device time inclusive of what they launch)
    ce_rows = {e.key: {"calls": e.count,
                       "self_device_ms": e.self_device_time_total / 1e3,
                       "device_ms": e.device_time_total / 1e3}
               for e in averages
               if "logsumexp" in e.key.lower() or "ChunkedCE" in e.key}
    log(json.dumps({"profiled_step": {
        "run": label, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us, "ce_rows": ce_rows}}))
    log(json.dumps({"profiled_kernels": profiled_kernels(averages, label,
                                                         busy_us)}))
    table = averages.table(sort_by="cuda_time_total", row_limit=60)
    name = ("profile_step.txt" if label == "adamw"
            else f"profile_step_{label}.txt")
    OUT.mkdir(exist_ok=True)
    (OUT / name).write_text(table)
    log(f"  profile of one step (top rows, full table in "
        f"chiprun_out/{name}):")
    for line in table.splitlines()[:top]:
        log("    " + line)
    return ce_rows


# ------------------------------------------------------------- [serve]
#
# the serving arm and the RL loop: llama3-8b in the slotted decode engine
# at full width, nano-350m decode workers under the port's own master,
# and LMPPOTrainer on nano-350m through K1-K4

SERVE_SLOTS = 8
SERVE_CAPACITY = 2048
SERVE_TF_PROMPTS = (100, 1000)   # buckets 128 and 1024
SERVE_TF_STEPS = 16
SERVE_WRAP_PROMPT = SERVE_CAPACITY - 48
SERVE_WRAP_STEPS = 56            # the last 8 past the ring's end
SERVE_REQUESTS = 24
SERVE_SEED = 5
# bf16 logits against the forward: 2e-2 of the largest value, or twice
# the distance of the bf16 K1 forward itself from the f32 forward,
# whichever is larger (bf16 noise of a random-weight model grows with
# depth and width; a wrong position, mask or cache row is of order 1)
SERVE_REL_TOL = 2e-2
SERVE_NOISE_FACTOR = 2.0
# the rollout's logprobs against the teacher-forced K1 forward's
PPO_LOGP_TOL = 2e-2
SERVE_TIMED_STEPS = 50


def serve_config():
    from dlrover_tpu_torch.models import PRESETS

    return dataclasses.replace(PRESETS["llama3-8b"], remat=False)


def drawn_params(cfg, seed, keep_f32=False):
    """The model's fp32 params drawn from ``seed`` on the card, and their
    bf16 casts (each cast as it is taken); the fp32 dict is kept only
    with ``keep_f32``."""
    from dlrover_tpu_torch.models import llama_init

    f32 = llama_init(cfg, seed=seed, device="cuda")
    if keep_f32:
        return f32, {k: v.to(torch.bfloat16) for k, v in f32.items()}
    return {k: f32.pop(k).to(torch.bfloat16) for k in list(f32)}


def noise_gate(label, engine_logits, bf16_logits, f32_logits):
    """Holds the engine's bf16 logits against the K1 forward's, with the
    tolerance SERVE_REL_TOL or SERVE_NOISE_FACTOR times the K1 forward's
    own distance from the f32 forward; logs all three distances."""
    _, pair = rel_err(engine_logits, bf16_logits)
    _, engine_vs_f32 = rel_err(engine_logits, f32_logits)
    _, k1_vs_f32 = rel_err(bf16_logits, f32_logits)
    tol = max(SERVE_REL_TOL, SERVE_NOISE_FACTOR * k1_vs_f32)
    agree = float((engine_logits.argmax(-1) == bf16_logits.argmax(-1))
                  .float().mean())
    ok = pair <= tol and bool(torch.isfinite(engine_logits).all())
    log(f"  [serve] {label}: engine vs K1 forward rel={pair:.3e} (tol "
        f"{tol:.3e}); engine vs f32 {engine_vs_f32:.3e}, K1 forward vs f32 "
        f"{k1_vs_f32:.3e}; argmax agreement {agree:.3f} "
        f"{'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"serve logits check failed ({label})")
    return {"rel": pair, "tol": tol, "engine_vs_f32": engine_vs_f32,
            "k1_vs_f32": k1_vs_f32, "argmax_agreement": agree}


def pool_inputs(S, live_slots):
    """The static-buffer arguments of a decode step with ``live_slots``
    live (slot -> (token, position))."""
    tokens, positions, live = [0] * S, [0] * S, [False] * S
    for slot, (tok, pos) in live_slots.items():
        tokens[slot], positions[slot], live[slot] = int(tok), int(pos), True
    return (torch.tensor(tokens, device="cuda"),
            torch.tensor(positions, device="cuda"),
            torch.tensor(live, device="cuda"))


def k1_attend(q, k, v, window):
    from dlrover_tpu_torch.ops.attention import flash_attention

    return flash_attention(q, k, v, causal=True, window=window)


def plain_attend(q, k, v, window):
    from dlrover_tpu_torch.ops.attention import flash_fwd_plain

    return flash_fwd_plain(q, k, v, None, None, True, q.shape[-1] ** -0.5,
                           window=window)[0]


def windowed_forward(cfg, params, tokens, window, attend):
    """The Llama forward over ``tokens`` [B, T] at positions 0..T-1 with
    causal attention over a sliding window of ``window`` keys (the slot
    ring's semantics past its capacity), rope applied outside the
    attention, ``attend(q, k, v, window)`` on [B, H, T, hd]. f32
    logits."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.models.llama import (
        LAYER_KEYS,
        _rms_norm,
        _rope_apply,
        _rope_tables,
    )

    dtype = getattr(torch, cfg.dtype)
    B, T = tokens.shape
    H, KVH, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    pos = torch.arange(T, device=tokens.device).expand(B, T)
    cos, sin = _rope_tables(pos, hd // 2, cfg.rope_theta, dtype)
    x = F.embedding(tokens, params["embed"].to(dtype))
    for i in range(cfg.n_layers):
        p = {k: params["layers." + k][i].to(dtype) for k in LAYER_KEYS}
        y = _rms_norm(x, p["attn_norm"], cfg.norm_eps)
        q = _rope_apply((y @ p["wq"]).view(B, T, H, hd), cos, sin)
        k = _rope_apply((y @ p["wk"]).view(B, T, KVH, hd), cos, sin)
        v = (y @ p["wv"]).view(B, T, KVH, hd)
        o = attend(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                   window)
        x = x + o.transpose(1, 2).reshape(B, T, H * hd) @ p["wo"]
        y = _rms_norm(x, p["mlp_norm"], cfg.norm_eps)
        x = x + (F.silu(y @ p["w_gate"]) * (y @ p["w_up"])) @ p["w_down"]
    x = _rms_norm(x, params["final_norm"], cfg.norm_eps)
    return (x @ params["lm_head"].to(dtype)).float()


def serve_logit_checks(cfg, f32, bf16, engine) -> dict:
    """(a) prompts of 100 and 1000 tokens (buckets 128 and 1024) in
    slots 0 and 1, then 16 teacher-forced decode steps of both in one
    pool step each, against the full forward (K1) at the same positions;
    (c) a 2000-token prompt in slot 2 decoded 56 teacher-forced steps,
    the last 8 past the ring's end, against the plain forward with a
    sliding window of C keys (and its K1 twin)."""
    from dlrover_tpu_torch.models import llama_apply
    from dlrover_tpu_torch.serving.engine import decode_logits, prefill_logits

    cfg32 = dataclasses.replace(cfg, dtype="float32", attn_impl="reference")
    gen = torch.Generator(device="cuda").manual_seed(SERVE_SEED)
    S, C = engine.slots, engine.capacity
    out = {}
    with torch.no_grad():
        seqs, got = {}, {}
        for slot, n in enumerate(SERVE_TF_PROMPTS):
            seq = torch.randint(0, cfg.vocab_size, (n + SERVE_TF_STEPS,),
                                generator=gen, device="cuda")
            padded = torch.zeros(engine.bucket_for(n), dtype=torch.long,
                                 device="cuda")
            padded[:n] = seq[:n]
            seqs[slot] = seq
            got[slot] = [prefill_logits(cfg, engine.weights, engine.cache,
                                        padded, n, slot)[0]]
        for t in range(SERVE_TF_STEPS):
            step = {slot: (seq[n + t], n + t) for (slot, seq), n in
                    zip(seqs.items(), SERVE_TF_PROMPTS)}
            logits = decode_logits(cfg, engine.weights, engine.cache,
                                   *pool_inputs(S, step))
            for slot in seqs:
                got[slot].append(logits[slot])
        for (slot, seq), n in zip(seqs.items(), SERVE_TF_PROMPTS):
            reset_launches()
            k1_ref = llama_apply(cfg, bf16, seq[None])[0, n - 1:]
            k1 = launch_counts()["flash_fwd"]
            if k1 != cfg.n_layers:
                raise SystemExit(f"serve: the K1 forward launched K1 {k1} "
                                 f"times, want {cfg.n_layers}")
            f32_ref = llama_apply(cfg32, f32, seq[None])[0, n - 1:]
            out[f"prompt{n}"] = noise_gate(
                f"prompt {n} (bucket {engine.bucket_for(n)}) prefill + "
                f"{SERVE_TF_STEPS} decode steps", torch.stack(got[slot]),
                k1_ref, f32_ref)

        n = SERVE_WRAP_PROMPT
        seq = torch.randint(0, cfg.vocab_size, (n + SERVE_WRAP_STEPS,),
                            generator=gen, device="cuda")
        padded = torch.zeros(engine.bucket_for(n), dtype=torch.long,
                             device="cuda")
        padded[:n] = seq[:n]
        prefill_logits(cfg, engine.weights, engine.cache, padded, n, 2)
        wrapped = []
        for t in range(SERVE_WRAP_STEPS):
            logits = decode_logits(cfg, engine.weights, engine.cache,
                                   *pool_inputs(S, {2: (seq[n + t], n + t)}))
            if n + t >= C:
                wrapped.append(logits[2])
        rows = engine.cache.pos[2]
        if int(rows.min()) != n + SERVE_WRAP_STEPS - C or \
                int(rows.max()) != n + SERVE_WRAP_STEPS - 1:
            raise SystemExit(f"serve: the wrapped ring holds positions "
                             f"{int(rows.min())}..{int(rows.max())}")
        # every token of the sequence attended the C positions up to its
        # own (the ring's content when it was decoded): a sliding window
        # of C keys over the whole sequence
        reset_launches()
        k1_ref = windowed_forward(cfg, bf16, seq[None], C, k1_attend)
        k1 = launch_counts()["flash_fwd"]
        if k1 != cfg.n_layers:
            raise SystemExit(f"serve: the windowed K1 forward launched K1 "
                             f"{k1} times, want {cfg.n_layers}")
        f32_ref = windowed_forward(cfg32, f32, seq[None], C, plain_attend)
        out["wrap"] = noise_gate(
            f"wrap-around: {len(wrapped)} steps past capacity {C} against "
            f"the forward with a {C}-key sliding window",
            torch.stack(wrapped), k1_ref[0, C:], f32_ref[0, C:])
    return out


def serve_requests(cfg, n, prompt_range, new_range, seed):
    """Seeded greedy requests with lengths and budgets drawn in range."""
    from dlrover_tpu_torch.serving.scheduler import ServeRequest

    rs = np.random.RandomState(seed)
    return [ServeRequest(
        request_id=f"r{i}",
        prompt=rs.randint(0, cfg.vocab_size,
                          rs.randint(*prompt_range)).tolist(),
        max_new_tokens=int(rs.randint(*new_range)), temperature=0.0)
        for i in range(n)]


def run_batch(engine, requests, rng_seed=0):
    """The requests through a ContinuousBatchingScheduler on ``engine``:
    {id: tokens}, the slot each took, the overlap high water, the
    seconds and the generated tokens."""
    from dlrover_tpu_torch.serving.scheduler import (
        ContinuousBatchingScheduler,
        ServeRequest,
    )

    slots = {}
    admit = engine.admit

    def recording_admit(slot, prompt, rng, temperature):
        slots[tuple(prompt)] = slot
        return admit(slot, prompt, rng, temperature)

    engine.admit = recording_admit
    sched = ContinuousBatchingScheduler(engine, rng_seed=rng_seed)
    for r in requests:
        sched.submit(ServeRequest(**r.to_payload()))
    done = {}
    t0 = time.perf_counter()
    try:
        while len(done) < len(requests):
            done.update({f.request_id: f.tokens for f in sched.step()})
    finally:
        engine.admit = admit
    seconds = time.perf_counter() - t0
    return (done, {r.request_id: slots[tuple(r.prompt)] for r in requests},
            sched.stats()["overlap_high_water"], seconds,
            sum(len(t) for t in done.values()))


def serve_alone(engine, request, slot) -> list:
    """One greedy request alone in ``slot`` of the same pool: admission,
    then graph-replayed steps with only that slot live."""
    S = engine.slots
    tok, _, pos = engine.admit(slot, request.prompt, 0, 0.0)
    out = [tok]
    while len(out) < request.max_new_tokens:
        tokens, positions, live = [0] * S, [0] * S, [False] * S
        tokens[slot], positions[slot], live[slot] = out[-1], pos, True
        nxt, _ = engine.step(tokens, positions, live, 0, [0.0] * S)
        out.append(int(nxt[slot]))
        pos += 1
    return out


def serve_times(engine, bf16) -> dict:
    """The decode step at 8 live slots and context 2048: graph replays
    (CUDA events) and the host's step (load, replay or eager run, read
    back), its bound (the weights a step reads, all but the embedding
    table, and the whole cache, over the HBM rate), and TTFT per prompt
    bucket (host clock around one admission)."""
    S, C = engine.slots, engine.capacity
    args = ([7 + s for s in range(S)], [C - 1 + s for s in range(S)],
            [True] * S, 0, [0.0] * S)
    engine.step(*args)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(SERVE_TIMED_STEPS):
        engine.replay()
    end.record()
    torch.cuda.synchronize()
    replay_ms = start.elapsed_time(end) / SERVE_TIMED_STEPS

    def host_ms(step):
        step(*args)
        t0 = time.perf_counter()
        for _ in range(SERVE_TIMED_STEPS // 2):
            step(*args)
        return (time.perf_counter() - t0) * 1e3 / (SERVE_TIMED_STEPS // 2)

    graph_host_ms = host_ms(engine.step)
    eager_host_ms = host_ms(engine.step_eager)
    profiled = profile_decode_step(engine, args)
    start.record()
    for _ in range(10):
        engine._decode_eager()
    end.record()
    torch.cuda.synchronize()
    eager_ms = start.elapsed_time(end) / 10
    weight_bytes = sum(t.numel() * t.element_size()
                       for k, t in bf16.items() if k != "embed")
    cache_bytes = sum(t.numel() * t.element_size()
                      for t in (engine.cache.k, engine.cache.v))
    bound_ms = (weight_bytes + cache_bytes) / PEAK_BYTES * 1e3
    ttft = {}
    gen = np.random.RandomState(SERVE_SEED)
    for b in sorted({engine.bucket_for(1 << i) for i in range(3, 12)}):
        prompt = gen.randint(0, engine.config.vocab_size, b).tolist()
        t0 = time.perf_counter()
        engine.admit(0, prompt, 0, 0.0)
        ttft[b] = (time.perf_counter() - t0) * 1e3
    return {"replay_ms": replay_ms, "eager_ms": eager_ms,
            "graph_step_host_ms": graph_host_ms,
            "eager_step_host_ms": eager_host_ms,
            "bound_ms": bound_ms, "bound_gb": (weight_bytes + cache_bytes)
            / 1e9, "weights_gb": weight_bytes / 1e9,
            "cache_gb": cache_bytes / 1e9, "ttft_ms_by_bucket": ttft,
            "profiled_eager_step": profiled}


def profile_decode_step(engine, args, top=12) -> dict:
    """Per-op device time of one eager decode step (the kernels the graph
    holds, without the graph), written to
    chiprun_out/profile_serve_step.txt; the first ``top`` rows are
    logged."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.step_eager(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.step_eager(*args)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    kernels = sum(e.count for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    table = averages.table(sort_by="cuda_time_total", row_limit=40)
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_serve_step.txt").write_text(table)
    log("  [serve] profile of one eager decode step (top rows, full table "
        "in chiprun_out/profile_serve_step.txt):")
    for line in table.splitlines()[:top]:
        log("    " + line)
    return {"eager_wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_kernels": kernels}


def serve_phase() -> dict:
    """[serve]: llama3-8b at full width (32 layers, dim 4096, 32 heads
    over 8 kv heads of 128, mlp 14336, vocab 128256, rope_theta 5e5),
    weights drawn from a seed on the card and held in bf16, in
    ``DecodeEngine(slots=8, capacity=2048)`` warmed up (every bucket,
    the decode step captured). Gates: (a) and (c) of
    :func:`serve_logit_checks`; (b) 24 seeded greedy requests (prompts
    16-1500 tokens, 32-256 new) through the continuous-batching
    scheduler, at least 2 in one decode step, each request's tokens
    bit-equal to the same request served alone in the same slot of the
    same pool. Numbers: the step's ms (graph and eager), its bound,
    tokens/s, TTFT per bucket, peak memory."""
    from dlrover_tpu_torch.serving.engine import DecodeEngine

    t_phase = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    cfg = serve_config()
    t0 = time.perf_counter()
    f32, bf16 = drawn_params(cfg, SERVE_SEED, keep_f32=True)
    draw_s = time.perf_counter() - t0
    weights_gb = sum(t.numel() * 2 for t in bf16.values()) / 1e9
    engine = DecodeEngine(cfg, bf16, slots=SERVE_SLOTS,
                          capacity=SERVE_CAPACITY)
    if any(engine.weights["layers"][0][k].data_ptr()
           != bf16[f"layers.{k}"][0].data_ptr() for k in ("wq", "w_down")):
        raise SystemExit("serve: the engine copied bf16 weights")
    t0 = time.perf_counter()
    engine.warmup()
    warmup_s = time.perf_counter() - t0
    log(f"  [serve] llama3-8b: {weights_gb:.2f} GB of bf16 weights drawn "
        f"in {draw_s:.1f} s; warmup (buckets {sorted(engine._buckets)}, "
        f"decode graph captured: {engine.decode_traces()}) {warmup_s:.1f} s")
    checks = serve_logit_checks(cfg, f32, bf16, engine)
    del f32
    release()

    requests = serve_requests(cfg, SERVE_REQUESTS, (16, 1501), (32, 257),
                              SERVE_SEED)
    together, slots, overlap, batch_s, n_tokens = run_batch(engine,
                                                           requests)
    t0 = time.perf_counter()
    mismatched = [r.request_id for r in requests
                  if serve_alone(engine, r, slots[r.request_id])
                  != together[r.request_id]]
    alone_s = time.perf_counter() - t0
    ok = not mismatched and overlap >= 2
    log(f"  [serve] continuous batching: {len(requests)} requests, "
        f"{n_tokens} tokens in {batch_s:.2f} s ({n_tokens / batch_s:.1f} "
        f"tokens/s), overlap high water {overlap}; each alone in its slot "
        f"({alone_s:.1f} s): bit-equal {len(requests) - len(mismatched)}/"
        f"{len(requests)} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit(f"serve batching check failed: overlap {overlap}, "
                         f"mismatched {mismatched}")
    times = serve_times(engine, bf16)
    report = {
        "model": "llama3-8b", "slots": SERVE_SLOTS,
        "capacity": SERVE_CAPACITY, "weights_gb": weights_gb,
        "decode_step_graph_replay_ms": times["replay_ms"],
        "decode_step_eager_ms": times["eager_ms"],
        "decode_step_host_ms_graph": times["graph_step_host_ms"],
        "decode_step_host_ms_eager": times["eager_step_host_ms"],
        "decode_step_bound_ms": times["bound_ms"],
        "decode_step_bound_gb": times["bound_gb"],
        "decode_tokens_per_s_at_8_slots": SERVE_SLOTS * 1e3
        / times["graph_step_host_ms"],
        "batch_tokens_per_s": n_tokens / batch_s,
        "batch_requests": len(requests), "batch_tokens": n_tokens,
        "batch_s": batch_s, "overlap_high_water": overlap,
        "ttft_ms_by_bucket": times["ttft_ms_by_bucket"],
        "profiled_eager_step": times["profiled_eager_step"],
        "checks": checks, "warmup_s": warmup_s,
        "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
        "phase_s": time.perf_counter() - t_phase, "card": CARD["line"],
    }
    log(json.dumps({"serve": report}))
    del engine, bf16
    release()
    return report


# -------------------------------------------------------- [serve-pool]

POOL_WORKERS = 2
POOL_REQUESTS = 64
POOL_RATE_HZ = 8.0
POOL_SLOTS = 8
POOL_CAPACITY = 1024
POOL_SEED = 7
POOL_KILL_RANK = 1
POOL_KILL_AFTER_DONE = 16
POOL_TIMEOUT_S = 150
POOL_DIR = ROOT / "_serve_pool"


def pool_config():
    from dlrover_tpu_torch.models import PRESETS

    return dataclasses.replace(PRESETS["nano-350m"], remat=False)


def pool_engine():
    from dlrover_tpu_torch.serving.engine import DecodeEngine

    cfg = pool_config()
    engine = DecodeEngine(cfg, drawn_params(cfg, POOL_SEED),
                          slots=POOL_SLOTS, capacity=POOL_CAPACITY)
    engine.warmup()
    return engine


def write_json(path, obj) -> None:
    tmp = f"{path}.tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f)
    os.replace(tmp, path)


def serve_worker(spec: dict) -> int:
    """A [serve-pool] decode worker process: a warmed nano-350m engine
    under a DecodeWorker over RpcServingClient, in the decode-pool
    rendezvous group of the master at ``spec["addr"]``. Appends each
    finished sequence to ``spec["out"]`` and rewrites its scheduler's
    stats in ``spec["stats"]`` every 50 ms; stops when ``spec["stop"]``
    exists."""
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.serving.worker import DecodeWorker, RpcServingClient

    rank = int(spec["rank"])
    engine = pool_engine()
    worker = DecodeWorker(
        RpcServingClient(MasterClient(spec["addr"], rank, "decode"), rank),
        engine, rank)
    worker.start()
    write_json(spec["ready"], {"pid": os.getpid()})
    written = 0

    def flush(f):
        nonlocal written
        fins = worker.finished[written:]
        for fin in fins:
            f.write(json.dumps({"request_id": fin.request_id,
                                "tokens": fin.tokens, "ttft_s": fin.ttft_s,
                                "latency_s": fin.latency_s}) + "\n")
        written += len(fins)
        f.flush()
        write_json(spec["stats"], worker.scheduler.stats())

    with open(spec["out"], "a") as f:
        while not os.path.exists(spec["stop"]):
            flush(f)
            time.sleep(0.05)
        worker.stop()
        flush(f)
    return 0


def read_jsonl(path) -> list:
    if not os.path.exists(path):
        return []
    with open(path) as f:
        return [json.loads(line) for line in f if line.strip()]


def read_json(path):
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def serve_pool_phase() -> dict:
    """[serve-pool]: ``python -m dlrover_tpu_torch.master.main --platform
    local --port 0``, two decode worker processes on the card (each a
    DecodeWorker over RpcServingClient with a nano-350m engine at full
    width, bf16, 8 slots of 1024), a seeded Poisson sweep of 64 requests
    (prompts 16-512, 16-128 new tokens, greedy) through
    ``MasterClient.serve_submit``, worker 1 SIGKILLed mid-sweep while it
    holds requests. Gates: every request fetched ``done`` with the
    tokens a reference engine in this process (same weights, same pool
    shape) gives it; the ledger's done count 64, failed 0, at most 2
    attempts, at least one re-queue; overlap >= 2; no CUDA context
    beyond this process's once the workers are gone. Every process and
    file is removed at the end, also when a check fails."""
    import shutil
    import signal
    import threading

    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.common.ipc import SOCKET_DIR_ENV
    from dlrover_tpu_torch.serving import loadgen

    t_phase = time.perf_counter()
    shutil.rmtree(POOL_DIR, ignore_errors=True)
    POOL_DIR.mkdir(parents=True)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    env[SOCKET_DIR_ENV] = str(POOL_DIR / "socks")
    procs = []
    try:
        baseline = len(compute_apps())
        addr_file = POOL_DIR / "addr"
        with open(POOL_DIR / "master.log", "wb") as master_log:
            master = subprocess.Popen(  # noqa: S603
                [sys.executable, "-m", "dlrover_tpu_torch.master.main",
                 "--platform", "local", "--port", "0", "--node_num", "1",
                 "--addr-file", str(addr_file)],
                env=env, stdout=master_log, stderr=subprocess.STDOUT,
                cwd=ROOT)
        procs.append(master)
        deadline = time.time() + 60
        while not addr_file.exists():
            if master.poll() is not None or time.time() > deadline:
                raise SystemExit("serve-pool: the master did not start")
            time.sleep(0.05)
        addr = addr_file.read_text().strip()
        specs = []
        for rank in range(POOL_WORKERS):
            spec = {name: str(POOL_DIR / f"{name}{rank}") for name in
                    ("out", "stats", "stop", "ready")}
            spec.update(rank=rank, addr=addr)
            specs.append(spec)
            with open(POOL_DIR / f"worker{rank}.log", "wb") as wlog:
                procs.append(subprocess.Popen(  # noqa: S603
                    [sys.executable, str(ROOT / "chip_smoke.py"),
                     "--serve-worker", json.dumps(spec)],
                    env=env, stdout=wlog, stderr=subprocess.STDOUT,
                    cwd=ROOT))
        workers = procs[1:]
        t0 = time.perf_counter()
        while not all(os.path.exists(s["ready"]) for s in specs):
            if any(w.poll() is not None for w in workers) or \
                    time.perf_counter() - t0 > 180:
                raise SystemExit("serve-pool: a worker did not start: " + (
                    POOL_DIR / "worker0.log").read_text()[-2000:])
            time.sleep(0.1)
        start_s = time.perf_counter() - t0
        log(f"  [serve-pool] master at {addr}, {POOL_WORKERS} workers warm "
            f"after {start_s:.1f} s")

        cfg = pool_config()
        requests = loadgen.make_requests(
            POOL_REQUESTS, cfg.vocab_size, prompt_len_range=(16, 512),
            seed=POOL_SEED)
        rs = np.random.RandomState(POOL_SEED)
        for req in requests:
            req["max_new_tokens"] = int(rs.randint(16, 129))
        arrivals = loadgen.poisson_arrivals(POOL_REQUESTS, POOL_RATE_HZ,
                                            seed=POOL_SEED)
        submitter_client = MasterClient(addr, 0, "client")
        status_client = MasterClient(addr, 0, "client")
        submitted = []
        submitter = threading.Thread(target=lambda: submitted.append(
            loadgen.run_open_loop(lambda p: submitter_client.serve_submit(
                **p), requests, arrivals)), daemon=True)
        t_sweep = time.monotonic()
        submitter.start()
        killed, counts = None, {}
        deadline = time.monotonic() + POOL_TIMEOUT_S
        while time.monotonic() < deadline:
            counts = status_client.serve_status()["counts"]
            if killed is None and counts["done"] >= POOL_KILL_AFTER_DONE:
                stats = read_json(specs[POOL_KILL_RANK]["stats"]) or {}
                if stats.get("live", 0) > 0:
                    victim = workers[POOL_KILL_RANK]
                    victim.send_signal(signal.SIGKILL)
                    victim.wait(30)
                    killed = {"at_s": time.monotonic() - t_sweep,
                              "done_before": counts["done"],
                              "live_in_victim": stats["live"]}
                    log(f"  [serve-pool] SIGKILLed worker {POOL_KILL_RANK} "
                        f"at {killed['at_s']:.2f} s into the sweep, "
                        f"holding {stats['live']} live request(s)")
            if submitted and counts["done"] + counts["failed"] >= \
                    POOL_REQUESTS:
                break
            time.sleep(0.05)
        wall_s = time.monotonic() - t_sweep
        open(specs[0]["stop"], "w").close()
        workers[0].wait(60)
        gone = time.perf_counter()
        contexts = len(compute_apps())
        while contexts > baseline and time.perf_counter() - gone < 15:
            time.sleep(0.5)
            contexts = len(compute_apps())

        status = status_client.serve_status()
        counts = status["counts"]
        fetched = {r["request_id"]: status_client.serve_fetch(
            r["request_id"]) for r in requests}
        finished = [rec for s in specs for rec in read_jsonl(s["out"])]
        stats = [read_json(s["stats"]) or {} for s in specs]
        overlap = max(s.get("overlap_high_water", 0) for s in stats)

        from dlrover_tpu_torch.serving.scheduler import ServeRequest

        ref_engine = pool_engine()
        want, _slots, _o, ref_s, _n = run_batch(
            ref_engine, [ServeRequest.from_payload(r) for r in requests])
        del ref_engine
        release()
        wrong = sorted(rid for rid, res in fetched.items()
                       if res.state != "done"
                       or list(res.tokens) != want[rid])
        keys = loadgen.summarize(len(requests), finished, wall_s)
        keys["serve_goodput_pct"] = counts["done"] / len(requests) * 100
        report = {
            "submitted": submitted[0] if submitted else 0,
            "counts": counts, "workers": status.get("workers"),
            "killed": killed, "overlap_high_water": overlap,
            "exit_codes": [w.returncode for w in workers],
            "contexts_after": contexts, "contexts_baseline": baseline,
            "workers_start_s": start_s, "sweep_s": wall_s,
            "reference_s": ref_s, **keys,
        }
        failures = []
        if killed is None:
            failures.append("the kill never landed on a serving worker")
        if counts.get("done") != POOL_REQUESTS or counts.get("failed"):
            failures.append(f"ledger {counts}")
        if counts.get("max_attempts_seen", 0) > 2:
            failures.append("a request was leased more than twice")
        if killed is not None and counts.get("requeued_total", 0) < 1:
            failures.append("nothing was re-queued after the kill")
        if overlap < 2:
            failures.append(f"overlap {overlap}")
        if wrong:
            failures.append(f"tokens or state wrong for {wrong}")
        if workers[0].returncode != 0:
            failures.append(f"worker 0 exit {workers[0].returncode}")
        if contexts > baseline:
            failures.append(f"{contexts} CUDA contexts after the workers, "
                            f"{baseline} before")
        report["phase_s"] = time.perf_counter() - t_phase
        report["card"] = CARD["line"]
        log(json.dumps({"serve_pool": report}))
        log(f"  [serve-pool] {len(requests) - len(wrong)}/{len(requests)} "
            f"requests done with the reference engine's tokens "
            f"{'ok' if not failures else 'FAIL: ' + '; '.join(failures)}")
        if failures:
            for path in sorted(POOL_DIR.glob("*.log")):
                log(f"  [serve-pool] {path.name} (tail):\n"
                    + path.read_text(errors="replace")[-3000:])
            raise SystemExit(f"serve-pool failed: {failures}")
        return report
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
            proc.wait(30)
        shutil.rmtree(POOL_DIR, ignore_errors=True)


# ---------------------------------------------------------------- [ppo]

PPO_B = 8
PPO_PROMPT = 128
PPO_NEW = 128
PPO_ITERATIONS = 2
PPO_SEED = 1


def ppo_phase() -> dict:
    """[ppo]: LMPPOTrainer on nano-350m at full width. Actor and ref: the
    port's Llama, bf16 compute over fp32 masters, ``attn_impl="flash"``,
    remat off; critic: an embedding and a linear value head. B=8 prompts
    of 128 tokens, 128 new tokens sampled at temperature 1.0, 2
    iterations of one PPO epoch (one update of the 8 rollouts each).
    Gates per iteration: ``make_experience`` launches K1 once per layer
    for each of the actor's and the ref's forwards and K2-K4 never, the
    update K1-K4 once per layer each (counts from 0 around each part);
    the rollout's logprobs equal log_softmax of the actor's teacher-
    forced K1 logits at the sampled tokens (what the buffer stores),
    within 2e-2 of the largest; finite stats; the actor's params moved.
    Numbers: rollout tokens/s, update ms, peak memory."""
    import torch.nn.functional as F

    from dlrover_tpu_torch.models import PRESETS, llama_apply, llama_init
    from dlrover_tpu_torch.rl import (
        LMPPOTrainer,
        ModelEngine,
        ModelSpec,
        PPOConfig,
    )
    from dlrover_tpu_torch.rl.generation import GenerateConfig

    t_phase = time.perf_counter()
    release()
    torch.cuda.reset_peak_memory_stats()
    cfg = dataclasses.replace(PRESETS["nano-350m"], remat=False)
    L = cfg.n_layers

    def llama(seed):
        return llama_init(cfg, seed=PPO_SEED, device="cuda")

    def apply(p, tokens):
        return llama_apply(cfg, p, tokens)

    def critic_init(seed):
        g = torch.Generator(device="cuda").manual_seed(seed)
        return {"emb": torch.randn(cfg.vocab_size, cfg.dim, generator=g,
                                   device="cuda") * 0.02,
                "w": torch.randn(cfg.dim, 1, generator=g,
                                 device="cuda") * 0.02}

    def critic_apply(p, tokens):
        return (F.embedding(tokens.long(), p["emb"]) @ p["w"])[..., 0]

    engine = ModelEngine({
        "actor": ModelSpec(llama, apply, trainable=True,
                           optimizer=lambda p: torch.optim.AdamW(
                               p.values(), lr=1e-5)),
        "critic": ModelSpec(critic_init, critic_apply, trainable=True,
                            optimizer=lambda p: torch.optim.AdamW(
                                p.values(), lr=1e-4)),
        "ref": ModelSpec(llama, apply),
    })
    trainer = LMPPOTrainer(
        engine, PPOConfig(ppo_epochs=1, train_batch_size=PPO_B),
        llama_config=cfg,
        score_fn=lambda seq, m: (seq[:, -m.shape[1]:] % 2 == 0).float()
        .mean(1),
        gen=GenerateConfig(max_new_tokens=PPO_NEW, temperature=1.0))
    rollouts = []
    generate = trainer.backend.generate

    def timed_generate(*args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = generate(*args)
        torch.cuda.synchronize()
        rollouts.append((res, time.perf_counter() - t0))
        return res

    trainer.backend.generate = timed_generate
    before = engine.actor["layers.wq"].detach().clone()
    rs = np.random.RandomState(PPO_SEED)
    iterations = []
    for it in range(PPO_ITERATIONS):
        prompts = {"tokens": rs.randint(0, cfg.vocab_size,
                                        (PPO_B, PPO_PROMPT))}
        trainer.buffer.reset()
        reset_launches()
        t0 = time.perf_counter()
        score = trainer.make_experience(prompts)
        torch.cuda.synchronize()
        exp_s = time.perf_counter() - t0
        exp_launches = launch_counts()
        res, gen_s = rollouts[-1]
        stored = torch.as_tensor(np.stack(
            [s["old_logprobs"] for s in trainer.buffer._samples]))
        abs_err, rel = rel_err(res.logprobs.cpu(), stored[:, PPO_PROMPT - 1:])
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = trainer.rl_training()
        torch.cuda.synchronize()
        update_ms = (time.perf_counter() - t0) * 1e3
        upd_launches = launch_counts()
        want_exp = {"flash_fwd": 2 * L, "flash_bwd_preprocess": 0,
                    "flash_bwd_dq": 0, "flash_bwd_dkv": 0}
        want_upd = {name: L for name in FLASH_KERNELS}
        finite = all(math.isfinite(float(v)) for v in stats.values())
        # and no other kernel
        strays = {k: v for counts in (exp_launches, upd_launches)
                  for k, v in counts.items() if v and k not in FLASH_KERNELS}
        ok = (all(exp_launches[k] == v for k, v in want_exp.items())
              and all(upd_launches[k] == v for k, v in want_upd.items())
              and not strays and rel <= PPO_LOGP_TOL and finite)
        rec = {"iteration": it, "mean_score": score,
               "rollout_s": gen_s,
               "rollout_tokens_per_s": PPO_B * PPO_NEW / gen_s,
               "experience_s": exp_s, "update_ms": update_ms,
               "logprob_max_abs_err": abs_err, "logprob_rel": rel,
               "make_experience_launches": {k: exp_launches[k]
                                            for k in want_exp},
               "update_launches": {k: upd_launches[k] for k in want_upd},
               "stats": {k: float(v) for k, v in stats.items()}}
        iterations.append(rec)
        log(f"  [ppo] iteration {it}: {json.dumps(rec)} "
            f"{'ok' if ok else 'FAIL'}")
        if not ok:
            raise SystemExit(f"ppo check failed at iteration {it}")
    moved = float((engine.actor["layers.wq"].detach() - before).abs().max())
    if not moved > 0:
        raise SystemExit("ppo: the actor's params did not move")
    report = {"model": "nano-350m", "B": PPO_B, "prompt": PPO_PROMPT,
              "new_tokens": PPO_NEW, "iterations": iterations,
              "actor_wq_max_change": moved,
              "peak_gib": torch.cuda.max_memory_allocated() / 2 ** 30,
              "phase_s": time.perf_counter() - t_phase,
              "card": CARD["line"]}
    log(json.dumps({"ppo": report}))
    del trainer, engine
    release()
    return report


# -------------------------------------------------------- [prof] [brain]
#
# the deep-profiling plane on the main training path: the Trainer's
# always-on device-time sampler and a deep capture the master triggers
# through the agent, and the brain service fed by the same run

PROF_SAMPLE_STEPS = 4
PROF_HEALTHY = 40          # steps at the full rate, the measured range
PROF_MAX_STEPS = 260       # the regressed run ends 2 steps after its ack
PROF_GEMMS = 200           # the injected regression: extra bf16 GEMMs a
PROF_GEMM_N = 8192         # step, ~1.1 TFLOP each (device time, matmul)
PROF_PROFILE_AT = PROF_HEALTHY + 1   # profile=True window: 2 steps
PROF_TIMEOUT_S = 420
PROF_KERNELS = ("flash_fwd", "flash_bwd_preprocess", "flash_bwd_dq",
                "flash_bwd_dkv")
PROF_WORKER = '''
"""[prof]'s worker: nano-350m (B8 S2048, bf16 over f32 masters, adamw,
remat none, flash attention: K1-K4) through Trainer on the card, under
the launcher. With ``gemms``, every step from ``healthy`` on first queues
that many bf16 GEMMs on the card (a device-side step-time regression);
the run ends 2 steps after the capture channel's ack. With ``profile``,
``profile=True`` captures 2 steps from there, and the worker then waits
for ``scraped`` (the agent's /metrics was read) before its last steps."""
import json, os, sys, time

import numpy as np
import torch

from dlrover_tpu_torch.models import PRESETS, llama_init, llama_loss_fn
from dlrover_tpu_torch.models import llama_logical_axes
from dlrover_tpu_torch.ops import launch_counts
from dlrover_tpu_torch.parallel import Strategy
from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

spec = json.loads(sys.argv[1])
cfg = PRESETS["nano-350m"]
B, S = spec["batch"], spec["seq"]


class Stream:
    """The example's stand-in corpus: seeded uniform tokens per step."""

    def __iter__(self):
        for i in range(10 ** 6):
            yield {"tokens": np.random.RandomState(i).randint(
                0, cfg.vocab_size, size=(B, S + 1), dtype=np.int32)}


args = TrainingArgs(
    output_dir=spec["out"], max_steps=spec["steps"], learning_rate=3e-4,
    strategy=Strategy(remat="none"), flash_checkpoint=False, log_steps=2,
    profile=bool(spec["profile"]), profile_start_step=spec["profile"] or 10,
    profile_num_steps=2)
trainer = Trainer(llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
                  llama_logical_axes(cfg), args, train_data=Stream(),
                  device="cuda")
if trainer._profiler is not None:
    trainer._profiler.require_ops = tuple(spec["kernels"])
n = spec["gemm_n"]
a, b, c = (torch.randn(n, n, device="cuda", dtype=torch.bfloat16)
           for _ in range(3))
ack = os.path.join(os.environ.get("DLROVER_PROF_CAPTURE_DIR", ""),
                   "capture_ack.json")
done = {"ack_step": None, "scraped": None}


def prestep(state, batch):
    step = trainer.global_step
    if spec["gemms"] and step >= spec["healthy"]:
        for _ in range(spec["gemms"]):
            torch.mm(a, b, out=c)
    if spec["gemms"] and done["ack_step"] is None and os.path.exists(ack):
        done["ack_step"] = step
        args.max_steps = step + 2
    prof = trainer._profiler
    if prof is not None and prof._done and done["scraped"] is None:
        t0 = time.time()
        while not os.path.exists(spec["scraped"]) and time.time() - t0 < 90:
            time.sleep(0.05)
        done["scraped"] = time.time() - t0
    return state, batch


trainer.prestep = prestep
trainer.train()
out = {"launches": launch_counts(), "ack_step": done["ack_step"],
       "scrape_wait_s": done["scraped"],
       "peak_bytes": torch.cuda.max_memory_allocated(),
       "sampling": trainer._prof.sampling_enabled,
       "window_costs": list(trainer._prof.window_costs),
       "first_window_cost_s": trainer._prof.first_window_cost_s,
       "last_window_cost_s": trainer._prof.last_window_cost_s,
       "last_gap": trainer._prof.last_gap,
       "step_ewma_s": trainer._prof.step_ewma_s,
       "profile_ops": (trainer._profiler.assert_ops_present(
           tuple(spec["kernels"])) if trainer._profiler else None)}
trainer.close()
with open(spec["result"], "w") as f:
    json.dump(out, f)
'''


class HttpWatch:
    """Polls, while a run goes on, the master's /captures.json and
    /metrics (its device-time gauges) and, where given, the agent's
    /metrics; ``feed`` is called with the worker's newest telemetry
    snapshot on each pass."""

    def __init__(self, master_http, tele_dir, agent_metrics=None,
                 feed=None):
        import threading

        self.master_http, self.tele_dir = master_http, tele_dir
        self.agent_metrics, self.feed = agent_metrics, feed
        self.captures: dict = {}
        self.optime: list = []
        self.agent_text = ""
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._loop, daemon=True)
        self._thread.start()

    @staticmethod
    def get(url) -> str | None:
        import urllib.request

        try:
            return urllib.request.urlopen(url, timeout=5).read().decode()
        except OSError:
            return None

    def _loop(self):
        while not self._stop.is_set():
            text = self.get(f"http://{self.master_http}/captures.json")
            if text:
                for rec in json.loads(text).get("captures", ()):
                    self.captures[rec["id"]] = rec
            text = self.get(f"http://{self.master_http}/metrics")
            lines = [line for line in (text or "").splitlines()
                     if line.startswith("dlrtpu_device_optime_ms{")]
            if lines:
                self.optime = lines
            if self.agent_metrics:
                text = self.get(self.agent_metrics)
                if text and "dlrtpu_kernel_self_ms{" in text:
                    self.agent_text = text
            if self.feed is not None:
                snaps = [s for role, _src, s in
                         telemetry_snapshots(self.tele_dir)
                         if role == "worker"] if self.tele_dir.exists() else []
                if snaps:
                    self.feed(snaps[-1])
            self._stop.wait(0.5)

    def stop(self):
        self._stop.set()
        self._thread.join(timeout=60)


def prof_launch(run_tmp, label, spec_extra, env_extra, feed=None,
                agent_port=None, on_scraped=None) -> dict:
    """One launcher run of PROF_WORKER under a master of its own with its
    HTTP plane; returns what the run left: the worker's result, its log,
    its telemetry, the master's polled /captures.json and gauges."""
    import signal

    run_dir = run_tmp / label
    run_dir.mkdir()
    tele_dir, log_dir = run_dir / "telemetry", run_dir / "logs"
    script, result = run_dir / "prof_worker.py", run_dir / "result.json"
    script.write_text(PROF_WORKER)
    spec = {"out": str(run_dir / "out"), "result": str(result),
            "batch": 8, "seq": 2048, "healthy": PROF_HEALTHY,
            "gemm_n": PROF_GEMM_N, "kernels": list(PROF_KERNELS),
            "scraped": str(run_dir / "scraped"), "gemms": 0, "profile": 0,
            **spec_extra}
    env = dict(os.environ)
    for key in ("DLROVER_TPU_TORCH_SOCKET_DIR", "DLROVER_RUNTIME_METRICS_PATH",
                "DLROVER_PARAL_CONFIG_PATH", "DLROVER_MASTER_ADDR",
                "DLROVER_CHAOS"):
        env.pop(key, None)
    env.update({"TMPDIR": str(run_dir),
                "ELASTIC_JOB_NAME": os.environ["ELASTIC_JOB_NAME"] + label,
                "DLROVER_TELEMETRY_DIR": str(tele_dir),
                "DLROVER_PROBE_DISABLE": "1",
                "DLROVER_KERNEL_METRICS_PATH": str(run_dir / "kernels.json"),
                **env_extra})
    addr_file, master_log = run_dir / "master_addr", run_dir / "master.log"
    with open(master_log, "wb") as out:
        master = subprocess.Popen(
            [sys.executable, "-m", "dlrover_tpu_torch.master.main",
             "--port", "0", "--node_num", "1", "--http-port", "0",
             "--addr-file", str(addr_file)], cwd=str(ROOT),
            env=dict(env, DLROVER_TELEMETRY_ROLE="master"), stdout=out,
            stderr=subprocess.STDOUT)
    proc = watch = None
    try:
        t0 = time.perf_counter()
        while not (addr_file.exists() and "DLROVER_MASTER_HTTP=" in
                   master_log.read_text(errors="replace")):
            if master.poll() is not None or time.perf_counter() - t0 > 60:
                raise SystemExit(f"prof: the master never served:\n"
                                 f"{master_log.read_text()[-3000:]}")
            time.sleep(0.05)
        http = [line.split("=", 1)[1] for line in
                master_log.read_text().splitlines()
                if line.startswith("DLROVER_MASTER_HTTP=")][0]
        env["DLROVER_MASTER_ADDR"] = addr_file.read_text()
        cmd = [sys.executable, "-m", "dlrover_tpu_torch.trainer.run",
               "--nnodes", "1", "--nproc_per_node", "1", "--max-restarts",
               "0", "--log-dir", str(log_dir)]
        if agent_port is not None:
            cmd += ["--metrics-port", str(agent_port)]
        agent_metrics = (f"http://127.0.0.1:{agent_port}/metrics"
                         if agent_port is not None else None)
        t_run = time.perf_counter()
        with open(run_dir / "tpu_run.log", "wb") as out:
            proc = subprocess.Popen(
                cmd + [str(script), json.dumps(spec)], cwd=str(ROOT),
                env=env, stdout=out, stderr=subprocess.STDOUT,
                start_new_session=True)
        watch = HttpWatch(http, tele_dir, agent_metrics, feed)
        deadline = time.perf_counter() + PROF_TIMEOUT_S
        while proc.poll() is None and time.perf_counter() < deadline:
            if on_scraped is not None and watch.agent_text and not (
                    run_dir / "scraped").exists():
                on_scraped(watch.agent_text)
                (run_dir / "scraped").touch()
            time.sleep(0.2)
        rc = proc.poll()
        run_s = time.perf_counter() - t_run
    finally:
        if watch is not None:
            watch.stop()
        if proc is not None:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
            proc.wait()
        if master.poll() is None:
            master.terminate()
        try:
            master.wait(timeout=20)
        except subprocess.TimeoutExpired:
            master.kill()
            master.wait()
    text = (run_dir / "tpu_run.log").read_text(errors="replace")
    worker_logs = sorted(log_dir.glob("worker_*.log"))
    wlog = worker_logs[0].read_text(errors="replace") if worker_logs else ""
    log(f"  [prof] {label}: tpu-run exit {rc} after {run_s:.1f} s")
    if rc != 0:
        for line in (text.splitlines()[-20:] + wlog.splitlines()[-40:]):
            log(f"    {line[:240]}")
        raise SystemExit(f"prof: {label} run exited {rc}, want 0")
    snaps = [s for role, _src, s in telemetry_snapshots(tele_dir)
             if role == "worker"]
    run = {"result": json.loads(result.read_text()), "worker_log": wlog,
           "agent_log": text, "snap": snaps[-1] if snaps else {},
           "captures": dict(watch.captures), "optime": list(watch.optime),
           "agent_text": watch.agent_text, "tele_dir": tele_dir,
           "master_log": master_log.read_text(errors="replace"),
           "run_s": run_s}
    if not snaps:
        raise SystemExit(f"prof: {label} left no worker telemetry")
    return run


def step_wall_s(snap, first: int, last: int) -> float:
    """Wall time from the end of step ``first`` to the end of step
    ``last`` (``step.end`` events): the steps in between and everything
    the loop did between them, the sampler's windows included."""
    ends = {e["step"]: e["t"] for e in events(snap, "step.end")}
    if first not in ends or last not in ends:
        raise SystemExit(f"prof: no step.end events for steps {first} and "
                         f"{last}: {sorted(ends)[:5]}..{sorted(ends)[-5:]}")
    return ends[last] - ends[first]


def kernel_rows(ops) -> dict:
    """K1-K4's rows of a window's top kernels: {name: {ms, calls}}."""
    rows = {}
    for name in PROF_KERNELS:
        pattern = re.compile(rf"\b{name}_kernel\b")
        found = [o for o in ops if pattern.search(o["op"])]
        if found:
            rows[name] = {"ms": sum(o["ms"] for o in found),
                          "calls": sum(o["calls"] for o in found)}
    return rows


def prof_phase() -> dict:
    """[prof]: the deep-profiling plane on the main path, nano-350m at
    full width (B8 S2048, bf16, K1-K4) under the launcher twin, a master
    of its own with its HTTP plane, and the agent. Two runs of
    PROF_WORKER: the first with ``DLROVER_PROF_SAMPLE_STEPS=0`` (no
    sampling) and ``profile=True`` over 2 steps after the measured range,
    whose ``StepProfiler.assert_ops_present`` must find K1-K4 and whose
    top kernels the agent's /metrics must serve as
    ``dlrtpu_kernel_self_ms``; the second with
    ``DLROVER_PROF_SAMPLE_STEPS=4`` (the governor at its default 2 %):
    every sampled window's categories and K1-K4 by name (ms, calls) from
    the worker's ``device-time sample`` lines, each window's cost and
    legs (the first, cold, apart), and the sampler's overhead over steps
    2 to 40 against the first run's; then from step 41 a device-side
    regression (PROF_GEMMS extra bf16 GEMMs a step) that the master
    must turn into a capture directive, the agent relay, the worker
    capture for 2 steps and /captures.json show done, with an artifact
    whose merged timeline holds the host spans and K1-K4's CUDA kernels
    and whose attribution names matmul against the stored baseline. The
    brain service runs beside the second run (see ``brain_phase``)."""
    import shutil
    import tempfile

    from dlrover_tpu_torch.common.rpc import find_free_port

    card = CARD["line"]
    release()
    run_tmp = Path(tempfile.mkdtemp(prefix="dlprof"))
    t_phase = time.perf_counter()
    brain = BrainFeeder(run_tmp)
    try:
        scraped = {}

        def on_scraped(text):
            scraped["lines"] = [line for line in text.splitlines()
                                if line.startswith("dlrtpu_kernel_self_ms{")]

        off = prof_launch(
            run_tmp, "off", {"steps": PROF_PROFILE_AT + 3,
                             "profile": PROF_PROFILE_AT},
            {"DLROVER_PROF_SAMPLE_STEPS": "0"},
            agent_port=find_free_port("127.0.0.1"), on_scraped=on_scraped)
        on = prof_launch(
            run_tmp, "on", {"steps": PROF_MAX_STEPS, "gemms": PROF_GEMMS},
            {"DLROVER_PROF_SAMPLE_STEPS": str(PROF_SAMPLE_STEPS)},
            feed=brain.feed)
        report = prof_checks(off, on, scraped, card)
        report["brain"] = brain_phase(brain, on)
    finally:
        brain.stop()
        for label in ("off", "on"):
            unlink_segments(os.environ["ELASTIC_JOB_NAME"] + label)
        shutil.rmtree(run_tmp, ignore_errors=True)
        log(f"  [prof] cleanup: removed {run_tmp}")
    report["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"prof": report}))
    return report


def prof_checks(off, on, scraped, card) -> dict:
    """The [prof] gates and figures over the two runs."""
    want_launch = {name: 16 for name in PROF_KERNELS}
    for label, run in (("off", off), ("on", on)):
        res = run["result"]
        steps = max(e["step"] for e in events(run["snap"], "step.end"))
        if any(res["launches"].get(k, 0) != v * steps
               for k, v in want_launch.items()):
            raise SystemExit(f"prof: {label} launched {res['launches']} over "
                             f"{steps} steps, want 16 a step for K1-K4")
    # the profile=True window (first run): K1-K4 found, and served by
    # the agent's /metrics
    ops = off["result"]["profile_ops"]
    lines = scraped.get("lines") or []
    log(f"  [prof] profile=True: assert_ops_present found K1-K4 among "
        f"{ops} kernels; the agent's /metrics served "
        f"{len(lines)} dlrtpu_kernel_self_ms lines:")
    for line in lines[:8]:
        log(f"    {line[:200]}")
    # the agent serves the window's top 15 kernels (K4 leads the flash
    # kernels; K2's 0.5 ms a step is far down the table)
    if not ops or not any("flash_bwd_dkv_kernel" in line for line in lines):
        raise SystemExit("prof: the profile window's kernels are not on "
                         "the agent's /metrics")
    if off["result"]["window_costs"] or off["result"]["sampling"] is not False:
        raise SystemExit("prof: the run without sampling sampled")

    # the sampled windows (second run)
    res = on["result"]
    if not res["sampling"]:
        raise SystemExit("prof: sampling was off on the card")
    samples = [json.loads(line.split("device-time sample ", 1)[1])
               for line in on["worker_log"].splitlines()
               if "device-time sample " in line]
    windows = []
    for smp in samples:
        rows = kernel_rows(smp["top_ops"])
        windows.append({"step": smp["step"],
                        "categories_ms": smp["categories"],
                        "total_ms": smp["total_ms"],
                        "device_events": smp["device_events"],
                        "kernels": rows})
        log(f"  [prof] sampled window at step {smp['step']}: "
            f"{json.dumps(windows[-1])} ({card})")
        if "cuda" not in smp["activities"] or set(rows) != set(
                PROF_KERNELS):
            raise SystemExit(f"prof: window at step {smp['step']} saw "
                             f"{smp['activities']} and K1-K4 {sorted(rows)}")
    healthy = [w for w in windows if w["step"] < PROF_HEALTHY]
    if len(healthy) < 2:
        raise SystemExit(f"prof: {len(healthy)} sampled windows before the "
                         f"regression, want at least 2")
    costs = res["window_costs"]
    cold = [c for c in costs if c["cold"]]
    steady = [c for c in costs if not c["cold"]]
    log(f"  [prof] window costs (s, on the step thread): first (cold) "
        f"{json.dumps(cold)}; steady {json.dumps(steady)}; gap after the "
        f"last {res['last_gap']} steps at a step EWMA of "
        f"{res['step_ewma_s']:.4f} s ({card})")
    if len(cold) != 1 or not steady:
        raise SystemExit(f"prof: window costs {costs}")
    wall_off = step_wall_s(off["snap"], 2, PROF_HEALTHY)
    wall_on = step_wall_s(on["snap"], 2, PROF_HEALTHY)
    in_range = [c for c in costs if c["step"] < PROF_HEALTHY]
    overhead = {
        "steps": f"2..{PROF_HEALTHY}", "wall_s_sampling_off": wall_off,
        "wall_s_sampling_on": wall_on,
        "overhead_pct": (wall_on - wall_off) / wall_off * 100,
        "windows_in_range": len(in_range),
        "window_cost_s_in_range": sum(c["cost_s"] for c in in_range),
        "cold_window_cost_s": cold[0]["cost_s"],
        "overhead_pct_without_the_cold_window":
            (wall_on - wall_off - cold[0]["cost_s"]) / wall_off * 100,
        "window_cost_pct_of_wall": sum(c["cost_s"] for c in in_range)
        / wall_on * 100,
    }
    log(f"  [prof] sampler overhead {json.dumps(overhead)} ({card})")

    # the regression -> directive -> relay -> capture -> /captures.json
    done = [r for r in on["captures"].values() if r.get("state") == "done"]
    mlog = on["master_log"]
    for line in mlog.splitlines():
        if any(k in line for k in ("SLO breach step_time", "deep capture")):
            log(f"    master: {line.strip()[:220]}")
    if len(done) != 1 or res["ack_step"] is None:
        raise SystemExit(f"prof: captures {on['captures']}, worker saw the "
                         f"ack at step {res['ack_step']}")
    rec = done[0]
    # the directive reached the worker only through the agent's relay
    # into its capture channel; the agent's own event where it flushed it
    begun = [e for e in events(on["snap"], "prof.capture.begin")
             if e.get("capture") == rec["id"]]
    relayed = [e for role, _src, s in telemetry_snapshots(on["tele_dir"])
               if role == "agent"
               for e in events(s, "prof.capture.dispatch")]
    log(f"  [prof] relay: agent {json.dumps(relayed)}, worker "
        f"{json.dumps(begun)}")
    if len(begun) != 1:
        raise SystemExit(f"prof: the worker began {begun}")
    summary = rec.get("summary") or {}
    log(f"  [prof] /captures.json: " + json.dumps(
        {k: rec.get(k) for k in ("id", "rank", "state", "reason",
                                 "requested_t", "done_t", "artifact")}))
    if "slo:step_time_regression" not in rec.get("reason", ""):
        raise SystemExit(f"prof: capture reason {rec.get('reason')}")
    if summary.get("end_step", 0) - summary.get("start_step", 0) + 1 != 2 \
            or summary.get("steps") != 2:
        raise SystemExit(f"prof: the capture spans {summary}")
    attribution = summary.get("attribution") or []
    log(f"  [prof] capture: steps {summary['start_step']}-"
        f"{summary['end_step']}, categories {summary['categories']}, "
        f"attribution {json.dumps(attribution)} ({card})")
    matmul = [a for a in attribution if a["category"] == "matmul"]
    if not (matmul and (matmul[0]["delta_pct"] or 0) > 100):
        raise SystemExit(f"prof: the attribution does not name matmul: "
                         f"{attribution}")
    cap_rows = kernel_rows(summary.get("top_ops") or [])
    art = Path(rec["artifact"])
    with open(art / "timeline.perfetto.json") as f:
        timeline = json.load(f)["traceEvents"]
    host = {e["name"] for e in timeline if e.get("cat") == "host"}
    kernel_names = [e["name"] for e in timeline if e.get("cat") == "kernel"]
    found = {name: sum(1 for k in kernel_names
                       if re.search(rf"\b{name}_kernel\b", k))
             for name in PROF_KERNELS}
    log(f"  [prof] artifact {sorted(os.listdir(art))}: "
        f"{len(timeline)} timeline events, host spans "
        f"{sorted(host)[:8]}, CUDA kernel events {len(kernel_names)}, "
        f"K1-K4 events {found}; capture's K1-K4 rows {json.dumps(cap_rows)}")
    if "train.step" not in host or not all(found.values()) or \
            set(cap_rows) != set(PROF_KERNELS):
        raise SystemExit("prof: the capture artifact lacks the host spans "
                         "or K1-K4's kernel events")
    regress = events(on["snap"], "device.optime.regression")
    log(f"  [prof] device.optime.regression events {json.dumps(regress)}; "
        f"master /metrics device-time gauges: {on['optime'][:6]}")
    if not on["optime"]:
        raise SystemExit("prof: the master's /metrics has no "
                         "dlrtpu_device_optime_ms")
    return {"card": card, "config": "nano-350m", "batch": 8, "seq": 2048,
            "sample_steps": PROF_SAMPLE_STEPS, "windows": windows,
            "window_costs": costs, "overhead": overhead,
            "capture": {"id": rec["id"], "steps": [summary["start_step"],
                                                   summary["end_step"]],
                        "categories": summary["categories"],
                        "attribution": attribution,
                        "kernels": cap_rows,
                        "ack_step": res["ack_step"]},
            "profile_window_ops": ops,
            "run_s": {"off": off["run_s"], "on": on["run_s"]},
            "peak_gib": res["peak_bytes"] / 2 ** 30}


class BrainFeeder:
    """The brain service (``python -m dlrover_tpu_torch.brain.main``) in a
    process of its own, and a BrainClient that persists a runtime record
    of a run each time it is fed a newer step of the worker's telemetry:
    its tokens/s, its step, the card's peak memory."""

    JOB = ("prof-run", "nano-350m-b8-s2048")

    def __init__(self, run_tmp):
        from dlrover_tpu_torch.brain import BrainClient

        self.log_path = run_tmp / "brain.log"
        with open(self.log_path, "wb") as out:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "dlrover_tpu_torch.brain.main",
                 "--port", "0", "--db", str(run_tmp / "brain.sqlite")],
                cwd=str(ROOT), stdout=out, stderr=subprocess.STDOUT)
        t0 = time.perf_counter()
        self.addr = None
        while self.addr is None:
            for line in self.log_path.read_text().splitlines():
                if line.startswith("DLROVER_BRAIN_ADDR="):
                    self.addr = line.split("=", 1)[1]
            if self.proc.poll() is not None or time.perf_counter() - t0 > 60:
                raise SystemExit(f"brain: never served:\n"
                                 f"{self.log_path.read_text()[-2000:]}")
            time.sleep(0.05)
        self.start_s = time.perf_counter() - t0
        self.client = BrainClient(self.addr)
        self.persisted: list = []
        self._last_step = 0

    def feed(self, snap):
        ends = events(snap, "step.end")
        gauges = {g["name"]: g["value"] for g in snap.get("gauges", ())}
        if not ends or ends[-1]["step"] <= self._last_step or \
                "train.tokens_per_s" not in gauges:
            return
        self._last_step = ends[-1]["step"]
        rec = {"worker_count": 1, "status": "running",
               "global_step": self._last_step,
               "speed": gauges["train.tokens_per_s"],
               "used_memory_mb": gauges.get("device.hbm.peak_bytes", 0)
               / 2 ** 20}
        if self.client.persist_metrics(*self.JOB, rec):
            self.persisted.append(rec)

    def stop(self):
        self.client.close()
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            self.proc.wait(timeout=20)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()


BRAIN_STEPS = 8


def brain_phase(brain, on) -> dict:
    """[brain]: the plans of the brain service fed by [prof]'s second run
    (``worker_resource``: the peak memory with headroom;
    ``job_completion``: steps/s and the time to step PROF_MAX_STEPS), and
    a BrainReporter on a dead address beside BRAIN_STEPS steps of
    nano-350m: every step runs, none stalls, the client degrades to
    instant no-ops. The brain is host code: this leg shows only that it
    takes a card run's figures."""
    from dlrover_tpu_torch.brain import BrainClient, BrainReporter
    from dlrover_tpu_torch.common import retry
    from dlrover_tpu_torch.common.rpc import find_free_port
    from dlrover_tpu_torch.models import PRESETS, llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.trainer import build_optimizer

    card = CARD["line"]
    log(f"  [brain] serving at {brain.addr} (up in {brain.start_s:.2f} s), "
        f"{len(brain.persisted)} records persisted from the run: first "
        f"{json.dumps(brain.persisted[:1])}, last "
        f"{json.dumps(brain.persisted[-1:])}")
    records = brain.client.get_job_metrics(brain.JOB[0])
    plans = {
        "worker_resource": brain.client.optimize(*brain.JOB,
                                                 "worker_resource"),
        "job_completion": brain.client.optimize(
            *brain.JOB, "job_completion", {"max_steps": PROF_MAX_STEPS}),
    }
    log(f"  [brain] plans {json.dumps(plans)} ({card})")
    peak = max(r["used_memory_mb"] for r in brain.persisted)
    if len(records) != len(brain.persisted) or len(records) < 3 or \
            plans["worker_resource"] != {"memory_mb": int(peak * 1.4)} or \
            not (plans["job_completion"] or {}).get("steps_per_second"):
        raise SystemExit(f"brain: {len(records)} records, plans {plans}")

    # a dead brain beside a training loop
    release()
    cfg = PRESETS["nano-350m"]
    res = auto_accelerate(llama_loss_fn(cfg), lambda s, d: llama_init(
        cfg, s, d), build_optimizer("adamw", SLICE_LR), Strategy(
        remat="none"), device="cuda", seed=0)
    state, batch = res.state, synthetic_batch(cfg.vocab_size, 2048, 8, 0)
    retry.set_default_rpc_policy(retry.RetryPolicy(
        max_attempts=1, base_delay=0.01, deadline=0.5, jitter=False))
    try:
        dead = BrainClient(f"127.0.0.1:{find_free_port('127.0.0.1')}")
        reporter = BrainReporter(dead, "dead", "dead", interval=0.05)

        def steps(n):
            out = []
            for _ in range(n):
                t0 = time.perf_counter()
                res.train_step(state, batch, None)
                torch.cuda.synchronize()
                out.append((time.perf_counter() - t0) * 1e3)
            return out

        steps(2)
        alone = steps(BRAIN_STEPS)
        reporter.start()
        beside = steps(BRAIN_STEPS)
        reporter.stop()
        t0 = time.perf_counter()
        noop = (dead.persist_metrics("u", "j", {}),
                dead.optimize("u", "j", "cold_create"))
        noop_ms = (time.perf_counter() - t0) * 1e3
        dead.close()
    finally:
        retry.set_default_rpc_policy(None)
    dead_leg = {"step_ms_alone": alone, "step_ms_beside_dead_reporter":
                beside, "median_ratio": statistics.median(beside)
                / statistics.median(alone), "degraded": dead.degraded,
                "noop_calls_ms": noop_ms}
    log(f"  [brain] dead address: {json.dumps(dead_leg)} ({card})")
    if not dead.degraded or noop != (False, None) or noop_ms > 50 or \
            max(beside) > 2 * statistics.median(alone):
        raise SystemExit(f"brain: the dead client {dead_leg}")
    del res, state
    release()
    return {"records": len(records), "plans": plans, "dead_address": dead_leg}

def main() -> int:
    """All phases. The job's name keys its shm segments (the step
    timer's ring, which every Trainer feeds, and the checkpoint's): they
    are unlinked at the end, also when a phase fails."""
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2
    job = f"chipsmoke{os.getpid()}"
    os.environ["ELASTIC_JOB_NAME"] = job
    try:
        return run_phases()
    finally:
        gone = unlink_segments(job)
        if gone:
            log(f"cleanup: unlinked {gone}")


def run_phases() -> int:
    from dlrover_tpu_torch.ops import _build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"torch {torch.__version__} cuda {torch.version.cuda}")

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    CARD["line"] = smi.stdout.strip().splitlines()[0]
    print(CARD["line"], flush=True)

    # 2. build
    t0 = time.perf_counter()
    per_lib = _build.build()
    log(f"phase build: {time.perf_counter() - t0:.1f} s "
        f"(per library: {per_lib})")
    for name in _build.SOURCES:
        report = _build.library_path(name).with_suffix(".log")
        if report.exists():
            for line in report.read_text().splitlines():
                if "Used" in line or "spill" in line:
                    log(f"  {name}: {line.strip()}")

    # 3. kernels vs plain versions
    log("phase kernels:")
    worst: dict[str, float] = {}
    for i, (name, shape) in enumerate(SHAPES.items()):
        inputs = check_shape(name, shape, seed=i, worst=worst)
        heads = check_heads(name, shape, seed=i, worst=worst)
        if name == "slice":
            slice_inputs, slice_heads = inputs, heads
        del inputs, heads
    check_shape("masked", SHAPES["gqa"], 3, worst, **MASKED)
    check_heads("masked", SHAPES["gqa"], 3, worst, **MASKED)
    times, library, sdpa_bwd, prepass_ms = time_kernels(slice_inputs)
    heads_times, heads_library, sdpa_bwd_plain_ms = time_heads(slice_heads)
    times.update(heads_times)
    library.update(heads_library)
    del slice_inputs, slice_heads
    time_packing(SHAPES["gqa"])
    bound = bounds(SHAPES["slice"])

    log("phase ring kernels:")
    for i, (name, shape) in enumerate(RING_SHAPES.items()):
        inputs = check_ring(name, shape, 10 + i, worst)
        if name == "ring":
            ring_inputs = inputs
        del inputs
    # the kernels line carries the wholly visible block: six of the ten
    # blocks per layer of the [seq4] run, three quarters of their work
    for name, (ms, plain, b_ms, b_by, lib) in time_ring(
            ring_inputs)["visible"].items():
        times[name], bound[name] = (ms, plain), (b_ms, b_by)
        library[name] = lib
    del ring_inputs

    def bwd_sum(names):
        return sum(times[k][0] for k in ("flash_bwd_preprocess",) + names)

    log(json.dumps({"backward_at_slice_shape": {
        # K3's and K4's times each hold both rope pre-passes, which the
        # backward runs once for the two
        "port_bwd_ms": bwd_sum(("flash_bwd_dq", "flash_bwd_dkv"))
        - prepass_ms["flash_bwd_dq"],
        "sdpa_bwd_ms": sdpa_bwd,
        "port_bshd_bwd_ms": bwd_sum(("flash_bwd_dq_heads",
                                     "flash_bwd_dkv_heads")),
        "sdpa_bwd_ms_rope_free_views": sdpa_bwd_plain_ms}}))
    torch.cuda.empty_cache()

    # 3b. K1-K4 at head_dim 64 vs plain versions, and their times
    log("phase kernels-d64:")
    d64 = kernels_d64_phase()
    for acc, part in zip((worst, times, library, bound), d64):
        acc.update(part)

    # 4. optimizer kernels vs plain versions, and their times
    log("phase optimizer kernels:")
    opt_worst, opt_times, opt_library, opt_bound = optimizer_phase(
        slice_config())
    worst.update(opt_worst)
    times.update(opt_times)
    library.update(opt_library)
    bound.update(opt_bound)
    torch.cuda.empty_cache()

    # 5. the training slice through the kernels, once per optimizer
    log("phase slice:")
    launches = train_slice()
    release()

    # 5b. the GPT-2 family: gpt2-1.5b through Trainer, K1-K4 at head_dim 64
    log("phase gpt2:")
    gpt2_launches = gpt2_phase()
    launches.update({name + "_d64": gpt2_launches[name]
                     for name in FLASH_KERNELS})

    # 5c. serving and RL: llama3-8b in the slotted decode engine, decode
    # workers under the port's own master, PPO through K1-K4
    log("phase serve:")
    serve_phase()
    log("phase serve-pool:")
    serve_pool_phase()
    log("phase ppo:")
    ppo_phase()

    # 5d. the deep-profiling plane on the main path (its launches are the
    # workers', gated there), and the brain service fed by it
    log("phase prof:")
    prof_phase()

    # 6. kernel line, then the result line
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bound[name][0],
            "bound_by": bound[name][1], "library_ms": library.get(name),
        })
        if name in prepass_ms:  # its rope pre-passes, included in ms
            kernels[-1]["prepass_ms"] = prepass_ms[name]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ckpt-child"]:
        sys.exit(ckpt_child(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--serve-worker"]:
        sys.exit(serve_worker(json.loads(sys.argv[2])))
    sys.exit(main())
