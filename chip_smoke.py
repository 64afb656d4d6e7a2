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
   with a profiled step; ``[ulysses4]``: the same with
   ``attn_impl="ulysses"`` (the all-to-all regroups the 4 in-process
   shards into 4 head groups, K1-K4 once per group and layer: 4 a layer
   and step), losses within 2e-2 of adamw's; then the train step's other
   options:
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
   after; ``[mesh1-opt]``: on that mesh again, every optimizer (FusedAdamW
   bits 32 with a clip, K7, and bits 8, K8; per-leaf Adam8bit, K5/K6;
   AGD, group Adam, OffloadAdam, WSAM over adamw) and adamw under
   ``overlap_collectives`` "xla" and "manual", each against its
   optimizer's unsharded run (losses within 1e-5 relative, bit-equality
   printed; K7/K8 one a step, K5/K6 one a leaf a step, K1-K4 16 a step;
   every param and param-shaped moment a DTensor; the overlap arms equal
   to ``[mesh1]`` with no ring call), each arm's step and optimizer-step
   ms beside the unsharded run's, its state bytes on the card and the
   grad all-gather's ms, then ``[reshape1]``'s round with fused 8-bit
   Adam, bit-equal after it, in a ``{"mesh1_opt": ...}`` line;
   ``[seq4-mesh1]``, on ``[mesh1]``'s group before it is destroyed:
   nano-350m under ``MeshConfig(data=1, fsdp=-1, seq=4)``, the 4 seq
   ranks held in this process beside the one-rank DeviceMesh (every
   param and moment a DTensor), on the ring (K12-K14 160 a step, K2 64)
   and under ``attn_impl="ulysses"`` (K1-K4 64 a step), each within
   1e-5 (relative) of ``[seq4]``'s and ``[ulysses4]``'s losses
   (bit-equality printed) and 2e-2 of adamw's, step ms, host enqueue ms
   and peak GiB beside theirs and an earlier smoke's, in a
   ``{"seq4_mesh1": ...}`` line; ``[search1]``, after ``[mesh1-opt]``
   with no process group: the
   strategy search (``make_search_engine``, the engine
   ``search_strategy`` searches with) on nano-350m, B8 S2048, adamw, ``try_low_precision``, the card's memory,
   greedy over at most 4 dry-runs (on one card: the unsharded mesh at
   its first feasible remat and its int8 variant), then remat "minimal"
   and "full" of that mesh through the same dry-runner; each dry-run's
   strategy, build and step s, loss, the memory estimate beside
   ``max_memory_allocated`` and its launches a step, the winner, the
   int8 gate's decision and the cost model's rank correlation, in a
   ``{"search1": ...}`` line; gated: every dry-run ok, the winner the
   fastest that passes the int8 gate, K1-K4 16 a step (K1 32 under a
   remat) in each bf16 dry-run, K16 and K17 launched in the int8 one,
   the allocated memory within 1 GiB from one freed candidate to the
   next;
   ``[reshape1]``, the in-process reshape at one rank: nano-350m
   through the Trainer on a one-rank NCCL DeviceMesh with Flash
   Checkpoint and a reshape channel, 3 steps, then a request of round 2
   for the same world (1 -> 1) at that boundary: the agreement, a save
   of the step, the group destroyed and formed anew on NCCL from
   another store, the mesh and the optimizer rebuilt, the state moved
   by the mover, and 3 more steps: the ack ok, the losses after the
   round within 1e-5 of an uninterrupted run from the same weights
   (bit-equality printed), K1-K4 16 a step on both sides, one process,
   the state on the card; each leg's seconds with the card's name and
   power limit in a ``{"reshape1": ...}`` line; then ``[gpt2]``: gpt2-124m's logits (12 layers, full width,
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
   ``[moe]``: K1-K4 at Mixtral-8x7B's attention shape (B1 H32 KVH8
   S4096) against their plain versions, then timed beside SDPA with
   ``enable_gqa``, and a llama at Mixtral-8x7B's published widths (dim
   4096, 32 heads over 8 kv heads, mlp 14336, 8 experts top-2, vocab
   32000, rope theta 1e6; depth cut to 2 of 32 layers, capacity factor
   1.25) through ``Trainer``, B1 S4096, bf16 over f32 masters, adamw,
   1 + 5 steps on one repeated batch: losses finite and falling, the
   first within 2e-2 of the same params' loss through the plain
   attention, K1-K4 twice a step; step ms, tokens/s, MFU on the active
   FLOPs, peak, aux/z/dropped per step, and a profiled step's device ms
   by part; ``[lowp]``, low-precision compute: K15 ``quantize_fp8`` (e4m3
   and e5m2, both layouts, a given scale that overflows), K16
   ``quantize_int8_channels`` (rows and columns) and K17
   ``dequantize_int32`` (both orders, bf16 and f32) against their plain
   versions bit for bit on the main path's operands (M = B4 x S2048 =
   8192 rows), ``torch._int_mm`` against the exact integer products and
   ``torch._scaled_mm`` within 1e-2 of the plain dequantized matmul; at
   llama3-8b's projection shapes (K x N: 4096x6144 q/k/v stacked,
   4096x4096 o, 4096x14336 gate or up, 14336x4096 down) each of K15/K16
   on the activation and the weight, K17 on the product, the fp8, int8
   and bf16 GEMMs and the quantized matmul's forward end to end (CUDA
   graph replays) against their bounds (bytes; 2MNK over 1,979 TFLOP/s
   for fp8/int8, 989 for bf16); then llama3-8b's published widths (dim
   4096, 32 heads over 8 kv heads of 128, mlp 14336, vocab 128256, rope
   theta 5e5; depth cut to 4 of 32 layers, 1.92 B params) through
   ``Trainer``, B4 S2048, adamw over f32 masters, 6 steps on one repeated
   seeded batch from the same weights under ``compute_dtype`` bfloat16,
   fp8 and int8 (remat "none") and int8 under remat "minimal", each
   followed by a profiled step (device ms by part: GEMMs by type,
   K15-K17, K1-K4, the rest): losses finite and falling, the first
   within 2e-2 (relative) of the bf16 run's, K1-K4 and the mode's
   quantize kernels launched (K15 3 a projection under fp8; K16 2 and
   K17 1 under int8, the same under "minimal", whose recompute takes
   the saved quantized matmuls) and no other mode's; step ms, tokens/s,
   MFU against 989 TFLOP/s and (named so) 1,979, peak; then gpt2-1.5b's
   widths (2 of 48 layers, head_dim 64 through K1-K4) 3 steps under
   each mode with the same gates; then serving and RL: ``[serve]``,
   llama3-8b at full width (32
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
   ``[recsys]``, the CTR job: ``RecsysConfig(dim=128, fields=26,
   hidden=64, device_capacity=2**22)`` (MLPerf DLRM-dcnv2's 26 Criteo
   fields of dim 128) through the Trainer with ``TieredBatchPreparer``
   and GroupAdam at f32 compute, batch 8192; first the small config
   (dim 8, capacity 64, 4 fields, vocab 512), whose 8 losses on the card
   must be within 1e-5 of the port's CPU run from the same weights, and
   a demote -> promote round-trip of 4096 rows and their aux rows on the
   card, bit-identical; then 2**23 warm triples imported (half spill to
   the host tier), 20 steps of a Zipf id stream with 3% never-seen ids
   (every batch id resident before its step, gated), Flash Checkpoint's
   save at step 6 of 12, a PS version bump before step 3 whose
   ``PsFailoverMonitor`` migration (export, a fresh tier's import) must
   keep every triple and leave the master's workers synced; a child
   process (``--recsys-child``) restores step 6 (the table, GroupAdam's
   state with int32 counts, the tier's sidecar) and trains steps 7-12
   within 1e-5 of the uninterrupted run; printed: step ms and the
   prestep's host ms (medians of steps 2-12), rows demoted, promoted and
   fresh a step, device bytes of the table and GroupAdam's state, the
   host tier's bytes, the save, restore and migration seconds and a
   profiled iteration's idle share;
   ``[coworker]``, the input pipeline: nano-350m (B8 S2048, flash, adamw)
   through the Trainer fed in process, by
   ``DevicePrefetcher(CoworkerDataset(...))`` with a
   ``CoworkerDataService`` process and by a ``ShmBatchWriter`` process ->
   ``ShmDataLoader`` -> ``DevicePrefetcher`` (``--coworker-child``); each
   arm's 8 losses within 1e-5 of the in-process feed's, K1-K4 16 launches
   a step; printed: each arm's step ms, the prefetcher's copy ms on its
   side stream, the handoff ms a batch and a profiled iteration's idle
   share; then ``ElasticTrainer`` at world sizes 1, 2 and 4 (accum 4, 2
   and 1 at global 8, micro 2; the ranks in turn on the card, their
   gradients averaged; 2 layers, f32, the reference attention), whose
   losses must agree within 1e-5;
6. one JSON line with every kernel's numbers (K1-K4's head_dim 64
   instantiations as ``<name>_d64``, their launches from ``[gpt2]``;
   K15-K17's launches from ``[lowp]``'s fp8 and int8 runs, their times
   at the q/k/v shape's activation and product),
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
    # low-precision compute: no TPU kernel; XLA fuses these chains into
    # the dots of the functions named
    "quantize_fp8": ("dlrover_tpu_torch/ops/csrc/lowp.cu",
                     "none: dlrover_tpu/ops/fp8.py:169 quantize_e4m3 "
                     "(fused by XLA)"),
    "quantize_int8_channels": ("dlrover_tpu_torch/ops/csrc/lowp.cu",
                               "none: dlrover_tpu/ops/quantization.py:187 "
                               "_per_channel_q (fused by XLA)"),
    "dequantize_int32": ("dlrover_tpu_torch/ops/csrc/lowp.cu",
                         "none: dlrover_tpu/ops/quantization.py:201 "
                         "_int8_dot_impl's epilogue (fused by XLA)"),
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
    from dlrover_tpu_torch.ops import (
        attention,
        fused_optim,
        lowp,
        quantization,
    )

    return attention, quantization, fused_optim, lowp


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
    the other routes' kernels. Ulysses (``attn_impl="ulysses"``) under a
    seq axis of n ranks runs K1-K4 once per head group instead: n per
    layer and step."""
    route = HEADS_KERNELS if cfg.attn_impl == "bshd" else FLASH_KERNELS
    per_step = {name: 1 for name in route}
    per_step[route[0]] = fwd_runs
    if seq > 1 and cfg.attn_impl == "ulysses":
        per_step = {name: seq * n for name, n in per_step.items()}
    elif seq > 1:
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

    # each unsharded run's losses and summary, for [mesh1-opt]
    refs = {}
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
        res, state, batch, losses, counts, summary = train_run(
            cfg, label, factory, strategy, steps)
        profile_step(res, state, batch, label, top=8)
        del res, state
        release()
        refs[label] = {"losses": losses, "summary": summary}
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
    res, state, batch, losses, counts, seq4_summary = train_run(
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
    # each seq run's losses and summary, for [seq4-mesh1]
    seq_refs = {"seq4": (losses, seq4_summary)}
    # Ulysses over the same 4 in-process ranks: K1-K4 per head group
    seq_refs["ulysses4"] = ulysses_run(cfg, steps, adamw_losses)
    release()

    # the train step's other options: AGD through the example's chain,
    # the chunked CE, and the rest of the optimizers
    agd_phase(cfg, steps, trainer_summary, none_summary)
    release()
    ce_chunk_runs(cfg, steps, adamw_losses, none_summary, ce1_rows)
    refs.update(optimizer_runs(cfg, none_summary))
    release()
    # the data, fsdp and tensor axes' path: DTensor state on a one-rank
    # NCCL DeviceMesh, and the seq axis in this process beside it
    refs["mesh1"] = mesh1_phase(cfg, steps, adamw_losses, none_summary,
                                seq_refs)
    release()
    # every optimizer and the overlap modes on that mesh
    mesh1_opt_phase(cfg, refs)
    release()
    # the strategy search, with no process group (its int8 candidate
    # runs K16 and K17, which a DeviceMesh refuses)
    search1_phase(cfg)
    return launches


def ulysses_run(cfg, steps, adamw_losses):
    """[ulysses4]: adamw with ``attn_impl="ulysses"`` under
    ``MeshConfig(seq=4)`` in this process: the all-to-all regroups the 4
    sequence shards into 4 head groups of 2 heads, K1-K4 run once per
    group and layer over the whole sequence (train_run gates the
    launches); losses within 2e-2 of adamw's; step ms, host enqueue ms,
    K1-K4 launches per step. Returns (losses, summary)."""
    from dlrover_tpu_torch.parallel import MeshConfig, Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    ul = dataclasses.replace(cfg, attn_impl="ulysses")
    res, state, _b, losses, counts, summary = train_run(
        ul, "ulysses4", build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none", mesh=MeshConfig(seq=SEQ)), steps,
        optimizer="adamw")
    ring = res.mesh.ring
    if ring.kind != "in-process" or ring.ranks != tuple(range(SEQ)):
        raise SystemExit(f"ulysses4: ran on {ring.describe()}, want the "
                         f"in-process transport with {SEQ} ranks")
    del res, state
    gap = loss_gap("ulysses4", losses, adamw_losses)
    seq_ref = (losses, summary)
    log(json.dumps({"ulysses4": {
        "card": CARD["line"], "config": "nano-350m", "seq_ranks": SEQ,
        "step_ms_median_2_to_5": summary["step_ms_median_2_to_5"],
        "host_enqueue_ms_median_2_to_5":
            summary["host_enqueue_ms_median_2_to_5"],
        "tokens_per_s": summary["tokens_per_s"], "mfu": summary["mfu"],
        "peak_mem_gib": summary["peak_mem_gib"],
        "k1_k4_launches_per_step": {name: counts[name] / steps
                                    for name in FLASH_KERNELS},
        "loss_gap_to_adamw": gap}}))
    return seq_ref


# --------------------------------------------------------------- [mesh1]

MESH1_STEPS = 5
MESH1_MORE = 2


def mesh1_phase(cfg, steps, adamw_losses, none_summary, seq_refs):
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
    within LOSS_TOL of the first Trainer's continuation; then
    [seq4-mesh1] on the same group (``seq_refs``: the [seq4] and
    [ulysses4] runs' losses and summaries). The group is destroyed at
    the end, also when a check fails. No fallback: without NCCL or a
    kernel the phase raises."""
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
        check_dtensor_state("mesh1", state)
        profile_step(res, state, _b, "mesh1", top=8)
        del res, state
        release()
        gap = loss_gap("mesh1", losses, adamw_losses, LOSS_TOL,
                       relative=True, to="the unsharded adamw run")
        job = os.environ["ELASTIC_JOB_NAME"]
        with flash_env("mesh1", job):
            chain = mesh1_chain(cfg, CKPT_DIR / "mesh1")
        release()
        seq4_mesh1_runs(cfg, steps, adamw_losses, seq_refs)
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
    return {"losses": losses, "summary": summary}


def check_dtensor_state(label, state) -> None:
    """Fail unless every param and every moment is a DTensor."""
    kinds = {type(p).__name__ for p in state.params.values()}
    moments = {type(m).__name__ for st in state.optimizer.state.values()
               for k, m in st.items() if k != "step"}
    if kinds != {"DTensor"} or moments != {"DTensor"}:
        raise SystemExit(f"{label}: params {kinds}, moments {moments}: "
                         "want DTensors")


# [seq4]'s and [ulysses4]'s steady step ms and host enqueue ms in an
# earlier smoke of this script (NVIDIA H100 80GB HBM3, 700.00 W; PERF.md),
# printed beside [seq4-mesh1]'s and this run's
EARLIER_SEQ_MS = {"seq4": {"step_ms": 151.73, "host_enqueue_ms": 114.42},
               "ulysses4": {"step_ms": 145.41, "host_enqueue_ms": None}}


def seq4_mesh1_runs(cfg, steps, adamw_losses, seq_refs):
    """[seq4-mesh1]: on [mesh1]'s one-rank NCCL group, nano-350m under
    ``MeshConfig(data=1, fsdp=-1, seq=4)`` with its logical axes: the 4
    seq ranks held in this process (the in-process ring) beside the
    one-rank DeviceMesh that the other axes fill, every param and moment
    a DTensor. Two arms on the [seq4] run's batch: the ring (K12-K14 160
    a step each, K2 64; train_run gates them) and ``attn_impl="ulysses"``
    (K1-K4 64 a step). Each arm's losses within LOSS_TOL (relative) of
    its run without the group ([seq4], [ulysses4]; bit-equality printed)
    and within 2e-2 of flash adamw's; step ms, host enqueue ms and peak
    GiB beside those runs' and an earlier smoke's."""
    from dlrover_tpu_torch.models import llama_logical_axes
    from dlrover_tpu_torch.parallel import MeshConfig, Strategy
    from dlrover_tpu_torch.trainer import build_optimizer

    report = {"card": CARD["line"], "config": "nano-350m", "batch": 8,
              "seq": 2048, "mesh": "MeshConfig(data=1, fsdp=-1, seq=4)"}
    for arm, arm_cfg in (("seq4", cfg),
                         ("ulysses4", dataclasses.replace(
                             cfg, attn_impl="ulysses"))):
        label = f"{arm}-mesh1"
        res, state, _b, losses, counts, summary = train_run(
            arm_cfg, label, build_optimizer("adamw", SLICE_LR,
                                            weight_decay=0.0),
            Strategy(remat="none", mesh=MeshConfig(data=1, fsdp=-1,
                                                   seq=SEQ)),
            steps, optimizer="adamw", axes=llama_logical_axes(arm_cfg))
        ring, dm = res.mesh.ring, res.mesh.device_mesh
        log(f"  [{label}] {res.strategy.describe(res.mesh)}")
        if (ring.kind != "in-process" or ring.ranks != tuple(range(SEQ))
                or dm is None or "seq" in dm.mesh_dim_names):
            raise SystemExit(f"{label}: ran on {ring.describe()} beside "
                             f"{dm}, want the in-process ring of {SEQ} "
                             "ranks beside a DeviceMesh without seq")
        check_dtensor_state(label, state)
        del res, state
        release()
        ref_losses, ref = seq_refs[arm]
        gap = loss_gap(label, losses, ref_losses, LOSS_TOL, relative=True,
                       to=f"[{arm}]")
        loss_gap(label, losses, adamw_losses)
        report[arm] = {
            "step_ms_median_2_to_5": summary["step_ms_median_2_to_5"],
            "host_enqueue_ms_median_2_to_5":
                summary["host_enqueue_ms_median_2_to_5"],
            "peak_mem_gib": summary["peak_mem_gib"],
            "without_group": {
                "step_ms_median_2_to_5": ref["step_ms_median_2_to_5"],
                "host_enqueue_ms_median_2_to_5":
                    ref["host_enqueue_ms_median_2_to_5"],
                "peak_mem_gib": ref["peak_mem_gib"]},
            "earlier_smoke": EARLIER_SEQ_MS[arm],
            "launches_per_step": {
                name: counts[name] // steps
                for name in dict.fromkeys(FLASH_KERNELS + RING_KERNELS)},
            "loss_gap_relative": gap, "bit_equal": losses == ref_losses,
            "losses": losses}
    log(json.dumps({"seq4_mesh1": report}))


# ------------------------------------------------------------- [search1]

# a dry-run's steps: the build's first, one warm-up, three timed
SEARCH_STEPS = 5
SEARCH_MEM_GROWTH = 1 << 30


def search1_phase(cfg):
    """[search1]: the strategy search on the card, through the engine
    that ``search_strategy`` searches with (``make_search_engine``: the
    analysis of ``llama_init`` under a ``FakeTensorMode``, the
    ``auto_accelerate`` dry-runner), kept so that each candidate prints:
    nano-350m at full width, the smoke's B8 S2048 batch, adamw,
    ``try_low_precision``, ``hbm_gb`` from the card, ``max_dryruns=4``,
    no process group. On one
    card that is the unsharded mesh at its first feasible remat and its
    int8 variant; then the same runner profiles remat "minimal" and
    "full" of that mesh, for ``cost_model_rank_correlation``. Prints each
    dry-run (strategy, compile and step s, loss, ok/error, the estimate
    beside ``max_memory_allocated``, K1-K4 and K16/K17 launches a step),
    the winner, the int8 gate's decision and the correlation. Gates:
    every dry-run ok; the winner the fastest candidate that passes the
    int8 gate; K1-K4 16 a step (K1 twice that under a remat's recompute)
    in each bf16 dry-run, K16 and K17 launched in the int8 one; the card's
    allocated memory after each freed candidate within 1 GiB of the
    previous."""
    import torch.distributed as dist

    from dlrover_tpu_torch.models import (
        llama_init,
        llama_logical_axes,
        llama_loss_fn,
    )
    from dlrover_tpu_torch.parallel import Strategy, estimate_hbm_per_device
    from dlrover_tpu_torch.parallel.engine import (
        LOSS_PARITY_TOL,
        card_hbm_gb,
        cost_model_rank_correlation,
        make_search_engine,
    )
    from dlrover_tpu_torch.trainer import build_optimizer

    if dist.is_initialized():
        raise SystemExit("search1: a process group exists")
    t_phase = time.perf_counter()
    B, S = 8, 2048
    # per dry-run, from its build (the init, after the last one was
    # freed) to the next: memory before it, its peak and its launches
    runs: list = []

    def close():
        if runs and "peak" not in runs[-1]:
            torch.cuda.synchronize()
            runs[-1].update(peak=torch.cuda.max_memory_allocated(),
                            launches=launch_counts())

    def init(seed, device):
        if torch.device(device).type == "cuda":
            close()
            runs.append({"allocated_before": torch.cuda.memory_allocated()})
            torch.cuda.reset_peak_memory_stats()
            reset_launches()
        return llama_init(cfg, seed, device)

    engine = make_search_engine(
        llama_loss_fn(cfg), init,
        build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        llama_logical_axes(cfg), lambda: synthetic_batch(cfg.vocab_size, S,
                                                         B, 0),
        device="cuda", seq_len=S, batch_per_device=B, max_dryruns=4,
        search_algo="greedy", try_low_precision=True)
    analysis, runner = engine.analysis, engine.dry_runner
    best = engine.search()
    close()
    after = [torch.cuda.memory_allocated()]
    results = engine.results
    extra = [Strategy(mesh=engine.candidates[0].mesh, remat=mode)
             for mode in ("minimal", "full")]
    for strategy in extra:
        results.append(runner.profile(strategy))
        close()
        after.append(torch.cuda.memory_allocated())
    corr = cost_model_rank_correlation(engine.candidates + extra, results)

    allocated = [r["allocated_before"] for r in runs] + after[-1:]
    growth = [b - a for a, b in zip(allocated, allocated[1:])]
    rows, failures = [], []
    for r, run in zip(results, runs):
        s = r.strategy
        per_step = {name: run["launches"][name] / SEARCH_STEPS
                    for name in FLASH_KERNELS + LOWP_KERNELS}
        rows.append({
            "strategy": s.describe(), "remat": s.remat,
            "compute_dtype": s.compute_dtype, "ok": r.ok, "error": r.error,
            "compile_s": r.compile_s, "step_s": r.step_s, "loss": r.loss,
            "estimate_gib": estimate_hbm_per_device(
                analysis, s, batch_per_device=B, seq_len=S) / 2**30,
            "max_memory_allocated_gib": run["peak"] / 2**30,
            "launches_per_step": per_step})
        log(f"  [search1] {json.dumps(rows[-1])}")
        if not r.ok:
            failures.append(f"{s.describe()} failed: {r.error}")
        want = {name: 16.0 for name in FLASH_KERNELS}
        want["flash_fwd"] *= REMAT_FWD_RUNS[s.remat]
        if any(per_step[n] != want[n] for n in FLASH_KERNELS):
            failures.append(f"{s.describe()}: K1-K4 a step {per_step}, "
                            f"want {want}")
        quant = ("quantize_int8_channels", "dequantize_int32")
        if s.compute_dtype == "int8" and not all(per_step[n]
                                                  for n in quant):
            failures.append(f"{s.describe()}: K16/K17 never launched")
    # the winner: the fastest searched candidate that passes the engine's
    # int8 gate (one it never weighed was slower than an unquantized one)
    searched = [r for r in results[:len(results) - len(extra)] if r.ok]
    passed = {id(r): ok for r, ok in engine.quant_gate}
    want_best = min((r for r in searched
                     if r.strategy.compute_dtype != "int8"
                     or passed.get(id(r))), key=lambda r: r.step_s,
                    default=None)
    by_dtype = {r.strategy.compute_dtype: r for r in searched}
    gate = {"decisions": [
        {"strategy": r.strategy.describe(), "passed": ok}
        for r, ok in engine.quant_gate] or "int8 never the fastest left",
        "tol": LOSS_PARITY_TOL}
    if "int8" in by_dtype and "bfloat16" in by_dtype:
        q, b = by_dtype["int8"], by_dtype["bfloat16"]
        gate.update(int8_step_s=q.step_s, bf16_step_s=b.step_s,
                    loss_rel_diff=abs(q.loss - b.loss) / abs(b.loss))
    if want_best is None or best is not want_best.strategy:
        failures.append(f"the search picked {best.describe()}, want "
                        f"{want_best and want_best.strategy.describe()}")
    if any(g > SEARCH_MEM_GROWTH for g in growth):
        failures.append(f"allocated memory grew {growth} bytes between "
                        "freed candidates")
    log(json.dumps({"search1": {
        "card": CARD["line"], "config": "nano-350m", "batch": B, "seq": S,
        "hbm_gb": card_hbm_gb(), "candidates": [
            c.describe() for c in engine.candidates],
        "dryruns": rows, "winner": best.describe(), "int8_gate": gate,
        "rank_correlation": corr,
        "allocated_after_each_freed_gib": [a / 2**30 for a in allocated],
        "phase_s": time.perf_counter() - t_phase}}))
    if failures:
        raise SystemExit(f"search1: {failures}")


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


# ------------------------------------------------------------ [mesh1-opt]

# [mesh1-opt]: the clip norm of FusedAdamW bits 32's arm (nano-350m's
# grads reach norms above 1 in its first steps)
MESH1_OPT_CLIP = 1.0


def timed_whole_grads():
    """Wrap ``FusedAdamW.whole_grads`` (the grads all-gathered whole: the
    step's new collective, a no-op at one rank) with CUDA events; returns
    (the event pairs, a function that unwraps it)."""
    from dlrover_tpu_torch.ops.fused_optim import FusedAdamW

    inner, events = FusedAdamW.__dict__["whole_grads"], []

    def whole_grads(params):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = inner.__func__(params)
        end.record()
        events.append((start, end))
        return out

    FusedAdamW.whole_grads = staticmethod(whole_grads)
    return events, lambda: setattr(FusedAdamW, "whole_grads", inner)


def check_mesh_state(label, state):
    """Every param a DTensor, and every moment of a param's shape too
    (OffloadAdam's live on the host: its ``state_dict()`` places them as
    their params)."""
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.optimizers import OffloadAdam

    opt = state.optimizer
    if {type(p).__name__ for p in state.params.values()} != {"DTensor"}:
        raise SystemExit(f"{label}: a param is not a DTensor")
    host = isinstance(opt, OffloadAdam)
    entries = (opt.state_dict()["state"].values() if host
               else opt.state.values())
    params = [p for g in opt.param_groups for p in g["params"]]
    shapes = {tuple(p.shape) for p in params}
    for entry in entries:
        if not isinstance(entry, dict):
            continue
        for key, v in entry.items():
            if (isinstance(v, torch.Tensor) and v.is_floating_point()
                    and tuple(v.shape) in shapes and v.dim()
                    and not isinstance(v, DTensor)):
                raise SystemExit(f"{label}: moment {key} of a param's "
                                 "shape is not a DTensor")


def mesh1_wsam_run(cfg, steps, axes, B=8, S=2048):
    """The decoupled WSAM step over torch AdamW on the one-rank mesh (the
    params and the base optimizer from ``auto_accelerate``, remat
    "none", bf16 over f32 masters as ``wsam_run``): (losses, step
    seconds, state)."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.optimizers import make_wsam_step_fn
    from dlrover_tpu_torch.parallel import (
        MeshConfig,
        Strategy,
        auto_accelerate,
    )
    from dlrover_tpu_torch.parallel import remat as remat_lib
    from dlrover_tpu_torch.parallel.accelerate import global_value
    from dlrover_tpu_torch.trainer import build_optimizer

    res = auto_accelerate(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed,
                                                            device),
        build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none", mesh=MeshConfig(data=1, fsdp=-1)),
        device="cuda", seed=0, param_logical_axes=axes)
    inner = llama_loss_fn(cfg)

    def loss_fn(p, batch, rng):
        with remat_lib.no_remat():
            return inner({n: t.to(torch.bfloat16) for n, t in p.items()},
                         batch, rng)

    step = make_wsam_step_fn(loss_fn, res.state.optimizer, SLICE_LR)
    batch = {k: torch.as_tensor(v, device="cuda") for k, v in
             synthetic_batch(cfg.vocab_size, S, B, 0).items()}
    torch.cuda.synchronize()
    reset_launches()
    losses, step_s = [], []
    for _ in range(steps):
        t0 = time.perf_counter()
        losses.append(global_value(step(res.state.params, batch,
                                        None)).item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = launch_counts()
    for name, want in attention_launches(cfg, 2 * steps).items():
        if launches[name] != want:
            raise SystemExit(f"mesh1-opt wsam: {name} launched "
                             f"{launches[name]} times, want {want}")
    return losses, step_s, res.state


def mesh1_opt_phase(cfg, refs):
    """[mesh1-opt]: every optimizer and the overlap modes on [mesh1]'s
    one-rank NCCL DeviceMesh (``MeshConfig(data=1, fsdp=-1)``),
    nano-350m at full width, B8 S2048, flash, remat "none", on the
    repeated batch of the unsharded runs in ``refs``: FusedAdamW bits 32
    with ``clip_norm`` (K7) and bits 8 (K8), per-leaf Adam8bit (K5/K6),
    AGD, group Adam, OffloadAdam and WSAM over AdamW (OPT_STEPS steps,
    as their unsharded runs), and AdamW under ``overlap_collectives``
    "xla" and "manual". The unsharded runs of FusedAdamW with the clip
    and of AGD are made here first, before the group. Gates: every param
    and every moment of a param's shape a DTensor; each arm's losses
    within LOSS_TOL (relative) of its optimizer's unsharded run
    (bit-equality printed), K1-K4 16 a step, K7 and K8 one a step, K5
    and K6 one a leaf a step; the overlap arms' losses equal to
    [mesh1]'s (adamw, "off") and no ring call (fsdp is 1). Prints per
    arm: step ms and optimizer-step ms beside the unsharded run's, the
    state's bytes on the card, the grad all-gather's ms (FusedAdamW,
    Adam8bit) and the leaves it gathered (none at one rank). Then
    [reshape1]'s 1 -> 1 round with FusedAdamW bits 8,
    its losses after the round bit-equal to an uninterrupted run. The
    group is destroyed at the end, also when a check fails."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from dlrover_tpu_torch.models import llama_logical_axes
    from dlrover_tpu_torch.ops import collectives
    from dlrover_tpu_torch.ops.fused_optim import fused_adamw
    from dlrover_tpu_torch.optimizers import (
        OffloadAdam,
        adam8bit,
        agd,
        group_adam,
    )
    from dlrover_tpu_torch.parallel import (
        MeshConfig,
        Strategy,
        mesh_state,
        set_mesh,
    )
    from dlrover_tpu_torch.trainer import build_optimizer

    t_phase = time.perf_counter()
    steps = MESH1_STEPS
    # the unsharded runs the smoke makes nowhere else
    for label, factory, n in (
            ("fused_adamw32_clip", fused_adamw(SLICE_LR,
                                               clip_norm=MESH1_OPT_CLIP),
             steps),
            ("agd", agd(SLICE_LR), OPT_STEPS)):
        res, state, _b, losses, _c, summary = train_run(
            cfg, label, factory, Strategy(remat="none"), n)
        del res, state
        release()
        refs[label] = {"losses": losses, "summary": summary}
    n_leaves = 12
    arms = (
        # label, factory, steps, the unsharded run, optimizer kernels,
        # strategy fields, optimizer-step timer
        ("fused_adamw32", fused_adamw(SLICE_LR, clip_norm=MESH1_OPT_CLIP),
         steps, "fused_adamw32_clip", {"fused_adamw32": steps}, {}, None),
        ("fused_adamw8", adam8bit(SLICE_LR, fused=True), steps,
         "adam8bit_fused", {"fused_adamw8": steps},
         {"fused_optim": True}, None),
        ("adam8bit", build_optimizer("adam8bit", SLICE_LR,
                                     weight_decay=0.0), steps, "adam8bit",
         {"quantize_int8": n_leaves * steps,
          "dequantize_int8": n_leaves * steps}, {}, None),
        ("agd", agd(SLICE_LR), OPT_STEPS, "agd", {}, {}, None),
        ("group_adam", group_adam(SLICE_LR), OPT_STEPS, "group_adam", {},
         {}, None),
        ("offload_adam", lambda params: OffloadAdam(params, lr=SLICE_LR),
         OPT_STEPS, "offload_adam", {}, {}, time_offload_steps),
        ("overlap_xla", build_optimizer("adamw", SLICE_LR,
                                        weight_decay=0.0), steps, "mesh1",
         {}, {"overlap_collectives": "xla"}, None),
        ("overlap_manual", build_optimizer("adamw", SLICE_LR,
                                           weight_decay=0.0), steps,
         "mesh1", {}, {"overlap_collectives": "manual"}, None),
    )
    axes = llama_logical_axes(cfg)
    mesh = MeshConfig(data=1, fsdp=-1)
    if dist.is_initialized():
        raise SystemExit("mesh1-opt: a process group already exists")
    store = tempfile.mkdtemp(prefix="mesh1opt")
    dist.init_process_group("nccl", init_method=f"file://{store}/store",
                            rank=0, world_size=1)
    report = {"card": CARD["line"], "config": "nano-350m", "batch": 8,
              "seq": 2048, "mesh": {"data": 1, "fsdp": 1}, "arms": {}}
    try:
        for label, factory, n, ref, kernels, fields, timer in arms:
            gathers, unwrap = timed_whole_grads()
            calls = dict(collectives.ring_calls)
            leaves = mesh_state.gathered["leaves"]
            try:
                res, state, _b, losses, counts, summary = train_run(
                    cfg, f"mesh1-opt {label}", factory,
                    Strategy(remat="none", mesh=mesh, **fields), n,
                    optimizer=label, time_opt=timer, axes=axes)
            finally:
                unwrap()
            check_mesh_state(label, state)
            del res, state
            release()
            for name in ("quantize_int8", "dequantize_int8",
                         "fused_adamw32", "fused_adamw8"):
                if counts[name] != kernels.get(name, 0):
                    raise SystemExit(
                        f"mesh1-opt {label}: {name} launched {counts[name]} "
                        f"times, want {kernels.get(name, 0)}")
            ring = {k: collectives.ring_calls[k] - calls[k] for k in calls}
            unsharded = refs[ref]
            if ref == "mesh1":
                if losses != unsharded["losses"] or any(ring.values()):
                    raise SystemExit(
                        f"mesh1-opt {label}: losses {losses} against "
                        f"[mesh1]'s {unsharded['losses']}, ring calls "
                        f"{ring}")
                gap = 0.0
            else:
                gap = loss_gap(f"mesh1-opt {label}", losses,
                               unsharded["losses"], LOSS_TOL, relative=True,
                               to=f"the unsharded {ref} run")
            gather_ms = [a.elapsed_time(b) for a, b in gathers]
            report["arms"][label] = {
                "steps": n, "reference": ref,
                "bit_equal": losses == unsharded["losses"],
                "loss_gap_relative": gap,
                "step_ms_median_from_2": summary["step_ms_median_2_to_5"],
                "unsharded_step_ms_median_from_2": unsharded["summary"][
                    "step_ms_median_2_to_5"],
                "opt_step_ms_median_from_2": summary[
                    "opt_step_ms_median_2_to_5"],
                "unsharded_opt_step_ms_median_from_2": unsharded[
                    "summary"].get("opt_step_ms_median_2_to_5"),
                "state_gb_on_card": summary["opt_state_gb_on_device"],
                "grad_gather_ms_median": (statistics.median(gather_ms)
                                          if gather_ms else None),
                "leaves_gathered": mesh_state.gathered["leaves"] - leaves,
                "ring_calls": ring,
                "optimizer_launches": {k: counts[k] for k in kernels},
            }
            log(f"  [mesh1-opt] {label}: {json.dumps(report['arms'][label])}")
        losses, step_s, state = mesh1_wsam_run(cfg, OPT_STEPS, axes)
        check_mesh_state("wsam", state)
        del state
        release()
        gap = loss_gap("mesh1-opt wsam", losses, refs["wsam"]["losses"],
                       LOSS_TOL, relative=True, to="the unsharded wsam run")
        report["arms"]["wsam"] = {
            "steps": OPT_STEPS, "reference": "wsam",
            "bit_equal": losses == refs["wsam"]["losses"],
            "loss_gap_relative": gap,
            "step_ms_median_from_2": statistics.median(step_s[1:]) * 1e3,
            "unsharded_step_ms_median_from_2": refs["wsam"]["summary"][
                "step_ms_median_2_to_5"]}
        log(f"  [mesh1-opt] wsam: {json.dumps(report['arms']['wsam'])}")
    finally:
        set_mesh(None)
        dist.destroy_process_group()
        shutil.rmtree(store, ignore_errors=True)
    release()
    reshape = reshape1_phase(cfg, adam8bit(SLICE_LR, fused=True),
                             label="mesh1-opt-reshape",
                             optimizer_kernels={"fused_adamw8": 1},
                             bit_equal=True)
    report["reshape_fused_adamw8"] = {
        k: reshape[k] for k in ("legs_s", "reshape_total_s",
                                "bit_equal_after_round",
                                "loss_gap_after_round")}
    report["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"mesh1_opt": report}))


# --------------------------------------------------------------- [reshape1]

RESHAPE1_STEPS = 3  # steps on each side of the round


class TokenRows:
    """Token rows as examples/llama_pretrain.py makes them (row ``idx`` is
    RandomState(idx)'s), for an elastic loader."""

    def __init__(self, vocab, seq_len, n):
        self.vocab, self.seq_len, self.n = vocab, seq_len, n

    def __len__(self):
        return self.n

    def __getitem__(self, idx):
        return np.random.RandomState(idx).randint(
            0, self.vocab, size=(self.seq_len + 1,), dtype=np.int32)


def reshape1_trainer(cfg, out, channel, optimizer=None, B=8, S=2048):
    """nano-350m through the port's Trainer on a one-rank DeviceMesh
    (``MeshConfig(fsdp=-1)``, bf16 over f32 masters, adamw unless
    ``optimizer``, a factory, says otherwise), Flash Checkpoint saving
    to shm at step RESHAPE1_STEPS; each step's loss, wall ms
    (synchronised) and launch counts kept."""
    from dlrover_tpu_torch.models import (
        llama_init,
        llama_logical_axes,
        llama_loss_fn,
    )
    from dlrover_tpu_torch.parallel import MeshConfig, Strategy
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from dlrover_tpu_torch.trainer.elastic import (
        ElasticDataLoader,
        ElasticSampler,
    )

    n = B * 2 * RESHAPE1_STEPS
    loader = ElasticDataLoader(
        TokenRows(cfg.vocab_size, S, n), batch_size=B,
        sampler=ElasticSampler(n, num_replicas=1, rank=0, shuffle=False),
        collate_fn=lambda rows: {"tokens": np.stack(rows)})

    class Recording(Trainer):
        def _adopt_accel(self, params):
            super()._adopt_accel(params)
            self.wrap()

        def wrap(self):
            inner = self._accel.train_step

            def step(state, batch, rng):
                t0 = time.perf_counter()
                state, metrics = inner(state, batch, rng)
                torch.cuda.synchronize()
                self.steps.append({
                    "step": state.step, "loss": metrics["loss"],
                    "ms": (time.perf_counter() - t0) * 1e3,
                    "launches": launch_counts()})
                if self.after_step is not None:
                    self.after_step(state.step)
                return state, metrics

            self._accel.train_step = step

    args = TrainingArgs(
        output_dir=str(out), max_steps=2 * RESHAPE1_STEPS,
        learning_rate=SLICE_LR, log_steps=0,
        flash_checkpoint=channel is not None, save_steps=RESHAPE1_STEPS,
        save_storage_every=1000,
        strategy=Strategy(remat="none", mesh=MeshConfig(data=1, fsdp=-1)))
    Recording.steps, Recording.after_step = None, None
    tr = Recording(
        llama_loss_fn(cfg), lambda s, d: llama_init(cfg, s, d),
        llama_logical_axes(cfg), args, train_data=loader,
        reshape_channel=channel, device="cuda", optimizer=optimizer)
    tr.steps = []
    tr.wrap()
    return tr


def reshape1_phase(cfg, optimizer=None, label="reshape1",
                   optimizer_kernels=None, bit_equal=False):
    """[reshape1]: the in-process reshape on the card, 1 -> 1. A one-rank
    NCCL group from a ``file://`` store, nano-350m through the Trainer
    with Flash Checkpoint and a reshape channel; after step
    RESHAPE1_STEPS a request of round 2 for the same world arrives, and
    at that boundary the Trainer agrees on it, saves the step, destroys
    the group and forms a new one on NCCL (another store), rebuilds the
    DeviceMesh and the optimizer, moves the state through the mover and
    trains RESHAPE1_STEPS more. Gates: the ack ok; the losses after the
    round within LOSS_TOL (absolute) of an uninterrupted run from the
    same weights (bit-equality printed); K1-K4 16 a step on both sides;
    one process (no restart), the state on the card on an NCCL group.
    Prints each leg of the reshape with the card's name and power
    limit. The group is destroyed at the end, also when a check fails;
    no fallback: a failed ack or any exception fails the run.
    ``optimizer`` (a factory; adamw without), ``label``: another arm of
    the same round ([mesh1-opt]'s FusedAdamW bits 8), whose
    ``optimizer_kernels`` (name: launches a step) are gated with K1-K4,
    and with ``bit_equal`` the losses after the round must equal the
    uninterrupted run's bit for bit."""
    import shutil
    import tempfile

    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from dlrover_tpu_torch.parallel import set_mesh
    from dlrover_tpu_torch.trainer.elastic.reshape import (
        ReshapeChannel,
        ReshapeRequest,
    )

    if dist.is_initialized():
        raise SystemExit(f"{label}: a process group already exists")
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix=label)
    pid = os.getpid()
    dist.init_process_group("nccl", init_method=f"file://{tmp}/store1",
                            rank=0, world_size=1)
    per_step = {name: n for name, n in attention_launches(cfg, 1).items()
                if name in FLASH_KERNELS}
    per_step.update(optimizer_kernels or {})
    try:
        job = os.environ["ELASTIC_JOB_NAME"]
        with flash_env(label, job):
            channel = ReshapeChannel(os.path.join(tmp, "chan"))
            request = ReshapeRequest(
                round=2, world={0: 1}, prev_world={0: 1}, total=1,
                coordinator=f"file://{tmp}/store2")
            tr = reshape1_trainer(cfg, CKPT_DIR / label, channel, optimizer)
            # the agent's request lands during the last step before it
            tr.after_step = lambda step: (
                channel.signal(request) if step == RESHAPE1_STEPS else None)
            reset_launches()
            t_train = time.perf_counter()
            tr.train()
            train_s = time.perf_counter() - t_train
            ack = channel.read_ack(2)
            if not ack or not ack.get("ok"):
                raise SystemExit(f"{label}: the round was not adopted: {ack}")
            if dist.get_backend() != "nccl" or dist.get_world_size() != 1:
                raise SystemExit(f"{label}: not on a one-rank NCCL group")
            placed = {(type(p).__name__, p.device.type,
                       getattr(getattr(p, "device_mesh", None),
                               "device_type", None))
                      for p in tr.state.params.values()}
            if placed != {("DTensor", "cuda", "cuda")}:
                raise SystemExit(f"{label}: params after the round {placed}")
            got = tr.steps
            tr.close()
            del tr
            release()
        set_mesh(None)
        ref_tr = reshape1_trainer(cfg, CKPT_DIR / f"{label}-ref", None,
                                  optimizer)
        ref_tr.train()
        ref = ref_tr.steps
        del ref_tr
        release()
    finally:
        set_mesh(None)
        if dist.is_initialized():
            dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    if os.getpid() != pid or len(got) != 2 * RESHAPE1_STEPS:
        raise SystemExit(f"{label}: {len(got)} steps in this process")
    losses = [r["loss"].item() for r in got]
    ref_losses = [r["loss"].item() for r in ref]
    after = slice(RESHAPE1_STEPS, None)
    gap = max(abs(a - b) for a, b in zip(losses[after], ref_losses[after]))
    if gap > LOSS_TOL or (bit_equal and losses[after] != ref_losses[after]):
        raise SystemExit(f"{label}: losses after the round {losses[after]} "
                         f"against the uninterrupted {ref_losses[after]}")
    prev = {name: 0 for name in per_step}
    for r in got:
        delta = {name: r["launches"][name] - prev[name] for name in per_step}
        prev = {name: r["launches"][name] for name in per_step}
        if delta != per_step:
            raise SystemExit(f"{label}: step {r['step']} launched {delta}, "
                             f"want {per_step}")
    steady = statistics.median(r["ms"] for r in got[1:RESHAPE1_STEPS])
    legs = {k: ack[k] for k in ("agree_s", "boundary_save_s",
                                "group_reform_s", "adopt_s", "restore_s")}
    report = {
        "card": CARD["line"], "config": "nano-350m", "batch": 8,
        "seq": 2048, "world": "1 -> 1 (NCCL)", "ack_ok": ack["ok"],
        "boundary_step": ack["step"], "moved": ack["moved"],
        "pulled": ack["pulled"], "legs_s": legs,
        "reshape_total_s": ack["dur"],
        "first_step_after_ms": got[RESHAPE1_STEPS]["ms"],
        "steady_step_ms_median_2_to_3": steady,
        "first_step_after_over_steady": got[RESHAPE1_STEPS]["ms"] / steady,
        "step_ms": [r["ms"] for r in got], "losses": losses,
        "uninterrupted_losses": ref_losses,
        "loss_gap_after_round": gap,
        "bit_equal_after_round": losses[after] == ref_losses[after],
        "launches_per_step": per_step, "train_s_with_final_persist": train_s,
        "phase_s": time.perf_counter() - t_phase,
    }
    log(f"  [{label}] {CARD['line']}: round 2 adopted at step "
        f"{ack['step']} in {ack['dur']:.3f} s; legs {legs}; first step "
        f"after {got[RESHAPE1_STEPS]['ms']:.1f} ms (steady {steady:.1f}); "
        f"loss gap {gap:.3g} (bit-equal {report['bit_equal_after_round']})")
    log(json.dumps({label: report}))
    return report


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
    a step a pass. Returns each run's losses and summary by label, the
    references of [mesh1-opt]."""
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
    refs = {}
    for label, factory, init, time_opt in runs:
        res, state, _b, losses, _c, summary = train_run(
            cfg, label, factory, Strategy(remat="none"), OPT_STEPS,
            init=init, time_opt=time_opt)
        del res, state
        release()
        refs[label] = {"losses": losses, "summary": summary}
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
    refs["wsam"] = {"losses": losses, "summary": {
        "step_ms_median_2_to_5": report["wsam_adamw"][
            "step_ms_median_from_2"]}}
    release()
    log(json.dumps({"optimizers": report, "card": CARD["line"]}))
    return refs


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
            elif "trainer.run" in cmd:
                # the launcher's own command line (which names the worker
                # script) in a child it forked and that has not exec'd
                role = "other: a fork of the launcher"
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
    import http.client
    import urllib.request

    base = f"http://{http_addr}"
    try:
        urllib.request.urlopen(base + "/report.json", timeout=5).read()
        text = urllib.request.urlopen(base + "/metrics", timeout=5).read()
    except (OSError, http.client.HTTPException):
        # not answering, or killed mid-response (an IncompleteRead)
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


# ------------------------------------------------------------- [moe]
#
# a llama at Mixtral-8x7B's published widths (mistralai/Mixtral-8x7B-v0.1)
# through Trainer: K1-K4 at GQA 4 and S 4096, the routed FFN as torch ops

MOE_LAYERS = 2         # of Mixtral's 32: see moe_config
MOE_B, MOE_S, MOE_STEPS = 1, 4096, 5
MOE_WARMUP = 1
MIXTRAL_ATTN = (1, 32, 8, 4096)   # (B, H, KVH, S) of one [moe] layer


def moe_config():
    """Mixtral-8x7B's widths: dim 4096, 32 heads over 8 kv heads of 128,
    mlp 14336, 8 experts, top-2, vocab 32000, rope theta 1e6, RMSNorm
    eps 1e-5; capacity factor 1.25 (the JAX package's default; Mixtral
    drops no token). Cut: MOE_LAYERS of 32 layers: 3.16 B params (2
    layers) hold ~51 GB of f32 masters, AdamW moments and f32 grads."""
    from dlrover_tpu_torch.models import LlamaConfig

    return LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=MOE_LAYERS, n_heads=32,
        n_kv_heads=8, mlp_dim=14336, max_seq_len=MOE_S, rope_theta=1e6,
        norm_eps=1e-5, n_experts=8, moe_top_k=2, moe_capacity_factor=1.25)


def moe_active_params(cfg) -> int:
    """The params one token runs through: all but the E - k experts it
    is not routed to."""
    return cfg.param_count() - ((cfg.n_experts - cfg.moe_top_k) * 3
                                * cfg.dim * cfg.mlp_dim * cfg.n_layers)


def time_mixtral_attention(inputs) -> dict:
    """K1-K4 at MIXTRAL_ATTN (CUDA-graph replays, median of 5; K1, K3
    and K4 each with their rope pre-passes, which the backward runs once
    for K3 and K4), their plain versions (CUDA events, 2 calls), SDPA's
    forward and backward with ``enable_gqa`` on the pre-roped q/k as the
    library yardstick (``linalg.vecdot`` for K2), and the bounds."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, cos, sin, o, lse, delta = inputs
    scale = HEAD_DIM ** -0.5
    args = (q, k, v, do, lse, delta, cos, sin, True, scale)

    def med(fn, iters):
        return statistics.median(graph_ms(fn, iters))

    ms = {
        "flash_fwd": med(lambda: att.flash_fwd(q, k, v, cos, sin, True,
                                               scale), 10),
        "flash_bwd_preprocess": med(
            lambda: att.flash_bwd_preprocess(do, o), 20),
        "flash_bwd_dq": med(lambda: att.flash_bwd_dq(*args), 10),
        "flash_bwd_dkv": med(lambda: att.flash_bwd_dkv(*args), 10),
    }
    bwd_prepass = med(lambda: (att.flash_fwd_rope_k(q, cos, sin),
                               att.flash_fwd_rope_k(k, cos, sin)), 20)
    plain = {
        "flash_fwd": cuda_ms(lambda: att.flash_fwd_plain(
            q, k, v, cos, sin, True, scale), 2, warmup=1),
        "flash_bwd_preprocess": cuda_ms(
            lambda: att.flash_bwd_preprocess_plain(do, o), 2, warmup=1),
        "flash_bwd_dq": cuda_ms(lambda: att.flash_bwd_dq_plain(*args), 2,
                                warmup=1),
        "flash_bwd_dkv": cuda_ms(lambda: att.flash_bwd_dkv_plain(*args), 2,
                                 warmup=1),
    }
    sdpa = torch.nn.functional.scaled_dot_product_attention
    leaves = (att._rope(q, cos, sin).to(torch.bfloat16).requires_grad_(),
              att._rope(k, cos, sin).to(torch.bfloat16).requires_grad_(),
              v.clone().requires_grad_())
    fwd = med(lambda: sdpa(*leaves, is_causal=True, enable_gqa=True), 10)
    both = med(lambda: torch.autograd.grad(
        sdpa(*leaves, is_causal=True, enable_gqa=True), leaves, do), 10)
    bound = bounds(MIXTRAL_ATTN)
    out = {
        "shape": dict(zip(("B", "H", "KVH", "S"), MIXTRAL_ATTN)),
        "card": CARD["line"], "ms": ms, "plain_ms": plain,
        "bound_ms": {name: bound[name][0] for name in ms},
        "bound_by": {name: bound[name][1] for name in ms},
        "share_of_bound": {name: bound[name][0] / ms[name] for name in ms},
        "bwd_rope_prepass_ms": bwd_prepass,
        "port_bwd_ms": ms["flash_bwd_preprocess"] + ms["flash_bwd_dq"]
        + ms["flash_bwd_dkv"] - bwd_prepass,
        "sdpa_gqa_fwd_ms": fwd, "sdpa_gqa_bwd_ms": both - fwd,
        # K2's library yardstick, as at the slice's shape
        "vecdot_ms": med(lambda: torch.linalg.vecdot(do, o, dim=-1), 20),
    }
    log(json.dumps({"mixtral_attention": out}))
    return out


def moe_breakdown(averages, cfg, B, S, busy_us) -> dict:
    """A profiled [moe] step's device ms by part. The matmuls (aten mm
    and bmm rows by input shape, forward and backward alike): the
    router's (a dim of E), the dispatch and combine einsums' (a dim of
    E x C), the expert GEMMs' (leading E and a dim of C) and the others
    (attention projections, the head); the gating's own ops (sort,
    cumsum, scatter, gather, one-hot); K1-K4 by kernel name; the foreach
    AdamW (``aten::_foreach_*``); the copies (``aten::copy_``: the f32
    masters to bf16, the grads back); the rest of the busy time (norms,
    SwiGLU and rope elementwise, the CE, the embedding)."""
    from dlrover_tpu_torch.parallel.moe import MoEConfig

    E = cfg.n_experts
    C = MoEConfig(E, cfg.moe_top_k,
                  cfg.moe_capacity_factor).capacity(S)
    parts = dict.fromkeys(("router", "dispatch_combine", "experts",
                           "other_gemms", "gating", "adamw", "copies"), 0.0)
    gating = ("aten::sort", "aten::cumsum", "aten::scatter_add",
              "aten::scatter_add_", "aten::gather", "aten::one_hot")
    for e in averages:
        ms = e.self_device_time_total / 1e3
        if not ms:
            continue
        if e.key in ("aten::mm", "aten::bmm", "aten::addmm",
                     "aten::baddbmm"):
            dims = [d for shape in e.input_shapes for d in shape]
            if E * C in dims:
                parts["dispatch_combine"] += ms
            elif any(len(sh) == 3 and sh[0] == E and C in sh
                     for sh in e.input_shapes):
                parts["experts"] += ms
            elif any(len(sh) == 2 and E in sh for sh in e.input_shapes):
                parts["router"] += ms
            else:
                parts["other_gemms"] += ms
        elif e.key in gating:
            parts["gating"] += ms
        elif e.key.startswith("aten::_foreach_"):
            parts["adamw"] += ms
        elif e.key == "aten::copy_":
            parts["copies"] += ms
    kernels = profiled_kernels(averages, "moe", busy_us)
    parts["k1_k4"] = kernels["attention_ms"]
    busy = busy_us / 1e3
    parts["rest"] = busy - sum(parts.values())
    return {"device_busy_ms": busy, "ms": parts,
            "share": {k: v / busy for k, v in parts.items()},
            "capacity": C, "kernels": kernels["kernels"]}


def moe_phase(worst) -> dict:
    """[moe]: K1-K4 at MIXTRAL_ATTN against their plain versions (into
    ``worst``) and timed beside SDPA, then the Mixtral-width llama
    through Trainer (bf16 over f32 masters, remat "none", adamw) on one
    repeated seeded batch, B1 S4096, for MOE_WARMUP + MOE_STEPS steps:
    losses finite and falling, the first within 2e-2 (relative) of the
    same params' loss with the plain attention, K1-K4 once per layer and
    step and no other attention kernel; step ms (median of the measured
    steps), tokens/s, MFU on the active FLOPs (passed to the Trainer as
    ``model_flops_per_token``), peak GiB, each step's aux, z and dropped
    share (the layers' mean); then a profiled step, its device ms by
    part (``moe_breakdown``). Returns its summary."""
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.parallel.moe import record_metrics
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    attn = check_shape("mixtral", MIXTRAL_ATTN, 7, worst)
    attention = time_mixtral_attention(attn)
    del attn
    release()

    cfg = moe_config()
    B, S, steps = MOE_B, MOE_S, MOE_WARMUP + MOE_STEPS
    active = moe_active_params(cfg)
    per_token = mfu.transformer_step_flops(active, 1, cfg.n_layers,
                                           cfg.dim, S)
    log(f"  [moe] Mixtral-8x7B widths, {cfg.n_layers} of 32 layers: "
        f"{cfg.param_count()} params, {active} active a token; MFU counts "
        f"{per_token:.6e} FLOPs a token (6 x active + causal attention), "
        f"not the dense 6 x all {6.0 * cfg.param_count():.6e}")
    batch = synthetic_batch(cfg.vocab_size, S, B, 0)
    job = os.environ["ELASTIC_JOB_NAME"]
    t_phase = time.perf_counter()
    with flash_env("moe", job):
        trainer = Trainer(
            llama_loss_fn(cfg),
            lambda seed, device: llama_init(cfg, seed, device), None,
            TrainingArgs(
                output_dir=str(CKPT_DIR / "moe"), max_steps=steps,
                num_epochs=1, learning_rate=SLICE_LR, optimizer="adamw",
                strategy=Strategy(remat="none"), flash_checkpoint=False,
                log_steps=0, model_flops_per_token=per_token),
            train_data=[batch] * steps, device="cuda")
        # the same initial params through the plain attention
        tokens = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
        with torch.no_grad():
            plain = llama_loss_fn(dataclasses.replace(
                cfg, attn_impl="reference"))(
                {n: p.to(torch.bfloat16)
                 for n, p in trainer.state.params.items()},
                tokens, None).item()
        release()
        inner = trainer._accel.train_step
        losses, step_s, per_step = [], [], []

        def timed(state, batch, rng):
            t0 = time.perf_counter()
            with record_metrics() as seen:
                state, metrics = inner(state, batch, rng)
            losses.append(metrics["loss"].item())
            torch.cuda.synchronize()
            step_s.append(time.perf_counter() - t0)
            per_step.append({k: statistics.mean(m[k].item() for m in seen)
                             for k in ("aux_loss", "z_loss", "dropped")})
            return state, metrics

        trainer._accel.train_step = timed
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_launches()
        trainer.train()
        launches = launch_counts()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30
        log(f"  [moe] losses: {losses}")
        log(f"  [moe] step seconds: {step_s}")
        log(f"  [moe] aux, z, dropped per step (mean of the layers): "
            f"{json.dumps(per_step)}")
        log(f"  [moe] launches over {steps} steps: {launches}")
        if not all(math.isfinite(x) for x in losses):
            raise SystemExit(f"moe: non-finite loss: {losses}")
        if not losses[-1] < losses[0]:
            raise SystemExit(f"moe: loss did not fall: {losses}")
        first_gap = abs(losses[0] - plain) / abs(plain)
        log(f"  [moe] first step's loss {losses[0]} against the plain "
            f"attention's {plain}: relative gap {first_gap:.3e}")
        if first_gap > 2e-2:
            raise SystemExit(f"moe: the first loss {losses[0]} leaves the "
                             f"plain attention's {plain} by {first_gap}")
        want = {name: cfg.n_layers * steps * int(name in FLASH_KERNELS)
                for name in FLASH_KERNELS + HEADS_KERNELS + RING_KERNELS}
        for name, n in want.items():
            if launches[name] != n:
                raise SystemExit(f"moe: {name} launched {launches[name]} "
                                 f"times, want {n}")
        steady = statistics.median(step_s[MOE_WARMUP:])
        summary = {
            "config": "Mixtral-8x7B widths", "card": CARD["line"],
            "n_layers": cfg.n_layers, "n_layers_published": 32,
            "params": cfg.param_count(), "active_params": active,
            "batch": B, "seq": S, "optimizer": "adamw", "remat": "none",
            "capacity_factor": cfg.moe_capacity_factor,
            "warmup_steps": MOE_WARMUP, "measured_steps": MOE_STEPS,
            "step_ms_median": steady * 1e3,
            "first_step_ms": step_s[0] * 1e3,
            "tokens_per_s": B * S / steady,
            "flops_per_token": per_token,
            "mfu_active": mfu.mfu(per_token * B * S, steady),
            "mfu_peak_flops": mfu.peak_flops(), "peak_mem_gib": peak_gib,
            "moe_per_step": per_step,
            "k1_k4_launches_per_step": {
                name: launches[name] / steps for name in FLASH_KERNELS},
            "first_loss": losses[0], "plain_attention_first_loss": plain,
            "loss_last": losses[-1], "attention": attention,
        }
        trainer._accel.train_step = inner
        summary["profile"] = profile_moe_step(trainer, batch, cfg, B, S)
        del trainer, inner
        release()
    summary["phase_s"] = time.perf_counter() - t_phase
    log(json.dumps({"moe": summary}))
    return summary


def profile_moe_step(trainer, batch, cfg, B, S) -> dict:
    """One more [moe] step under torch.profiler with input shapes: its
    ``moe_breakdown`` line and the table (chiprun_out/profile_step_moe.txt)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 record_shapes=True) as prof:
        t0 = time.perf_counter()
        trainer._accel.train_step(trainer.state, batch, None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    out = moe_breakdown(prof.key_averages(group_by_input_shape=True), cfg,
                        B, S, busy_us)
    out.update(wall_ms=wall_us / 1e3, device_idle_share=1 - busy_us / wall_us)
    log(json.dumps({"moe_profiled_step": out}))
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_step_moe.txt").write_text(
        averages.table(sort_by="cuda_time_total", row_limit=60))
    return out


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


# ------------------------------------------------------------- [lowp]
#
# low-precision compute: K15-K17 against their plain versions, the fp8 and
# int8 GEMMs beside bf16 at llama3-8b's projection shapes, then llama3-8b's
# widths (4 of 32 layers) and gpt2-1.5b's (2 of 48) through Trainer under
# compute_dtype bfloat16, fp8 and int8

PEAK_LOWP = 1979e12  # H100 SXM dense fp8 and int8 tensor-core rate
LOWP_M = 8192        # the slice's rows: B4 x S2048
# llama3-8b's projections (K, N): q/k/v stacked, o, gate or up, down
LOWP_GEMMS = {"qkv": (4096, 6144), "o": (4096, 4096),
              "gate_up": (4096, 14336), "down": (14336, 4096)}
LOWP_LAYERS = 4      # of llama3-8b's 32: see lowp_config
LOWP_B, LOWP_S, LOWP_STEPS = 4, 2048, 6
LOWP_GPT2_LAYERS, LOWP_GPT2_STEPS = 2, 3
LOWP_KERNELS = ("quantize_fp8", "quantize_int8_channels", "dequantize_int32")
# the fp8 GEMM against the plain dequantized matmul (bf16 operands), of
# the largest value: the plain side rounds each dequantized operand to
# bf16 (2^-9) and both round the output to bf16
LOWP_GEMM_TOL = 1e-2
# a quant run's first loss against the bf16 run's (relative): the same
# weights and batch, so the gap is the quantized forward's own error. The
# later steps are not gated: on one repeated batch at lr 3e-4 the 1.92 B
# model memorizes it in a few steps along a path that amplifies any
# difference (the bf16 run's own loss rises from step 3 to 4), and a
# quant run's step-5 loss left bf16's by 7.9% in a first run
LOWP_LOSS_TOL = 2e-2


def lowp_config(layers=LOWP_LAYERS):
    """llama3-8b at its published widths (dim 4096, 32 heads over 8 kv
    heads of 128, mlp 14336, vocab 128256, rope theta 5e5), depth cut to
    ``layers``: 4 layers hold 1.92 B params, ~31 GB of f32 masters,
    grads and AdamW moments, beside the B4 S2048 activations and logits."""
    from dlrover_tpu_torch.models import PRESETS

    return dataclasses.replace(PRESETS["llama3-8b"], n_layers=layers)


def lowp_check(worst) -> None:
    """K15-K17 against their plain versions on the main path's operands
    (bit for bit), and the GEMM routes against the plain products."""
    from dlrover_tpu_torch.ops import lowp

    gen = torch.Generator(device="cuda").manual_seed(23)

    def randn(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen, device="cuda")
                * scale).to(torch.bfloat16)

    a, w = randn(LOWP_M, 4096, scale=2.0), randn(4096, 6144)
    g, ragged = randn(LOWP_M, 6144, scale=1e-3), randn(1000, 200)
    errs = {name: 0.0 for name in LOWP_KERNELS}

    def codes_err(got, want):
        got, want = got.float(), want.float()
        same_nan = torch.equal(got.isnan(), want.isnan())
        diff = (got - want).nan_to_num(0.0, 0.0, 0.0).abs().max().item()
        return diff if same_nan else math.inf

    cases = [(a, "e4m3", None), (w, "e4m3", None), (g, "e5m2", None),
             (ragged, "e4m3", None),
             (a, "e4m3", torch.tensor(2e-3, device="cuda")),   # overflows
             (g, "e5m2", torch.tensor(1e-9, device="cuda"))]
    for x, fmt, scale in cases:
        q, qt, s = lowp.quantize_fp8(x, fmt, scale, layout="both")
        pq, pqt, ps = lowp.quantize_fp8_plain(x, fmt, scale, layout="both")
        errs["quantize_fp8"] = max(errs["quantize_fp8"], codes_err(q, pq),
                                   codes_err(qt, pqt),
                                   abs(s.item() - ps.item()))
    for x, channels in ((a, "rows"), (w, "cols"), (randn(14336, 4096),
                                                    "cols"),
                        (ragged, "rows"), (ragged, "cols")):
        q, s = lowp.quantize_int8_channels(x, channels)
        pq, ps = lowp.quantize_int8_channels_plain(x, channels)
        errs["quantize_int8_channels"] = max(
            errs["quantize_int8_channels"],
            (q.int() - pq.int()).abs().max().item(),
            (s - ps).abs().max().item())
    qa, sa = lowp.quantize_int8_channels(a, "rows")
    qbt, sb = lowp.quantize_int8_channels(w, "cols")
    acc = lowp.int8_mm(qa, qbt)
    int_exact = torch.equal(acc, (qa.double() @ qbt.double().t()).to(
        torch.int32))
    for product_first in (False, True):
        for dtype in (torch.bfloat16, torch.float32):
            got = lowp.dequantize_int32(acc, sa, sb, dtype, product_first)
            want = lowp.dequantize_int32_plain(acc, sa, sb, dtype,
                                               product_first)
            errs["dequantize_int32"] = max(
                errs["dequantize_int32"],
                (got.float() - want.float()).abs().max().item())
    qa8, _, sa8 = lowp.quantize_fp8(a)
    _, qbt8, sb8 = lowp.quantize_fp8(w, layout="col")
    out = lowp.fp8_mm(qa8, qbt8.t(), sa8, sb8, torch.bfloat16)
    plain = (lowp.dequantize_fp8(qa8, sa8, torch.bfloat16)
             @ lowp.dequantize_fp8(qbt8.t(), sb8, torch.bfloat16))
    _, gemm_rel = rel_err(out, plain)
    torch.cuda.synchronize()
    failures = []
    for name, err in errs.items():
        ok = err == 0.0
        log(f"  lowp   {name:22s} max_abs_err={err:.3e} (bit-equal "
            f"required) {'ok' if ok else 'FAIL'}")
        worst[name] = err
        if not ok:
            failures.append(name)
    log(f"  lowp   int8 GEMM (torch._int_mm) exact integer products: "
        f"{'ok' if int_exact else 'FAIL'}")
    log(f"  lowp   fp8 GEMM (torch._scaled_mm) vs the plain dequantized "
        f"matmul: rel_err={gemm_rel:.3e} (tol {LOWP_GEMM_TOL}) "
        f"{'ok' if gemm_rel <= LOWP_GEMM_TOL else 'FAIL'}")
    if not int_exact:
        failures.append("int8_mm")
    if gemm_rel > LOWP_GEMM_TOL:
        failures.append("fp8_mm")
    if failures:
        raise SystemExit(f"lowp kernel check failed: {failures}")


# f32 operations an element of K15 (abs, max, divide, convert), K16 (abs,
# max, divide, round, two clamps, convert) and K17 (convert, two products)
LOWP_OPS = {"quantize_fp8": 4, "quantize_int8_channels": 7,
            "dequantize_int32": 3}


def lowp_bound(name, nbytes, elems):
    """Least time (ms) of K15-K17 on ``elems`` elements: the bytes each
    must move (each input read once, each output written once) over HBM
    bandwidth, or its f32 operations over the f32 peak."""
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = LOWP_OPS[name] * elems / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops
            else "operations")


def lowp_times(times, library, bound) -> dict:
    """The table at each of llama3-8b's projection shapes (M = 8192, CUDA
    graph replays, medians of 5): K15 on the activation and the weight,
    K16 likewise, K17 on the product, the fp8, int8 and bf16 GEMMs
    against their bounds, and the quantized matmul end to end (quantize,
    GEMM, dequantize; the forward of ``fp8_dot``/``int8_dot``) beside
    ``torch.matmul`` in bf16. The kernels line's entries take the q/k/v
    shape's activation (K15, K16) and product (K17)."""
    from dlrover_tpu_torch.ops import fp8, lowp, quantization

    gen = torch.Generator(device="cuda").manual_seed(24)
    M, table = LOWP_M, {}

    def med(fn, iters):
        return statistics.median(graph_ms(fn, iters))

    for label, (K, N) in LOWP_GEMMS.items():
        a = torch.randn(M, K, generator=gen, device="cuda").bfloat16()
        w = (torch.randn(K, N, generator=gen, device="cuda")
             * K ** -0.5).bfloat16()
        qa, _, sa = lowp.quantize_fp8(a)
        _, qbt, sb = lowp.quantize_fp8(w, layout="col")
        ia, isa = lowp.quantize_int8_channels(a, "rows")
        ibt, isb = lowp.quantize_int8_channels(w, "cols")
        acc = lowp.int8_mm(ia, ibt)
        flops = 2.0 * M * N * K
        row = {
            "K": K, "N": N,
            "k15_act_ms": med(lambda: lowp.quantize_fp8(a, layout="both"),
                              20),
            "k15_act_bound_ms": lowp_bound("quantize_fp8", M * K * 4,
                                           M * K)[0],
            "k15_weight_ms": med(
                lambda: lowp.quantize_fp8(w, layout="both"), 20),
            "k15_weight_bound_ms": lowp_bound("quantize_fp8", K * N * 4,
                                              K * N)[0],
            "k16_act_ms": med(
                lambda: lowp.quantize_int8_channels(a, "rows"), 20),
            "k16_act_bound_ms": lowp_bound(
                "quantize_int8_channels", M * K * 3 + M * 4, M * K)[0],
            "k16_weight_ms": med(
                lambda: lowp.quantize_int8_channels(w, "cols"), 20),
            "k16_weight_bound_ms": lowp_bound(
                "quantize_int8_channels", K * N * 3 + N * 4, K * N)[0],
            "k17_ms": med(lambda: lowp.dequantize_int32(
                acc, isa, isb, torch.bfloat16), 20),
            "k17_bound_ms": lowp_bound(
                "dequantize_int32", M * N * 6 + (M + N) * 4, M * N)[0],
            "fp8_gemm_ms": med(lambda: lowp.fp8_mm(
                qa, qbt.t(), sa, sb, torch.bfloat16), 10),
            "int8_gemm_ms": med(lambda: lowp.int8_mm(ia, ibt), 10),
            "bf16_gemm_ms": med(lambda: torch.matmul(a, w), 10),
            "fp8_int8_gemm_bound_ms": flops / PEAK_LOWP * 1e3,
            "bf16_gemm_bound_ms": flops / PEAK_BF16 * 1e3,
            "fp8_dot_fwd_ms": med(lambda: fp8.fp8_dot_op(a, w, None, None),
                                  10),
            "int8_dot_fwd_ms": med(lambda: quantization.int8_dot_op(a, w),
                                   10),
        }
        table[label] = row
        if label == "qkv":
            inv = lowp._INV_FMAX["e4m3"]
            times["quantize_fp8"] = (row["k15_act_ms"], med(
                lambda: lowp.quantize_fp8_plain(a, layout="both"), 5))
            bound["quantize_fp8"] = lowp_bound("quantize_fp8", M * K * 4,
                                               M * K)
            library["quantize_fp8"] = med(
                lambda: (a.float() / (a.abs().amax().float() * inv)).to(
                    torch.float8_e4m3fn), 10)
            times["quantize_int8_channels"] = (row["k16_act_ms"], med(
                lambda: lowp.quantize_int8_channels_plain(a, "rows"), 5))
            bound["quantize_int8_channels"] = lowp_bound(
                "quantize_int8_channels", M * K * 3 + M * 4, M * K)
            library["quantize_int8_channels"] = None
            times["dequantize_int32"] = (row["k17_ms"], med(
                lambda: lowp.dequantize_int32_plain(acc, isa, isb,
                                                    torch.bfloat16), 5))
            bound["dequantize_int32"] = lowp_bound(
                "dequantize_int32", M * N * 6 + (M + N) * 4, M * N)
            library["dequantize_int32"] = None
        del a, w, qa, qbt, ia, ibt, acc
        release()
    log(json.dumps({"lowp_gemms": {"card": CARD["line"], "M": M,
                                   "shapes": table}}))
    return table


def lowp_breakdown(averages, busy_us) -> dict:
    """A profiled step's device ms by part: the GEMMs by type (the aten
    rows ``_scaled_mm``, ``_int_mm``; bf16 ``mm``/``addmm``/``bmm``, the
    backward's and the head's included), K15-K17 and K1-K4 by kernel
    name, and the rest."""
    from torch.autograd import DeviceType

    def op_ms(*names):
        return sum(e.device_time_total for e in averages
                   if e.device_type == DeviceType.CPU
                   and e.key in names) / 1e3

    def kernel_ms(*patterns):
        return sum(e.self_device_time_total for e in averages
                   if e.device_type == DeviceType.CUDA
                   and any(p in e.key for p in patterns)) / 1e3

    parts = {
        "gemm_fp8": op_ms("aten::_scaled_mm"),
        "gemm_int8": op_ms("aten::_int_mm"),
        "gemm_bf16": op_ms("aten::mm", "aten::addmm", "aten::bmm"),
        "k15_quantize_fp8": kernel_ms("fp8_amax_kernel", "fp8_quant_kernel"),
        "k16_quantize_int8": kernel_ms("int8_rows_kernel",
                                       "int8_cols_kernel"),
        "k17_dequantize_int32": kernel_ms("dequant_kernel"),
        "k1_k4": kernel_ms(*(f"{n}_kernel" for n in FLASH_KERNELS),
                           "flash_fwd_rope_k_kernel"),
    }
    parts["rest"] = busy_us / 1e3 - sum(parts.values())
    return parts


def lowp_train(cfg, label, mode, remat, steps, B, S, loss_fn,
               init_fn) -> dict:
    """``steps`` Trainer steps of ``cfg`` under ``compute_dtype=mode`` on
    one repeated seeded batch (the same seeded weights in every run),
    then a profiled step; returns the run's summary with its losses."""
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    batch = synthetic_batch(cfg.vocab_size, S, B, 0)
    trainer = Trainer(
        loss_fn(cfg), lambda seed, device: init_fn(cfg, seed, device), None,
        TrainingArgs(output_dir=str(CKPT_DIR / label), max_steps=steps,
                     num_epochs=1, learning_rate=SLICE_LR,
                     optimizer="adamw", compute_dtype=mode,
                     strategy=Strategy(remat=remat), flash_checkpoint=False,
                     log_steps=0),
        train_data=[batch] * steps, device="cuda")
    inner = trainer._accel.train_step
    losses, step_s = [], []

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
    trainer._accel.train_step = inner
    tokens = {"tokens": torch.as_tensor(batch["tokens"], device="cuda")}
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        inner(trainer.state, tokens, None)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_step_{label}.txt").write_text(
        averages.table(sort_by="cuda_time_total", row_limit=60))
    del trainer, inner
    release()
    steady = statistics.median(step_s[1:])
    flops = mfu.transformer_step_flops(cfg.param_count(), B * S,
                                       cfg.n_layers, cfg.dim, S)
    summary = {
        "run": label, "compute_dtype": mode, "remat": remat,
        "n_layers": cfg.n_layers, "params": cfg.param_count(),
        "batch": B, "seq": S, "steps": steps,
        "step_ms_median_2_on": steady * 1e3,
        "first_step_ms": step_s[0] * 1e3, "tokens_per_s": B * S / steady,
        "mfu_bf16_peak": mfu.mfu(flops, steady, PEAK_BF16),
        "mfu_fp8_int8_peak_1979": mfu.mfu(flops, steady, PEAK_LOWP),
        "peak_mem_gib": peak_gib, "losses": losses,
        "launches": {n: launches[n] for n in FLASH_KERNELS + LOWP_KERNELS},
        "profiled_step": dict(
            wall_ms=wall_us / 1e3, device_busy_ms=busy_us / 1e3,
            device_idle_share=1 - busy_us / wall_us,
            parts_ms=lowp_breakdown(averages, busy_us)),
    }
    log(f"  [{label}] losses: {losses}")
    log(f"  [{label}] step seconds: {step_s}")
    log(json.dumps({"lowp_run": summary}))
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss: {losses}")
    return summary


def lowp_gate(runs, ref) -> None:
    """Each quant run launched K1-K4 and its quantize kernels (and no
    other mode's), its loss fell and its first loss is within
    LOWP_LOSS_TOL (relative) of the bf16 run's; prints the first and the
    largest gap and the bf16 step time beside the run's."""
    base = runs[ref]
    for label, run in runs.items():
        if label == ref:
            continue
        gaps = [abs(x - y) / abs(y)
                for x, y in zip(run["losses"], base["losses"])]
        log(f"  [{label}] loss gap to {ref} (relative): first "
            f"{gaps[0]:.3e}, largest {max(gaps):.3e}; step "
            f"{run['step_ms_median_2_on']:.2f} ms against {ref}'s "
            f"{base['step_ms_median_2_on']:.2f}")
        counts = run["launches"]
        want = {"fp8": ("quantize_fp8",),
                "int8": ("quantize_int8_channels", "dequantize_int32")}[
            run["compute_dtype"]]
        missing = [n for n in FLASH_KERNELS + want if counts[n] == 0]
        stray = [n for n in LOWP_KERNELS if n not in want and counts[n]]
        if missing or stray:
            raise SystemExit(f"{label}: kernels not launched {missing}, "
                             f"launched off their path {stray}")
        if gaps[0] > LOWP_LOSS_TOL or not run["losses"][-1] < run[
                "losses"][0]:
            raise SystemExit(f"{label}: losses {run['losses']} against the "
                             f"bf16 run's {base['losses']}")
    if any(base["launches"][n] for n in LOWP_KERNELS):
        raise SystemExit(f"{ref}: a quantize kernel ran in the bf16 run")


def lowp_phase(worst, times, library, bound) -> dict:
    """[lowp]: the kernel checks and the GEMM table, then llama3-8b's
    widths through Trainer under bfloat16, fp8, int8 and int8 with remat
    "minimal" (6 steps each, then a profiled step), and gpt2-1.5b's
    under each mode (3 steps). Returns the launches of K15-K17 on the
    main path (fp8's run for K15, int8's for K16 and K17)."""
    from dlrover_tpu_torch.models import (
        GPT2_PRESETS,
        gpt2_init,
        gpt2_loss_fn,
        llama_init,
        llama_loss_fn,
    )

    t_phase = time.perf_counter()
    lowp_check(worst)
    table = lowp_times(times, library, bound)
    cfg = lowp_config()
    log(f"  [lowp] llama3-8b widths, {cfg.n_layers} of 32 layers: "
        f"{cfg.param_count()} params, B{LOWP_B} S{LOWP_S}")
    job = os.environ["ELASTIC_JOB_NAME"]
    runs = {}
    with flash_env("lowp", job):
        for label, mode, remat in (
                ("lowp-bf16", "bfloat16", "none"), ("lowp-fp8", "fp8",
                                                    "none"),
                ("lowp-int8", "int8", "none"),
                ("lowp-int8-minimal", "int8", "minimal")):
            runs[label] = lowp_train(cfg, label, mode, remat, LOWP_STEPS,
                                     LOWP_B, LOWP_S, llama_loss_fn,
                                     llama_init)
        lowp_gate(runs, "lowp-bf16")
        # the quantized matmuls are saved under remat: the recompute
        # re-runs no quantize (K16/K17 as under "none"), only K1 again
        a, b = runs["lowp-int8"]["launches"], runs[
            "lowp-int8-minimal"]["launches"]
        for name in ("quantize_int8_channels", "dequantize_int32"):
            if a[name] != b[name]:
                raise SystemExit(f"lowp-int8-minimal: {name} {b[name]} "
                                 f"launches against remat none's {a[name]}")
        gcfg = dataclasses.replace(GPT2_PRESETS["gpt2-1.5b"],
                                   n_layers=LOWP_GPT2_LAYERS)
        gruns = {}
        for mode in ("bfloat16", "fp8", "int8"):
            label = f"lowp-gpt2-{mode}"
            gruns[label] = lowp_train(gcfg, label, mode, "none",
                                      LOWP_GPT2_STEPS, 8, 1024,
                                      gpt2_loss_fn, gpt2_init)
        lowp_gate(gruns, "lowp-gpt2-bfloat16")
    summary = {"card": CARD["line"], "gemms": table,
               "runs": {k: {f: v[f] for f in (
                   "step_ms_median_2_on", "tokens_per_s", "mfu_bf16_peak",
                   "mfu_fp8_int8_peak_1979", "peak_mem_gib", "launches")}
                   for k, v in {**runs, **gruns}.items()},
               "phase_s": time.perf_counter() - t_phase}
    log(json.dumps({"lowp": summary}))
    return {"quantize_fp8": runs["lowp-fp8"]["launches"]["quantize_fp8"],
            **{n: runs["lowp-int8"]["launches"][n]
               for n in ("quantize_int8_channels", "dequantize_int32")}}


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
POOL_STOP_GRACE_S = 0.2
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
        write_json(spec["stats"], dict(worker.scheduler.stats(),
                                       held=worker.scheduler.held()))

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


def kill_if_leased(victim, spec: dict, client) -> list:
    """SIGKILL a [serve-pool] worker only while the master's ledger has
    requests leased to it, and return their ids; else resume it and
    return []. The worker is stopped (SIGSTOP) before the check, so what
    it holds cannot change under it, and a report sent just before the
    stop lands during POOL_STOP_GRACE_S. A request the stopped worker
    held (its last stats) and the master still has leased can then only
    come back through the lease's expiry."""
    import signal

    victim.send_signal(signal.SIGSTOP)
    time.sleep(POOL_STOP_GRACE_S)
    held = (read_json(spec["stats"]) or {}).get("held", [])
    leased = [rid for rid in held
              if client.serve_fetch(rid).state == "leased"]
    if not leased:
        victim.send_signal(signal.SIGCONT)
        return []
    victim.send_signal(signal.SIGKILL)
    victim.wait(30)
    return leased


def serve_pool_phase() -> dict:
    """[serve-pool]: ``python -m dlrover_tpu_torch.master.main --platform
    local --port 0``, two decode worker processes on the card (each a
    DecodeWorker over RpcServingClient with a nano-350m engine at full
    width, bf16, 8 slots of 1024), a seeded Poisson sweep of 64 requests
    (prompts 16-512, 16-128 new tokens, greedy) through
    ``MasterClient.serve_submit``, worker 1 SIGKILLed mid-sweep while the
    master has requests leased to it (``kill_if_leased``). Gates: every
    request fetched ``done`` with the tokens a reference engine in this
    process (same weights, same pool shape) gives it; the ledger's done
    count 64, failed 0, at most 2 attempts, every request leased to the
    victim re-queued; overlap >= 2; no CUDA context
    beyond this process's once the workers are gone. Every process and
    file is removed at the end, also when a check fails."""
    import shutil
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
                leased = kill_if_leased(workers[POOL_KILL_RANK],
                                        specs[POOL_KILL_RANK], status_client)
                if leased:
                    killed = {"at_s": time.monotonic() - t_sweep,
                              "done_before": counts["done"],
                              "leased_in_victim": len(leased)}
                    log(f"  [serve-pool] SIGKILLed worker {POOL_KILL_RANK} "
                        f"at {killed['at_s']:.2f} s into the sweep, "
                        f"holding {len(leased)} leased request(s)")
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
        if killed is not None and counts.get("requeued_total", 0) < \
                killed["leased_in_victim"]:
            failures.append(f"{counts.get('requeued_total', 0)} re-queued "
                            f"after the kill, {killed['leased_in_victim']} "
                            f"leased to the victim")
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


# ------------------------------------------------------------ [recsys]
#
# the CTR job through the port's Trainer: a tiered KvEmbedding at MLPerf
# DLRM-dcnv2's widths (26 categorical fields of dim 128, Criteo 1TB) with
# a 2**22-row device table, GroupAdam, batch 8192 (the reference's global
# 65536 over 8 cards), 2**23 warm ids imported so that half live on the
# host tier from the first step, a Zipf id stream with a few percent of
# never-seen ids; Flash Checkpoint saves step 6, a child process resumes
# there, a PS version bump migrates the tier mid-run

RECSYS = dict(dim=128, fields=26, hidden=64, device_capacity=1 << 22)
RECSYS_SMALL = dict(dim=8, fields=4, hidden=16, device_capacity=64)
RECSYS_BATCH = 8192
RECSYS_VOCAB = 1 << 23     # warm ids: twice the device table
RECSYS_SMALL_VOCAB = 512
RECSYS_ZIPF = 1.2
RECSYS_FRESH = 0.03        # share of each batch's ids never seen before
# 12 steps (the issue's 20 cut to keep the smoke in its limit): a save
# at step 6, the child trains 7-12
RECSYS_STEPS = 12
RECSYS_SAVE_STEP = 6
RECSYS_BUMP_STEP = 3       # the PS version bump, before this step's prestep
RECSYS_LR = 1e-2
RECSYS_SEED = 17
RECSYS_DIR = ROOT / "_recsys_smoke"
# ids of the warm vocabulary (an odd multiplier is a bijection mod 2**40)
# and of never-seen ones (above 2**41)
WARM_MULT, FRESH_BASE = 2654435761, 1 << 41


def warm_ids(ranks):
    return (np.asarray(ranks, np.int64) * WARM_MULT) % (1 << 40)


def recsys_tier(cfg):
    """``make_tiered_embedding``'s tier with its host tier sized for the
    warm vocabulary up front (the default starts at the device table's
    size and doubles on the first demotion, touching 12 GB of host
    memory in one step)."""
    from dlrover_tpu_torch.ops.sparse_embedding import TieredKvEmbedding

    return TieredKvEmbedding(dim=cfg.dim, capacity=cfg.device_capacity,
                             init_scale=cfg.init_scale, seed=cfg.seed,
                             host_capacity=RECSYS_VOCAB)


class RecsysStream:
    """Step ``i``'s batch, made from (seed, i): ``ids`` [B, fields] from a
    Zipf stream over the warm vocabulary's ranks with a share of
    never-seen ids, ``labels`` the parity of the first field's rank. Its
    position rides the checkpoint (``state_dict``), as a loader's does."""

    def __init__(self, seed, steps, batch, fields, vocab):
        self.seed, self.steps, self.batch_size = seed, steps, batch
        self.fields, self.vocab, self.pos = fields, vocab, 0

    def batch(self, i):
        rng = np.random.default_rng([self.seed, i])
        shape = (self.batch_size, self.fields)
        ranks = (rng.zipf(RECSYS_ZIPF, size=shape) - 1) % self.vocab
        ids = warm_ids(ranks)
        fresh = rng.random(shape) < RECSYS_FRESH
        ids[fresh] = FRESH_BASE + rng.integers(0, 1 << 40,
                                               size=int(fresh.sum()))
        return {"ids": ids, "labels": (ranks[:, 0] % 2).astype(np.float32)}

    def __iter__(self):
        while self.pos < self.steps:
            i = self.pos
            self.pos += 1
            yield self.batch(i)

    def state_dict(self):
        return {"pos": self.pos}

    def load_state_dict(self, sd):
        self.pos = int(sd["pos"])


def recsys_preparer(kv, on_call=None):
    """The TieredBatchPreparer with each call's host ms, its rows moved
    (the tier's counters before and after) and the residency gate: every
    id of the batch resident, at the slot handed to the step."""
    from dlrover_tpu_torch.models import TieredBatchPreparer

    class Timed(TieredBatchPreparer):
        calls: list = []

        def __call__(self, state, batch, count=True):
            if on_call is not None:
                on_call(len(self.calls) + 1)
            before = dict(self.kv.counters)
            raw = np.asarray(batch["ids"])
            t0 = time.perf_counter()
            state, out = super().__call__(state, batch, count=count)
            ms = (time.perf_counter() - t0) * 1e3
            slots = self.kv.mapper.resident_slots(raw)
            if (slots < 0).any() or not np.array_equal(slots, out["slots"]):
                raise SystemExit(
                    f"recsys: {int((slots < 0).sum())} ids of the batch are "
                    f"not resident before the step")
            self.calls.append({"host_ms": ms, **{
                k: self.kv.counters[k] - before.get(k, 0)
                for k in ("demoted_rows", "promoted_rows", "fresh_rows")}})
            return state, out

    return Timed(kv)


def recsys_trainer(cfg, out, stream, prep, device="cuda", flash=True,
                   save_steps=RECSYS_SAVE_STEP, init_params=None):
    """The port's Trainer over the CTR model: GroupAdam, f32 compute (see
    ``recsys_phase``), the preparer as its prestep."""
    from dlrover_tpu_torch.models import (
        recsys_init,
        recsys_logical_axes,
        recsys_loss_fn,
    )
    from dlrover_tpu_torch.optimizers import group_adam
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    def init(seed, dev):
        if init_params is not None:
            return {k: v.to(dev) for k, v in init_params.items()}
        return recsys_init(cfg, torch.Generator(dev).manual_seed(seed),
                           prep.kv, dev)

    return Trainer(
        recsys_loss_fn(cfg), init, recsys_logical_axes(cfg),
        TrainingArgs(output_dir=str(out), max_steps=stream.steps,
                     learning_rate=RECSYS_LR, compute_dtype="float32",
                     flash_checkpoint=flash, save_steps=save_steps,
                     save_storage_every=10 ** 6, log_steps=0),
        train_data=stream, optimizer=group_adam(RECSYS_LR), prestep=prep,
        device=device)


def recsys_import(kv, table, vocab, seed):
    """Import ``vocab`` warm (id, vector, freq) triples, hottest rank
    first: the device table fills, the rest spills to the host tier.
    Vectors are drawn on the card; freqs follow the Zipf law's shape."""
    gen = torch.Generator("cuda").manual_seed(seed)
    vecs = torch.randn((vocab, kv.dim), generator=gen, device="cuda") \
        * kv.init_scale
    ranks = np.arange(vocab, dtype=np.int64)
    freqs = np.maximum(1, (1e6 * (ranks + 1.0) ** -RECSYS_ZIPF)).astype(
        np.int64)
    kv.import_(table, warm_ids(ranks), vecs, freqs)
    del vecs


def recsys_roundtrip_check() -> None:
    """A demote -> promote round-trip of rows and their aux rows (int32
    counts, f32 moments) on the card: bit-identical."""
    from dlrover_tpu_torch.ops.sparse_embedding import TieredKvEmbedding

    cap, dim = 4096, RECSYS["dim"]
    kv = TieredKvEmbedding(dim=dim, capacity=cap, seed=1)
    gen = torch.Generator("cuda").manual_seed(3)
    table = kv.init_table(gen)
    aux = [torch.randint(0, 99, (cap, 1), generator=gen, device="cuda",
                         dtype=torch.int32),
           torch.randn((cap, dim), generator=gen, device="cuda"),
           torch.rand((cap, dim), generator=gen, device="cuda")]
    ids = warm_ids(np.arange(cap))
    slots = kv.mapper.lookup(ids)   # resident at the random rows above
    idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
    before = [t.index_select(0, idx).clone() for t in [table] + aux]
    kv.prepare_batch(table, FRESH_BASE + np.arange(cap), aux=aux)  # demote all
    if kv.host_ids != cap:
        raise SystemExit(f"recsys: {kv.host_ids} rows demoted, want {cap}")
    _, slots, _ = kv.prepare_batch(table, ids, aux=aux)            # promote
    idx = torch.as_tensor(slots, dtype=torch.long, device="cuda")
    same = [torch.equal(t.index_select(0, idx), b)
            for t, b in zip([table] + aux, before)]
    log(f"  [recsys] demote -> promote round-trip of {cap} rows on the card: "
        f"table, steps, mu, nu bit-identical {same}")
    if not all(same):
        raise SystemExit("recsys: a demote/promote round-trip changed bits")


def recsys_small_check() -> dict:
    """The small configuration's first 8 losses on the card at f32
    compute against the port's CPU run from the same weights."""
    from dlrover_tpu_torch.models import RecsysConfig, make_tiered_embedding
    from dlrover_tpu_torch.models import recsys_init

    cfg = RecsysConfig(**RECSYS_SMALL)
    init = recsys_init(cfg, torch.Generator().manual_seed(0),
                       device="cpu")
    losses = {}
    for device in ("cuda", "cpu"):
        stream = RecsysStream(RECSYS_SEED, 8, 16, cfg.fields,
                              RECSYS_SMALL_VOCAB)
        tr = recsys_trainer(cfg, RECSYS_DIR / f"small_{device}", stream,
                            recsys_preparer(make_tiered_embedding(cfg)),
                            device=device, flash=False, init_params=init)
        got = record_losses(tr)
        tr.train()
        losses[device] = [x.item() for x in got]
        tr.close()
    gap = max(abs(a - b) for a, b in zip(losses["cuda"], losses["cpu"]))
    log(f"  [recsys] small config (dim 8, capacity 64, fields 4, vocab 512) "
        f"losses on the card {losses['cuda']}, on the CPU {losses['cpu']}: "
        f"largest gap {gap:.3e}")
    if len(losses["cuda"]) != 8 or gap > LOSS_TOL:
        raise SystemExit(f"recsys: the card's small-config losses leave the "
                         f"CPU's by {gap}")
    return {"small_losses_gap_to_cpu": gap}


def recsys_child(spec: dict) -> int:
    """The [recsys] resume: a fresh Trainer over the phase's job restores
    step 6 (the table, GroupAdam's state, the tier's sidecar) and trains
    steps 7-12; its losses, the restore's seconds and the tier go to
    ``spec["report"]``. It saves nothing (the phase measures the restore).
    Started early, it imports and makes its CUDA context, then waits for
    ``spec["go"]``."""
    from dlrover_tpu_torch.models import RecsysConfig
    from dlrover_tpu_torch.trainer import Trainer

    torch.cuda.init()
    go, deadline = Path(spec["go"]), time.monotonic() + 900
    while not go.exists():
        if time.monotonic() > deadline:
            return 3
        time.sleep(0.05)
    cfg = RecsysConfig(**RECSYS)
    prep = recsys_preparer(recsys_tier(cfg))
    stream = RecsysStream(RECSYS_SEED, RECSYS_STEPS, RECSYS_BATCH,
                          cfg.fields, RECSYS_VOCAB)
    tr = recsys_trainer(cfg, spec["out"], stream, prep, save_steps=0)
    tr._final_save = lambda: None
    seen = {}
    inner = Trainer.maybe_resume

    def maybe_resume(self):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        seen["step"] = inner(self)
        torch.cuda.synchronize()
        seen["restore_s"] = time.perf_counter() - t0
        return seen["step"]

    Trainer.maybe_resume = maybe_resume
    losses = record_losses(tr)
    tr.train()
    table = tr.state.params["table"]
    steps_dtype = str(tr.state.optimizer.state[table]["steps"].dtype)
    Path(spec["report"]).write_text(json.dumps({
        "resumed_from": seen["step"], "restore_s": seen["restore_s"],
        "losses": [x.item() for x in losses], "steps_dtype": steps_dtype,
        "host_ids": prep.kv.host_ids, "calls": prep.calls}))
    tr.close()
    return 0


def profile_iteration(fn, label) -> dict:
    """One call of ``fn`` (a whole loop iteration) under torch.profiler:
    the wall ms, the device's busy ms and its idle share; the table goes
    to chiprun_out/profile_step_<label>.txt."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    averages = prof.key_averages()
    busy_us = sum(e.self_device_time_total for e in averages
                  if e.device_type == DeviceType.CUDA
                  and not e.is_user_annotation)
    OUT.mkdir(exist_ok=True)
    (OUT / f"profile_step_{label}.txt").write_text(
        averages.table(sort_by="cuda_time_total", row_limit=40))
    return {"wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
            "device_idle_share": 1 - busy_us / wall_us}


def recsys_phase() -> dict:
    """[recsys]: the CTR job on the card. RecsysConfig(dim=128, fields=26,
    hidden=64, device_capacity=2**22), GroupAdam, batch 8192, f32 compute
    (under bf16 the step would cast the whole 2 GiB table each step:
    ``auto_accelerate`` casts every master before the loss). Gates: the
    small config's losses on the card against the CPU's; a bit-identical
    demote -> promote round-trip; every batch id resident before its
    step; the PS bump's migration keeps every (id, vector, freq) triple
    and the master sees the worker synced; the child's losses for steps
    7-12 within 1e-5 of the uninterrupted run's, its GroupAdam counts
    int32. The embedding's backward is ``F.embedding``'s (deterministic
    on CUDA: it sorts the slots and sums each run of equal slots in
    order), so the resumed losses are expected bit-equal; the gate takes
    1e-5."""
    import shutil
    import threading

    from dlrover_tpu_torch.agent.ckpt_saver import AsyncCheckpointSaver
    from dlrover_tpu_torch.agent.master_client import MasterClient
    from dlrover_tpu_torch.master.master import LocalJobMaster
    from dlrover_tpu_torch.models import RecsysConfig
    from dlrover_tpu_torch.scheduler.job import new_job_args
    from dlrover_tpu_torch.trainer.elastic.ps_failover import (
        PsFailoverClient,
        PsFailoverMonitor,
    )

    t_phase = time.perf_counter()
    card = CARD["line"]
    shutil.rmtree(RECSYS_DIR, ignore_errors=True)
    RECSYS_DIR.mkdir()
    outer_job = os.environ.get("ELASTIC_JOB_NAME", "")
    job = f"{outer_job}rec"
    os.environ["ELASTIC_JOB_NAME"] = job
    master = None
    # the resuming child starts now (its imports and CUDA context overlap
    # the run) and waits for the go file
    report, go = RECSYS_DIR / "child.json", RECSYS_DIR / "go"
    child_log = RECSYS_DIR / "child.log"
    with open(child_log, "w") as out:
        child = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()), "--recsys-child",
             json.dumps({"out": str(RECSYS_DIR / "run"),
                         "report": str(report), "go": str(go)})],
            cwd=str(ROOT), stdout=out, stderr=subprocess.STDOUT)
    try:
        summary = recsys_small_check()
        recsys_roundtrip_check()
        release()

        cfg = RecsysConfig(**RECSYS)
        kv = recsys_tier(cfg)
        master = LocalJobMaster(0, new_job_args("local", "recsys",
                                                node_num=1))
        master.prepare()
        failover = PsFailoverClient(MasterClient(
            f"127.0.0.1:{master.port}", 0, "worker"))
        migration = {}
        migrated = threading.Event()

        def bump(step):
            # the master migrates the PS once, mid-run; the monitor's
            # migration runs while this step's prestep waits for it
            if step != RECSYS_BUMP_STEP:
                return
            master.elastic_ps_service.inc_global_cluster_version()
            if not migrated.wait(300):
                raise SystemExit("recsys: the PS migration never ran")

        prep = recsys_preparer(kv, on_call=bump)
        stream = RecsysStream(RECSYS_SEED, RECSYS_STEPS, RECSYS_BATCH,
                              cfg.fields, RECSYS_VOCAB)
        tr = recsys_trainer(cfg, RECSYS_DIR / "run", stream, prep)
        tr._final_save = lambda: None  # step 6's save is the one resumed
        table = tr.state.params["table"]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        recsys_import(kv, table, RECSYS_VOCAB, RECSYS_SEED)
        torch.cuda.synchronize()
        import_s = time.perf_counter() - t0
        log(f"  [recsys] imported {RECSYS_VOCAB} warm triples in "
            f"{import_s:.2f} s: {len(kv.mapper)} on the card, "
            f"{kv.host_ids} on the host tier")

        def on_migrate(old, new):
            t0 = time.perf_counter()
            ids, vecs, freqs = prep.kv.export(table)
            fresh = recsys_tier(cfg)
            fresh.import_(table, ids, vecs, freqs)
            # a migrated PS carries (id, vector, freq) triples, not the
            # optimizer's slots: the table's GroupAdam state starts fresh
            for t in prep.aux_tensors(tr.state.optimizer, table):
                t.zero_()
            prep.kv = fresh
            torch.cuda.synchronize()
            migration.update(seconds=time.perf_counter() - t0,
                             rows=int(ids.size), versions=(old, new))
            ids2, vecs2, freqs2 = fresh.export(table)
            a, b = np.argsort(ids), np.argsort(ids2)
            migration["triples_equal"] = bool(
                np.array_equal(ids[a], ids2[b])
                and np.array_equal(vecs[a], vecs2[b])
                and np.array_equal(freqs[a], freqs2[b]))
            migrated.set()

        monitor = PsFailoverMonitor(failover, on_migrate, interval=0.05)
        monitor.start()
        saves = []
        inner_save = tr.save_checkpoint

        def save_checkpoint(persist=False):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            ok = inner_save(persist=persist)
            saves.append({"step": tr.global_step, "ok": ok,
                          "blocking_s": time.perf_counter() - t0})
            tr.args.save_steps = 0   # one save: step 6's
            return ok

        tr.save_checkpoint = save_checkpoint
        inner_step, losses, spans = tr._accel.train_step, [], []

        def recording(state, batch, rng):
            t0 = time.perf_counter()
            state, metrics = inner_step(state, batch, rng)
            torch.cuda.synchronize()
            spans.append((t0, time.perf_counter()))
            losses.append(metrics["loss"])
            return state, metrics

        tr._accel.train_step = recording
        t0 = time.perf_counter()
        tr.train()
        train_s = time.perf_counter() - t0
        monitor.stop()
        synced = master.elastic_ps_service.all_workers_synced()
        run_losses = [x.item() for x in losses]
        calls = prep.calls
        step_ms = [(spans[i][1] - spans[i - 1][1]) * 1e3
                   for i in range(1, len(spans))]
        device_bytes = table.numel() * table.element_size() + sum(
            t.numel() * t.element_size()
            for t in tr.state.optimizer.state[table].values())
        host_bytes = prep.kv.host_bytes()
        log(f"  [recsys] losses {run_losses}")
        log(f"  [recsys] PS bump before step {RECSYS_BUMP_STEP}: "
            f"{json.dumps(migration)}, all_workers_synced {synced}")
        if (not migration.get("triples_equal") or not synced
                or failover.local_version != 1):
            raise SystemExit(f"recsys: the PS migration failed: {migration}, "
                             f"synced {synced}")
        if len(saves) != 1 or not saves[0]["ok"] \
                or saves[0]["step"] != RECSYS_SAVE_STEP:
            raise SystemExit(f"recsys: saves {saves}, want one at step "
                             f"{RECSYS_SAVE_STEP}")
        if len(run_losses) != RECSYS_STEPS or not all(
                math.isfinite(x) for x in run_losses):
            raise SystemExit(f"recsys: losses {run_losses}")

        # one more loop iteration (prestep and step) under the profiler
        extra = stream.batch(RECSYS_STEPS)
        profiled = profile_iteration(lambda: inner_step(
            *prep(tr.state, extra), None), "recsys")
        tr.close()
        del tr, table, kv, prep
        AsyncCheckpointSaver.reset()
        release()

        # the resume in the child process
        t0 = time.perf_counter()
        go.write_text("")
        child.wait(timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != 0:
            log(child_log.read_text()[-4000:])
            raise SystemExit(f"recsys: the resuming child exited "
                             f"{child.returncode}")
        resumed = json.loads(report.read_text())
        log(f"  [recsys] child: resumed from step {resumed['resumed_from']} "
            f"in {resumed['restore_s']:.2f} s, losses {resumed['losses']}, "
            f"GroupAdam steps {resumed['steps_dtype']}, {child_s:.1f} s")
        if resumed["resumed_from"] != RECSYS_SAVE_STEP \
                or resumed["steps_dtype"] != "torch.int32" \
                or len(resumed["losses"]) != RECSYS_STEPS - RECSYS_SAVE_STEP:
            raise SystemExit(f"recsys: the child {resumed}")
        gap = loss_gap("recsys-resume", resumed["losses"],
                       run_losses[RECSYS_SAVE_STEP:], LOSS_TOL,
                       to="the uninterrupted run")

        def median(key, rows):
            return statistics.median(r[key] for r in rows)

        steady = calls[1:]
        summary.update({
            "config": "RecsysConfig(dim=128, fields=26, hidden=64, "
                      "device_capacity=2**22), GroupAdam, f32 compute",
            "batch": RECSYS_BATCH, "steps": RECSYS_STEPS,
            "warm_vocab": RECSYS_VOCAB, "import_s": import_s,
            "step_ms_median_2_on": statistics.median(step_ms),
            "prestep_host_ms_median_2_on": median("host_ms", steady),
            "demoted_rows_per_step_median": median("demoted_rows", steady),
            "promoted_rows_per_step_median": median("promoted_rows", steady),
            "fresh_rows_per_step_median": median("fresh_rows", steady),
            "rows_per_step": calls,
            "device_bytes_table_and_optimizer": device_bytes,
            "host_tier_bytes": host_bytes,
            "save_blocking_s": saves[0]["blocking_s"],
            "restore_s": resumed["restore_s"], "child_s": child_s,
            "migration_s": migration["seconds"],
            "migration_rows": migration["rows"],
            "resume_loss_gap": gap, "train_s": train_s,
            "profiled_iteration": profiled,
            "phase_s": time.perf_counter() - t_phase, "card": card})
        log(json.dumps({"recsys": summary}))
        return summary
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
        if master is not None:
            master.stop()
        os.environ["ELASTIC_JOB_NAME"] = outer_job
        gone = unlink_segments(job)
        if gone:
            log(f"  [recsys] cleanup: unlinked {gone}")
        shutil.rmtree(RECSYS_DIR, ignore_errors=True)


# ---------------------------------------------------------- [coworker]
#
# the input pipeline feeding the slice's Trainer: nano-350m (B8 S2048,
# flash, adamw) fed in process, by DevicePrefetcher(CoworkerDataset) with
# a CoworkerDataService process, and by ShmBatchWriter (a process) ->
# ShmDataLoader -> DevicePrefetcher; every arm the same token batches

COWORKER_STEPS = 8
COWORKER_ELASTIC_LAYERS = 2
COWORKER_WORLDS = (1, 2, 4)     # accum 4, 2, 1 at global 8, micro 2
COWORKER_MICRO = 2


def coworker_batches(vocab, S, B, n):
    """The example's token stream, ``n`` batches of ``B`` rows in order."""
    from dlrover_tpu_torch.examples.llama_pretrain import (
        synthetic_token_stream,
    )

    ds = synthetic_token_stream(vocab, S, n_samples=B * n)
    return [{"tokens": np.stack([ds[i * B + r] for r in range(B)])}
            for i in range(n)]


def coworker_child(spec: dict) -> int:
    """A feeder process: ``spec["role"]`` "coworker" serves the batches
    through a CoworkerDataService announcing to ``spec["info"]``; "shm"
    puts them through a ShmBatchWriter. Runs until ``spec["stop"]``
    exists."""
    batches = coworker_batches(spec["vocab"], spec["seq"], spec["batch"],
                               spec["n"])
    stop = Path(spec["stop"])
    if spec["role"] == "coworker":
        from dlrover_tpu_torch.trainer.elastic.coworker import (
            CoworkerDataService,
        )

        cw = CoworkerDataService(lambda: iter(batches),
                                 announce_to=spec["info"], announce_every=1,
                                 queue_size=4)
        cw.start()
        closer = cw.stop
    else:
        from dlrover_tpu_torch.trainer.elastic import ShmBatchWriter

        writer = ShmBatchWriter(spec["name"], slots=4,
                                slot_bytes=spec["slot_bytes"])
        for b in batches:
            writer.put(b, timeout=120)
        writer.end()
        closer = lambda: writer.close(unlink=True)  # noqa: E731
    deadline = time.monotonic() + 600
    while not stop.exists() and time.monotonic() < deadline:
        time.sleep(0.02)
    closer()
    return 0


class TimedFeed:
    """An iterable whose iterator records each ``next``'s wall ms: the
    handoff, what the Trainer waits for a batch."""

    def __init__(self, inner):
        self.inner, self.ms = inner, []

    def __iter__(self):
        it = iter(self.inner)
        while True:
            t0 = time.perf_counter()
            try:
                item = next(it)
            except StopIteration:
                return
            self.ms.append((time.perf_counter() - t0) * 1e3)
            yield item


def coworker_train(cfg, label, feed, steps=COWORKER_STEPS):
    """nano-350m through the Trainer over ``feed``: (losses, step ms of
    steps 2..n, launches, trainer)."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy
    from dlrover_tpu_torch.trainer import Trainer, TrainingArgs

    tr = Trainer(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        None, TrainingArgs(output_dir=str(OUT / f"coworker_{label}"),
                           max_steps=steps, learning_rate=SLICE_LR,
                           optimizer="adamw", strategy=Strategy(remat="none"),
                           flash_checkpoint=False, log_steps=0),
        train_data=feed, device="cuda")
    inner, losses, starts = tr._accel.train_step, [], []

    def recording(state, batch, rng):
        starts.append(time.perf_counter())
        state, metrics = inner(state, batch, rng)
        losses.append(metrics["loss"])
        return state, metrics

    tr._accel.train_step = recording
    torch.cuda.synchronize()
    reset_launches()
    tr.train()
    torch.cuda.synchronize()
    end = time.perf_counter()
    launches = launch_counts()
    step_ms = [(b - a) * 1e3 for a, b in zip(starts[1:], starts[2:] + [end])]
    return [x.item() for x in losses], step_ms, launches, tr


def elastic_world_runs(cfg, batches) -> dict:
    """ElasticTrainer at world sizes 1, 2 and 4 over the same global
    batches of 8 at micro 2 (accum 4, 2, 1): 2 layers of nano-350m, f32
    compute (the reference attention: the flash kernels take bf16), the
    ranks of a world run in turn on the card and their gradients are
    averaged before one AdamW update. Their losses must agree within
    1e-5."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.trainer.elastic import ElasticTrainer

    small = dataclasses.replace(cfg, n_layers=COWORKER_ELASTIC_LAYERS,
                                attn_impl="reference", dtype="float32")
    loss_fn = llama_loss_fn(small)
    init = {k: v.float() for k, v in llama_init(small, 0, "cuda").items()}
    out = {}
    for world in COWORKER_WORLDS:
        et = ElasticTrainer(len(batches[0]["tokens"]), COWORKER_MICRO, world)
        params = {k: v.clone().requires_grad_() for k, v in init.items()}
        opt = torch.optim.AdamW(list(params.values()), lr=SLICE_LR,
                                weight_decay=0.0)
        taken = []

        def grad_fn(p, mb):
            loss = loss_fn(p, mb, None)
            grads = torch.autograd.grad(loss, list(p.values()))
            return loss.detach(), dict(zip(p, grads))

        step = et.wrap_step(grad_fn, lambda p, o, g: (taken.append(g) or p,
                                                      o))
        losses = []
        for batch in batches:
            tokens = torch.as_tensor(batch["tokens"], device="cuda")
            local = et.local_batch_size
            rank_losses = []
            for rank in range(world):
                _, _, loss = step(params, None, {
                    "tokens": tokens[rank * local:(rank + 1) * local]})
                rank_losses.append(loss)
            with torch.no_grad():
                for name, p in params.items():
                    p.grad = sum(g[name] for g in taken) / world
            taken.clear()
            opt.step()
            opt.zero_grad(set_to_none=True)
            losses.append((sum(rank_losses) / world).item())
        out[world] = {"accum": et.accum_steps, "losses": losses}
        del params, opt
        release()
    ref = out[COWORKER_WORLDS[0]]["losses"]
    gap = max(abs(a - b) for w in COWORKER_WORLDS[1:]
              for a, b in zip(out[w]["losses"], ref))
    log(f"  [coworker] ElasticTrainer worlds {json.dumps(out)}; largest "
        f"gap to world 1: {gap:.3e}")
    if gap > LOSS_TOL:
        raise SystemExit(f"coworker: ElasticTrainer's losses differ across "
                         f"world sizes by {gap}")
    return {"elastic_worlds": out, "elastic_world_gap": gap}


def coworker_phase() -> dict:
    """[coworker]: the input pipeline feeding nano-350m (B8 S2048, flash,
    adamw) through the port's Trainer. The in-process feed first; then
    DevicePrefetcher(CoworkerDataset) with one CoworkerDataService
    process; then a ShmBatchWriter process -> ShmDataLoader ->
    DevicePrefetcher. Every arm trains on the same token batches, so its 8
    losses must be within 1e-5 of the in-process run's, with K1-K4 16
    launches a step. Printed: each arm's step ms beside the in-process
    feed's, the prefetcher's copy ms on its side stream, the handoff ms
    per batch, a profiled iteration's idle share. Before the arms,
    ElasticTrainer at world sizes 1, 2 and 4."""
    from dlrover_tpu_torch.common.ipc import socket_path
    from dlrover_tpu_torch.trainer.elastic import (
        DevicePrefetcher,
        ShmDataLoader,
    )
    from dlrover_tpu_torch.trainer.elastic.coworker import (
        CoworkerDataset,
        DataInfoService,
    )

    t_phase = time.perf_counter()
    cfg = slice_config()
    B, S, n = 8, 2048, COWORKER_STEPS
    batches = coworker_batches(cfg.vocab_size, S, B, n)
    want = attention_launches(cfg, n)
    runs = {}

    def gate(label, losses, launches):
        for name in FLASH_KERNELS:
            if launches[name] != want[name]:
                raise SystemExit(f"coworker: {label}: {name} launched "
                                 f"{launches[name]} times, want "
                                 f"{want[name]}")
        if label != "in-process":
            runs[label]["loss_gap"] = loss_gap(
                f"coworker-{label}", losses, runs["in-process"]["losses"],
                LOSS_TOL, to="the in-process feed")

    stop = OUT / "coworker.stop"
    stop.unlink(missing_ok=True)
    spec = {"vocab": cfg.vocab_size, "seq": S, "batch": B, "stop": str(stop)}
    info = DataInfoService()
    info.start()
    procs = []

    def feeder(role, **extra):
        proc = subprocess.Popen(
            [sys.executable, str(Path(__file__).resolve()),
             "--coworker-child", json.dumps({**spec, "role": role,
                                             **extra})], cwd=str(ROOT))
        procs.append(proc)
        return proc

    try:
        # both feeders start first: their start-up overlaps the
        # ElasticTrainer runs, which time nothing. The coworker's service
        # holds two batches more, for the profiled iteration after its run;
        # the shm writer fills its 4 slots and waits for the loader
        name = f"cw{os.getpid()}"
        slot_bytes = 2 * B * (S + 1) * 4 + (1 << 16)
        feeder("coworker", info=info.addr, n=n + 2)
        feeder("shm", name=name, slot_bytes=slot_bytes, n=n)
        elastic = elastic_world_runs(cfg, batches)
        losses, step_ms, launches, tr = coworker_train(cfg, "inproc",
                                                       batches)
        runs["in-process"] = {"losses": losses,
                              "step_ms_median": statistics.median(step_ms)}
        gate("in-process", losses, launches)
        tr.close()
        del tr
        release()

        # the coworker arm
        prefetch = DevicePrefetcher(
            CoworkerDataset(info.addr, n_batches=n, fetch_timeout=60.0),
            device="cuda", depth=2)
        feed = TimedFeed(prefetch)
        losses, step_ms, launches, tr = coworker_train(cfg, "coworker", feed)
        runs["coworker"] = {
            "losses": losses, "step_ms_median": statistics.median(step_ms),
            "copy_ms_median": statistics.median(prefetch.copy_ms()),
            "handoff_ms_median": statistics.median(feed.ms)}
        gate("coworker", losses, launches)
        # a steady iteration of the same feed under the profiler: the
        # first of two more batches warms a fresh dataset's fetch thread
        extra = iter(DevicePrefetcher(
            CoworkerDataset(info.addr, n_batches=2, fetch_timeout=60.0),
            device="cuda"))
        tr._accel.train_step(tr.state, next(extra), None)

        def one_iteration():
            tr._accel.train_step(tr.state, next(extra), None)

        runs["coworker"]["profiled_iteration"] = profile_iteration(
            one_iteration, "coworker")
        tr.close()
        del tr
        release()

        # the shm arm
        deadline = time.monotonic() + 120
        sock = Path(socket_path("queue", f"batchfill_{name}"))
        while not sock.exists():
            if time.monotonic() > deadline:
                raise SystemExit("coworker: the shm writer never started")
            time.sleep(0.02)
        loader = ShmDataLoader(name, slots=4, slot_bytes=slot_bytes)
        prefetch = DevicePrefetcher(loader, device="cuda", depth=2)
        feed = TimedFeed(prefetch)
        losses, step_ms, launches, tr = coworker_train(cfg, "shm", feed)
        runs["shm"] = {"losses": losses,
                       "step_ms_median": statistics.median(step_ms),
                       "copy_ms_median": statistics.median(prefetch.copy_ms()),
                       "handoff_ms_median": statistics.median(feed.ms)}
        gate("shm", losses, launches)
        tr.close()
        loader.close()
        del tr
        release()
    finally:
        stop.write_text("")
        for proc in procs:
            try:
                proc.wait(60)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait()
        info.stop()
        stop.unlink(missing_ok=True)
    for proc in procs:
        if proc.returncode != 0:
            raise SystemExit(f"coworker: a feeder exited {proc.returncode}")

    summary = {"config": "nano-350m", "batch": B, "seq": S, "steps": n,
               **{k: {kk: vv for kk, vv in v.items() if kk != "losses"}
                  for k, v in runs.items()}}
    summary.update(elastic)
    summary.update(phase_s=time.perf_counter() - t_phase, card=CARD["line"])
    for label, run in runs.items():
        log(f"  [coworker] {label}: losses {run['losses']}")
    log(json.dumps({"coworker": summary}))
    return summary


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

    # 5a. the in-process reshape on the card: 1 -> 1 over a re-formed
    # NCCL group, K1-K4 on both sides of the round
    log("phase reshape1:")
    reshape1_phase(slice_config())
    release()

    # 5b. the GPT-2 family: gpt2-1.5b through Trainer, K1-K4 at head_dim 64
    log("phase gpt2:")
    gpt2_launches = gpt2_phase()
    launches.update({name + "_d64": gpt2_launches[name]
                     for name in FLASH_KERNELS})
    release()

    # 5b'. MoE: a llama at Mixtral-8x7B's widths through Trainer, K1-K4
    # at GQA 4 and S 4096
    log("phase moe:")
    moe_phase(worst)
    release()

    # 5b''. low-precision compute: K15-K17, the fp8/int8 GEMMs, llama3-8b's
    # and gpt2-1.5b's widths under compute_dtype fp8 and int8
    log("phase lowp:")
    launches.update(lowp_phase(worst, times, library, bound))
    release()

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

    # 5e. the recsys family: the tiered-KvEmbedding CTR job through the
    # Trainer (spill, PS migration, a resume in a child), then the input
    # pipeline (coworker and shm feeds through the side-stream prefetcher)
    log("phase recsys:")
    recsys_phase()
    release()
    log("phase coworker:")
    coworker_phase()
    release()

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
    if sys.argv[1:2] == ["--recsys-child"]:
        sys.exit(recsys_child(json.loads(sys.argv[2])))
    if sys.argv[1:2] == ["--coworker-child"]:
        sys.exit(coworker_child(json.loads(sys.argv[2])))
    sys.exit(main())
