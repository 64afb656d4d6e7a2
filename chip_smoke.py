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
   shape each kernel's ms, its plain version's ms, SDPA's ms as the
   library yardstick (its backward from CUDA-graph replays, forward and
   backward less forward), and the bound (bytes or tensor-core
   operations at the H100 SXM peaks), K1's time including its rope
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
   adamw (torch.optim.AdamW, the earlier slice; then a profiled step
   and, logged only, 5 steps on the example's token stream),
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
   with a profiled step;
6. one JSON line with every kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when CUDA is missing. Longer reports
(per-op profile of one step) go to ``chiprun_out/``.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import math
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
# ring blocks (B, H, KVH, shard length): the slice's block shape first
RING_SHAPES = {
    "ring": (8, 8, 8, 512),
    "ring-gqa": (2, 32, 8, 256),
    "ring-ragged": (2, 8, 4, 500),
}
SEQ = 4  # ranks of the [seq4] run's seq axis

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


def rope_tables(B, S, dtype):
    from dlrover_tpu_torch.models.llama import _rope_tables

    pos = torch.arange(S, device="cuda").expand(B, S)
    cos, sin = _rope_tables(pos, HEAD_DIM // 2, 10000.0, dtype)
    return torch.cat([cos, cos], -1), torch.cat([sin, sin], -1)


def make_inputs(shape, seed):
    B, H, KVH, S = shape
    gen = torch.Generator(device="cuda").manual_seed(seed)

    def randn(heads):
        return torch.randn(B, heads, S, HEAD_DIM, generator=gen,
                           device="cuda").to(torch.bfloat16)

    q, k, v, do = randn(H), randn(KVH), randn(KVH), randn(H)
    cos, sin = rope_tables(B, S, torch.bfloat16)
    return q, k, v, do, cos, sin


def rel_err(got, want) -> tuple[float, float]:
    diff = (got.float() - want.float()).abs().max().item()
    return diff, diff / max(want.float().abs().max().item(), 1e-30)


class Judge:
    """Holds kernel outputs against plain ones at one case, logging each
    comparison; ``worst`` collects each kernel's largest absolute error
    (end-to-end checks are logged and judged, not collected)."""

    def __init__(self, name, worst):
        self.name, self.worst, self.failures = name, worst, []

    def __call__(self, kernel, what, got, want, collect=True):
        abs_err, rel = rel_err(got, want)
        if collect:
            self.worst[kernel] = max(self.worst.get(kernel, 0.0), abs_err)
        ok = abs_err <= LSE_ABS_TOL if what == "lse" else rel <= REL_TOL[what]
        log(f"  {self.name:6s} {kernel:21s} {what:5s} max_abs_err="
            f"{abs_err:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            self.failures.append(f"{self.name}/{kernel}/{what}")

    def done(self):
        torch.cuda.synchronize()
        if self.failures:
            raise SystemExit(f"kernel check failed: {self.failures}")


def check_shape(name, shape, seed, worst, window=None, prefix=None):
    """K1-K4 vs plain versions at one shape (with rope; the mask extras
    when given); fills ``worst`` with each kernel's largest absolute
    error. Returns the inputs for timing."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, cos, sin = make_inputs(shape, seed)
    mask = (True, HEAD_DIM ** -0.5, window, prefix)
    judge = Judge(name, worst)

    # each kernel on shared inputs (the kernel chain's own o/lse/delta)
    o, lse = att.flash_fwd(q, k, v, cos, sin, *mask)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, *mask)
    judge("flash_fwd", "o", o, o_p)
    judge("flash_fwd", "lse", lse, lse_p)
    del o_p, lse_p
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


def bounds(shape):
    """Least time (ms) per kernel at ``shape``: the larger of bytes moved
    (each input read once, each output written once) over HBM bandwidth
    and the products' operations over the peak for their type. Causal
    work counts only the S(S+1)/2 visible (query, key) pairs."""
    B, H, KVH, S = shape
    D = HEAD_DIM
    pairs = B * H * S * (S + 1) / 2
    q_b, kv_b, row_b = B * H * S * D * 2, B * KVH * S * D * 2, B * H * S * 4
    tab_b = 2 * B * S * D * 2
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
    times = {
        "flash_fwd": (
            cuda_ms(lambda: att.flash_fwd(q, k, v, cos, sin, True, scale), 20),
            cuda_ms(lambda: att.flash_fwd_plain(q, k, v, cos, sin, True,
                                                scale), 3)),
        "flash_bwd_preprocess": (k2["kernel"], k2["plain"]),
        "flash_bwd_dq": (
            cuda_ms(lambda: att.flash_bwd_dq(*args), 20),
            cuda_ms(lambda: att.flash_bwd_dq_plain(*args), 3)),
        "flash_bwd_dkv": (
            cuda_ms(lambda: att.flash_bwd_dkv(*args), 20),
            cuda_ms(lambda: att.flash_bwd_dkv_plain(*args), 3)),
    }
    # library yardstick: SDPA (flash backend) on pre-roped q/k; timed
    # here only, the port never calls it
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qr = att._rope(q, cos, sin).to(torch.bfloat16).requires_grad_()
    kr = att._rope(k, cos, sin).to(torch.bfloat16).requires_grad_()
    vr = v.clone().requires_grad_()
    fwd_ms = cuda_ms(lambda: sdpa(qr, kr, vr, is_causal=True), 20)
    bwd_ms = sdpa_bwd_ms((qr, kr, vr), do, "slice")
    library = {"flash_fwd": fwd_ms, "flash_bwd_preprocess": k2["library"]}
    prepass_ms = {"flash_fwd": statistics.median(prepass)}
    prepass_ms["flash_bwd_dq"] = prepass_ms["flash_bwd_dkv"] = (
        statistics.median(bwd_prepass))
    return times, library, bwd_ms, prepass_ms


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
    times = {}
    for name, call in (("flash_fwd_heads", fwd), ("flash_bwd_dq_heads", args),
                       ("flash_bwd_dkv_heads", args)):
        kernel, plain = getattr(att, name), getattr(att, name + "_plain")
        times[name] = (cuda_ms(lambda: kernel(*call), 20),
                       cuda_ms(lambda: plain(*call), 3))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    views = [att._split_heads(t, H).detach().requires_grad_()
             for t in (q, k, v)]
    fwd_ms = cuda_ms(lambda: sdpa(*views, is_causal=True), 20)
    bwd_ms = sdpa_bwd_ms(views, att._split_heads(do, H), "bshd views")
    return times, {"flash_fwd_heads": fwd_ms}, bwd_ms


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
    return {kernel.__name__: kernel.launches for mod in kernel_modules()
            for kernel in mod.KERNELS}


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


def state_bytes(optimizer) -> int:
    """Bytes of the tensors an optimizer keeps in its state."""
    def walk(value):
        if isinstance(value, torch.Tensor):
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


def attention_launches(cfg, steps, seq=1):
    """The launches of each attention kernel a run of ``steps`` steps
    must show: one per layer and step for the kernels of
    ``cfg.attn_impl``'s route; under a seq axis of ``seq`` ranks, for
    each ring-block kernel n(n+1)/2 per layer and step (the blocks not
    wholly in a shard's future) and for K2 n (one per rank); none for
    the other routes' kernels."""
    per_step = {name: 1 for name in (
        FLASH_KERNELS if cfg.attn_impl == "flash" else HEADS_KERNELS)}
    if seq > 1:
        per_step = {name: seq * (seq + 1) // 2 for name in RING_KERNELS}
        per_step["flash_bwd_preprocess"] = seq
    return {name: cfg.n_layers * steps * per_step.get(name, 0)
            for name in dict.fromkeys(FLASH_KERNELS + HEADS_KERNELS
                                      + RING_KERNELS)}


def train_run(cfg, label, factory, strategy, steps=5, B=8, S=2048,
              optimizer=None):
    """``steps`` train steps on one repeated seeded batch; returns (res,
    state, batch, losses, launches, summary). Uniform random tokens hold
    nothing a model can learn across batches, so only a repeated batch
    makes a falling loss show that the step learns. ``optimizer`` names
    the optimizer in the summary (default: ``label``)."""
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import auto_accelerate

    res = auto_accelerate(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        factory, strategy, device="cuda", seed=0)
    state = res.state
    opt_events = time_optimizer_steps(state.optimizer)
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
    opt_ms = [a.elapsed_time(b) for a, b in opt_events]
    log(f"  [{label}] losses: {losses}")
    log(f"  [{label}] step seconds: {step_s}")
    log(f"  [{label}] optimizer.step ms: {opt_ms}")
    log(f"  [{label}] launches over {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"{label}: non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"{label}: loss did not fall: {losses}")
    for name, want in attention_launches(cfg, steps,
                                         strategy.mesh.seq).items():
        if launches[name] != want:
            raise SystemExit(f"{label}: {name} launched {launches[name]} "
                             f"times, want {want}")
    steady = statistics.median(step_s[1:])
    flops = mfu.transformer_step_flops(cfg.param_count(), B * S,
                                       cfg.n_layers, cfg.dim, S)
    summary = {
        "config": "nano-350m", "attn_impl": cfg.attn_impl,
        "optimizer": optimizer or label, "batch": B, "seq": S,
        "seq_transport": res.mesh.ring.describe() if res.mesh.ring else None,
        "steps": steps, "step_ms_median_2_to_5": steady * 1e3,
        "host_enqueue_ms_median_2_to_5":
            statistics.median(enqueue_s[1:]) * 1e3,
        "first_step_ms": step_s[0] * 1e3,
        "tokens_per_s": B * S / steady,
        "mfu": mfu.mfu(flops, steady), "mfu_peak_flops": mfu.peak_flops(),
        "peak_mem_gib": peak_bytes / 2**30,
        "opt_state_gb": state_bytes(state.optimizer) / 1e9,
        "opt_step_ms_median_2_to_5": statistics.median(opt_ms[1:]),
        "loss_first": losses[0], "loss_last": losses[-1],
    }
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
    res, state, batch, adamw_losses, launches, _ = train_run(
        cfg, "adamw", build_optimizer("adamw", SLICE_LR, weight_decay=0.0),
        Strategy(remat="none"), steps)
    profile_step(res, state, batch)
    del res, state
    release()
    stream_losses(cfg, B, S, steps)
    release()

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
    return launches


def loss_gap(label, losses, adamw_losses, limit=2e-2):
    """Fail when a run's losses leave the adamw run's by more than
    ``limit`` at any step."""
    gap = max(abs(a - b) for a, b in zip(losses, adamw_losses))
    log(f"  [{label}] largest loss gap to adamw: {gap:.3e}")
    if gap > limit:
        raise SystemExit(f"{label}: losses {losses} leave adamw's "
                         f"{adamw_losses} by {gap}")


def stream_losses(cfg, B, S, steps):
    """Log (no assertion) the losses of ``steps`` fresh steps on the
    example's token stream, a new batch each step as
    examples/llama_pretrain.py draws them."""
    from dlrover_tpu_torch.models import llama_init, llama_loss_fn
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.trainer import build_optimizer

    res = auto_accelerate(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        build_optimizer("adamw", 3e-4, weight_decay=0.0),
        Strategy(remat="none"), device="cuda", seed=0)
    state, losses = res.state, []
    for s in range(steps):
        state, metrics = res.train_step(
            state, synthetic_batch(cfg.vocab_size, S, B, s), None)
        losses.append(metrics["loss"].item())
    log(f"  losses on the example's stream (a new batch per step, logged "
        f"only): {losses}")


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
    log(json.dumps({"profiled_step": {
        "run": label, "wall_ms": wall_us / 1e3,
        "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us}}))
    table = averages.table(sort_by="cuda_time_total", row_limit=60)
    name = ("profile_step.txt" if label == "adamw"
            else f"profile_step_{label}.txt")
    OUT.mkdir(exist_ok=True)
    (OUT / name).write_text(table)
    log(f"  profile of one step (top rows, full table in "
        f"chiprun_out/{name}):")
    for line in table.splitlines()[:top]:
        log("    " + line)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is "
              "False); this script runs on the GPU only", file=sys.stderr)
        return 2
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
    print(smi.stdout.strip().splitlines()[0], flush=True)

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
    sys.exit(main())
