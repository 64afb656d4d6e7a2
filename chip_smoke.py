#!/usr/bin/env python3
"""Smoke run of the PyTorch port (dlrover_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each fatal on failure (no exception is caught):

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel from ``dlrover_tpu_torch/ops/csrc`` (parallel
   nvcc, sm_90a), with its seconds and the ptxas register report;
3. each kernel against its plain PyTorch version in bf16 at three
   shapes (the training slice's B8 H8 S2048 D128, a GQA shape H32/KVH8
   S1024, a ragged S=1000), per kernel on shared inputs and end to end
   through the autograd Function; at the slice's shape the kernel's ms,
   the plain version's ms, SDPA's ms as the library yardstick, and the
   bound (bytes or tensor-core operations at the H100 SXM peaks);
4. the training slice: ``auto_accelerate`` on nano-350m at full width
   (16 layers, dim 1024, 8 heads, vocab 32000), B=8, S=2048, adamw at
   lr 3e-4, 5 steps on one seeded synthetic batch; the loss must be
   finite and fall, and every kernel's launch count over those steps must show
   the path ran through it (flash_fwd exactly 16 per step); then, logged
   only, the losses of 5 fresh steps on the example's token stream;
5. one JSON line with every kernel's numbers, then the last line
   ``{"ok": true, "device": {...}}``.

Exits non-zero with no result line when CUDA is missing. Longer reports
(per-op profile of one step) go to ``chiprun_out/``.
"""

from __future__ import annotations

import dataclasses
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
REL_TOL = {"o": 2e-2, "delta": 1e-3, "dq": 3e-2, "dk": 3e-2, "dv": 3e-2}
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
}


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


def check_shape(name, shape, seed, worst):
    """Kernels vs plain versions at one shape; fills ``worst`` with each
    kernel's largest absolute error. Returns the inputs for timing."""
    from dlrover_tpu_torch.ops import attention as att

    q, k, v, do, cos, sin = make_inputs(shape, seed)
    scale = HEAD_DIM ** -0.5
    failures = []

    def judge(kernel, what, got, want):
        abs_err, rel = rel_err(got, want)
        worst[kernel] = max(worst.get(kernel, 0.0), abs_err)
        ok = abs_err <= LSE_ABS_TOL if what == "lse" else rel <= REL_TOL[what]
        log(f"  {name:6s} {kernel:21s} {what:5s} max_abs_err={abs_err:.3e} "
            f"rel={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}/{kernel}/{what}")

    # each kernel on shared inputs (the kernel chain's own o/lse/delta)
    o, lse = att.flash_fwd(q, k, v, cos, sin, True, scale)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    judge("flash_fwd", "o", o, o_p)
    judge("flash_fwd", "lse", lse, lse_p)
    del o_p, lse_p
    delta = att.flash_bwd_preprocess(do, o)
    judge("flash_bwd_preprocess", "delta", delta,
          att.flash_bwd_preprocess_plain(do, o))
    args = (q, k, v, do, lse, delta, cos, sin, True, scale)
    judge("flash_bwd_dq", "dq", att.flash_bwd_dq(*args),
          att.flash_bwd_dq_plain(*args))
    dk, dv = att.flash_bwd_dkv(*args)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*args)
    judge("flash_bwd_dkv", "dk", dk, dk_p)
    judge("flash_bwd_dkv", "dv", dv, dv_p)
    del dk, dv, dk_p, dv_p

    # end to end through the autograd Function vs the plain chain
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = att.flash_attention(*leaves, rope_cos=cos, rope_sin=sin)
    out.backward(do)
    o_p, lse_p = att.flash_fwd_plain(q, k, v, cos, sin, True, scale)
    delta_p = att.flash_bwd_preprocess_plain(do, o_p)
    pargs = (q, k, v, do, lse_p, delta_p, cos, sin, True, scale)
    dq_p = att.flash_bwd_dq_plain(*pargs)
    dk_p, dv_p = att.flash_bwd_dkv_plain(*pargs)
    for what, got, want in (("o", out.detach(), o_p), ("dq", leaves[0].grad,
                            dq_p), ("dk", leaves[1].grad, dk_p),
                            ("dv", leaves[2].grad, dv_p)):
        abs_err, rel = rel_err(got, want)
        ok = rel <= REL_TOL[what]
        log(f"  {name:6s} {'autograd':21s} {what:5s} max_abs_err="
            f"{abs_err:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
        if not ok:
            failures.append(f"{name}/autograd/{what}")
    torch.cuda.synchronize()
    if failures:
        raise SystemExit(f"kernel check failed: {failures}")
    return q, k, v, do, cos, sin, o, lse, delta


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
    work = {
        # (bytes, ops, peak)
        "flash_fwd": (2 * q_b + 2 * kv_b + tab_b + row_b, 4 * D * pairs,
                      PEAK_BF16),
        "flash_bwd_preprocess": (2 * q_b + row_b, 2 * B * H * S * D,
                                 PEAK_F32),
        "flash_bwd_dq": (3 * q_b + 2 * kv_b + 2 * row_b + tab_b,
                         6 * D * pairs, PEAK_BF16),
        "flash_bwd_dkv": (2 * q_b + 4 * kv_b + 2 * row_b + tab_b,
                          8 * D * pairs, PEAK_BF16),
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
    out = sdpa(qr, kr, vr, is_causal=True)
    bwd_ms = cuda_ms(lambda: torch.autograd.grad(
        out, (qr, kr, vr), do, retain_graph=True), 20)
    library = {"flash_fwd": fwd_ms, "flash_bwd_preprocess": k2["library"]}
    return times, library, bwd_ms


def synthetic_batch(vocab: int, seq_len: int, batch: int, step: int):
    """Tokens as examples/llama_pretrain.py makes them: sample ``idx`` is
    RandomState(idx).randint(0, vocab, seq_len + 1)."""
    rows = [np.random.RandomState(step * batch + i).randint(
        0, vocab, size=(seq_len + 1,), dtype=np.int32) for i in range(batch)]
    return {"tokens": np.stack(rows)}


def model_check(cfg):
    """Logits of a 2-layer cut of the model: flash kernels vs plain
    attention, same weights, bf16 compute."""
    from dlrover_tpu_torch.models import llama_apply, llama_init

    small = dataclasses.replace(cfg, n_layers=2)
    params = llama_init(small, seed=1, device="cuda")
    tokens = torch.as_tensor(
        synthetic_batch(cfg.vocab_size, 256, 2, 99)["tokens"][:, :-1],
        device="cuda")
    with torch.no_grad():
        flash = llama_apply(small, params, tokens)
        ref = llama_apply(dataclasses.replace(small, attn_impl="reference"),
                          params, tokens)
    abs_err, rel = rel_err(flash, ref)
    ok = bool(torch.isfinite(flash).all()) and rel <= 5e-2
    log(f"  model logits flash vs reference (2 layers, B2 S256): "
        f"max_abs_err={abs_err:.3e} rel={rel:.3e} {'ok' if ok else 'FAIL'}")
    if not ok:
        raise SystemExit("model check failed")


def train_slice(steps: int = 5):
    from dlrover_tpu_torch.common import mfu
    from dlrover_tpu_torch.models import PRESETS, llama_init, llama_loss_fn
    from dlrover_tpu_torch.ops import attention as att
    from dlrover_tpu_torch.parallel import Strategy, auto_accelerate
    from dlrover_tpu_torch.trainer import build_optimizer

    cfg = PRESETS["nano-350m"]
    B, S = 8, 2048
    model_check(cfg)
    res = auto_accelerate(
        llama_loss_fn(cfg), lambda seed, device: llama_init(cfg, seed, device),
        build_optimizer("adamw", 3e-4, weight_decay=0.0),
        Strategy(remat="none"), device="cuda", seed=0)
    state = res.state
    # one seeded batch, repeated: uniform random tokens hold nothing a
    # model can learn across batches, so only a repeated batch makes a
    # falling loss show that the step learns
    batch = synthetic_batch(cfg.vocab_size, S, B, 0)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    att.reset_launches()
    losses, step_s = [], []
    for s in range(steps):
        t0 = time.perf_counter()
        state, metrics = res.train_step(state, batch, None)
        losses.append(metrics["loss"].item())
        torch.cuda.synchronize()
        step_s.append(time.perf_counter() - t0)
    launches = att.launches()
    peak_bytes = torch.cuda.max_memory_allocated()
    log(f"  losses: {losses}")
    log(f"  step seconds: {step_s}")
    log(f"  launches over {steps} steps: {launches}")
    if not all(math.isfinite(x) for x in losses):
        raise SystemExit(f"non-finite loss: {losses}")
    if not losses[-1] < losses[0]:
        raise SystemExit(f"loss did not fall: {losses}")
    if launches["flash_fwd"] != cfg.n_layers * steps:
        raise SystemExit(f"flash_fwd launched {launches['flash_fwd']} "
                         f"times, want {cfg.n_layers * steps}")
    for name, n in launches.items():
        if n <= 0:
            raise SystemExit(f"{name} never launched on the training path")
    steady = statistics.median(step_s[1:])
    flops = mfu.transformer_step_flops(cfg.param_count(), B * S,
                                       cfg.n_layers, cfg.dim, S)
    summary = {
        "config": "nano-350m", "batch": B, "seq": S, "steps": steps,
        "step_ms_median_2_to_5": steady * 1e3,
        "first_step_ms": step_s[0] * 1e3,
        "tokens_per_s": B * S / steady,
        "mfu": mfu.mfu(flops, steady), "mfu_peak_flops": mfu.peak_flops(),
        "peak_mem_gib": peak_bytes / 2**30,
        "loss_first": losses[0], "loss_last": losses[-1],
    }
    log(json.dumps({"slice": summary}))
    profile_step(res, state, batch)
    del res, state
    torch.cuda.empty_cache()
    stream_losses(cfg, B, S, steps)
    return launches


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


def profile_step(res, state, batch):
    """Per-op device time of one more step, written to chiprun_out/."""
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
        "wall_ms": wall_us / 1e3, "device_busy_ms": busy_us / 1e3,
        "device_idle_share": 1 - busy_us / wall_us}}))
    table = averages.table(sort_by="cuda_time_total", row_limit=40)
    OUT.mkdir(exist_ok=True)
    (OUT / "profile_step.txt").write_text(table)
    log("  profile of one step (top rows, full table in "
        "chiprun_out/profile_step.txt):")
    for line in table.splitlines()[:16]:
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
    slice_inputs = None
    for i, (name, shape) in enumerate(SHAPES.items()):
        inputs = check_shape(name, shape, seed=i, worst=worst)
        if name == "slice":
            slice_inputs = inputs
    times, library, sdpa_bwd_ms = time_kernels(slice_inputs)
    del slice_inputs
    bound = bounds(SHAPES["slice"])
    bwd_sum = sum(times[k][0] for k in ("flash_bwd_preprocess",
                                        "flash_bwd_dq", "flash_bwd_dkv"))
    log(json.dumps({"backward_at_slice_shape": {
        "port_bwd_ms": bwd_sum, "sdpa_bwd_ms": sdpa_bwd_ms}}))
    torch.cuda.empty_cache()

    # 4. the training slice through the kernels
    log("phase slice:")
    launches = train_slice()

    # 5. kernel line, then the result line
    kernels = []
    for name, (source, replaces) in KERNEL_INFO.items():
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "max_abs_err": worst[name], "ms": times[name][0],
            "plain_ms": times[name][1], "bound_ms": bound[name][0],
            "bound_by": bound[name][1], "library_ms": library.get(name),
        })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
