"""Strategy search engine: analyse, candidates, dry-run, pick (port of
dlrover_tpu/parallel/engine.py, with the same names and arithmetic).

A candidate is a complete :class:`Strategy` (mesh factorization x remat
x precision). Dry-running builds the candidate's train step through
``auto_accelerate`` and times real steps on the card; memory
feasibility is pre-filtered analytically, so only plausible meshes are
built. Given the same :class:`ModelAnalysis`, the candidate list, the
memory estimate, the Bayesian search's seeds and suggestions and the
pick are the JAX package's.

What differs, for the card and for one process per card:

- No TPU figure is a default: ``hbm_gb=None`` is the card's
  ``total_memory`` (:func:`card_hbm_gb`), ``devices_per_host=None`` the
  local world size, and the links' bandwidths (``ici_gbps``,
  ``dcn_gbps``) have none: a multi-slice search must pass them.
- :class:`DryRunner` times with CUDA events, frees each candidate's
  state before the next is built, and records as infeasible only an
  out-of-memory error, the port's ``NotImplementedError`` (a mesh or
  option not ported yet) and a mesh's ``MeshError``; anything else, a
  kernel's build or launch failure above all, propagates.
- Every rank of a process group dry-runs each candidate over the whole
  group and measures its own step; the result is agreed before it is
  recorded (the step and build times MAX-reduced, ``ok`` AND-reduced),
  so the search sees the same numbers on every rank and every rank
  returns the same ``Strategy``.
"""

from __future__ import annotations

import collections
import dataclasses
import gc
import math
import os
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.ops.fused_optim import tree_order
from dlrover_tpu_torch.parallel.mesh import MeshError, batch_place
from dlrover_tpu_torch.parallel.strategy import (
    MeshConfig,
    Strategy,
    auto_strategy,
)

logger = get_logger(__name__)

__all__ = [
    "BayesianSearch", "DryRunResult", "DryRunner", "EngineTask",
    "LOSS_PARITY_TOL", "ModelAnalysis", "StrategySearchEngine", "TaskType",
    "analyse_params", "candidate_strategies", "card_hbm_gb",
    "cost_model_rank_correlation", "estimate_hbm_per_device",
    "make_auto_accelerate_dry_runner", "search_strategy",
]

# the relative loss tolerance within which a quantized candidate may win
LOSS_PARITY_TOL = 0.05

# what a dry-run records as an infeasible candidate; the rest propagates
INFEASIBLE = (torch.cuda.OutOfMemoryError, NotImplementedError, MeshError)


# --------------------------------------------------------------------------
# analyser
# --------------------------------------------------------------------------


@dataclasses.dataclass
class ModelAnalysis:
    """Static model facts the planner needs."""

    param_count: int = 0
    param_bytes: int = 0
    largest_layer_params: int = 0
    has_attention: bool = False
    n_layers: int = 0
    moe: bool = False
    n_experts: int = 1
    hidden: int = 0  # model width (activation feature dim)


def analyse_params(params: dict) -> ModelAnalysis:
    """ModelAnalysis of a flat ``{name: tensor}`` dict (real, meta or
    fake tensors, or numpy arrays: only shapes and dtypes are read),
    walked in the JAX package's leaf order (``tree_order``), so that a
    tie in the width vote falls as it does there.

    ``hidden`` is inferred structurally: for each weight matrix the
    smaller of its two trailing dims is a candidate for the residual
    width; the modal candidate wins. A stacked layer axis is a leading
    dim of a leaf of 3 or more dims."""
    leaves = [params[name] for name in tree_order(params)]
    count = bytes_ = largest = n_layers = 0
    width_votes: collections.Counter = collections.Counter()
    for leaf in leaves:
        shape = tuple(getattr(leaf, "shape", ()))
        n = math.prod(shape)
        count += n
        bytes_ += n * getattr(getattr(leaf, "dtype", None), "itemsize", 4)
        largest = max(largest, n)
        if len(shape) >= 2:
            width_votes[int(min(shape[-2], shape[-1]))] += 1
        if len(shape) >= 3:
            n_layers = max(n_layers, shape[0])
    hidden = width_votes.most_common(1)[0][0] if width_votes else 0
    return ModelAnalysis(param_count=count, param_bytes=bytes_,
                         largest_layer_params=largest, n_layers=n_layers,
                         hidden=hidden)


# --------------------------------------------------------------------------
# memory feasibility (analytic pre-filter)
# --------------------------------------------------------------------------


def estimate_hbm_per_device(
    analysis: ModelAnalysis,
    strategy: Strategy,
    batch_per_device: int = 8,
    seq_len: int = 2048,
    hidden: Optional[int] = None,
    attn_quadratic: bool = False,
) -> float:
    """Rough bytes a card: params + grads + Adam state + activations.

    The model state is sharded by fsdp x tensor x expert x pipe,
    activations by seq, with remat discounts. ``hidden`` defaults to the
    width :func:`analyse_params` inferred.

    The activation term charges what the backward stores a layer:
    attention q/k/v/o (4 x hidden wide), the MLP gate/up (~3 x hidden
    each) and the two norm inputs. ``attn_quadratic=True`` also charges
    the [B, H, S, S] f32 scores of non-blockwise attention (the plain
    reference path); the flash kernels keep their score tiles in shared
    memory and registers, so they charge none."""
    if hidden is None:
        hidden = analysis.hidden or 4096
    m = strategy.mesh
    model_shard = max(m.fsdp * m.tensor * m.expert * m.pipe, 1)
    # fp32 master params + grads + 2x Adam moments
    model_state = analysis.param_count * 4.0 * 4.0 / model_shard
    # "offload" keeps only the full-level boundary tensors on the card
    act_discount = {
        "none": 1.0, "minimal": 0.35, "offload": 0.15, "full": 0.12,
    }.get(strategy.remat, 0.35)
    act_shard = max(m.seq, 1)
    # stored per layer (bf16): residual + 2 norm inputs (3x hidden),
    # q/k/v/o (4x hidden), gate/up hidden (~2 x 3x hidden) + lse rows
    width_factor = 3.0 + 4.0 + 6.0
    acts = (batch_per_device * seq_len * hidden * 2.0 * width_factor
            * max(analysis.n_layers, 1) * act_discount / act_shard)
    if attn_quadratic:
        heads = max(hidden // 128, 1)
        # f32 scores per layer, both operands sequence-sharded (the ring
        # holds S_local x S_local blocks a step)
        acts += (batch_per_device * heads * (seq_len / act_shard) ** 2 * 4.0
                 * max(analysis.n_layers, 1) * act_discount)
    return model_state + acts


def card_hbm_gb() -> float:
    """The current card's memory in GiB (``total_memory``); raises
    without one: the search then needs ``hbm_gb``."""
    if not torch.cuda.is_available():
        raise ValueError("hbm_gb=None reads the card's memory, and there is "
                         "no CUDA device: pass hbm_gb")
    return torch.cuda.get_device_properties(
        torch.cuda.current_device()).total_memory / (1 << 30)


def _local_world_size() -> int:
    """The processes (one per card) on this host: ``LOCAL_WORLD_SIZE``
    where the launcher sets it, else the process group's world (one
    host), else 1."""
    if os.environ.get("LOCAL_WORLD_SIZE"):
        return max(int(os.environ["LOCAL_WORLD_SIZE"]), 1)
    return dist.get_world_size() if dist.is_initialized() else 1


# --------------------------------------------------------------------------
# candidate generation
# --------------------------------------------------------------------------


def _factorizations(n: int, dims: int):
    """All tuples (d0..dims-1) with product n, each di >= 1 dividing n."""
    if dims == 1:
        yield (n,)
        return
    for d in [x for x in range(1, n + 1) if n % x == 0]:
        for rest in _factorizations(n // d, dims - 1):
            yield (d,) + rest


def _dcn_placement(pipe: int, data: int, fsdp: int, n_slices: int):
    """Distribute ``n_slices`` across the axes that tolerate the slow
    link, cheapest traffic first: pipe (p2p stage activations) > data
    (one grad all-reduce a step) > fsdp (a param all-gather every step).
    Returns (dcn_pipe, dcn_data, dcn_fsdp), or None when the
    factorization cannot absorb every slice."""
    remaining = n_slices
    placement = []
    for size in (pipe, data, fsdp):
        f = math.gcd(size, remaining)
        placement.append(f)
        remaining //= f
    if remaining != 1:
        return None
    return tuple(placement)


def candidate_strategies(
    n_devices: int,
    analysis: ModelAnalysis,
    devices_per_host: Optional[int] = None,
    hbm_gb: Optional[float] = None,
    seq_len: int = 2048,
    batch_per_device: int = 8,
    hidden: Optional[int] = None,
    max_candidates: int = 16,
    allow_pipe: bool = True,
    n_slices: int = 1,
    ici_gbps: Optional[float] = None,
    dcn_gbps: Optional[float] = None,
) -> list:
    """Feasible mesh factorizations, best first: pure fsdp first, then
    tensor up to ``devices_per_host`` (tensor collectives stay inside a
    host), pipe only when allowed and the layers are stacked; a mesh
    whose estimate exceeds 90% of ``hbm_gb`` at every remat level is
    dropped, and each mesh keeps its cheapest feasible remat. Sequences
    of 32768 or more add variants that carve a ``seq`` axis out of
    ``fsdp``; a MoE model variants that carve an ``expert`` axis.

    ``hbm_gb=None`` is the card's memory, ``devices_per_host=None`` the
    local world size. Multi-slice (``n_slices > 1``): the slice boundary
    must fall on pipe, data or fsdp, and the cost model charges the slow
    link by ``ici_gbps / dcn_gbps``, which must then be passed."""
    if hbm_gb is None:
        hbm_gb = card_hbm_gb()
    if devices_per_host is None:
        devices_per_host = _local_world_size()
    bw_ratio = 1.0
    if n_slices > 1:
        if ici_gbps is None or dcn_gbps is None:
            raise ValueError(
                f"n_slices={n_slices} needs ici_gbps and dcn_gbps, the "
                "bandwidths within and between slices: there is no "
                "default for them")
        bw_ratio = max(ici_gbps / max(dcn_gbps, 1e-9), 1.0)
    hbm = hbm_gb * (1 << 30)
    seen: set = set()
    out: list = []
    for data, fsdp, tensor, pipe in _factorizations(n_devices, 4):
        if tensor > devices_per_host:
            continue
        if pipe > 1 and (not allow_pipe or analysis.n_layers < pipe):
            continue
        if pipe > 8:
            continue
        key = (data, fsdp, tensor, pipe)
        if key in seen:
            continue
        seen.add(key)
        dcn_pipe = dcn_data = dcn_fsdp = 1
        dcn_cost = 0.0
        if n_slices > 1:
            placed = _dcn_placement(pipe, data, fsdp, n_slices)
            if placed is None:
                continue  # the slice boundary would cut a fast-link axis
            dcn_pipe, dcn_data, dcn_fsdp = placed
            dcn_cost = (0.01 * math.log2(dcn_pipe)
                        + 0.06 * math.log2(dcn_data)
                        + 0.15 * math.log2(dcn_fsdp)) * (bw_ratio / 7.0)
        mesh = MeshConfig(
            pipe=pipe, data=data, fsdp=fsdp, expert=1, seq=1,
            tensor=tensor, dcn_pipe=dcn_pipe, dcn_data=dcn_data,
            dcn_fsdp=dcn_fsdp,
        )
        # cheapest compute first: the first memory-feasible remat wins
        for remat in ("none", "minimal", "offload", "full"):
            s = Strategy(mesh=mesh, remat=remat)
            est = estimate_hbm_per_device(analysis, s, batch_per_device,
                                          seq_len, hidden)
            if est > hbm * 0.9:
                continue
            # cost-model score (lower better): comm penalty for tensor and
            # pipe, the remat's recompute, replication for pure data
            score = (
                0.15 * (tensor > 1)
                + 0.05 * tensor / devices_per_host
                + 0.25 * (pipe > 1)
                + 0.02 * pipe
                + {"none": 0.0, "minimal": 0.05, "offload": 0.10,
                   "full": 0.15}[remat]
                + 0.10 * (data > 1 and fsdp == 1)
                + dcn_cost
            )
            out.append((score, s))
            break
    out.sort(key=lambda t: t[0])
    strategies = [s for _, s in out[:max_candidates]]

    # long-context variants: part of the fsdp axis onto seq
    if seq_len >= 32768:
        extra = []
        for s in strategies[:4]:
            m = s.mesh
            want = max(seq_len // 32768, 2)
            seq = 1
            for cand in range(min(want, m.fsdp), 1, -1):
                if m.fsdp % cand == 0:
                    seq = cand
                    break
            if seq > 1 and (m.fsdp // seq) % m.dcn_fsdp == 0:
                extra.append(Strategy(
                    mesh=dataclasses.replace(m, fsdp=m.fsdp // seq, expert=1,
                                             seq=seq),
                    remat=s.remat))
        strategies = extra + strategies

    # MoE variants: an expert axis out of fsdp
    if analysis.moe and analysis.n_experts > 1:
        extra = []
        for s in strategies[:4]:
            m = s.mesh
            exp = 1
            for cand in range(min(analysis.n_experts, m.fsdp), 1, -1):
                if m.fsdp % cand == 0:
                    exp = cand
                    break
            if exp > 1 and (m.fsdp // exp) % m.dcn_fsdp == 0:
                extra.append(Strategy(
                    mesh=dataclasses.replace(m, fsdp=m.fsdp // exp,
                                             expert=exp),
                    remat=s.remat))
        strategies = extra + strategies

    return strategies[:max_candidates]


# --------------------------------------------------------------------------
# dry-runner
# --------------------------------------------------------------------------


@dataclasses.dataclass
class DryRunResult:
    strategy: Strategy
    compile_s: float = 0.0
    step_s: float = 0.0
    ok: bool = True
    error: str = ""
    # the last measured loss (None when the step returns no "loss"): the
    # quantized-dtype gate compares it with the same mesh's unquantized
    # run before a quantized candidate may win
    loss: Optional[float] = None


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _release() -> None:
    """Free what the last candidate left (its state may sit in reference
    cycles), so that the next one is built in the memory it would have
    alone."""
    gc.collect()
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.empty_cache()


def _group_max(values: list) -> list:
    """``values`` MAX-reduced over the process group (as they are without
    one)."""
    if not dist.is_initialized():
        return list(values)
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    t = torch.tensor(values, dtype=torch.float64, device=device)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return t.tolist()


def _infeasible(result: DryRunResult, e: BaseException) -> None:
    result.ok = False
    result.error = f"{type(e).__name__}: {e}"
    logger.warning("dry-run failed for %s: %s", result.strategy.describe(),
                   result.error[:200])


class DryRunner:
    """Builds and times the real train step of a candidate."""

    def __init__(self, build_fn: Callable[[Strategy], tuple],
                 warmup: int = 1, iters: int = 3):
        """``build_fn(strategy) -> (train_step, state, batch, rng)``."""
        self._build_fn = build_fn
        self._warmup = warmup
        self._iters = iters

    def profile(self, strategy: Strategy) -> DryRunResult:
        """Build (``compile_s``: the build and the first step), warm up,
        then time ``iters`` steps (``step_s``, CUDA events on the card).
        An infeasible candidate (:data:`INFEASIBLE`) comes back with
        ``ok=False``; any other exception propagates.

        Under a process group every rank records the same result: the
        build's outcome is agreed before any step runs, so a build that
        fails on one rank skips the steps on all of them; the steps'
        collectives leave no rank behind to agree with, so an error in a
        step propagates; ``step_s`` and ``compile_s`` are the slowest
        rank's."""
        result = DryRunResult(strategy=strategy)
        train_step = state = batch = rng = None
        try:
            t0 = time.perf_counter()
            try:
                train_step, state, batch, rng = self._build_fn(strategy)
            except INFEASIBLE as e:
                _infeasible(result, e)
            failed = _group_max([0.0 if result.ok else 1.0])[0]
            if failed and result.ok:
                result.ok = False
                result.error = "failed on another rank of the process group"
            if result.ok:
                try:
                    self._time(result, t0, train_step, state, batch, rng)
                except INFEASIBLE as e:
                    if dist.is_initialized():
                        raise
                    _infeasible(result, e)
        finally:
            train_step = state = batch = rng = None
            _release()
        result.step_s, result.compile_s = _group_max(
            [result.step_s, result.compile_s])
        return result

    def _time(self, result, t0, train_step, state, batch, rng) -> None:
        state, _ = train_step(state, batch, rng)
        _sync()
        result.compile_s = time.perf_counter() - t0
        for _ in range(self._warmup):
            state, _ = train_step(state, batch, rng)
        _sync()
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
        t1 = time.perf_counter()
        for _ in range(self._iters):
            state, metrics = train_step(state, batch, rng)
        if cuda:
            end.record()
            end.synchronize()
            result.step_s = start.elapsed_time(end) / 1e3 / self._iters
        else:
            result.step_s = (time.perf_counter() - t1) / self._iters
        loss = metrics.get("loss") if isinstance(metrics, dict) else None
        if loss is not None:
            result.loss = float(loss)


def cost_model_rank_correlation(candidates: list,
                                results: list) -> Optional[float]:
    """Spearman rank correlation between the cost-model order (the
    candidates list, best first) and the measured step times of the ok
    results among them; None with fewer than 3 points or no spread."""
    index_of = {id(s): i for i, s in enumerate(candidates)}
    pairs = [(index_of[id(r.strategy)], r.step_s) for r in results
             if r.ok and id(r.strategy) in index_of]
    if len(pairs) < 3:
        return None
    ranks_model = _ranks([p[0] for p in pairs])
    ranks_meas = _ranks([p[1] for p in pairs])
    n = len(pairs)
    m1 = sum(ranks_model) / n
    m2 = sum(ranks_meas) / n
    cov = sum((a - m1) * (b - m2) for a, b in zip(ranks_model, ranks_meas))
    v1 = sum((a - m1) ** 2 for a in ranks_model)
    v2 = sum((b - m2) ** 2 for b in ranks_meas)
    if v1 <= 0 or v2 <= 0:
        return None
    return cov / (v1 * v2) ** 0.5


def _ranks(values: list) -> list:
    """Fractional (average) ranks: ties share their mean rank."""
    order = sorted(range(len(values)), key=lambda i: values[i])
    ranks = [0.0] * len(values)
    i = 0
    while i < len(order):
        j = i
        while (j + 1 < len(order)
               and values[order[j + 1]] == values[order[i]]):
            j += 1
        avg = (i + j) / 2.0
        for k in range(i, j + 1):
            ranks[order[k]] = avg
        i = j + 1
    return ranks


# --------------------------------------------------------------------------
# Bayesian-optimization search (a small numpy Gaussian process + expected
# improvement over the discrete candidate list)
# --------------------------------------------------------------------------


def _strategy_features(s: Strategy) -> list:
    """A candidate in R^8 for the GP kernel: log2 of each mesh axis, the
    remat ordinal, and the slow-link exposure."""
    m = s.mesh
    remat_ord = {"none": 0.0, "minimal": 1.0, "offload": 1.5,
                 "full": 2.0}.get(s.remat, 1.0)
    return [
        math.log2(max(m.data, 1)),
        math.log2(max(m.fsdp, 1)),
        math.log2(max(m.tensor, 1)),
        math.log2(max(m.pipe, 1)),
        math.log2(max(m.seq, 1)),
        math.log2(max(m.expert, 1)),
        remat_ord,
        math.log2(max(m.dcn_data * m.dcn_fsdp, 1))
        + 0.5 * math.log2(max(m.dcn_pipe, 1)),
    ]


class BayesianSearch:
    """GP + expected improvement over a discrete candidate list, seeded by
    the cost model's top candidate and the one farthest from it; a failed
    dry-run feeds back a penalty (10x the worst ok time, at least 1)."""

    def __init__(self, candidates: list, n_seed: int = 2,
                 noise: float = 1e-6, length_scale: float = 1.5):
        self._candidates = list(candidates)
        self._X = np.asarray([_strategy_features(s)
                              for s in self._candidates], float)
        self._observed: dict = {}
        self._failed: set = set()
        self._noise = noise
        self._ls = length_scale
        self._seed_order = self._make_seed_order(n_seed)

    def _make_seed_order(self, n_seed: int) -> list:
        if not self._candidates:
            return []
        order = [0]
        if n_seed > 1 and len(self._candidates) > 1:
            d = np.linalg.norm(self._X - self._X[0], axis=1)
            order.append(int(d.argmax()))
        return order[:n_seed]

    def _kernel(self, A, B):
        d2 = ((A[:, None, :] - B[None, :, :]) ** 2).sum(-1)
        return np.exp(-0.5 * d2 / (self._ls ** 2))

    def suggest(self, exclude=()) -> Optional[int]:
        """Index of the next candidate to dry-run (None: exhausted);
        ``exclude``: indices handed out but not yet observed."""
        skip = set(self._observed) | set(exclude)
        unobserved = [i for i in range(len(self._candidates))
                      if i not in skip]
        if not unobserved:
            return None
        for i in self._seed_order:
            if i not in skip:
                return i
        obs_idx = sorted(self._observed)
        if not obs_idx:
            # every seed in flight, nothing observed: cost-model order
            return unobserved[0]
        X_o = self._X[obs_idx]
        y = np.asarray([self._observed[i] for i in obs_idx], float)
        y_mean, y_std = y.mean(), max(y.std(), 1e-9)
        y_n = (y - y_mean) / y_std
        K = self._kernel(X_o, X_o) + self._noise * np.eye(len(obs_idx))
        L = np.linalg.cholesky(K)
        alpha = np.linalg.solve(L.T, np.linalg.solve(L, y_n))
        X_u = self._X[unobserved]
        K_s = self._kernel(X_u, X_o)
        mu = K_s @ alpha
        v = np.linalg.solve(L, K_s.T)
        var = np.clip(1.0 - (v ** 2).sum(0), 1e-12, None)
        sigma = np.sqrt(var)
        # expected improvement (minimization)
        best = y_n.min()
        z = (best - mu) / sigma
        cdf = 0.5 * (1.0 + np.vectorize(math.erf)(z / math.sqrt(2.0)))
        pdf = np.exp(-0.5 * z ** 2) / np.sqrt(2 * np.pi)
        ei = (best - mu) * cdf + sigma * pdf
        return unobserved[int(ei.argmax())]

    def observe(self, index: int, step_s: float, ok: bool = True):
        if not ok:
            # anchored to the worst ok time, so failures do not compound
            ok_times = [v for i, v in self._observed.items()
                        if i not in self._failed]
            step_s = max(max(ok_times, default=1.0) * 10.0, 1.0)
            self._failed.add(index)
        self._observed[index] = float(step_s)

    def best(self) -> Optional[int]:
        """The best ok observation (failures only steer the GP)."""
        ok_obs = {i: v for i, v in self._observed.items()
                  if i not in self._failed}
        if not ok_obs:
            return None
        return min(ok_obs, key=ok_obs.get)


# --------------------------------------------------------------------------
# engine + task loop
# --------------------------------------------------------------------------


class TaskType:
    ANALYSE = "ANALYSE"
    TUNE = "TUNE"
    DRYRUN = "DRYRUN"
    FINISH = "FINISH"
    FAIL = "FAIL"
    WAIT = "WAIT"


@dataclasses.dataclass
class EngineTask:
    task_type: str
    strategy: Optional[Strategy] = None
    task_id: int = -1


def _is_quant(strategy: Strategy) -> bool:
    return strategy.compute_dtype in ("int8", "fp8")


class StrategySearchEngine:
    """Generates candidates, scores them by dry-run, returns the winner:
    :meth:`search` in one call, or the task loop (:meth:`get_task` /
    :meth:`report_task_result`) for a caller that drives it step by
    step."""

    def __init__(
        self,
        n_devices: int,
        analysis: ModelAnalysis,
        dry_runner: Optional[DryRunner] = None,
        devices_per_host: Optional[int] = None,
        hbm_gb: Optional[float] = None,
        seq_len: int = 2048,
        max_dryruns: int = 6,
        search_algo: str = "greedy",
        try_low_precision: bool = False,
        loss_parity_tol: float = LOSS_PARITY_TOL,
        **candidate_kwargs,
    ):
        if search_algo not in ("greedy", "bo"):
            raise ValueError(
                f"search_algo must be 'greedy' or 'bo', got {search_algo!r}")
        self._n_devices = n_devices
        self._analysis = analysis
        self._dry_runner = dry_runner
        self._max_dryruns = max_dryruns
        self._algo = search_algo
        self._loss_parity_tol = loss_parity_tol
        self._hbm_gb = card_hbm_gb() if hbm_gb is None else hbm_gb
        self._devices_per_host = (_local_world_size()
                                  if devices_per_host is None
                                  else devices_per_host)
        self._candidates = candidate_strategies(
            n_devices, analysis, devices_per_host=self._devices_per_host,
            hbm_gb=self._hbm_gb, seq_len=seq_len, **candidate_kwargs)
        if try_low_precision:
            # int8 variants of the top two; one may win only within
            # loss_parity_tol of its unquantized sibling (_pick_best)
            quant = [dataclasses.replace(s, compute_dtype="int8")
                     for s in self._candidates[:2]]
            self._candidates = (self._candidates[:2] + quant
                                + self._candidates[2:])
        self._bo = (BayesianSearch(self._candidates) if search_algo == "bo"
                    else None)
        self._results: list = []
        self._cursor = 0
        self._pending: set = set()
        self._finished = False
        self._quant_gate: list = []

    @property
    def candidates(self) -> list:
        return list(self._candidates)

    @property
    def results(self) -> list:
        return list(self._results)

    @property
    def analysis(self) -> ModelAnalysis:
        return self._analysis

    @property
    def dry_runner(self) -> Optional[DryRunner]:
        return self._dry_runner

    @property
    def quant_gate(self) -> list:
        """The last pick's quantization-gate decisions: ``(result,
        passed)`` for each quantized candidate that was the fastest left
        in the pool when it was weighed."""
        return list(self._quant_gate)

    def _fallback(self) -> Strategy:
        return auto_strategy(self._n_devices, self._analysis.param_count,
                             hbm_gb=self._hbm_gb,
                             devices_per_host=self._devices_per_host)

    # -------------------------------------------------------- synchronous

    def search(self) -> Strategy:
        """Dry-run candidates; the fastest feasible step wins. "greedy"
        profiles the cost model's top ``max_dryruns`` in order; "bo" lets
        the GP pick each next dry-run."""
        if not self._candidates:
            logger.warning("no feasible candidates; heuristic fallback")
            return self._fallback()
        if self._dry_runner is None:
            return self._candidates[0]
        if self._algo == "bo":
            for _ in range(min(self._max_dryruns, len(self._candidates))):
                idx = self._bo.suggest()
                if idx is None:
                    break
                r = self._dry_runner.profile(self._candidates[idx])
                self._results.append(r)
                self._bo.observe(idx, r.step_s, r.ok)
        else:
            for s in self._candidates[:self._max_dryruns]:
                self._results.append(self._dry_runner.profile(s))
        ok = [r for r in self._results if r.ok]
        if not ok:
            logger.warning("all dry-runs failed; using top candidate")
            return self._candidates[0]
        best = self._pick_best(ok, verbose=True)
        corr = cost_model_rank_correlation(self._candidates, self._results)
        if corr is not None:
            logger.info(
                "cost-model calibration: rank correlation with measured "
                "step times = %.2f%s", corr,
                "" if corr >= 0.3 else " (weak: the analytic order is "
                "unreliable here beyond memory feasibility)")
        if best.ok:
            logger.info("strategy search: %s wins (%.4fs/step over %d "
                        "candidates)", best.strategy.describe(), best.step_s,
                        len(ok))
        else:
            logger.warning("strategy search: falling back to unmeasured %s "
                           "(no parity-checked candidate succeeded)",
                           best.strategy.describe())
        self._finished = True
        return best.strategy

    # ---------------------------------------------------------- task loop

    def get_task(self) -> EngineTask:
        """Task ids are candidate indices (both algorithms), so
        ``report_task_result`` can feed the Bayesian search."""
        if self._finished:
            return EngineTask(TaskType.FINISH, self.best_strategy())
        if self._cursor >= min(len(self._candidates), self._max_dryruns):
            self._finished = True
            return EngineTask(TaskType.FINISH, self.best_strategy())
        if self._bo is not None:
            idx = self._bo.suggest(exclude=self._pending)
            if idx is None:
                self._finished = True
                return EngineTask(TaskType.FINISH, self.best_strategy())
        else:
            idx = self._cursor
        self._pending.add(idx)
        self._cursor += 1
        return EngineTask(TaskType.DRYRUN, self._candidates[idx],
                          task_id=idx)

    def report_task_result(self, task_id: int, result: DryRunResult):
        self._results.append(result)
        self._pending.discard(task_id)
        if self._bo is not None and 0 <= task_id < len(self._candidates):
            self._bo.observe(task_id, result.step_s, result.ok)

    def _pick_best(self, ok: list, verbose: bool = False) -> DryRunResult:
        """The fastest measured candidate, with the quantization gate: an
        int8/fp8 candidate wins only when its loss is within
        ``loss_parity_tol`` (relative) of the same mesh and remat's
        unquantized run; a gated one is skipped. ``verbose`` logs the
        decisions at info."""

        def sibling(r):
            for o in ok:
                if (not _is_quant(o.strategy)
                        and o.strategy.mesh == r.strategy.mesh
                        and o.strategy.remat == r.strategy.remat):
                    return o
            return None

        self._quant_gate = []
        pool = list(ok)
        while pool:
            best = min(pool, key=lambda r: r.step_s)
            if not _is_quant(best.strategy):
                return best
            sib = sibling(best)
            passed = (sib is not None and best.loss is not None
                      and sib.loss is not None
                      and abs(best.loss - sib.loss)
                      <= self._loss_parity_tol * max(abs(sib.loss), 1e-9))
            self._quant_gate.append((best, passed))
            if passed:
                if verbose:
                    logger.info(
                        "quantized dtype selected: %s at %.4fs/step "
                        "(unquantized sibling %.4fs, loss %.4f vs %.4f)",
                        best.strategy.compute_dtype, best.step_s,
                        sib.step_s, best.loss, sib.loss)
                return best
            if verbose:
                logger.info("quantized candidate %s gated off (no "
                            "loss-parity evidence)", best.strategy.describe())
            pool = [r for r in pool if r is not best]
        # only gated-off quantized candidates ran: the cost model's top
        # unquantized candidate, unmeasured
        for s in self._candidates:
            if not _is_quant(s):
                return DryRunResult(strategy=s, ok=False)
        return min(ok, key=lambda r: r.step_s)

    def best_strategy(self) -> Strategy:
        ok = [r for r in self._results if r.ok]
        if ok:
            return self._pick_best(ok).strategy
        if self._candidates:
            return self._candidates[0]
        return self._fallback()


# --------------------------------------------------------------------------
# a search over a real model through auto_accelerate
# --------------------------------------------------------------------------


def _rows(x, strategy: Strategy):
    """This rank's rows (dim 0) of a global batch leaf under
    ``strategy``'s mesh (all of them without a process group)."""
    index, count = batch_place(strategy.mesh)
    if count == 1:
        return x
    if isinstance(x, torch.Tensor):
        return x.chunk(count)[index]
    return np.split(np.asarray(x), count)[index]


def make_auto_accelerate_dry_runner(
    loss_fn, init_fn, optimizer_factory, param_logical_axes,
    make_batch: Callable[[], dict], device=None, seed: int = 0,
) -> DryRunner:
    """A DryRunner whose build is a real ``auto_accelerate`` call on the
    caller's model; ``make_batch()`` gives the global batch (a dict of
    arrays or tensors), of which each rank takes its rows under the
    candidate's mesh."""

    def build(strategy: Strategy):
        from dlrover_tpu_torch.parallel.accelerate import auto_accelerate

        res = auto_accelerate(
            loss_fn, init_fn, optimizer_factory, strategy, device=device,
            seed=seed, param_logical_axes=param_logical_axes)
        batch = {k: _rows(v, strategy) for k, v in make_batch().items()}
        return res.train_step, res.state, batch, None

    return DryRunner(build)


def make_search_engine(
    loss_fn, init_fn, optimizer_factory, param_logical_axes, make_batch,
    n_devices: Optional[int] = None, device=None, seed: int = 0,
    **engine_kwargs,
) -> StrategySearchEngine:
    """The engine :func:`search_strategy` searches with: the model
    analysed from ``init_fn(seed, "cpu")`` under a ``FakeTensorMode``
    (shapes and dtypes only, nothing allocated on the card or the host),
    its candidates dry-run through ``auto_accelerate`` on ``device``
    (``cuda`` unless the caller says otherwise). ``n_devices`` defaults
    to the process group's world size (1 without one)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    if n_devices is None:
        n_devices = dist.get_world_size() if dist.is_initialized() else 1
    with FakeTensorMode():
        analysis = analyse_params(init_fn(seed, "cpu"))
    runner = make_auto_accelerate_dry_runner(
        loss_fn, init_fn, optimizer_factory, param_logical_axes, make_batch,
        device=device, seed=seed)
    return StrategySearchEngine(n_devices, analysis, dry_runner=runner,
                                **engine_kwargs)


def search_strategy(
    loss_fn, init_fn, optimizer_factory, param_logical_axes, make_batch,
    n_devices: Optional[int] = None, device=None, seed: int = 0,
    **engine_kwargs,
) -> Strategy:
    """One-call measured search: analyse the model, generate candidates,
    dry-run them, pick (:func:`make_search_engine`). Under a process
    group every rank calls this and gets the same ``Strategy``."""
    return make_search_engine(
        loss_fn, init_fn, optimizer_factory, param_logical_axes, make_batch,
        n_devices=n_devices, device=device, seed=seed,
        **engine_kwargs).search()
