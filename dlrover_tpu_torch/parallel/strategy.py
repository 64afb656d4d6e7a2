"""Serializable acceleration plans (a copy of the ``Strategy`` dataclass of
dlrover_tpu/parallel/strategy.py, with its fields and JSON round-trip),
and its deterministic planner ``auto_strategy`` (the same heuristics, so
that both packages plan the same ``Strategy`` from the same inputs; the
caller passes the card's memory as ``hbm_gb``).

``MeshConfig`` keeps every field, so that a plan written by the JAX
package loads here; of its axes the port runs ``seq`` (ring attention,
parallel/mesh.py). The others must be 1 (or -1, which then absorbs
nothing): data, fsdp, tensor, expert and pipe parallelism are ROADMAP
Queue 1 item 7.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence, Tuple

from dlrover_tpu_torch.common.log import get_logger

logger = get_logger(__name__)

AXIS_ORDER: Tuple[str, ...] = (
    "pipe", "data", "fsdp", "expert", "seq", "tensor")

LogicalRules = Sequence[Tuple[str, object]]

DEFAULT_RULES: LogicalRules = (
    ("batch", ("data", "fsdp")),
    ("seq", "seq"),
    ("embed", "fsdp"),
    ("heads", "tensor"),
    ("kv_heads", "tensor"),
    ("mlp", "tensor"),
    ("vocab", "tensor"),
    ("expert", "expert"),
    ("head_dim", None),
    ("kv", None),
    ("layer", None),
    ("stage", "pipe"),
)


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Sizes for each named axis; 1 means the axis is inactive and -1
    absorbs the remaining ranks. ``seq=n`` shards the sequence over n
    ring ranks: a process group of n processes, or n ranks in one
    process on one device. ``dcn_*`` give the slices an axis spans (kept
    for plan compatibility)."""

    pipe: int = 1
    data: int = -1
    fsdp: int = 1
    expert: int = 1
    seq: int = 1
    tensor: int = 1
    dcn_pipe: int = 1
    dcn_data: int = 1
    dcn_fsdp: int = 1


@dataclasses.dataclass
class Strategy:
    """A complete, serializable acceleration plan (field meanings as in
    the JAX package; the port honours the values listed in
    ``auto_accelerate`` and raises on the rest)."""

    mesh: MeshConfig = dataclasses.field(default_factory=MeshConfig)
    rules: LogicalRules = DEFAULT_RULES
    # compute precision for matmuls/activations; params stay fp32 master.
    compute_dtype: str = "bfloat16"
    # remat policy name: none | minimal | offload | full
    remat: str = "minimal"
    # number of microbatches for gradient accumulation
    grad_accum: int = 1
    # donation of params/opt-state buffers in the train step
    donate: bool = True
    # collective-compute overlap for the fsdp layer scan: off | xla | manual
    overlap_collectives: str = "off"
    # which matmul sites quantize under compute_dtype int8/fp8
    quant_sites: str = "all"
    # one-pass fused optimizer step (ops/fused_optim.py)
    fused_optim: bool = False

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        d["rules"] = [list(r) for r in self.rules]
        return json.dumps(d, indent=2)

    @classmethod
    def from_json(cls, s: str) -> "Strategy":
        d = json.loads(s)
        d["mesh"] = MeshConfig(**d["mesh"])
        d["rules"] = tuple(
            (name, tuple(ax) if isinstance(ax, list) else ax)
            for name, ax in d["rules"]
        )
        return cls(**d)

    def describe(self, mesh=None) -> str:
        """One line for logs; with the built ``mesh``, it names the seq
        axis' transport."""
        active = {
            a: getattr(self.mesh, a)
            for a in AXIS_ORDER
            if getattr(self.mesh, a) != 1
        }
        extras = ""
        if self.overlap_collectives != "off":
            extras += f", overlap={self.overlap_collectives}"
        if self.quant_sites != "all":
            extras += f", qsites={self.quant_sites}"
        if self.fused_optim:
            extras += ", fused_optim"
        if mesh is not None and mesh.ring is not None:
            extras += f", seq transport={mesh.ring.describe()}"
        return (
            f"Strategy(mesh={active or 'dp-only'}, dtype={self.compute_dtype},"
            f" remat={self.remat}, accum={self.grad_accum}{extras})"
        )


def _remat_for(param_bytes_per_device: float, hbm_bytes: float) -> str:
    # Params + optimizer state (Adam: 2x fp32) + grads ~ 4x param bytes.
    if param_bytes_per_device * 4 > hbm_bytes * 0.6:
        return "full"
    if param_bytes_per_device * 4 > hbm_bytes * 0.3:
        return "minimal"
    return "none"


def auto_strategy(
    n_devices: int,
    param_count: int,
    seq_len: int = 2048,
    hbm_gb: float = 16.0,
    devices_per_host: int = 4,
    moe: bool = False,
    n_experts: int = 1,
    long_context_threshold: int = 32768,
    n_slices: int = 1,
) -> Strategy:
    """Deterministic planner (the atorch auto_config analogue).

    Heuristics, TPU-first:
    - Prefer FSDP (ZeRO-3 on the ``fsdp`` axis) until per-device param+opt
      state fits comfortably; it has the best compute/communication ratio
      on ICI and no model-code requirements.
    - Add tensor parallelism only when a single FSDP shard of the layer
      activations/params would still blow HBM, capping ``tensor`` at the
      per-host device count so TP collectives never cross DCN.
    - Activate ``seq`` (ring attention) for very long sequences.
    - Activate ``expert`` for MoE models (expert count capped at device
      count).
    - Multi-slice (``n_slices > 1``): the slice boundary rides the
      ``data`` axis (pure DP over DCN — one gradient allreduce per
      step), carved out of the fsdp extent; per-slice FSDP stays on
      ICI. For finer control use the search engine's DCN-aware
      candidates (engine.candidate_strategies(n_slices=...)).
    """
    param_bytes = param_count * 4.0  # fp32 master params
    hbm = hbm_gb * (1 << 30)

    tensor = 1
    # With pure FSDP over all devices IN ONE SLICE (params replicate
    # across slices), per-device footprint:
    sharded_devices = n_devices // max(n_slices, 1)
    per_dev = param_bytes * 4 / max(sharded_devices, 1)
    if per_dev > hbm * 0.5:
        tensor = min(devices_per_host, n_devices)

    seq = 1
    if seq_len >= long_context_threshold:
        # shard sequence enough that activations fit; activations scale
        # ~seq^2 in attention score blocks but ring attention keeps them
        # linear; 1 axis step per 32k tokens is a safe default.
        seq = min(max(seq_len // long_context_threshold, 1), n_devices // tensor)
        while (n_devices // tensor) % seq != 0:
            seq -= 1

    expert = 1
    if moe and n_experts > 1:
        expert = min(n_experts, max(n_devices // (tensor * seq), 1))
        while (n_devices // (tensor * seq)) % expert != 0:
            expert -= 1

    fsdp = n_devices // (tensor * seq * expert)
    data = 1
    dcn_data = 1
    if n_slices > 1:
        if fsdp % n_slices != 0:
            raise ValueError(
                f"{n_slices} slices do not divide the fsdp extent "
                f"{fsdp} (n_devices={n_devices}, tensor={tensor}, "
                f"seq={seq}, expert={expert})"
            )
        # DP across slices (gradient allreduce tolerates DCN), FSDP
        # within each slice (param all-gathers stay on ICI)
        data = n_slices
        dcn_data = n_slices
        fsdp //= n_slices
    mesh = MeshConfig(
        pipe=1, data=data, fsdp=fsdp, expert=expert, seq=seq,
        tensor=tensor, dcn_data=dcn_data,
    )
    # params are REPLICATED across the data (slice) axis: the per-device
    # model-state share divides by the sharded extents only
    remat = _remat_for(param_bytes / (n_devices // max(n_slices, 1)), hbm)
    strategy = Strategy(mesh=mesh, remat=remat)
    logger.info("auto_strategy: %s", strategy.describe())
    return strategy
