"""Serializable acceleration plans (a copy of the ``Strategy`` dataclass of
dlrover_tpu/parallel/strategy.py, with its fields and JSON round-trip).

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
