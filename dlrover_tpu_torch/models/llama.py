"""LLaMA-family decoder in PyTorch (port of dlrover_tpu/models/llama.py).

Parameters are a flat ``dict[str, Tensor]`` of fp32 masters. Layer
parameters stay stacked on a leading axis as in the JAX package
(``"layers.wq"`` is [L, D, H*Dh]); the forward unbinds each stack once
and runs the layers as a Python loop, the counterpart of the JAX layer
scan. RMSNorm, RoPE, GQA, SwiGLU, untied LM head.

Attention: ``attn_impl="flash"`` takes the JAX package's einsum-form
branch (projections write the [B,H,S,Dh] layout; rope is applied inside
the flash kernels from full-width tables); ``"bshd"`` keeps the
model-native [B,S,H,Dh] layout end to end (rope applied outside, then
the fused-heads kernels, no transposes); ``"reference"`` runs the plain
attention with rope applied outside. When the active mesh's ``seq`` axis
is above 1, every ``attn_impl`` takes the sequence-parallel branch, as
in the JAX package: rope outside at global positions, q/k/v transposed
to [B,H,S,Dh], then ring attention over the ring-block kernels, or with
``attn_impl="ulysses"`` the Ulysses all-to-all around K1-K4
(parallel/sequence.py); ``"ulysses"`` without a seq axis runs the plain
attention, as the JAX package's does. What the port does not run yet
raises ``NotImplementedError`` naming its ROADMAP item.

Low-precision compute (``quant_autocast``, ops/fp8.py; set by
``auto_accelerate`` for ``compute_dtype`` "fp8" or "int8"): the
projections go through ``qdot``/``qeinsum`` with the JAX package's site
tags (``attn_qkv``, ``attn_out``, ``mlp``). Under "int8" the einsum-form
flash branch stays, its projections the JAX package's einsums
(``bsd,dhk->bhsk``, ``bhsk,hkd->bsd``) in int8; under "fp8" it yields to
the ``qdot`` branch (rope outside, then K1-K4 on the transposed q/k/v),
with gate and up two matmuls (per-tensor scales). The port keeps q/k/v
and gate/up separate under "int8" too: per-channel scales make the JAX
package's stacked weights give the same numbers. The LM head and the MoE
router never quantize.

MoE (``n_experts > 1``, Mixtral-style): the FFN of every layer is
``parallel/moe.py``'s ``moe_ffn`` over the stacked ``router`` [L, D, E]
and experts ``w_gate``/``w_up`` [L, E, D, M], ``w_down`` [L, E, M, D];
each layer adds ``moe_aux_weight * aux_loss + moe_z_weight * z_loss``
to the loss (``llama_apply(..., return_aux=True)``). On an ``expert``
mesh axis each rank runs its E/n experts (parallel/shard_ops.py);
under ``tensor`` or a seq process group the MoE FFN raises.

Sharded params: when the params are DTensors on a ``DeviceMesh`` (the
data, fsdp, expert and tensor axes, parallel/accelerate.py), the forward
takes each stack's local shard once, gathers each layer's slice over the
axes that shard it but ``tensor`` (and ``expert`` for the expert
stacks; parallel/shard_ops.py), and computes on
local tensors: ``H/t`` heads, ``KVH/t`` kv heads, ``M/t`` mlp columns
and ``V/t`` vocab rows, the rows of this rank's batch. The embedding is
looked up in this rank's vocab rows and summed over ``tensor``; the
logits stay split on the vocab and the loss goes through
``vocab_parallel_cross_entropy``. The attention kernels see plain
tensors, as the JAX package's ``_sharded_flash`` shard_map hands its
kernel local blocks.

Rematerialisation: with ``config.remat`` (and gradients on) each layer
runs under a non-reentrant checkpoint whose policy is
``config.remat_policy`` (parallel/remat.py: ``"dots_attn"``,
``"dots_attn_offload"``, ``"dots_no_batch"``, ``"dots"``), the JAX
layer scan's table. ``Strategy.remat="none"`` suppresses it
(``remat.no_remat``), as the JAX package does.
"""

from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.ops.attention import (
    flash_attention,
    flash_attention_bshd,
    mha_reference,
)
from dlrover_tpu_torch.ops.cross_entropy import (
    fused_linear_cross_entropy,
    softmax_cross_entropy,
    vocab_parallel_cross_entropy,
)
from dlrover_tpu_torch.ops.fp8 import (
    qdot,
    qeinsum,
    quant_mode,
    quant_site_enabled,
)
from dlrover_tpu_torch.parallel import remat as remat_lib
from dlrover_tpu_torch.parallel.mesh import (
    MeshError,
    ProcessGroupRing,
    axis_index,
    seq_ring,
)
from dlrover_tpu_torch.parallel.moe import MoEConfig, moe_ffn
from dlrover_tpu_torch.parallel.overlap import layer_gather_fn, plain_gather
from dlrover_tpu_torch.parallel.sequence import sequence_sharded_attention
from dlrover_tpu_torch.parallel.shard_ops import ShardContext


@dataclasses.dataclass(frozen=True)
class LlamaConfig:
    vocab_size: int = 32000
    dim: int = 4096
    n_layers: int = 32
    n_heads: int = 32
    n_kv_heads: int = 32
    mlp_dim: int = 11008
    max_seq_len: int = 2048
    rope_theta: float = 10000.0
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"          # activation/compute dtype
    # "flash" (hand-written kernels, [B,H,S,Dh]) | "bshd" (fused-heads
    # kernels, [B,S,H,Dh]) | "reference" | "ulysses"; a seq mesh axis
    # runs Ulysses with "ulysses" and the ring with any other value
    attn_impl: str = "flash"
    # checkpoint each layer under remat_policy: dots_attn |
    # dots_attn_offload | dots_no_batch | dots (parallel/remat.py)
    remat: bool = True
    remat_policy: str = "dots_attn"
    # accepted and ignored: TPU block tunings of the JAX kernels, kept so
    # a JAX config loads field for field; the port's kernels fix their
    # own tiles, and no block size changes the function computed
    attn_block_q: int = 1024
    attn_block_k: int = 1024
    attn_bwd_block_q: int = 0
    attn_bwd_block_k: int = 0
    pipe_microbatches: int = 0
    pipe_schedule: str = "gpipe"
    pipe_virtual_stages: int = 1
    # sequence chunks for the fused linear CE (1 = materialise full logits)
    ce_chunks: int = 1
    # MoE (mixtral-style FFN swap): 0/1 experts = dense
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_aux_weight: float = 0.01
    moe_z_weight: float = 1e-3

    def __post_init__(self):
        if self.pipe_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipe_schedule must be 'gpipe' or '1f1b', got "
                f"{self.pipe_schedule!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 1

    def moe_config(self) -> MoEConfig:
        return MoEConfig(n_experts=self.n_experts, top_k=self.moe_top_k,
                         capacity_factor=self.moe_capacity_factor)

    def param_count(self) -> int:
        d, v, h = self.dim, self.vocab_size, self.head_dim
        if self.is_moe:
            ffn = d * self.n_experts + 3 * d * self.mlp_dim * self.n_experts
        else:
            ffn = 3 * d * self.mlp_dim      # gate, up, down
        per_layer = (
            d * self.n_heads * h            # wq
            + 2 * d * self.n_kv_heads * h   # wk, wv
            + self.n_heads * h * d          # wo
            + ffn
            + 2 * d                         # norms
        )
        return v * d * 2 + d + self.n_layers * per_layer


PRESETS = {
    "tiny": LlamaConfig(
        vocab_size=256, dim=64, n_layers=2, n_heads=4, n_kv_heads=2,
        mlp_dim=128, max_seq_len=128, attn_impl="reference", remat=False,
        dtype="float32",
    ),
    "nano-350m": LlamaConfig(
        vocab_size=32000, dim=1024, n_layers=16, n_heads=8, n_kv_heads=8,
        mlp_dim=2816, max_seq_len=2048,
    ),
    "llama2-1b": LlamaConfig(
        vocab_size=32000, dim=2048, n_layers=16, n_heads=16, n_kv_heads=16,
        mlp_dim=5504, max_seq_len=2048,
    ),
    "llama2-7b": LlamaConfig(
        vocab_size=32000, dim=4096, n_layers=32, n_heads=32, n_kv_heads=32,
        mlp_dim=11008, max_seq_len=4096,
    ),
    "llama3-8b": LlamaConfig(
        vocab_size=128256, dim=4096, n_layers=32, n_heads=32, n_kv_heads=8,
        mlp_dim=14336, max_seq_len=8192, rope_theta=500000.0,
    ),
}

LAYER_KEYS = ("attn_norm", "wq", "wk", "wv", "wo", "mlp_norm", "w_gate",
              "w_up", "w_down")
MOE_LAYER_KEYS = LAYER_KEYS[:6] + ("router", "w_gate", "w_up", "w_down")
# the experts' dim of each MoE expert stack (split over ``expert``)
EXPERT_DIMS = {"w_gate": 1, "w_up": 1, "w_down": 1}

# the dim of each layer stack split over the ``tensor`` axis (None:
# replicated), the layout the local compute is written for: q/k/v and
# gate/up column-parallel, wo and w_down row-parallel
TENSOR_DIMS = {"attn_norm": None, "wq": 2, "wk": 2, "wv": 2, "wo": 1,
               "mlp_norm": None, "router": None, "w_gate": 2, "w_up": 2,
               "w_down": 1}


def layer_keys(config: LlamaConfig) -> tuple:
    """The names of one layer's params (``"layers.<name>"`` stacks)."""
    return MOE_LAYER_KEYS if config.is_moe else LAYER_KEYS


def check_supported(config: LlamaConfig) -> None:
    """Raise for the settings this slice of the port does not run."""
    if config.pipe_schedule != "gpipe" or config.pipe_virtual_stages != 1:
        raise NotImplementedError(
            "pipeline schedules are not ported yet (ROADMAP Queue 1 "
            "item 10)")
    if config.remat:
        remat_lib.layer_policy(config.remat_policy)  # raises if unknown
    if config.attn_impl not in ("flash", "bshd", "reference", "ulysses"):
        raise ValueError(
            f"attn_impl={config.attn_impl!r}: want flash, bshd, reference "
            "or ulysses")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def llama_init(config: LlamaConfig, seed: int = 0, device=None) -> dict:
    """fp32 master params with the shapes and distributions of the JAX
    ``llama_init``: projections N(0, 1/fan_in) (the MoE router and
    experts too), embed and lm_head N(0, 0.02^2), norms 1; layer params
    stacked on axis 0. Drawn from a
    ``torch.Generator`` seeded with ``seed`` on ``device`` (the numbers
    differ from jax.random's; tests bridge weights with
    ``params_from_jax``)."""
    check_supported(config)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, h, hd = config.dim, config.n_heads, config.head_dim
    kvh, m, L = config.n_kv_heads, config.mlp_dim, config.n_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def ones(*shape):
        return torch.ones(shape, device=device)

    if config.is_moe:
        E = config.n_experts
        ffn = {
            "layers.router": normal((L, d, E), d ** -0.5),
            "layers.w_gate": normal((L, E, d, m), d ** -0.5),
            "layers.w_up": normal((L, E, d, m), d ** -0.5),
            "layers.w_down": normal((L, E, m, d), m ** -0.5),
        }
    else:
        ffn = {
            "layers.w_gate": normal((L, d, m), d ** -0.5),
            "layers.w_up": normal((L, d, m), d ** -0.5),
            "layers.w_down": normal((L, m, d), m ** -0.5),
        }
    return {
        "embed": normal((config.vocab_size, d), 0.02),
        "layers.attn_norm": ones(L, d),
        "layers.wq": normal((L, d, h * hd), d ** -0.5),
        "layers.wk": normal((L, d, kvh * hd), d ** -0.5),
        "layers.wv": normal((L, d, kvh * hd), d ** -0.5),
        "layers.wo": normal((L, h * hd, d), (h * hd) ** -0.5),
        "layers.mlp_norm": ones(L, d),
        **ffn,
        "final_norm": ones(d),
        "lm_head": normal((d, config.vocab_size), 0.02),
    }


def llama_logical_axes(config: LlamaConfig) -> dict:
    """Logical axis names of each param, by the port's param names (the
    JAX package's ``llama_logical_axes`` tree, flattened by dots)."""
    check_supported(config)
    layer = {
        "attn_norm": ("layer", "embed"),
        "wq": ("layer", "embed", "heads"),
        "wk": ("layer", "embed", "kv_heads"),
        "wv": ("layer", "embed", "kv_heads"),
        "wo": ("layer", "heads", "embed"),
        "mlp_norm": ("layer", "embed"),
        "w_gate": ("layer", "embed", "mlp"),
        "w_up": ("layer", "embed", "mlp"),
        "w_down": ("layer", "mlp", "embed"),
    }
    if config.is_moe:
        layer.update({
            "router": ("layer", "embed", None),
            "w_gate": ("layer", "expert", "embed", "mlp"),
            "w_up": ("layer", "expert", "embed", "mlp"),
            "w_down": ("layer", "expert", "mlp", "embed"),
        })
    return {
        "embed": ("vocab", "embed"),
        **{f"layers.{k}": v for k, v in layer.items()},
        "final_norm": ("embed",),
        "lm_head": ("embed", "vocab"),
    }


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _rms_norm(x, scale, eps):
    var = x.float().square().mean(dim=-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps).to(x.dtype)
    return normed * scale.to(x.dtype)


def _rope_tables(positions, half, theta, dtype):
    """cos/sin tables [B, S, half], computed in f32 then cast to the
    compute dtype; computed once per step, outside the layer loop."""
    freqs = torch.exp(
        -math.log(theta)
        * torch.arange(0, half, dtype=torch.float32,
                       device=positions.device) / half
    )
    angles = positions[:, :, None].float() * freqs
    return torch.cos(angles).to(dtype), torch.sin(angles).to(dtype)


def _rope_apply(x, cos, sin):
    """x: [B, S, H, Dh]; half-width tables [B, S, Dh/2]."""
    half = x.shape[-1] // 2
    c = cos[:, :, None, :].to(x.dtype)
    s = sin[:, :, None, :].to(x.dtype)
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x1 * s + x2 * c], dim=-1)


def _first_position(S, ring) -> int:
    """The global position of the first of this process's S tokens: 0,
    or under a seq axis its first shard's (all shards with the
    in-process transport, this rank's with a process group)."""
    return 0 if ring is None else axis_index("seq") * (S // len(ring.ranks))


def _positions(tokens, ring):
    """The global positions of ``tokens`` [B, S] (see
    :func:`_first_position`)."""
    B, S = tokens.shape
    start = _first_position(S, ring)
    return torch.arange(start, start + S, device=tokens.device).expand(B, S)


def _flash_path(config, ring) -> bool:
    """Whether the einsum-form flash branch applies (the JAX package's
    ``flash_einsum_path``): ``attn_impl="flash"``, no seq axis, and no fp8
    (int8 keeps the branch)."""
    return (config.attn_impl == "flash" and ring is None
            and quant_mode() != "fp8")


def _int8_site(site) -> bool:
    """Whether an einsum-form site runs the JAX package's int8 einsum."""
    return quant_mode() == "int8" and quant_site_enabled(site)


def project_heads(y, w, heads, head_dim, site):
    """The einsum-form projection ``bsd,dhk->bhsk``: ``y`` [B,S,D] times
    ``w`` [D, heads*head_dim] as [B, heads, S, head_dim] (a view of the
    [B, S, heads*head_dim] product, no copy), int8 where ``qeinsum``
    quantizes the site."""
    B, S, D = y.shape
    if _int8_site(site):
        return qeinsum("bsd,dhk->bhsk", y, w.view(D, heads, head_dim),
                       site=site)
    return (y @ w).view(B, S, heads, head_dim).transpose(1, 2)


def project_out(out, w, site):
    """The einsum-form output projection ``bhsk,hkd->bsd``: ``out``
    [B, H, S, Dh] times ``w`` [H*Dh, D], int8 where ``qeinsum`` quantizes
    the site."""
    B, H, S, hd = out.shape
    if _int8_site(site):
        return qeinsum("bhsk,hkd->bsd", out, w.view(H, hd, -1), site=site)
    return out.transpose(1, 2).reshape(B, S, H * hd) @ w


def _maybe_full_rope(config, cos, sin, ring=None):
    """Full-width [B, S, Dh] tables for the flash path (rope fuses into
    the kernels); half-width tables otherwise."""
    if _flash_path(config, ring):
        return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
    return cos, sin


def _attention(config, q, k, v, ring=None):
    """Attention off the einsum-form flash branch (the JAX package's
    ``_attention``, shared with models/gpt2.py): q [B,S,H,Dh], k/v
    [B,S,KVH,Dh] -> [B,S,H,Dh]. Under a seq axis (``ring``) Ulysses with
    ``attn_impl="ulysses"``, else the ring, over [B,H,S,Dh]; with
    ``attn_impl="bshd"`` the model-native layout end to end (no q/k/v/o
    transposes); with ``attn_impl="flash"`` (the fp8 branch) K1-K4 on the
    transposed q/k/v, rope applied before; else plain attention."""
    if ring is not None:
        impl = "ulysses" if config.attn_impl == "ulysses" else "ring"
        return sequence_sharded_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            impl=impl, causal=True).transpose(1, 2)
    if config.attn_impl == "bshd":
        return flash_attention_bshd(q, k, v, causal=True)
    if config.attn_impl == "flash":
        # off the einsum-form branch (fp8): rope already applied
        return flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                               v.transpose(1, 2),
                               causal=True).transpose(1, 2)
    return mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                         v.transpose(1, 2), causal=True).transpose(1, 2)


def _layer(config: LlamaConfig, x, p, rope_cos, rope_sin, ring=None,
           shard=None):
    """One transformer block. x: [B,S,D]; p: this layer's params;
    ``ring``: the seq axis' transport, or None; ``shard``: (the mesh's
    ``ShardContext``, ``gather(key, local) -> whole`` for each param, the
    expert group) when ``p`` holds local shards, or None. Returns (x,
    aux): the layer's weighted MoE losses, None for a dense layer."""
    B, S, D = x.shape
    hd = config.head_dim
    to_tensor = from_tensor = _identity
    ctx = experts = None
    if shard is not None:
        ctx, gather, experts = shard
        p = {k: gather(k, v) for k, v in p.items()}
        to_tensor, from_tensor = ctx.to_tensor, ctx.from_tensor
    # this rank's heads (all of them off a tensor axis)
    h, kvh = p["wq"].shape[-1] // hd, p["wk"].shape[-1] // hd

    y = to_tensor(_rms_norm(x, p["attn_norm"], config.norm_eps))
    if _flash_path(config, ring):
        # projections viewed as [B,H,S,Dh] (no copies): the kernels read
        # heads and rows by stride
        qt = project_heads(y, p["wq"], h, hd, "attn_qkv")
        kt = project_heads(y, p["wk"], kvh, hd, "attn_qkv")
        vt = project_heads(y, p["wv"], kvh, hd, "attn_qkv")
        out = flash_attention(qt, kt, vt, causal=True, rope_cos=rope_cos,
                              rope_sin=rope_sin)
        x = x + from_tensor(project_out(out, p["wo"], "attn_out"))
    else:
        q = qdot(y, p["wq"], site="attn_qkv").view(B, S, h, hd)
        k = qdot(y, p["wk"], site="attn_qkv").view(B, S, kvh, hd)
        v = qdot(y, p["wv"], site="attn_qkv").view(B, S, kvh, hd)
        q = _rope_apply(q, rope_cos, rope_sin)
        k = _rope_apply(k, rope_cos, rope_sin)
        attn = _attention(config, q, k, v, ring)
        x = x + from_tensor(qdot(attn.reshape(B, S, h * hd), p["wo"],
                                 site="attn_out"))

    if config.is_moe:
        y = _rms_norm(x, p["mlp_norm"], config.norm_eps)
        out, metrics = moe_ffn(
            y, p, config.moe_config(),
            group=experts,
            batch_mean=None if ctx is None else ctx.batch_mean)
        aux = (config.moe_aux_weight * metrics["aux_loss"]
               + config.moe_z_weight * metrics["z_loss"])
        return x + out, aux
    y = to_tensor(_rms_norm(x, p["mlp_norm"], config.norm_eps))
    mlp = (F.silu(qdot(y, p["w_gate"], site="mlp"))
           * qdot(y, p["w_up"], site="mlp"))
    return x + from_tensor(qdot(mlp, p["w_down"], site="mlp")), None


def _identity(x):
    return x


def _sharded_weight(shard, params, name, dtype, tensor_dim):
    """A non-stacked param's local shard, cast, gathered over every axis
    but ``tensor``; its ``tensor`` split must be on ``tensor_dim``."""
    p = params[name]
    shard.expect_tensor_dim(name, p, tensor_dim)
    return shard.gather(shard.local(p).to(dtype), shard.gathers(p))


def _embed(params, tokens, dtype, shard):
    """The token embeddings [B, S, D]. On a ``tensor`` axis each rank looks
    up the tokens of its vocab rows (zeros for the others), and the ranks'
    rows are summed."""
    if shard is None:
        return F.embedding(tokens, params["embed"].to(dtype))
    w = _sharded_weight(shard, params, "embed", dtype, 0)
    if shard.tensor_size == 1:
        return F.embedding(tokens, w)
    local = tokens - shard.offset(params["embed"], 0)
    hit = (local >= 0) & (local < w.shape[0])
    x = F.embedding(local.clamp(0, w.shape[0] - 1), w)
    return shard.from_tensor(x * hit[..., None].to(dtype))


def check_tensor_heads(config, shard) -> None:
    """The tensor axis must split whole heads: it divides n_heads and
    n_kv_heads (each rank runs H/t q heads over KVH/t kv heads)."""
    t = 1 if shard is None else shard.tensor_size
    if config.n_heads % t or config.n_kv_heads % t:
        raise MeshError(
            f"a tensor axis of {t} must divide n_heads={config.n_heads} "
            f"and n_kv_heads={config.n_kv_heads}")


def _check_moe_mesh(config, shard, ring) -> None:
    """MoE runs unsharded, on the in-process seq transport, and on a
    DeviceMesh whose ``tensor`` axis is 1."""
    if not config.is_moe:
        return
    if isinstance(ring, ProcessGroupRing):
        raise NotImplementedError(
            "MoE under a seq process group (routing over sequence shards) "
            "is not ported yet (ROADMAP Queue 1 item 10)")
    if shard is not None and shard.tensor_size > 1:
        raise NotImplementedError(
            "MoE under a tensor axis (experts split by column and row) is "
            "not ported yet (ROADMAP Queue 1 item 10)")


def llama_apply(config: LlamaConfig, params: dict, tokens, positions=None,
                return_hidden: bool = False, return_aux: bool = False):
    """tokens [B, S] int -> logits [B, S, vocab] float32.

    ``params`` are used in their own dtype except that every weight is
    cast to ``config.dtype`` at its use, as the JAX forward does. Under a
    seq mesh axis ``tokens`` are the sequence shards this process holds
    (all of them with the in-process transport, this rank's with a
    process group), and positions default to their global positions.
    ``return_hidden=True`` returns the hidden states before the final
    norm, [B, S, dim] in ``config.dtype``, instead of logits (the chunked
    CE applies the norm and the head itself, chunk by chunk). With
    DTensor params (a DeviceMesh) ``tokens`` are this rank's rows (a
    DTensor split over the batch axes, or its local tensor) and the
    logits are this rank's rows and vocab columns.

    ``return_aux=True`` also returns the layers' summed MoE losses
    (``moe_aux_weight * aux_loss + moe_z_weight * z_loss`` per layer; a
    0-d f32 zero for a dense model). On a DeviceMesh it is this rank's
    term: the batch ranks' terms average to the global batch's."""
    check_supported(config)
    dtype = getattr(torch, config.dtype)
    ring = seq_ring()
    shard = ShardContext.of(params)
    _check_moe_mesh(config, shard, ring)
    if shard is not None:
        check_tensor_heads(config, shard)
        tokens = shard.local_rows(tokens)
        if positions is not None:
            positions = shard.local_rows(positions)
    if positions is None:
        positions = _positions(tokens, ring)

    x = _embed(params, tokens, dtype, shard)
    cos, sin = _rope_tables(positions, config.head_dim // 2,
                            config.rope_theta, dtype)
    cos, sin = _maybe_full_rope(config, cos, sin, ring)

    keys = layer_keys(config)
    experts = EXPERT_DIMS if config.is_moe else {}
    if shard is None:
        stacks = {k: params["layers." + k].to(dtype).unbind(0)
                  for k in keys}
        layer_shard = None
    else:
        for k in keys:
            if k in experts:
                shard.expect_expert_dim("layers." + k, params["layers." + k],
                                        experts[k])
            else:
                shard.expect_tensor_dim("layers." + k,
                                        params["layers." + k],
                                        TENSOR_DIMS[k])
        gathers = {
            k: shard.gathers(params["layers." + k], drop_leading=1,
                             local_axes=("tensor", "expert") if k in experts
                             else ("tensor",))
            for k in keys}
        stacked = {k: shard.local(params["layers." + k]).to(dtype)
                   for k in keys}
        # the fsdp gathers one layer ahead under overlap_collectives
        overlapped = layer_gather_fn(shard, gathers)
        stacks = (overlapped.split(stacked) if overlapped is not None else
                  {k: v.unbind(0) for k, v in stacked.items()})
        plain = plain_gather(shard, gathers)
        group = (shard.expert_group(params["layers.w_gate"]) if experts
                 else None)
    # under remat each layer keeps only what its policy saves; without
    # gradients there is nothing to keep
    remat = (config.remat and torch.is_grad_enabled()
             and not remat_lib.remat_disabled())
    policy = remat_lib.layer_policy(config.remat_policy) if remat else None
    aux = None
    for i in range(config.n_layers):
        p = {k: v[i] for k, v in stacks.items()}
        if shard is not None:
            layer_shard = (shard, plain if overlapped is None
                           else overlapped.layer(i, stacks), group)
        if remat:
            x, layer_aux = remat_lib.checkpoint(
                _layer, config, x, p, cos, sin, ring, layer_shard,
                policy=policy)
        else:
            x, layer_aux = _layer(config, x, p, cos, sin, ring, layer_shard)
        if layer_aux is not None:
            aux = layer_aux if aux is None else aux + layer_aux

    if return_hidden:
        out = x
    elif shard is None:
        x = _rms_norm(x, params["final_norm"], config.norm_eps)
        out = (x @ params["lm_head"].to(dtype)).float()
    else:
        norm = _sharded_weight(shard, params, "final_norm", dtype, None)
        head = _sharded_weight(shard, params, "lm_head", dtype, 1)
        x = shard.to_tensor(_rms_norm(x, norm, config.norm_eps))
        out = (x @ head).float()
    if not return_aux:
        return out
    return out, (aux if aux is not None
                 else torch.zeros((), dtype=torch.float32, device=x.device))


def sharded_loss(shard, loss_sum, valid_sum, aux=None):
    """A rank's term of the global mean loss over a DeviceMesh: its rows'
    loss over the valid labels of every rank's rows (None: no mesh, the
    mean itself), plus its share of the MoE losses ``aux`` (this rank's
    term of the batch's, from ``llama_apply``; its batch ranks' terms
    average to the global value)."""
    if shard is None:
        loss = loss_sum / valid_sum.clamp(min=1)
        return loss if aux is None else loss + aux
    term = loss_sum / shard.batch_sum(valid_sum).clamp(min=1)
    if aux is not None:
        term = term + aux / shard.batch_size
    return shard.loss_term(term)


def llama_loss_fn(config: LlamaConfig):
    """Next-token CE loss closure for auto_accelerate:
    ``loss_fn(params, batch, rng) -> scalar``, the mean over valid
    labels. ``batch["tokens"]`` [B, S+1] is shifted into inputs and
    labels, unless ``batch["labels"]`` [B, S] comes with them.

    A MoE model adds its layers' weighted aux and z losses
    (``llama_apply(..., return_aux=True)``) in both CE paths, as the JAX
    loss does.

    At ``config.ce_chunks > 1`` the final norm, the head and the CE run
    chunked (``fused_linear_cross_entropy`` over the hidden states), as
    the JAX loss does. That loss recomputes its logits in its own
    backward, so the closure names its two halves as ``remat_split``:
    ``(body, head)``, ``body(params, batch, rng) -> hidden`` (a MoE
    model's ``(hidden, aux)``) and ``head(params, batch, body's output)
    -> loss``. A strategy remat then
    checkpoints the body only (parallel/accelerate.py ``_remat_wrap``),
    and the chunked loss's forward runs once a step.

    With DTensor params the batch is this rank's rows and the loss a
    DTensor: this rank's term of the global mean, ``Partial`` over the
    batch axes (``sharded_loss``). The chunked CE runs on data and fsdp;
    under ``tensor`` it raises (ROADMAP Queue 1 item 7)."""
    check_supported(config)
    dtype = getattr(torch, config.dtype)

    def split(batch, shard):
        if shard is not None:
            batch = {k: shard.local_rows(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        if "labels" in batch:
            # already shifted (a seq rank's slice, parallel/accelerate.py)
            return tokens, batch["labels"]
        return tokens[:, :-1], tokens[:, 1:]

    if config.ce_chunks > 1:
        def body(params, batch, rng):
            shard = ShardContext.of(params)
            return llama_apply(config, params, split(batch, shard)[0],
                               return_hidden=True,
                               return_aux=config.is_moe)

        def head(params, batch, body_out):
            hidden, aux = body_out if config.is_moe else (body_out, None)
            shard = ShardContext.of(params)
            labels = split(batch, shard)[1]
            if shard is None:
                w, norm = params["lm_head"].to(dtype), params["final_norm"]
            elif shard.tensor_size > 1:
                raise NotImplementedError(
                    "ce_chunks > 1 under a tensor axis (the chunked CE over "
                    "vocab-split logits) is not ported yet (ROADMAP Queue 1 "
                    "item 7)")
            else:
                w = _sharded_weight(shard, params, "lm_head", dtype, 1)
                norm = _sharded_weight(shard, params, "final_norm",
                                       params["final_norm"].dtype, None)
            loss_sum, valid_sum = fused_linear_cross_entropy(
                hidden, w, labels, n_chunks=config.ce_chunks,
                norm_scale=norm, norm_eps=config.norm_eps)
            return sharded_loss(shard, loss_sum, valid_sum, aux)

        def chunked_loss_fn(params, batch, rng):
            return head(params, batch, body(params, batch, rng))

        chunked_loss_fn.remat_split = (body, head)
        return chunked_loss_fn

    def loss_fn(params, batch, rng):
        shard = ShardContext.of(params)
        inputs, labels = split(batch, shard)
        out = llama_apply(config, params, inputs, return_aux=config.is_moe)
        logits, aux = out if config.is_moe else (out, None)
        if shard is not None and shard.tensor_size > 1:
            loss, valid = vocab_parallel_cross_entropy(
                logits, labels, shard, shard.offset(params["lm_head"], 1))
        else:
            loss, valid = softmax_cross_entropy(logits, labels)
        return sharded_loss(shard, loss.sum(), valid.sum(), aux)

    return loss_fn
