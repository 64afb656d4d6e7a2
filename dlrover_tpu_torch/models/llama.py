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
to [B,H,S,Dh], then ring attention over the ring-block kernels
(parallel/sequence.py). What the port does not run yet raises
``NotImplementedError`` naming its ROADMAP item.

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
from dlrover_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from dlrover_tpu_torch.parallel import remat as remat_lib
from dlrover_tpu_torch.parallel.mesh import axis_index, seq_ring
from dlrover_tpu_torch.parallel.sequence import sequence_sharded_attention


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
    # kernels, [B,S,H,Dh]) | "reference"; a seq mesh axis runs the ring
    # whatever this says; the JAX package's "ulysses" is not ported yet
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


def check_supported(config: LlamaConfig) -> None:
    """Raise for the settings this slice of the port does not run."""
    if config.is_moe:
        raise NotImplementedError(
            "MoE FFN is not ported yet (ROADMAP Queue 1 item 10)")
    if config.ce_chunks > 1:
        raise NotImplementedError(
            "ce_chunks > 1 (fused_linear_cross_entropy) is not ported yet "
            "(ROADMAP Queue 1 item 2)")
    if config.pipe_schedule != "gpipe" or config.pipe_virtual_stages != 1:
        raise NotImplementedError(
            "pipeline schedules are not ported yet (ROADMAP Queue 1 "
            "item 10)")
    if config.remat:
        remat_lib.layer_policy(config.remat_policy)  # raises if unknown
    if config.attn_impl not in ("flash", "bshd", "reference"):
        raise NotImplementedError(
            f"attn_impl={config.attn_impl!r} is not ported yet (ROADMAP "
            "Queue 1 item 10: Ulysses sequence parallelism; a seq mesh "
            "axis runs ring attention with any other attn_impl)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def llama_init(config: LlamaConfig, seed: int = 0, device=None) -> dict:
    """fp32 master params with the shapes and distributions of the JAX
    ``llama_init``: projections N(0, 1/fan_in), embed and lm_head
    N(0, 0.02^2), norms 1; layer params stacked on axis 0. Drawn from a
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

    return {
        "embed": normal((config.vocab_size, d), 0.02),
        "layers.attn_norm": ones(L, d),
        "layers.wq": normal((L, d, h * hd), d ** -0.5),
        "layers.wk": normal((L, d, kvh * hd), d ** -0.5),
        "layers.wv": normal((L, d, kvh * hd), d ** -0.5),
        "layers.wo": normal((L, h * hd, d), (h * hd) ** -0.5),
        "layers.mlp_norm": ones(L, d),
        "layers.w_gate": normal((L, d, m), d ** -0.5),
        "layers.w_up": normal((L, d, m), d ** -0.5),
        "layers.w_down": normal((L, m, d), m ** -0.5),
        "final_norm": ones(d),
        "lm_head": normal((d, config.vocab_size), 0.02),
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


def _flash_path(config, ring) -> bool:
    """Whether the einsum-form flash branch applies (the JAX package's
    ``flash_einsum_path``): ``attn_impl="flash"`` and no seq axis."""
    return config.attn_impl == "flash" and ring is None


def _maybe_full_rope(config, cos, sin, ring=None):
    """Full-width [B, S, Dh] tables for the flash path (rope fuses into
    the kernels); half-width tables otherwise."""
    if _flash_path(config, ring):
        return torch.cat([cos, cos], dim=-1), torch.cat([sin, sin], dim=-1)
    return cos, sin


def _layer(config: LlamaConfig, x, p, rope_cos, rope_sin, ring=None):
    """One transformer block. x: [B,S,D]; p: this layer's params;
    ``ring``: the seq axis' transport, or None."""
    B, S, D = x.shape
    h, kvh, hd = config.n_heads, config.n_kv_heads, config.head_dim

    y = _rms_norm(x, p["attn_norm"], config.norm_eps)
    if _flash_path(config, ring):
        # projections viewed as [B,H,S,Dh] (no copies): the kernels read
        # heads and rows by stride
        qt = (y @ p["wq"]).view(B, S, h, hd).transpose(1, 2)
        kt = (y @ p["wk"]).view(B, S, kvh, hd).transpose(1, 2)
        vt = (y @ p["wv"]).view(B, S, kvh, hd).transpose(1, 2)
        out = flash_attention(qt, kt, vt, causal=True, rope_cos=rope_cos,
                              rope_sin=rope_sin)
        x = x + out.transpose(1, 2).reshape(B, S, h * hd) @ p["wo"]
    else:
        q = (y @ p["wq"]).view(B, S, h, hd)
        k = (y @ p["wk"]).view(B, S, kvh, hd)
        v = (y @ p["wv"]).view(B, S, kvh, hd)
        q = _rope_apply(q, rope_cos, rope_sin)
        k = _rope_apply(k, rope_cos, rope_sin)
        if ring is not None:
            # sequence sharded on the mesh: the ring over [B,H,S,Dh]
            attn = sequence_sharded_attention(
                q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
                causal=True).transpose(1, 2)
        elif config.attn_impl == "bshd":
            # model-native layout end to end: no q/k/v/o transposes
            attn = flash_attention_bshd(q, k, v, causal=True)
        else:
            attn = mha_reference(q.transpose(1, 2), k.transpose(1, 2),
                                 v.transpose(1, 2), causal=True)
            attn = attn.transpose(1, 2)
        x = x + attn.reshape(B, S, h * hd) @ p["wo"]

    y = _rms_norm(x, p["mlp_norm"], config.norm_eps)
    mlp = F.silu(y @ p["w_gate"]) * (y @ p["w_up"])
    return x + mlp @ p["w_down"]


def llama_apply(config: LlamaConfig, params: dict, tokens, positions=None):
    """tokens [B, S] int -> logits [B, S, vocab] float32.

    ``params`` are used in their own dtype except that every weight is
    cast to ``config.dtype`` at its use, as the JAX forward does. Under a
    seq mesh axis ``tokens`` are the sequence shards this process holds
    (all of them with the in-process transport, this rank's with a
    process group), and positions default to their global positions."""
    check_supported(config)
    dtype = getattr(torch, config.dtype)
    B, S = tokens.shape
    ring = seq_ring()
    if positions is None:
        # this process's first shard starts at its rank's global position
        start = (0 if ring is None
                 else axis_index("seq") * (S // len(ring.ranks)))
        positions = torch.arange(start, start + S,
                                 device=tokens.device).expand(B, S)

    x = F.embedding(tokens, params["embed"].to(dtype))
    cos, sin = _rope_tables(positions, config.head_dim // 2,
                            config.rope_theta, dtype)
    cos, sin = _maybe_full_rope(config, cos, sin, ring)

    stacks = {k: params["layers." + k].to(dtype).unbind(0)
              for k in LAYER_KEYS}
    # under remat each layer keeps only what its policy saves; without
    # gradients there is nothing to keep
    remat = (config.remat and torch.is_grad_enabled()
             and not remat_lib.remat_disabled())
    policy = remat_lib.layer_policy(config.remat_policy) if remat else None
    for i in range(config.n_layers):
        p = {k: v[i] for k, v in stacks.items()}
        if remat:
            x = remat_lib.checkpoint(_layer, config, x, p, cos, sin, ring,
                                     policy=policy)
        else:
            x = _layer(config, x, p, cos, sin, ring)

    x = _rms_norm(x, params["final_norm"], config.norm_eps)
    return (x @ params["lm_head"].to(dtype)).float()


def llama_loss_fn(config: LlamaConfig):
    """Next-token CE loss closure for auto_accelerate:
    ``loss_fn(params, batch, rng) -> scalar``, the mean over valid
    labels. ``batch["tokens"]`` [B, S+1] is shifted into inputs and
    labels, unless ``batch["labels"]`` [B, S] comes with them."""
    check_supported(config)

    def loss_fn(params, batch, rng):
        tokens = batch["tokens"]
        if "labels" in batch:
            # already shifted (a seq rank's slice, parallel/accelerate.py)
            inputs, labels = tokens, batch["labels"]
        else:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits = llama_apply(config, params, inputs)
        loss, valid = softmax_cross_entropy(logits, labels)
        return loss.sum() / valid.sum().clamp(min=1)

    return loss_fn
