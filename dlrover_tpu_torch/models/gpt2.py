"""GPT-2 family in PyTorch (port of dlrover_tpu/models/gpt2.py).

Learned position embeddings, pre-LayerNorm blocks, a gelu MLP (tanh
approximation, ``jax.nn.gelu``'s default) and a tied (``embed.T``) or
untied LM head. Parameters follow the port's Llama idiom: a flat
``dict[str, Tensor]`` of fp32 masters with the layer axis stacked
(``"layers.w_qkv"`` is [L, dim, 3*dim]); the forward unbinds each stack
once and runs the layers as a Python loop, the counterpart of the JAX
layer scan. Both presets have head_dim 64.

Attention: ``attn_impl="flash"`` takes the JAX package's einsum-form
branch (``flash_einsum_path``): one ``y @ w_qkv + b_qkv`` viewed as
[B, H, S, 64] q/k/v with no copy (the kernels read heads and rows by
stride, the row stride 3*dim), then K1-K4 causal without rope, and out
through ``w_proj``. ``"bshd"``, ``"reference"`` and a seq mesh axis go
through the Llama model's ``_attention``, as in the JAX package: the
bshd route at head_dim 64 is K1-K4 on transposed views, and the ring's
kernels K12-K14 are built for head_dim 128 only (ROADMAP R8), so on the
card a seq axis raises here.

Low-precision compute (ops/fp8.py ``quant_autocast``): the JAX
package's sites, ``attn_qkv``, ``attn_out`` and ``mlp``. Under "int8"
the einsum-form branch stays, its qkv the JAX package's
``bsd,dthk->tbhsk`` in int8 (a [3, B, H, S, 64] view of one GEMM's
product) and its output ``bhsk,hkd->bsd``; under "fp8" the ``qdot``
branch (``_attention``: K1-K4 on the transposed q/k/v).

Sharded params (DTensors on a DeviceMesh, parallel/accelerate.py): the
``data`` and ``fsdp`` axes run as the Llama model runs them, each
layer's slice gathered over the axes that shard it and the rows this
rank's. A ``tensor`` axis raises (ROADMAP Queue 1 item 7): the JAX
package splits ``w_qkv``'s fused ``3*dim`` columns as one ``heads`` dim,
so a contiguous shard holds all of q and half of k, and local compute
needs a q/k/v-aware layout first.

Rematerialisation: with ``config.remat`` (and gradients on) each layer
runs under a non-reentrant checkpoint with the JAX layer scan's default
policy, ``dots_with_no_batch_dims_saveable`` (``"dots_no_batch"``,
parallel/remat.py); ``Strategy.remat="none"`` suppresses it.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.models.llama import (
    _attention,
    _first_position,
    _flash_path,
    _int8_site,
    _positions,
    project_out,
    sharded_loss,
)
from dlrover_tpu_torch.ops.attention import flash_attention
from dlrover_tpu_torch.ops.cross_entropy import softmax_cross_entropy
from dlrover_tpu_torch.ops.fp8 import qdot, qeinsum
from dlrover_tpu_torch.parallel import remat as remat_lib
from dlrover_tpu_torch.parallel.mesh import seq_ring
from dlrover_tpu_torch.parallel.overlap import layer_gather_fn, plain_gather
from dlrover_tpu_torch.parallel.shard_ops import ShardContext


@dataclasses.dataclass(frozen=True)
class GPT2Config:
    vocab_size: int = 50257
    dim: int = 768
    n_layers: int = 12
    n_heads: int = 12
    mlp_dim: int = 3072
    max_seq_len: int = 1024
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    remat: bool = False
    # "flash" (hand-written kernels, [B,H,S,Dh]) | "bshd" | "reference";
    # a seq mesh axis runs the ring whatever this says
    attn_impl: str = "flash"
    # accepted and ignored: TPU block tunings of the JAX kernels (see
    # LlamaConfig)
    attn_block_q: int = 512
    attn_block_k: int = 512
    attn_bwd_block_q: int = 0
    attn_bwd_block_k: int = 0
    tie_lm_head: bool = True
    pipe_microbatches: int = 0
    pipe_schedule: str = "gpipe"

    def __post_init__(self):
        if self.pipe_schedule not in ("gpipe", "1f1b"):
            raise ValueError(
                f"pipe_schedule must be 'gpipe' or '1f1b', got "
                f"{self.pipe_schedule!r}"
            )

    @property
    def head_dim(self) -> int:
        return self.dim // self.n_heads

    def param_count(self) -> int:
        d, m, L, v = self.dim, self.mlp_dim, self.n_layers, self.vocab_size
        per_layer = 4 * d * d + 2 * d * m + 9 * d + m
        head = 0 if self.tie_lm_head else d * v
        return v * d + self.max_seq_len * d + L * per_layer + 2 * d + head


GPT2_PRESETS = {
    "tiny": GPT2Config(vocab_size=512, dim=128, n_layers=2, n_heads=4,
                       mlp_dim=512, max_seq_len=256,
                       attn_impl="reference"),
    "gpt2-124m": GPT2Config(),
    "gpt2-1.5b": GPT2Config(dim=1600, n_layers=48, n_heads=25,
                            mlp_dim=6400),
}

LAYER_KEYS = ("ln1_scale", "ln1_bias", "w_qkv", "b_qkv", "w_proj", "b_proj",
              "ln2_scale", "ln2_bias", "w_fc", "b_fc", "w_out", "b_out")
# used in f32 as the JAX layer norm takes them; the rest is cast to the
# compute dtype at its use
_NORM_KEYS = ("ln1_scale", "ln1_bias", "ln2_scale", "ln2_bias")


def check_supported(config: GPT2Config) -> None:
    """Raise for the settings this slice of the port does not run."""
    if config.pipe_schedule != "gpipe":
        raise NotImplementedError(
            "the 1F1B pipeline loss is not ported yet (ROADMAP Queue 1 "
            "item 10)")
    if config.attn_impl not in ("flash", "bshd", "reference"):
        raise NotImplementedError(
            f"attn_impl={config.attn_impl!r} is not ported yet (ROADMAP "
            "Queue 1 item 10: Ulysses sequence parallelism)")


# ---------------------------------------------------------------------------
# params
# ---------------------------------------------------------------------------


def gpt2_init(config: GPT2Config, seed: int = 0, device=None) -> dict:
    """fp32 master params with the shapes and distributions of the JAX
    ``gpt2_init``: token embeddings N(0, 0.02^2), position embeddings
    N(0, 0.01^2), projections N(0, 1/fan_in), biases 0, norm scales 1, an
    untied lm_head N(0, 0.02^2); layer params stacked on axis 0. Drawn
    from a ``torch.Generator`` seeded with ``seed`` on ``device`` (the
    numbers differ from jax.random's; tests bridge weights with
    ``params_from_jax``)."""
    check_supported(config)
    device = resolve_device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    d, m, L = config.dim, config.mlp_dim, config.n_layers

    def normal(shape, std):
        return torch.randn(shape, generator=gen, device=device) * std

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    params = {
        "embed": normal((config.vocab_size, d), 0.02),
        "pos_embed": normal((config.max_seq_len, d), 0.01),
        "layers.ln1_scale": ones(L, d),
        "layers.ln1_bias": zeros(L, d),
        "layers.w_qkv": normal((L, d, 3 * d), d ** -0.5),
        "layers.b_qkv": zeros(L, 3 * d),
        "layers.w_proj": normal((L, d, d), d ** -0.5),
        "layers.b_proj": zeros(L, d),
        "layers.ln2_scale": ones(L, d),
        "layers.ln2_bias": zeros(L, d),
        "layers.w_fc": normal((L, d, m), d ** -0.5),
        "layers.b_fc": zeros(L, m),
        "layers.w_out": normal((L, m, d), m ** -0.5),
        "layers.b_out": zeros(L, d),
        "final_ln_scale": ones(d),
        "final_ln_bias": zeros(d),
    }
    if not config.tie_lm_head:
        params["lm_head"] = normal((d, config.vocab_size), 0.02)
    return params


def gpt2_logical_axes(config: GPT2Config) -> dict:
    """Logical axis names of each param, by the port's param names (the
    JAX package's ``gpt2_logical_axes`` tree, flattened by dots)."""
    layer = {
        "ln1_scale": ("layer", "embed"),
        "ln1_bias": ("layer", "embed"),
        "w_qkv": ("layer", "embed", "heads"),
        "b_qkv": ("layer", "heads"),
        "w_proj": ("layer", "heads", "embed"),
        "b_proj": ("layer", "embed"),
        "ln2_scale": ("layer", "embed"),
        "ln2_bias": ("layer", "embed"),
        "w_fc": ("layer", "embed", "mlp"),
        "b_fc": ("layer", "mlp"),
        "w_out": ("layer", "mlp", "embed"),
        "b_out": ("layer", "embed"),
    }
    axes = {
        "embed": ("vocab", "embed"),
        "pos_embed": (None, "embed"),
        **{f"layers.{k}": v for k, v in layer.items()},
        "final_ln_scale": ("embed",),
        "final_ln_bias": ("embed",),
    }
    if not config.tie_lm_head:
        axes["lm_head"] = ("embed", "vocab")
    return axes


# ---------------------------------------------------------------------------
# forward
# ---------------------------------------------------------------------------


def _layer_norm(x, scale, bias, eps):
    """LayerNorm in f32 with the population variance, cast back to x's
    dtype (the JAX ``_layer_norm``). One ``F.layer_norm`` on the f32
    input: its backward keeps that input and the per-row statistics, not
    the f32 intermediates of the op-by-op form."""
    out = F.layer_norm(x.float(), (x.shape[-1],), scale.float(),
                       bias.float(), eps)
    return out.to(x.dtype)


def _block(config: GPT2Config, x, p, ring=None, shard=None):
    """One pre-LN block. x: [B,S,D]; p: this layer's params (weights and
    biases in the compute dtype, norm params f32); ``ring``: the seq
    axis' transport, or None; ``shard``: ``gather(key, local) -> whole``
    for each param when ``p`` holds local shards."""
    if shard is not None:
        p = {k: shard(k, v) for k, v in p.items()}
    B, S, D = x.shape
    h, hd = config.n_heads, config.head_dim

    y = _layer_norm(x, p["ln1_scale"], p["ln1_bias"], config.norm_eps)
    if _flash_path(config, ring) and _int8_site("attn_qkv"):
        # the JAX package's einsum-form qkv in int8: [3, B, H, S, Dh], a
        # view of the [B, S, 3*D] product
        qkv4 = qeinsum("bsd,dthk->tbhsk", y,
                       p["w_qkv"].view(D, 3, h, hd), site="attn_qkv")
        q, k, v = (qkv4 + p["b_qkv"].view(3, 1, h, 1, hd)).unbind(0)
        out = flash_attention(q, k, v, causal=True)
        attn_out = project_out(out, p["w_proj"], "attn_out")
    elif _flash_path(config, ring):
        qkv = y @ p["w_qkv"] + p["b_qkv"]
        # [B, S, 3, H, Dh] viewed as q/k/v [B, H, S, Dh] (no copies): the
        # kernels read heads and rows by stride
        q, k, v = qkv.view(B, S, 3, h, hd).transpose(1, 3).unbind(2)
        out = flash_attention(q, k, v, causal=True)
        attn_out = project_out(out, p["w_proj"], "attn_out")
    else:
        qkv = qdot(y, p["w_qkv"], site="attn_qkv") + p["b_qkv"]
        q, k, v = (t.view(B, S, h, hd) for t in qkv.split(D, dim=-1))
        attn = _attention(config, q, k, v, ring).reshape(B, S, D)
        attn_out = qdot(attn, p["w_proj"], site="attn_out")
    x = x + attn_out + p["b_proj"]

    y = _layer_norm(x, p["ln2_scale"], p["ln2_bias"], config.norm_eps)
    hmid = F.gelu(qdot(y, p["w_fc"], site="mlp") + p["b_fc"],
                  approximate="tanh")
    return x + qdot(hmid, p["w_out"], site="mlp") + p["b_out"]


def _gpt2_embed(config: GPT2Config, embed, pos_embed, tokens, positions,
                ring):
    """Token + learned position embeddings (both in the compute dtype
    before the add). Positions default to the tokens' global positions
    (under a seq axis, this process's shards'); a sequence longer than
    ``max_seq_len`` raises, as the JAX guard does (a gather would clamp
    out-of-range positions to the last learned row)."""
    end = tokens.shape[1]
    if positions is None:
        positions = _positions(tokens, ring)
        end += _first_position(end, ring)
    if end > config.max_seq_len:
        raise ValueError(f"sequence length {end} exceeds max_seq_len "
                         f"{config.max_seq_len}")
    return F.embedding(tokens, embed) + F.embedding(positions, pos_embed)


def gpt2_apply(config: GPT2Config, params: dict, tokens, positions=None):
    """tokens [B, S] int -> logits [B, S, vocab] float32.

    ``params`` are used in their own dtype except that embeddings,
    weights and biases are cast to ``config.dtype`` at their use, as the
    JAX forward does (the norm params stay f32). With DTensor params
    ``tokens`` are this rank's rows, and so are the logits."""
    check_supported(config)
    dtype = getattr(torch, config.dtype)
    ring = seq_ring()
    shard = ShardContext.of(params)
    layer_shard = None
    if shard is not None:
        if shard.tensor_size > 1:
            raise NotImplementedError(
                "GPT-2 under a tensor axis is not ported yet (ROADMAP "
                "Queue 1 item 7): w_qkv's fused 3*dim columns need a "
                "q/k/v-aware split")
        tokens = shard.local_rows(tokens)
        if positions is not None:
            positions = shard.local_rows(positions)
        gathers = {k: shard.gathers(params["layers." + k], drop_leading=1)
                   for k in LAYER_KEYS}
        # every other param whole on every rank (the gathers' backward
        # reduce-scatters their gradients)
        params = {n: p if n.startswith("layers.") else shard.gather(
                      shard.local(p), shard.gathers(p))
                  for n, p in params.items()}
        params.update({"layers." + k: shard.local(params["layers." + k])
                       for k in LAYER_KEYS})
    embed = params["embed"].to(dtype)
    x = _gpt2_embed(config, embed, params["pos_embed"].to(dtype), tokens,
                    positions, ring)

    stacked = {k: (params["layers." + k] if k in _NORM_KEYS
                   else params["layers." + k].to(dtype))
               for k in LAYER_KEYS}
    # the fsdp gathers one layer ahead under overlap_collectives
    overlapped = (layer_gather_fn(shard, gathers) if shard is not None
                  else None)
    stacks = (overlapped.split(stacked) if overlapped is not None else
              {k: v.unbind(0) for k, v in stacked.items()})
    # under remat each layer keeps only the weight matmuls; without
    # gradients there is nothing to keep
    remat = (config.remat and torch.is_grad_enabled()
             and not remat_lib.remat_disabled())
    policy = remat_lib.layer_policy("dots_no_batch") if remat else None
    for i in range(config.n_layers):
        p = {k: v[i] for k, v in stacks.items()}
        if shard is not None:
            layer_shard = (plain_gather(shard, gathers) if overlapped is None
                           else overlapped.layer(i, stacks))
        if remat:
            x = remat_lib.checkpoint(_block, config, x, p, ring,
                                     layer_shard, policy=policy)
        else:
            x = _block(config, x, p, ring, layer_shard)

    x = _layer_norm(x, params["final_ln_scale"], params["final_ln_bias"],
                    config.norm_eps)
    head = embed.t() if config.tie_lm_head else params["lm_head"].to(dtype)
    return (x @ head).float()


def gpt2_loss_fn(config: GPT2Config):
    """Next-token CE loss closure for auto_accelerate:
    ``loss_fn(params, batch, rng) -> scalar``, the mean over valid
    labels. ``batch["tokens"]`` [B, S+1] is shifted into inputs and
    labels, unless ``batch["labels"]`` [B, S] comes with them. With
    DTensor params the batch is this rank's rows and the loss this rank's
    term of the global mean (``llama.sharded_loss``)."""
    check_supported(config)

    def loss_fn(params, batch, rng):
        shard = ShardContext.of(params)
        if shard is not None:
            batch = {k: shard.local_rows(v) for k, v in batch.items()}
        tokens = batch["tokens"]
        if "labels" in batch:
            # already shifted (a seq rank's slice, parallel/accelerate.py)
            inputs, labels = tokens, batch["labels"]
        else:
            inputs, labels = tokens[:, :-1], tokens[:, 1:]
        logits = gpt2_apply(config, params, inputs)
        loss, valid = softmax_cross_entropy(logits, labels)
        return sharded_loss(shard, loss.sum(), valid.sum())

    return loss_fn
