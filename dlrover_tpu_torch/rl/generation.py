"""KV-cache incremental decoding for RL experience generation (port of
dlrover_tpu/rl/generation.py).

Prefill writes the prompt's K/V into a ring-buffer cache, then single-
token decode steps sample the continuation. The cache has a fixed size
with per-slot absolute positions, so sequences longer than its capacity
keep a sliding window instead of reallocating; GQA is native (the cache
stores the kv heads, queries are grouped onto them on read).

Attention here is plain torch, as in the JAX package, where it is a
masked einsum outside any Pallas kernel: scores in the compute dtype,
the ``1/sqrt(hd)`` scale cast to that dtype, a ``-1e30`` fill, the
softmax in f32 and cast back. The cache is laid out
``[L, B, KVH, C, hd]`` (the JAX package's is ``[L, B, C, KVH, hd]``):
each (row, kv head) is then one contiguous ``[C, hd]`` matrix, so the
score and value products are batched GEMMs over views, with no copy of
the cache; query head ``h`` reads kv head ``h // rep``, as
``jnp.repeat(k, rep, axis=2)`` maps it.

Weights are cast to the compute dtype once per call (``decode_weights``),
where the JAX package casts each weight at its use inside one compiled
program; the numbers are the same. Random draws come from
``torch.Generator`` s (Gumbel-max, as ``jax.random.categorical`` draws),
so the sampled tokens differ from the JAX package's at temperature > 0;
at temperature 0 both take the first maximal logit.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.models.llama import (
    LlamaConfig,
    _rms_norm,
    _rope_apply,
    _rope_tables,
)

# smallest prompt bucket: padding a 3-token prompt to 8 costs noise,
# while an unbounded set of tiny buckets costs a trace each
MIN_PROMPT_BUCKET = 8
# the JAX package's masked-score fill
NEG_INF = -1e30
# seeds drawn from a caller's generator for each draw of a generate call
_SEED_HIGH = 2 ** 62


def bucket_len(n: int, cap: int | None = None,
               min_bucket: int = MIN_PROMPT_BUCKET) -> int:
    """Next power-of-two >= n, clamped to [min_bucket, cap]. The ONE
    prompt-bucketing policy, shared by this backend and the serving
    engine (``serving/engine.py``)."""
    b = min_bucket
    while b < n:
        b <<= 1
    return b if cap is None else min(b, cap)


class KVCache(NamedTuple):
    """Ring-buffer cache: ``k``/``v`` are [L, B, KVH, C, hd]; ``pos``
    holds each slot's absolute position (-1 = empty). Updated in
    place."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor  # [C] int32


def init_kv_cache(config: LlamaConfig, batch: int, capacity: int,
                  dtype=None, device=None) -> KVCache:
    dtype = dtype or getattr(torch, config.dtype)
    device = resolve_device(device)
    shape = (config.n_layers, batch, config.n_kv_heads, capacity,
             config.head_dim)
    return KVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((capacity,), -1, dtype=torch.int32, device=device),
    )


# ---------------------------------------------------------------------------
# weights
# ---------------------------------------------------------------------------


class DecodeWeights(dict):
    """The params cast to the compute dtype once: ``embed``,
    ``final_norm``, ``lm_head`` and ``layers``, a list of per-layer dicts
    of views into the stacks (no copy where the params already are in
    the compute dtype)."""


def decode_weights(config: LlamaConfig, params: dict,
                   device=None) -> DecodeWeights:
    """``params`` (the port's flat dict, dense or MoE) as
    :class:`DecodeWeights`; already prepared weights pass through. With
    ``device`` the weights are also moved there."""
    if isinstance(params, DecodeWeights):
        return params
    dtype = getattr(torch, config.dtype)

    def cast(name, t):
        # the MoE router is read in f32 from its own params, as the JAX
        # package reads it
        return t.detach().to(device=device or t.device,
                             dtype=t.dtype if name == "router" else dtype)

    stacks = {name[len("layers."):]: cast(name[len("layers."):], t).unbind(0)
              for name, t in params.items() if name.startswith("layers.")}
    return DecodeWeights(
        embed=cast("embed", params["embed"]),
        final_norm=cast("final_norm", params["final_norm"]),
        lm_head=cast("lm_head", params["lm_head"]),
        layers=[{k: v[i] for k, v in stacks.items()}
                for i in range(config.n_layers)],
    )


# ---------------------------------------------------------------------------
# the layer pieces shared with serving/engine.py
# ---------------------------------------------------------------------------


def _rope(x, positions, theta):
    """x: [B, S, H, hd] roped at ``positions`` [B, S] (the JAX package's
    single-call ``_rope``)."""
    cos, sin = _rope_tables(positions, x.shape[-1] // 2, theta, x.dtype)
    return _rope_apply(x, cos, sin)


def moe_mixture(config: LlamaConfig, p, y, dtype):
    """Per-token top-k expert dispatch for DECODE shapes: no capacity
    machinery, every token computes its selected experts exactly. Gating
    as the JAX package's: softmax over all experts in f32, top-k of the
    probs, renormalised over the selection. All E experts run batched
    and combine through zero weights. The ONE implementation shared by
    this backend and the serving engine. ``p`` holds one layer's
    ``router`` [D, E] and ``w_gate``/``w_up`` [E, D, M], ``w_down``
    [E, M, D]; ``y`` [B, S, D]."""
    k = config.moe_top_k
    logits = y.float() @ p["router"].float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.topk(probs, k, dim=-1)       # [B, S, k]
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)
    # [B, S, E] combine weights (0 for unselected experts)
    weights = torch.zeros_like(probs).scatter_add(
        -1, gate_idx, gate_vals).to(dtype)
    gate_h = F.silu(torch.einsum("bsd,edm->bsem", y, p["w_gate"].to(dtype)))
    up_h = torch.einsum("bsd,edm->bsem", y, p["w_up"].to(dtype))
    out = torch.einsum("bsem,emd->bsed", gate_h * up_h,
                       p["w_down"].to(dtype))
    return torch.einsum("bse,bsed->bsd", weights, out)


def mlp(config: LlamaConfig, p, y, dtype):
    """The layer's FFN: SwiGLU, or the decode-shape MoE mixture."""
    if config.is_moe:
        return moe_mixture(config, p, y, dtype)
    gate = F.silu(y @ p["w_gate"])
    return (gate * (y @ p["w_up"])) @ p["w_down"]


def grouped_attention(q, ck, cv, valid):
    """Attention of roped queries over cached keys and values.

    q: [N, Sq, H, hd]; ck/cv: [N, KVH, C, hd]; ``valid``: a bool mask
    broadcastable to [N, Sq, C]. Returns [N, Sq, H*hd]. Query head ``h``
    attends kv head ``h // rep``: q is viewed as [N, KVH, rep*Sq, hd],
    so each (row, kv head) is one GEMM against its [C, hd] keys."""
    N, Sq, H, hd = q.shape
    kvh = ck.shape[1]
    rep = H // kvh
    qg = q.reshape(N, Sq, kvh, rep, hd).permute(0, 2, 3, 1, 4).reshape(
        N, kvh, rep * Sq, hd)
    # sqrt(hd) rounded to the compute dtype, as the JAX package divides
    scale = float(torch.tensor(hd, dtype=torch.float32).sqrt().to(q.dtype))
    scores = (qg @ ck.transpose(-1, -2)) / scale      # [N, KVH, rep*Sq, C]
    mask = valid.expand(N, Sq, valid.shape[-1])[:, None, None]
    scores = scores.view(N, kvh, rep, Sq, -1).masked_fill(~mask, NEG_INF)
    probs = torch.softmax(scores.float(), dim=-1).to(q.dtype)
    out = probs.view(N, kvh, rep * Sq, -1) @ cv        # [N, KVH, rep*Sq, hd]
    return out.view(N, kvh, rep, Sq, hd).permute(0, 3, 1, 2, 4).reshape(
        N, Sq, H * hd)


def project_qkv(config: LlamaConfig, p, hdn, positions):
    """One layer's attention-norm, q/k/v projections and rope:
    hdn [N, S, D] -> q [N, S, H, hd], k/v [N, S, KVH, hd]."""
    N, S, _ = hdn.shape
    h, kvh, hd = config.n_heads, config.n_kv_heads, config.head_dim
    y = _rms_norm(hdn, p["attn_norm"], config.norm_eps)
    q = (y @ p["wq"]).view(N, S, h, hd)
    k = (y @ p["wk"]).view(N, S, kvh, hd)
    v = (y @ p["wv"]).view(N, S, kvh, hd)
    return (_rope(q, positions, config.rope_theta),
            _rope(k, positions, config.rope_theta), v)


def finish_layer(config: LlamaConfig, p, hdn, attn, dtype):
    """The attention output projection, residual, MLP and residual."""
    hdn = hdn + attn @ p["wo"]
    y = _rms_norm(hdn, p["mlp_norm"], config.norm_eps)
    return hdn + mlp(config, p, y, dtype)


def logits_of(config: LlamaConfig, w, hidden):
    """Final norm and head, f32 logits."""
    x = _rms_norm(hidden, w["final_norm"], config.norm_eps)
    return (x @ w["lm_head"].to(x.dtype)).float()


# ---------------------------------------------------------------------------
# prefill and decode over a KVCache
# ---------------------------------------------------------------------------


def _decode_layers(config: LlamaConfig, w, x, positions, cache: KVCache,
                   write_idx):
    """Run all layers for S tokens (S = prompt len at prefill, 1 at
    decode), writing this step's K/V into the cache at ``write_idx`` ([S]
    slot indices). Returns (hidden, cache)."""
    dtype = x.dtype
    cache.pos[write_idx] = positions[0].to(torch.int32)
    q_pos = positions[0]
    # slot valid if written and not in this query's future
    valid = (cache.pos[None, :] >= 0) & (cache.pos[None, :] <= q_pos[:, None])
    hdn = x
    for i, p in enumerate(w["layers"]):
        q, k, v = project_qkv(config, p, hdn, positions)
        ck, cv = cache.k[i], cache.v[i]            # [B, KVH, C, hd]
        ck[:, :, write_idx] = k.transpose(1, 2)
        cv[:, :, write_idx] = v.transpose(1, 2)
        attn = grouped_attention(q, ck, cv, valid[None])
        hdn = finish_layer(config, p, hdn, attn, dtype)
    return hdn, cache


@torch.no_grad()
def prefill(config: LlamaConfig, params, tokens, cache: KVCache,
            valid_len=None):
    """Write the prompt's K/V; returns (last-token logits, cache).

    A prompt longer than the cache keeps its last C tokens (true
    sliding-window semantics). ``valid_len`` marks ``tokens`` as a padded
    length bucket: positions past it get ``-1`` (never attendable), and
    the returned logits are read at ``valid_len - 1``. Only supported
    when the bucket fits the cache."""
    w = decode_weights(config, params)
    dtype = getattr(torch, config.dtype)
    B, P = tokens.shape
    C = cache.pos.shape[0]
    start = 0
    if P > C:
        if valid_len is not None:
            raise ValueError(
                f"bucketed prefill needs bucket <= cache capacity "
                f"(got {P} > {C})")
        start = P - C
        tokens = tokens[:, -C:]
        P = C
    device = tokens.device
    pos_row = torch.arange(start, start + P, device=device)
    if valid_len is not None:
        vl = int(valid_len)
        pos_row = torch.where(pos_row < vl, pos_row, -1)
    positions = pos_row.expand(B, P)
    x = F.embedding(tokens, w["embed"]).to(dtype)
    write_idx = torch.arange(start, start + P, device=device) % C
    hidden, cache = _decode_layers(config, w, x, positions, cache, write_idx)
    if valid_len is not None:
        last = min(max(vl - 1, 0), P - 1)
        hidden_last = hidden[:, last:last + 1]
    else:
        hidden_last = hidden[:, -1:]
    return logits_of(config, w, hidden_last)[:, 0], cache


@torch.no_grad()
def decode_step(config: LlamaConfig, params, token, pos: int,
                cache: KVCache):
    """One token for the whole batch. token [B], ``pos`` the absolute
    position. Returns (logits [B, V], cache)."""
    w = decode_weights(config, params)
    dtype = getattr(torch, config.dtype)
    B = token.shape[0]
    device = token.device
    positions = torch.full((B, 1), int(pos), device=device)
    x = F.embedding(token[:, None], w["embed"]).to(dtype)
    C = cache.pos.shape[0]
    write_idx = torch.tensor([int(pos) % C], device=device)
    hidden, cache = _decode_layers(config, w, x, positions, cache, write_idx)
    return logits_of(config, w, hidden)[:, 0], cache


# ---------------------------------------------------------------------------
# sampling
# ---------------------------------------------------------------------------


def gumbel(shape, generator, device):
    """Standard Gumbel noise from ``generator`` (Gumbel-max sampling is
    what ``jax.random.categorical`` draws)."""
    u = torch.rand(shape, generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def seeds_from(rng: int, n: int) -> list:
    """``n`` seeds drawn from the seed ``rng``: the port's counterpart of
    splitting a JAX key into ``n`` independent keys."""
    gen = torch.Generator().manual_seed(int(rng))
    return torch.randint(0, _SEED_HIGH, (n,), generator=gen).tolist()


def generator_for(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


@dataclasses.dataclass(frozen=True)
class GenerateConfig:
    max_new_tokens: int = 64
    temperature: float = 1.0
    cache_capacity: int = 0  # 0 = prompt + max_new_tokens
    eos_id: int = -1         # -1 = never stop early


class GenerateResult(NamedTuple):
    sequences: torch.Tensor  # [B, P + N] prompt + continuation
    logprobs: torch.Tensor   # [B, N] sampled-token logprobs
    mask: torch.Tensor       # [B, N] 1.0 until (incl.) eos


@torch.no_grad()
def generate(config: LlamaConfig, params, prompt_tokens, rng,
             gen: GenerateConfig = GenerateConfig(),
             prompt_len=None) -> GenerateResult:
    """Autoregressive sampling with the ring-buffer KV cache: O(T) per
    new token. ``rng`` is an int seed; each draw takes its own seed from
    it, the first before any later one, so token 0's draw is independent
    of the later draws (the JAX package splits its key before the first
    sample).

    ``prompt_len`` marks ``prompt_tokens`` as a padded length bucket:
    the pads' positions are masked out of the cache and generation
    starts at ``prompt_len``."""
    w = decode_weights(config, params, device=prompt_tokens.device)
    B, P = prompt_tokens.shape
    N = int(gen.max_new_tokens)
    C = gen.cache_capacity or (P + N)
    device = prompt_tokens.device
    cache = init_kv_cache(config, B, C, device=device)
    logits, cache = prefill(config, w, prompt_tokens, cache,
                            valid_len=prompt_len)
    seeds = seeds_from(rng, N)

    def sample(logits, seed):
        if gen.temperature <= 0:
            tok = torch.argmax(logits, -1)
        else:
            noise = gumbel(logits.shape, generator_for(seed, device), device)
            tok = torch.argmax(logits / gen.temperature + noise, -1)
        logp = torch.log_softmax(logits, -1)
        return tok, logp.gather(-1, tok[:, None])[:, 0]

    tok, lp = sample(logits, seeds[0])
    alive = torch.ones(B, device=device)
    # generation starts right after the REAL prompt
    gen_start = int(prompt_len) if prompt_len is not None else P
    toks, lps, masks = [tok], [lp], [alive]
    for i in range(N - 1):
        # the token sampled from prefill sits at position gen_start; step
        # i consumes the token at gen_start + i
        logits, cache = decode_step(config, w, tok, gen_start + i, cache)
        nxt, lp = sample(logits, seeds[i + 1])
        # the new token is masked out once an eos has been generated at
        # or before the consumed token
        alive = alive * (tok != gen.eos_id).float()
        toks.append(nxt)
        lps.append(lp)
        masks.append(alive)
        tok = nxt
    tokens = torch.stack(toks, 1).to(prompt_tokens.dtype)
    return GenerateResult(
        sequences=torch.cat([prompt_tokens, tokens], dim=1),
        logprobs=torch.stack(lps, 1),
        mask=torch.stack(masks, 1),
    )


class KVCacheGenerationBackend:
    """Hands the PPO loop fast rollouts (the reference's inference-
    backend role). Prompts are padded to power-of-two length buckets
    (masked positions, the real length passed on), so the variants run
    are keyed by (batch, bucket) instead of (batch, prompt length);
    ``bucket_prompts=False`` runs each prompt at its own length. Runs on
    ``cuda`` unless ``device="cpu"`` is passed."""

    def __init__(self, config: LlamaConfig,
                 gen: Optional[GenerateConfig] = None,
                 bucket_prompts: bool = True, device=None):
        self.config = config
        self.gen = gen or GenerateConfig()
        self.bucket_prompts = bucket_prompts
        self.device = resolve_device(device)
        self._variants: set = set()

    def _run(self, params, toks, rng, prompt_len=None):
        self._variants.add((tuple(toks.shape), prompt_len is None))
        return generate(self.config, params, toks, rng, self.gen,
                        prompt_len=prompt_len)

    def generate(self, params, prompt_tokens, rng) -> GenerateResult:
        toks = torch.as_tensor(prompt_tokens, device=self.device)
        B, P = toks.shape
        Pb = bucket_len(P)
        cap = self.gen.cache_capacity
        if not self.bucket_prompts or (cap and cap < Pb):
            # an explicit cache smaller than the bucket means the
            # sliding-window truncation path
            return self._run(params, toks, rng)
        padded = toks
        if Pb != P:
            padded = torch.zeros((B, Pb), dtype=toks.dtype, device=toks.device)
            padded[:, :P] = toks
        res = self._run(params, padded, rng, prompt_len=P)
        # strip the pad columns: callers see prompt + continuation
        return GenerateResult(
            sequences=torch.cat([toks, res.sequences[:, Pb:]], dim=1),
            logprobs=res.logprobs, mask=res.mask)

    def trace_count(self) -> int:
        """Distinct generate variants run (one per (batch, bucket), never
        one per prompt length): the JAX backend's compiled-variant count."""
        return len(self._variants)
