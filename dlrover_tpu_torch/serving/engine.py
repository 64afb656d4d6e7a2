"""Slotted KV-cache decode engine: the device half of continuous
batching (port of dlrover_tpu/serving/engine.py).

The pool is a fixed device-resident cache of ``S`` slots (the batch
dimension), each slot an independent ring buffer of ``C`` positions with
its OWN position row; a host-side slot map decides who lives where. Two
programs:

- :func:`slot_prefill`: write ONE admitted sequence's prompt K/V into
  one slot. Prompts are padded to power-of-two length buckets (masked
  positions, the real length passed on), so one variant serves every
  prompt length inside a bucket. It runs eagerly.
- :func:`slot_decode`: ONE decode step for the whole pool, whatever mix
  of live slots exists: per-slot absolute positions, per-slot ring write
  indices, per-slot temperature, sampling on the device. Dead slots
  compute garbage nobody reads (their writes land at ring index 0 with
  position -1, and admission resets the whole row), so mid-step
  admission and eviction never change the step's shapes. On the card
  :class:`DecodeEngine` captures it once as a CUDA graph (the JAX
  package's one compiled program) and replays it from static input
  buffers for tokens, positions, live flags and temperatures.

Attention is plain torch, as the JAX package computes it outside any
Pallas kernel (``rl/generation.py``); the cache is laid out
``[L, S, KVH, C, hd]`` (the JAX package's is ``[L, S, C, KVH, hd]``) so
each (slot, kv head) is one contiguous ``[C, hd]`` matrix. Weights are
cast to the compute dtype once, when the engine is built.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from dlrover_tpu_torch.device import resolve_device
from dlrover_tpu_torch.models.llama import LlamaConfig

# shared with the PPO decode backend, where they are defined: the ONE
# prompt-bucketing policy and the ONE decode-shape MoE mixture
from dlrover_tpu_torch.rl.generation import (  # noqa: F401 - re-exported
    MIN_PROMPT_BUCKET as MIN_BUCKET,
    bucket_len,
    decode_weights,
    finish_layer,
    grouped_attention,
    gumbel,
    logits_of,
    moe_mixture,
    project_qkv,
)


class SlotKVCache(NamedTuple):
    """``k``/``v`` are [L, S, KVH, C, hd]; ``pos`` is [S, C]: each slot's
    ring carries its OWN absolute positions (-1 = invalid). Updated in
    place."""

    k: torch.Tensor
    v: torch.Tensor
    pos: torch.Tensor  # [S, C] int32


def init_slot_cache(config: LlamaConfig, slots: int, capacity: int,
                    dtype=None, device=None) -> SlotKVCache:
    dtype = dtype or getattr(torch, config.dtype)
    device = resolve_device(device)
    shape = (config.n_layers, slots, config.n_kv_heads, capacity,
             config.head_dim)
    return SlotKVCache(
        k=torch.zeros(shape, dtype=dtype, device=device),
        v=torch.zeros(shape, dtype=dtype, device=device),
        pos=torch.full((slots, capacity), -1, dtype=torch.int32,
                       device=device),
    )


def _sample(logits, generator, temperature):
    """Greedy where temperature <= 0, else a Gumbel-max draw at the row's
    temperature. logits [N, V], temperature [N] -> (tok [N], logprob
    [N]); the logprob is ``log_softmax(logits)`` at the token."""
    safe_t = torch.where(temperature > 0, temperature, 1.0)
    noise = gumbel(logits.shape, generator, logits.device)
    drawn = torch.argmax(logits / safe_t[:, None] + noise, dim=-1)
    greedy = torch.argmax(logits, dim=-1)
    tok = torch.where(temperature > 0, drawn, greedy)
    logp = torch.log_softmax(logits, dim=-1)
    return tok, logp.gather(-1, tok[:, None])[:, 0]


# ------------------------------------------------------------------ prefill


def _prefill_forward(config: LlamaConfig, w, tokens, length: int,
                     cache: SlotKVCache | None = None, slot: int = 0):
    """The prompt forward of one bucket-padded prompt ``tokens`` [Pb];
    positions past ``length`` are -1 and never attended. With ``cache``,
    each layer's K/V goes to ``slot``'s ring indices 0..Pb-1. Returns
    the f32 logits [1, V] at ``length - 1``."""
    dtype = getattr(torch, config.dtype)
    (Pb,) = tokens.shape
    idx = torch.arange(Pb, device=tokens.device)
    positions = torch.where(idx < length, idx, -1)[None, :]    # [1, Pb]
    x = F.embedding(tokens[None, :], w["embed"]).to(dtype)     # [1, Pb, D]
    # self-attention over the prompt only: a freshly admitted slot owns
    # no other context, so prefill never reads the pool cache
    q_pos = positions[0]
    valid = (q_pos[None, :] >= 0) & (q_pos[None, :] <= q_pos[:, None])
    hdn = x
    for i, p in enumerate(w["layers"]):
        q, k, v = project_qkv(config, p, hdn, positions)
        kt, vt = k.transpose(1, 2), v.transpose(1, 2)          # [1, KVH, Pb, hd]
        attn = grouped_attention(q, kt, vt, valid[None])
        if cache is not None:
            cache.k[i, slot, :, :Pb] = kt[0]
            cache.v[i, slot, :, :Pb] = vt[0]
        hdn = finish_layer(config, p, hdn, attn, dtype)
    last = min(max(int(length) - 1, 0), Pb - 1)
    return logits_of(config, w, hdn[:, last])


@torch.no_grad()
def prefill_logits(config: LlamaConfig, params, cache: SlotKVCache, tokens,
                   length: int, slot: int):
    """:func:`slot_prefill` before its draw: the admission's cache writes
    and row reset, returning the f32 logits [1, V] it samples from."""
    w = decode_weights(config, params)
    C = cache.pos.shape[1]
    logits = _prefill_forward(config, w, tokens, length, cache, slot)
    # FULL row reset: whatever a previous occupant left at higher ring
    # indices becomes invalid the moment this admission lands
    row = torch.arange(C, device=tokens.device)
    cache.pos[slot] = torch.where(row < length, row, -1).to(torch.int32)
    return logits


@torch.no_grad()
def slot_prefill(config: LlamaConfig, params, cache: SlotKVCache, tokens,
                 length: int, slot: int, generator, temperature: float):
    """Admit one sequence: run the prompt forward, write its K/V into
    ``slot``'s ring, fully reset that slot's position row, and sample the
    first output token from ``generator``. ``tokens`` is [Pb] (one
    bucket-padded prompt, Pb <= C). Returns (cache, token, logprob)."""
    logits = prefill_logits(config, params, cache, tokens, length, slot)
    temp = torch.full((1,), float(temperature), device=tokens.device)
    tok, logp = _sample(logits, generator, temp)
    return cache, tok[0], logp[0]


# ------------------------------------------------------------------- decode


@torch.no_grad()
def decode_logits(config: LlamaConfig, params, cache: SlotKVCache, tokens,
                  positions, live):
    """:func:`slot_decode` before its draw: the step's cache writes,
    returning the f32 logits [S, V] it samples from."""
    w = decode_weights(config, params)
    dtype = getattr(torch, config.dtype)
    S = tokens.shape[0]
    C = cache.pos.shape[1]
    safe_pos = torch.where(live, positions, 0)
    write_idx = safe_pos % C
    rows = torch.arange(S, device=tokens.device)
    # a slot attends its own ring only: written, and causally visible
    # from ITS position (this very step's write included)
    cache.pos[rows, write_idx] = torch.where(live, positions, -1).to(
        torch.int32)
    valid = (cache.pos >= 0) & (cache.pos <= safe_pos[:, None])  # [S, C]
    pos2 = safe_pos[:, None]
    hdn = F.embedding(tokens[:, None], w["embed"]).to(dtype)     # [S, 1, D]
    for i, p in enumerate(w["layers"]):
        q, k, v = project_qkv(config, p, hdn, pos2)
        ck, cv = cache.k[i], cache.v[i]                          # [S, KVH, C, hd]
        ck[rows, :, write_idx] = k[:, 0]
        cv[rows, :, write_idx] = v[:, 0]
        attn = grouped_attention(q, ck, cv, valid[:, None])
        hdn = finish_layer(config, p, hdn, attn, dtype)
    return logits_of(config, w, hdn[:, 0])


@torch.no_grad()
def slot_decode(config: LlamaConfig, params, cache: SlotKVCache, tokens,
                positions, live, generator, temperature):
    """One token for every slot of the pool. ``tokens``/``positions``/
    ``live``/``temperature`` are [S]; each live slot consumes its token
    at its OWN absolute position and writes K/V at ``position % C`` of
    its own ring. Dead slots write at ring index 0 with position -1. No
    host sync and no data-dependent shape: the step is CUDA-graph
    capturable. Returns (cache, next_tokens [S], logprobs [S])."""
    logits = decode_logits(config, params, cache, tokens, positions, live)
    tok, logp = _sample(logits, generator, temperature)
    return cache, tok, logp


# ------------------------------------------------------------------- engine


class DecodeEngine:
    """Host handle over the slot programs: owns the device cache and the
    weights (cast once), hands the scheduler ``admit``/``step``.

    ``rng`` arguments are int seeds: each call seeds the engine's own
    device generator, so a draw is a function of (inputs, seed). On
    ``cuda`` the decode step is captured once as a CUDA graph (at
    :meth:`warmup`, or at the first step) and replayed; a failed capture
    raises. :meth:`step_eager` runs it eagerly (a named second
    measurement); on the CPU every step runs eagerly. Every call runs on
    the device and stream the engine was built on, so any thread may
    drive it (one at a time: the scheduler's single stepping thread)."""

    def __init__(self, config: LlamaConfig, params, slots: int = 8,
                 capacity: int = 128, min_bucket: int = MIN_BUCKET,
                 device=None):
        self.config = config
        self.device = resolve_device(device)
        self.weights = decode_weights(config, params, device=self.device)
        self.slots = int(slots)
        self.capacity = int(capacity)
        self.min_bucket = int(min_bucket)
        self.cache = init_slot_cache(config, self.slots, self.capacity,
                                     device=self.device)
        self.use_graph = self.device.type == "cuda"
        self._stream = (torch.cuda.current_stream(self.device)
                        if self.use_graph else None)
        self._gen = torch.Generator(device=self.device)
        S = self.slots
        self._static = {
            "tokens": torch.zeros(S, dtype=torch.long, device=self.device),
            "positions": torch.zeros(S, dtype=torch.long, device=self.device),
            "live": torch.zeros(S, dtype=torch.bool, device=self.device),
            "temperature": torch.zeros(S, dtype=torch.float32,
                                       device=self.device),
        }
        self._graph = None
        self._graph_out = None
        self._buckets: set = set()
        self._decoded = False

    # ------------------------------------------------------------ helpers

    def _on_device(self):
        """The engine's device and stream (a worker thread's default
        stream is not the one the graph was captured against)."""
        stack = contextlib.ExitStack()
        if self._stream is not None:
            stack.enter_context(torch.cuda.device(self.device))
            stack.enter_context(torch.cuda.stream(self._stream))
        stack.enter_context(torch.no_grad())
        return stack

    def bucket_for(self, n: int) -> int:
        return bucket_len(n, self.capacity, self.min_bucket)

    def _decode_eager(self):
        st = self._static
        _cache, tok, logp = slot_decode(
            self.config, self.weights, self.cache, st["tokens"],
            st["positions"], st["live"], self._gen, st["temperature"])
        return tok, logp

    def _ring0(self):
        """What a warm-up step over dead slots overwrites: every slot's
        ring index 0 and the position rows."""
        return (self.cache.k[:, :, :, 0].clone(),
                self.cache.v[:, :, :, 0].clone(), self.cache.pos.clone())

    def _restore_ring0(self, saved):
        k0, v0, pos = saved
        self.cache.k[:, :, :, 0] = k0
        self.cache.v[:, :, :, 0] = v0
        self.cache.pos.copy_(pos)

    def _capture(self):
        """Capture one decode step over the static buffers. One eager
        step first (on a side stream, as capture requires: it creates the
        cuBLAS handles and workspaces), whose writes are undone."""
        saved = self._ring0()
        side = torch.cuda.Stream(self.device)
        side.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(side):
            self._decode_eager()
        torch.cuda.current_stream(self.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        graph.register_generator_state(self._gen)
        with torch.cuda.graph(graph):
            out = self._decode_eager()
        self._restore_ring0(saved)
        self._graph, self._graph_out = graph, out

    def _seed(self, rng):
        self._gen.manual_seed(int(rng))

    # ------------------------------------------------------------ the API

    def admit(self, slot: int, prompt, rng, temperature: float):
        """Prefill ``prompt`` (a 1-D int sequence) into ``slot`` and
        sample its first token. Prompts longer than the ring keep their
        last ``capacity`` tokens (the sliding-window contract). Returns
        (token, logprob, prompt_len_used)."""
        with self._on_device():
            toks = torch.as_tensor(np.asarray(prompt, np.int64).reshape(-1))
            if toks.shape[0] > self.capacity:
                toks = toks[-self.capacity:]
            n = int(toks.shape[0])
            bucket = self.bucket_for(n)
            padded = torch.zeros(bucket, dtype=torch.long, device=self.device)
            padded[:n] = toks.to(self.device)
            self._buckets.add(bucket)
            self._seed(rng)
            _cache, tok, logp = slot_prefill(
                self.config, self.weights, self.cache, padded, n, int(slot),
                self._gen, float(temperature))
            return int(tok), float(logp), n

    def _load(self, tokens, positions, live, temperature):
        st = self._static
        st["tokens"].copy_(torch.as_tensor(np.asarray(tokens, np.int64)))
        st["positions"].copy_(torch.as_tensor(np.asarray(positions,
                                                         np.int64)))
        st["live"].copy_(torch.as_tensor(np.asarray(live, bool)))
        st["temperature"].copy_(torch.as_tensor(np.asarray(temperature,
                                                           np.float32)))

    def step(self, tokens, positions, live, rng, temperature):
        """One decode step over the whole pool (sequences of length
        ``slots``). Returns (next_tokens, logprobs) as numpy arrays."""
        with self._on_device():
            self._load(tokens, positions, live, temperature)
            if self.use_graph:
                if self._graph is None:
                    self._capture()
                self._seed(rng)
                self._graph.replay()
                tok, logp = self._graph_out
            else:
                self._seed(rng)
                tok, logp = self._decode_eager()
            self._decoded = True
            return tok.cpu().numpy(), logp.cpu().numpy()

    def step_eager(self, tokens, positions, live, rng, temperature):
        """:meth:`step` run eagerly whatever ``graph`` says: the named
        eager measurement, and the graph's reference."""
        with self._on_device():
            self._load(tokens, positions, live, temperature)
            self._seed(rng)
            tok, logp = self._decode_eager()
            return tok.cpu().numpy(), logp.cpu().numpy()

    def replay(self):
        """Replay the captured step on whatever the static buffers hold
        (timing only); the caller synchronises."""
        with self._on_device():
            self._graph.replay()

    def warmup(self, buckets=None):
        """Run the given prompt buckets (all power-of-two buckets up to
        capacity when None) and capture the decode step ahead of traffic,
        so the first admission's lease never waits on a capture. Leaves
        the pool's state as it was."""
        if buckets is None:
            buckets = []
            b = self.min_bucket
            while b < self.capacity:
                buckets.append(b)
                b <<= 1
            buckets.append(self.capacity)
        with self._on_device():
            for b in sorted({self.bucket_for(int(n)) for n in buckets}):
                # the forward alone: no cache write, no pool change
                _prefill_forward(self.config, self.weights,
                                 torch.zeros(b, dtype=torch.long,
                                             device=self.device), 1)
                self._buckets.add(b)
            self._static["live"].zero_()
            if self.use_graph:
                if self._graph is None:
                    self._capture()
            else:
                saved = self._ring0()
                self._decode_eager()
                self._restore_ring0(saved)
                self._decoded = True

    def prefill_traces(self) -> int:
        """Prefill buckets run (== distinct buckets seen): the JAX
        engine's compiled-prefill count."""
        return len(self._buckets)

    def decode_traces(self) -> int:
        """Decode programs: the captured graph on the card (1), the eager
        step's one pool shape on the CPU; 0 before any."""
        return int(self._graph is not None or self._decoded)
