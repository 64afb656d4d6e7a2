"""Sequence (context) parallelism: ring attention (port of the ring half
of dlrover_tpu/parallel/sequence.py).

Each rank of the ``seq`` axis keeps its q shard resident while the k/v
shards travel around the ring; each visiting block is merged online, so
memory stays O(S_local^2) per block, and causality uses global positions,
so the result is single-device causal attention. q/k/v are
[batch, heads, len(ring.ranks) * seq_shard, head_dim]: the shards of the
ranks this process holds, in order (one shard with the process-group
transport, the whole sequence with the in-process one; parallel/mesh.py).

- Causal rings run :class:`_RingFlash`: each visible block through
  ``flash_ring_fwd`` (K12), merged as normalized (o, lse) pairs; the
  backward is a second ring through ``flash_ring_dq`` (K13) and
  ``flash_ring_dkv`` (K14) against the global lse and delta (from K2),
  with the f32 dk/dv rotating home with k/v. Blocks wholly in a shard's
  future are skipped (rank and tick are Python ints here).
- Non-causal rings run the einsum ring (plain torch through autograd, as
  in the JAX package, where it is no Pallas kernel either).

Ulysses (all-to-all over heads) is not ported yet (ROADMAP Queue 1 item
10).
"""

from __future__ import annotations

from typing import Optional

import torch

from dlrover_tpu_torch.ops.attention import (
    flash_attention,
    flash_bwd_preprocess,
    flash_ring_dkv,
    flash_ring_dq,
    flash_ring_fwd,
)
from dlrover_tpu_torch.parallel.mesh import get_mesh

__all__ = ["ring_attention", "sequence_sharded_attention"]


def _shards(t, parts: int):
    """The ``parts`` equal views of ``t`` along the sequence (dim 2)."""
    return t.split(t.shape[2] // parts, dim=2)


def _block_attn(q, k, v, sm_scale):
    """One (q shard x kv shard) block of the non-causal ring: the
    unnormalised f32 output and its row max and sum, GQA by grouping q
    heads against their kv head. Returns (o [b,h,sq,d], m [b,h,sq,1],
    l [b,h,sq,1])."""
    b, h, sq, d = q.shape
    kvh = k.shape[1]
    qg = q.reshape(b, kvh, h // kvh, sq, d).float()
    s = torch.einsum("bkgqd,bkld->bkgql", qg, k.float()) * sm_scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    o = torch.einsum("bkgql,bkld->bkgqd", p, v.float())
    return (o.reshape(b, h, sq, d), m.reshape(b, h, sq, 1),
            l.reshape(b, h, sq, 1))


def _einsum_ring(q, k, v, ring, sm_scale):
    """The non-causal ring of :func:`_block_attn` blocks with a running
    (o, m, l), differentiable through autograd."""
    held = ring.ranks
    qs = _shards(q, len(held))
    kv = [[a, b] for a, b in zip(_shards(k, len(held)),
                                 _shards(v, len(held)))]
    acc = [None] * len(held)
    for t in range(ring.size):
        if t:
            kv = ring.shift(kv)
        for i in range(len(held)):
            o_blk, m_blk, l_blk = _block_attn(qs[i], *kv[i], sm_scale)
            if acc[i] is None:
                acc[i] = (o_blk, m_blk, l_blk)
                continue
            o_acc, m_acc, l_acc = acc[i]
            m_new = torch.maximum(m_acc, m_blk)
            alpha, beta = torch.exp(m_acc - m_new), torch.exp(m_blk - m_new)
            acc[i] = (o_acc * alpha + o_blk * beta, m_new,
                      l_acc * alpha + l_blk * beta)
    return torch.cat([(o / l).to(q.dtype) for o, _, l in acc], dim=2)


def _merge_block(o_acc, lse_acc, o_blk, lse_blk):
    """Merge a normalized block (o_blk in the model dtype, lse_blk) into
    the running f32 (o, lse): the JAX ring's merge, in f32, written with
    logaddexp in a third of its operations (the ring is host-bound). A
    row that has seen no key keeps o = 0 and lse = -1e30: in f32 the
    logaddexp of two -1e30 is -1e30, and both weights are then 1."""
    lse = torch.logaddexp(lse_acc, lse_blk)
    w_acc = torch.exp(lse_acc - lse).unsqueeze(-1)
    w_blk = torch.exp(lse_blk - lse).unsqueeze(-1)
    return torch.addcmul(o_acc * w_acc, o_blk, w_blk), lse


class _RingFlash(torch.autograd.Function):
    """The causal ring on the ring-block kernels (K12-K14, and K2)."""

    @staticmethod
    def forward(ctx, q, k, v, ring, sm_scale):
        n, held = ring.size, ring.ranks
        qs = _shards(q, len(held))
        kv = [[a, b] for a, b in zip(_shards(k, len(held)),
                                     _shards(v, len(held)))]
        sq, sk = qs[0].shape[2], kv[0][0].shape[2]
        acc = [None] * len(held)
        for t in range(n):
            if t:
                kv = ring.shift(kv)
            for i, r in enumerate(held):
                c = (r - t) % n
                if c > r:  # wholly in the future of this q shard
                    continue
                o_blk, lse_blk = flash_ring_fwd(qs[i], *kv[i], r * sq, c * sk,
                                                sm_scale)
                # tick 0 is the diagonal, visible to every shard: merging
                # it into the empty pair would give it back unchanged
                acc[i] = ((o_blk.float(), lse_blk) if acc[i] is None
                          else _merge_block(*acc[i], o_blk, lse_blk))
        o = torch.cat([a[0] for a in acc], dim=2).to(q.dtype)
        lse = torch.cat([a[1] for a in acc], dim=2)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.ring, ctx.sm_scale = ring, sm_scale
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring, sm_scale = ctx.ring, ctx.sm_scale
        n, held = ring.size, ring.ranks
        qs, dos = _shards(q, len(held)), _shards(do, len(held))
        # contiguous once here, not in each of the rank's kernel launches
        lses = [t.contiguous() for t in _shards(lse, len(held))]
        deltas = [flash_bwd_preprocess(d, o_i)
                  for d, o_i in zip(dos, _shards(o, len(held)))]
        # per held rank: the visiting k, v and their f32 dk, dv so far
        state = [[a, b, None, None] for a, b in zip(_shards(k, len(held)),
                                                    _shards(v, len(held)))]
        sq, sk = qs[0].shape[2], state[0][0].shape[2]
        dq = [None] * len(held)
        for t in range(n):
            if t:
                state = ring.shift(state)
            for i, r in enumerate(held):
                c = (r - t) % n
                if c > r:
                    continue
                k_c, v_c, dk, dv = state[i]
                args = (qs[i], k_c, v_c, dos[i], lses[i], deltas[i], r * sq,
                        c * sk, sm_scale)
                dq_b = flash_ring_dq(*args)
                dk_b, dv_b = flash_ring_dkv(*args)
                # tick 0 (the diagonal) starts every accumulator
                dq[i] = dq_b if dq[i] is None else dq[i].add_(dq_b)
                state[i] = [k_c, v_c, dk_b if dk is None else dk.add_(dk_b),
                            dv_b if dv is None else dv.add_(dv_b)]
        # n - 1 hops so far: one more brings each shard's dk/dv home
        home = ring.shift([s[2:] for s in state])
        return (torch.cat(dq, dim=2).to(q.dtype),
                torch.cat([h[0] for h in home], dim=2).to(k.dtype),
                torch.cat([h[1] for h in home], dim=2).to(v.dtype), None, None)


def ring_attention(q, k, v, mesh=None, causal: bool = True,
                   sm_scale: Optional[float] = None):
    """Ring attention over the ``seq`` axis of ``mesh`` (default: the
    active mesh): causal rings on the ring-block kernels, non-causal ones
    on the einsum ring.

    Args:
      q: [batch, heads, seq_local, head_dim], the held ranks' q shards.
      k, v: [batch, kv_heads, seq_local, head_dim]; heads % kv_heads == 0.
    Returns the attention output, same shape and dtype as q.
    """
    mesh = mesh or get_mesh()
    n = mesh.shape.get("seq", 1)
    if sm_scale is None:
        sm_scale = q.shape[-1] ** -0.5
    if n == 1:
        if causal:
            return flash_attention(q, k, v, causal=True, sm_scale=sm_scale)
        o, _, l = _block_attn(q, k, v, sm_scale)
        return (o / l).to(q.dtype)
    ring = mesh.ring
    held = len(ring.ranks)
    for t in (q, k, v):
        if t.shape[2] % held:
            raise ValueError(
                f"a seq axis of {n} ranks ({held} in this process) does "
                f"not divide the sequence of {t.shape[2]}")
    if causal:
        return _RingFlash.apply(q, k, v, ring, float(sm_scale))
    return _einsum_ring(q, k, v, ring, float(sm_scale))


def sequence_sharded_attention(q, k, v, mesh=None, impl: str = "ring",
                               causal: bool = True,
                               sm_scale: Optional[float] = None):
    """Attention over the sequence shards of ``mesh``'s seq axis (default:
    the active mesh), [batch, heads, seq_local, head_dim] as in
    :func:`ring_attention`. ``impl="ring"`` runs :func:`ring_attention`;
    ``"ulysses"`` is not ported yet."""
    if impl == "ulysses":
        raise NotImplementedError(
            "impl='ulysses' (all-to-all over heads) is not ported yet "
            "(ROADMAP Queue 1 item 10)")
    if impl != "ring":
        raise ValueError(f"unknown sequence-parallel impl {impl!r}")
    return ring_attention(q, k, v, mesh=mesh, causal=causal,
                          sm_scale=sm_scale)
