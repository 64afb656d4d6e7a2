"""Token-level softmax cross-entropy, its vocab-parallel form and the
chunked fused linear cross-entropy (dlrover_tpu/ops/cross_entropy.py
``softmax_cross_entropy``, ``vocab_parallel_cross_entropy`` and
``fused_linear_cross_entropy``; plain torch there too: none is a Pallas
kernel in the JAX package, and the head product stays a
``torch.matmul``)."""

from __future__ import annotations

import torch

IGNORE_INDEX = -100  # labels that count for nothing


def softmax_cross_entropy(logits, labels, ignore_index: int = IGNORE_INDEX):
    """Token-level CE. logits [..., V] float, labels [...] int.

    Returns (per-token loss [...], valid mask [...]). Loss is 0 where
    ignored; caller averages by mask sum.
    """
    logits = logits.float()
    valid = labels != ignore_index
    safe_labels = torch.where(valid, labels, 0).long()
    lse = torch.logsumexp(logits, dim=-1)
    picked = torch.gather(logits, -1, safe_labels[..., None])[..., 0]
    loss = torch.where(valid, lse - picked, 0.0)
    return loss, valid


def vocab_parallel_cross_entropy(logits_shard, labels, shard, vocab_start,
                                 ignore_index: int = IGNORE_INDEX):
    """Token-level CE over logits split on the vocab dim over a mesh's
    ``tensor`` axis. ``logits_shard`` [..., V/t] are this rank's columns,
    the first of them global id ``vocab_start``; ``labels`` are global
    ids; ``shard`` is the mesh's ``parallel.shard_ops.ShardContext``.

    Two reductions over ``tensor``: the max (no gradient: the log-sum-exp
    does not depend on the shift), then the sum of the exponentials and
    the picked logit, whose backward is the identity on every rank (each
    tensor rank holds the same loss). Returns (per-token loss [...],
    valid mask [...]) as :func:`softmax_cross_entropy` does, the same on
    every tensor rank."""
    logits_shard = logits_shard.float()
    shard_v = logits_shard.shape[-1]
    valid = labels != ignore_index
    local = torch.where(valid, labels, 0).long() - vocab_start
    in_shard = (local >= 0) & (local < shard_v)
    global_max = shard.tensor_max(logits_shard.amax(dim=-1))
    sumexp = torch.exp(logits_shard - global_max[..., None]).sum(dim=-1)
    picked_local = torch.gather(
        logits_shard, -1, local.clamp(0, shard_v - 1)[..., None])[..., 0]
    both = shard.from_tensor(torch.stack(
        [sumexp, torch.where(in_shard, picked_local, 0.0)]))
    lse = global_max + torch.log(both[0])
    loss = torch.where(valid, lse - both[1], 0.0)
    return loss, valid


def _rms(x, scale, eps):
    """RMSNorm, expression for expression the model's ``_rms_norm`` (the
    chunked CE recomputes the model's final norm chunk by chunk)."""
    var = x.float().square().mean(dim=-1, keepdim=True)
    normed = x * torch.rsqrt(var + eps).to(x.dtype)
    return normed * scale.to(x.dtype)


def _chunks(S: int, n: int) -> list:
    """The row slices of the JAX package's ``n`` chunks of a sequence of
    ``S``: S padded to a multiple of n with ignore_index rows, cut into n
    equal chunks. The padding rows add nothing to the loss, its count or
    any gradient, so they are left out here rather than materialised; a
    chunk wholly of padding is no slice at all."""
    size = -(-S // n)
    return [slice(i, min(i + size, S)) for i in range(0, S, size)]


class _ChunkedCE(torch.autograd.Function):
    """``(loss_sum, valid_sum)`` of ``softmax(norm(h) @ w)`` chunk by
    chunk. The forward keeps only its inputs; the backward recomputes each
    chunk's logits, so one [B, S/n, V] f32 logits buffer lives at a time
    in either pass, and dw and d norm_scale accumulate in f32."""

    @staticmethod
    def forward(ctx, h, w, norm_scale, labels, n, ignore_index, eps):
        loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
        valid_sum = torch.zeros((), dtype=torch.int64, device=h.device)
        # a profiler row of its own (the backward has its autograd node's)
        with torch.profiler.record_function("_ChunkedCE.forward"):
            for sl in _chunks(h.shape[1], n):
                x = h[:, sl] if norm_scale is None else _rms(
                    h[:, sl], norm_scale, eps)
                loss, valid = softmax_cross_entropy(
                    (x @ w).float(), labels[:, sl], ignore_index)
                loss_sum += loss.sum()
                valid_sum += valid.sum()
        ctx.save_for_backward(h, w, norm_scale, labels)
        ctx.cfg = (n, ignore_index, eps)
        ctx.mark_non_differentiable(valid_sum)
        return loss_sum, valid_sum

    @staticmethod
    def backward(ctx, g_loss, _g_valid):
        h, w, norm_scale, labels = ctx.saved_tensors
        n, ignore_index, eps = ctx.cfg
        dh = torch.empty_like(h)
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dns = (None if norm_scale is None else
               torch.zeros(norm_scale.shape, dtype=torch.float32,
                           device=norm_scale.device))
        for sl in _chunks(h.shape[1], n):
            with torch.enable_grad():
                h_c = h[:, sl].detach().requires_grad_()
                ns = (None if norm_scale is None
                      else norm_scale.detach().requires_grad_())
                x = h_c if ns is None else _rms(h_c, ns, eps)
            lab = labels[:, sl]
            # d loss_sum / d logits = softmax - onehot(label) on valid
            # rows, 0 on ignored ones, times the cotangent of loss_sum:
            # the softmax in place in the one f32 buffer, its row sums
            # and the cotangent folded into one per-row factor
            logits = (x.detach() @ w).float()
            probs = logits.sub_(logits.amax(dim=-1, keepdim=True)).exp_()
            valid = lab != ignore_index
            g_row = (valid.to(probs.dtype) * g_loss)[..., None]
            probs.mul_(g_row / probs.sum(dim=-1, keepdim=True))
            safe = torch.where(valid, lab, 0).long()[..., None]
            probs.scatter_add_(-1, safe, -g_row)
            dlogits = probs.to(w.dtype)
            dx = dlogits @ w.t()
            dw += (x.detach().flatten(0, 1).t()
                   @ dlogits.flatten(0, 1)).float()
            if ns is None:
                dh[:, sl] = dx
            else:
                dh_c, dns_c = torch.autograd.grad(x, (h_c, ns), dx)
                dh[:, sl] = dh_c
                dns += dns_c.float()
        return (dh, dw.to(w.dtype),
                None if dns is None else dns.to(norm_scale.dtype),
                None, None, None, None)


def fused_linear_cross_entropy(
    h, w, labels, n_chunks: int = 8, norm_fn=None,
    ignore_index: int = IGNORE_INDEX, norm_scale=None,
    norm_eps: float = 1e-5,
):
    """CE of ``softmax(rms_norm(h, norm_scale) @ w)`` over [B, S, D]
    hidden states without materialising the full [B, S, V] logits.

    The sequence is processed in ``n_chunks`` chunks by a
    ``torch.autograd.Function``: the forward holds one [B, S/n, V] logits
    chunk at a time and saves only ``h``, ``w``, ``norm_scale`` and
    ``labels``; the backward recomputes each chunk's logits instead of
    storing them. Peak logits memory drops by ``n_chunks`` at the cost of
    one more head product. An ``S`` that ``n_chunks`` does not divide is
    padded as in the JAX package (its chunk boundaries, with ignore_index
    padding rows that add nothing). Without ``norm_scale`` the head
    multiplies ``h`` as it is.

    ``norm_fn=`` (the JAX package's legacy closure hook, which no caller
    of either package uses) is not ported and raises.

    Returns ``(loss_sum, valid_count)`` over all tokens, f32 and int64
    0-d tensors.
    """
    if norm_fn is not None:
        raise NotImplementedError(
            "fused_linear_cross_entropy(norm_fn=...) is the JAX package's "
            "legacy closure hook and is not ported: pass norm_scale= (the "
            "final RMSNorm's scale) and norm_eps=")
    n = max(1, min(int(n_chunks), h.shape[1]))
    return _ChunkedCE.apply(h, w, norm_scale, labels, n, int(ignore_index),
                            float(norm_eps))
