"""PPO math: logprobs, KL penalty, GAE, clipped losses (port of
dlrover_tpu/rl/ppo_utils.py).

Everything is plain torch on [batch, time] tensors. GAE's backward
recursion, a reversed ``lax.scan`` in the JAX package, is a reversed
loop over time here.
"""

from __future__ import annotations

import torch

from dlrover_tpu_torch.ops.cross_entropy import softmax_cross_entropy


def logprobs_from_logits(logits, actions):
    """log pi(a_t | s_t) for the taken actions: [B, T], in f32 (the
    negated token-level CE: logsumexp minus the gathered logit, so bf16
    logits don't leak precision into the PPO importance ratios)."""
    loss, _valid = softmax_cross_entropy(logits, actions)
    return -loss


def kl_penalty(logprobs, ref_logprobs, kl_coef: float):
    """Per-token KL penalty against the frozen reference policy (the k1
    estimator logp - ref_logp)."""
    return -kl_coef * (logprobs - ref_logprobs)


def rewards_with_kl(scores, logprobs, ref_logprobs, mask,
                    kl_coef: float = 0.1):
    """Dense per-token reward = KL penalty everywhere + the scalar score
    on the last valid token. The last valid token is located
    positionally (last nonzero of the mask), not as ``sum(mask)-1``: LM
    masks are zero over the prompt prefix."""
    rewards = kl_penalty(logprobs, ref_logprobs, kl_coef) * mask
    T = mask.shape[-1]
    any_valid = mask.sum(-1) > 0
    # argmax takes the first maximal index, as jnp.argmax does
    last_rev = torch.argmax((mask.flip(-1) > 0).to(torch.int32), dim=-1)
    last = torch.where(any_valid, T - 1 - last_rev, 0)
    rows = torch.arange(rewards.shape[0], device=rewards.device)
    rewards = rewards.clone()
    rewards[rows, last] += scores * any_valid.to(rewards.dtype)
    return rewards


def whiten(x, mask=None, eps: float = 1e-8):
    """Zero-mean unit-variance (masked)."""
    if mask is None:
        mean = x.mean()
        var = x.var(unbiased=False)
    else:
        denom = mask.sum().clamp_min(1.0)
        mean = (x * mask).sum() / denom
        var = (((x - mean) ** 2) * mask).sum() / denom
    return (x - mean) * torch.rsqrt(var + eps)


def gae_advantages_and_returns(values, rewards, mask, gamma: float = 1.0,
                               lam: float = 0.95,
                               use_whitening: bool = True):
    """Generalized advantage estimation over the time axis.
    ``values``/``rewards``/``mask``: [B, T]. Returns (advantages,
    returns), both [B, T], with no gradient."""
    values, rewards, mask = values.detach(), rewards.detach(), mask.detach()
    zeros = torch.zeros_like(values[:, :1])
    next_values = torch.cat([values[:, 1:], zeros], dim=-1)
    # gate the bootstrap with the NEXT position's mask: the last valid
    # token must not bootstrap from the critic's value of padding
    next_mask = torch.cat([mask[:, 1:], zeros], dim=-1)
    deltas = (rewards + gamma * next_values * next_mask - values) * mask
    carry = torch.zeros_like(values[:, 0])
    adv = [None] * values.shape[-1]
    for t in reversed(range(values.shape[-1])):
        carry = deltas[:, t] + gamma * lam * carry * mask[:, t]
        adv[t] = carry
    advantages = torch.stack(adv, dim=-1)
    returns = advantages + values
    if use_whitening:
        advantages = whiten(advantages, mask)
    return advantages, returns


def ppo_loss(logprobs, values, old_logprobs, old_values, advantages,
             returns, mask, clip_ratio: float = 0.2,
             value_clip: float = 0.2, vf_coef: float = 0.5,
             entropy_coef: float = 0.0, logits=None):
    """Clipped PPO policy + value loss. Returns (total_loss,
    stats_dict)."""
    denom = mask.sum().clamp_min(1.0)
    ratio = torch.exp(logprobs - old_logprobs)
    pg1 = -advantages * ratio
    pg2 = -advantages * torch.clamp(ratio, 1.0 - clip_ratio,
                                    1.0 + clip_ratio)
    pg_loss = (torch.maximum(pg1, pg2) * mask).sum() / denom

    v_clipped = old_values + torch.clamp(values - old_values, -value_clip,
                                         value_clip)
    vf1 = (values - returns) ** 2
    vf2 = (v_clipped - returns) ** 2
    vf_loss = 0.5 * (torch.maximum(vf1, vf2) * mask).sum() / denom

    entropy = torch.zeros((), device=logprobs.device)
    if logits is not None and entropy_coef:
        logp = torch.log_softmax(logits.float(), dim=-1)
        ent_t = -(logp.exp() * logp).sum(-1)
        entropy = (ent_t * mask).sum() / denom

    total = pg_loss + vf_coef * vf_loss - entropy_coef * entropy
    stats = {
        "policy_loss": pg_loss,
        "value_loss": vf_loss,
        "entropy": entropy,
        "approx_kl": ((old_logprobs - logprobs) * mask).sum() / denom,
        "clip_frac": (((ratio - 1.0).abs() > clip_ratio) * mask).sum()
        / denom,
    }
    return total, stats
