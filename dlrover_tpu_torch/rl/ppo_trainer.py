"""RLTrainer / PPOTrainer / LMPPOTrainer: the experience -> update RLHF
loop (port of dlrover_tpu/rl/ppo_trainer.py).

Experience generation runs the roles' forwards without gradient; the
PPO update is one autograd pass over actor and critic (both losses in
one graph, as the JAX package differentiates one loss in both), then
each role's optimizer step. Random draws are seeds from a
``torch.Generator`` seeded with ``rng_seed`` (the JAX trainer splits a
key), so sampled actions differ from the JAX package's; at temperature 0
an LM rollout is greedy and equal.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dlrover_tpu_torch.common.log import get_logger
from dlrover_tpu_torch.rl.generation import generator_for, gumbel
from dlrover_tpu_torch.rl.model_engine import ModelEngine
from dlrover_tpu_torch.rl.ppo_utils import (
    gae_advantages_and_returns,
    logprobs_from_logits,
    ppo_loss,
    rewards_with_kl,
)
from dlrover_tpu_torch.rl.replay_buffer import ReplayBuffer

logger = get_logger(__name__)


@dataclasses.dataclass
class PPOConfig:
    kl_coef: float = 0.1
    gamma: float = 1.0
    lam: float = 0.95
    clip_ratio: float = 0.2
    value_clip: float = 0.2
    vf_coef: float = 0.5
    entropy_coef: float = 0.0
    ppo_epochs: int = 4
    train_batch_size: int = 8
    whiten_advantages: bool = True


class RLTrainer:
    """Loop skeleton: subclasses implement make_experience + rl_training;
    train() alternates them."""

    def __init__(self, engine: ModelEngine, config):
        self.engine = engine
        self.config = config
        self.buffer = ReplayBuffer()

    def make_experience(self, prompts):
        raise NotImplementedError

    def rl_training(self):
        raise NotImplementedError

    def train(self, prompt_batches, iterations: int = 1):
        stats = {}
        for it in range(iterations):
            for prompts in prompt_batches:
                self.buffer.reset()
                self.make_experience(prompts)
                stats = self.rl_training()
            logger.info("rl iteration %d: %s", it, {
                k: round(float(v), 5) for k, v in stats.items()})
        return stats


def _numpy(t) -> np.ndarray:
    return t.detach().cpu().numpy()


class PPOTrainer(RLTrainer):
    """PPO over an actor/critic/ref(/reward) ModelEngine.

    Model contracts (all [B, T] time-major batches):
    - actor apply(params, obs) -> logits [B, T, A]
    - critic apply(params, obs) -> values [B, T]
    - reward: either a ModelEngine "reward" model mapping obs -> scalar
      scores [B], or a ``score_fn(obs, actions)`` passed in.
    """

    def __init__(self, engine: ModelEngine, config: PPOConfig,
                 score_fn=None, rng_seed: int = 0):
        super().__init__(engine, config)
        self._score_fn = score_fn
        self._rng = torch.Generator().manual_seed(int(rng_seed))
        self._update = self._build_update()

    # -------------------------------------------------------- experience

    def _next_rng(self) -> int:
        return int(torch.randint(0, 2 ** 62, (), generator=self._rng))

    def _tensor(self, x):
        if isinstance(x, torch.Tensor):
            return x.to(self.engine.device)
        return torch.as_tensor(np.asarray(x), device=self.engine.device)

    def _store(self, scores, obs, actions, logprobs, ref_logprobs, values,
               mask):
        """Rewards, GAE (whitened over the FULL rollout, once here, not
        per microbatch) and the buffer's samples; returns the mean
        score."""
        rewards = rewards_with_kl(scores, logprobs, ref_logprobs, mask,
                                  self.config.kl_coef)
        advantages, returns = gae_advantages_and_returns(
            values, rewards, mask, self.config.gamma, self.config.lam,
            self.config.whiten_advantages)
        self.buffer.add_samples({
            "obs": _numpy(obs),
            "actions": _numpy(actions),
            "old_logprobs": _numpy(logprobs),
            "old_values": _numpy(values),
            "advantages": _numpy(advantages),
            "returns": _numpy(returns),
            "mask": _numpy(mask),
        })
        return float(scores.float().mean())

    def _scores(self, *args):
        if self._score_fn is not None:
            return self._tensor(self._score_fn(*args)).float()
        if "reward" in self.engine.specs:
            return self.engine.apply("reward", *args).float()
        raise ValueError("need a reward model or score_fn")

    def make_experience(self, prompts):
        """Roll the actor over ``prompts`` (obs [B, T, ...]): sample
        actions, score them, store (obs, actions, logprobs, values,
        advantages, returns, mask)."""
        obs = self._tensor(prompts["obs"])
        mask = self._tensor(prompts.get(
            "mask", np.ones(obs.shape[:2], np.float32)))
        logits = self.engine.apply("actor", obs)
        gen = generator_for(self._next_rng(), logits.device)
        actions = torch.argmax(
            logits.float() + gumbel(logits.shape, gen, logits.device), -1)
        logprobs = logprobs_from_logits(logits, actions)
        ref_logits = (self.engine.apply("ref", obs)
                      if "ref" in self.engine.specs else logits)
        ref_logprobs = logprobs_from_logits(ref_logits, actions)
        values = self.engine.apply("critic", obs)
        scores = self._scores(obs, actions)
        return self._store(scores, obs, actions, logprobs, ref_logprobs,
                           values, mask)

    # ------------------------------------------------------------ update

    def _build_update(self):
        cfg = self.config
        actor_spec = self.engine.specs["actor"]
        critic_spec = self.engine.specs["critic"]

        def update(batch):
            """One step: the loss over both roles, one backward, each
            role's optimizer step. The stats are the pre-step params'."""
            actor_opt = self.engine.optimizer("actor")
            critic_opt = self.engine.optimizer("critic")
            actor_opt.zero_grad(set_to_none=True)
            critic_opt.zero_grad(set_to_none=True)
            with torch.enable_grad():
                logits = actor_spec.apply_fn(self.engine.params["actor"],
                                             batch["obs"])
                values = critic_spec.apply_fn(self.engine.params["critic"],
                                              batch["obs"])
                logprobs = logprobs_from_logits(logits, batch["actions"])
                total, stats = ppo_loss(
                    logprobs, values, batch["old_logprobs"],
                    batch["old_values"], batch["advantages"],
                    batch["returns"], batch["mask"], cfg.clip_ratio,
                    cfg.value_clip, cfg.vf_coef, cfg.entropy_coef,
                    logits=logits)
                total.backward()
            actor_opt.step()
            critic_opt.step()
            return {k: v.detach() for k, v in stats.items()}

        return update

    def rl_training(self):
        cfg = self.config
        stats = {}
        batch_size = cfg.train_batch_size
        if len(self.buffer) < batch_size:
            if len(self.buffer) == 0:
                logger.warning("rl_training with an empty buffer")
                return stats
            logger.warning(
                "buffer has %d samples < train_batch_size %d; shrinking "
                "the batch so the update still runs", len(self.buffer),
                batch_size)
            batch_size = len(self.buffer)
        for epoch in range(cfg.ppo_epochs):
            for batch in self.buffer.batches(batch_size, seed=epoch):
                stats = self._update({k: self._tensor(v)
                                      for k, v in batch.items()})
        return stats


class LMPPOTrainer(PPOTrainer):
    """PPO for language-model RLHF: experience comes from the KV-cache
    generation backend instead of a single full forward over pre-built
    obs.

    Contracts: actor/ref apply(params, tokens [B,T]) -> logits [B,T,V];
    critic apply -> values [B,T]; ``score_fn(sequences [B, P+N],
    gen_mask [B, N]) -> scores [B]`` judges the full generated text.
    """

    def __init__(self, engine: ModelEngine, config: PPOConfig,
                 llama_config, score_fn, gen=None, rng_seed: int = 0):
        from dlrover_tpu_torch.rl.generation import KVCacheGenerationBackend

        super().__init__(engine, config, score_fn=score_fn,
                         rng_seed=rng_seed)
        self.backend = KVCacheGenerationBackend(llama_config, gen,
                                                device=engine.device)

    def make_experience(self, prompts):
        """prompts: {"tokens": [B, P] int}. Rolls out continuations with
        the incremental decoder, then scores the sequences with ONE
        teacher-forced forward per model."""
        tokens = self._tensor(prompts["tokens"])
        B, P = tokens.shape
        res = self.backend.generate(self.engine.params["actor"], tokens,
                                    self._next_rng())
        seq = res.sequences                      # [B, P+N]
        obs, targets = seq[:, :-1], seq[:, 1:]   # next-token pairs
        # mask: only generated positions train (obs index P-1 predicts
        # the first generated token), and only while un-terminated
        T = obs.shape[1]
        mask = torch.zeros((B, T), device=tokens.device)
        mask[:, P - 1:] = res.mask

        logits = self.engine.apply("actor", obs)
        logprobs = logprobs_from_logits(logits, targets)
        ref_logits = (self.engine.apply("ref", obs)
                      if "ref" in self.engine.specs else logits)
        ref_logprobs = logprobs_from_logits(ref_logits, targets)
        values = self.engine.apply("critic", obs)
        scores = self._scores(seq, res.mask)
        return self._store(scores, obs, targets, logprobs, ref_logprobs,
                           values, mask)
