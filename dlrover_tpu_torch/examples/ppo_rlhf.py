"""PPO (RLHF-style) on the PyTorch port: the twin of
examples/ppo_rlhf.py, with the same arguments and the same loop.

Actor, critic and a frozen reference over the ModelEngine, experience
generation + PPO update on a contextual bandit whose rewarded action is
one-hot in the observation. The "reward model" is programmatic; swap in
a learned model by registering a trainable "reward" ModelSpec.

    python -m dlrover_tpu_torch.examples.ppo_rlhf --iterations 20

Runs on ``cuda``; ``main([...], device="cpu")`` runs it on the CPU.
Prints the mean score every 5 iterations and the final one, and returns
the final mean score.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def main(argv=None, device=None) -> float:
    p = argparse.ArgumentParser("ppo_rlhf")
    p.add_argument("--iterations", type=int, default=20)
    p.add_argument("--batch", type=int, default=32)
    p.add_argument("--horizon", type=int, default=4)
    args = p.parse_args(argv)

    from dlrover_tpu_torch import trainer as torch_trainer
    from dlrover_tpu_torch.device import resolve_device

    device = resolve_device(device)
    torch_trainer.init_distributed(device)

    from dlrover_tpu_torch.rl import (
        ModelEngine,
        ModelSpec,
        PPOConfig,
        PPOTrainer,
    )

    n_actions, obs_dim, hidden = 4, 8, 64

    def actor_init(seed):
        g = torch.Generator().manual_seed(seed)
        return {
            "w1": torch.randn(obs_dim, hidden, generator=g) * 0.1,
            "w2": torch.randn(hidden, n_actions, generator=g) * 0.1,
        }

    def actor_apply(params, obs):
        return torch.tanh(obs @ params["w1"]) @ params["w2"]

    def critic_init(seed):
        g = torch.Generator().manual_seed(seed)
        return {"w": torch.randn(obs_dim, 1, generator=g) * 0.1}

    def critic_apply(params, obs):
        return (obs @ params["w"]).squeeze(-1)

    def adam(params):
        return torch.optim.Adam(params.values(), lr=3e-3)

    engine = ModelEngine({
        "actor": ModelSpec(actor_init, actor_apply, trainable=True,
                           optimizer=adam),
        "critic": ModelSpec(critic_init, critic_apply, trainable=True,
                            optimizer=adam),
        "ref": ModelSpec(actor_init, actor_apply),
    }, device=device)
    engine.sync_ref_from_actor()

    def score_fn(obs, actions):
        target = torch.argmax(obs[..., :n_actions], dim=-1)
        return (actions == target).float().mean(-1)

    trainer = PPOTrainer(
        engine,
        PPOConfig(ppo_epochs=4, train_batch_size=16, kl_coef=0.02),
        score_fn=score_fn,
    )
    rs = np.random.RandomState(0)

    def prompts():
        obs = np.zeros((args.batch, args.horizon, obs_dim), np.float32)
        idx = rs.randint(0, n_actions, size=(args.batch, args.horizon))
        for b in range(args.batch):
            for t in range(args.horizon):
                obs[b, t, idx[b, t]] = 1.0
        return {"obs": obs}

    for it in range(args.iterations):
        trainer.buffer.reset()
        mean_score = trainer.make_experience(prompts())
        stats = trainer.rl_training()
        if (it + 1) % 5 == 0:
            print(f"iter {it+1}: score={mean_score:.3f} "
                  f"kl={float(stats['approx_kl']):.4f}")
    final = trainer.make_experience(prompts())
    print(f"final mean score: {final:.3f}")
    return final


if __name__ == "__main__":
    main()
