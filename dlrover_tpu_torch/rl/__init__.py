"""The RL (PPO) stack of the PyTorch port (port of dlrover_tpu/rl): PPO
math, the replay buffer, the role engine, the trainers and the KV-cache
generation backend (:mod:`generation`)."""

from dlrover_tpu_torch.rl.ppo_utils import (
    gae_advantages_and_returns,
    kl_penalty,
    logprobs_from_logits,
    ppo_loss,
    rewards_with_kl,
    whiten,
)
from dlrover_tpu_torch.rl.replay_buffer import ReplayBuffer
from dlrover_tpu_torch.rl.model_engine import ModelEngine, ModelSpec
from dlrover_tpu_torch.rl.ppo_trainer import (
    LMPPOTrainer,
    PPOConfig,
    PPOTrainer,
    RLTrainer,
)

__all__ = [
    "gae_advantages_and_returns",
    "kl_penalty",
    "logprobs_from_logits",
    "ppo_loss",
    "rewards_with_kl",
    "whiten",
    "ReplayBuffer",
    "ModelEngine",
    "ModelSpec",
    "PPOConfig",
    "LMPPOTrainer",
    "PPOTrainer",
    "RLTrainer",
]
