"""A2C on the vectorized bidding environment.

Replacement for the reference's ``sem_a2c_config`` (RLlib
A2CConfig, adcraft/experiment_utils/agent_configs.py:74-89): gamma=0.99,
lambda=0.99, lr=1e-3, grad_clip=1.0, vf_coeff=0.5, entropy_coeff=0.01,
[256, 256] relu nets. Instead of 23 workers x 2 envs, the env batch is an
array axis of the fused step.

A2C is a single-epoch advantage actor-critic: one GAE pass over the
rollout, one gradient step on the whole batch — no ratio clipping, no
minibatch reuse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax

from adcraft_tpu.agents.ppo import (
    PPOConfig,
    PPOTrainer,
)
from adcraft_tpu.config import EnvConfig
from adcraft_tpu.quantiles import QuantileTable

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class A2CConfig:
    """Hyper-parameters (defaults per agent_configs.py:74-89)."""

    gamma: float = 0.99
    gae_lambda: float = 0.99
    lr: float = 1e-3
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.01
    rollout_days: int = 16
    max_grad_norm: float = 1.0
    hidden: Tuple[int, int] = (256, 256)


class A2CTrainer(PPOTrainer):
    """A2C as a PPO specialization: single epoch, single minibatch, no
    clipping (ratio == 1 on fresh data makes the clipped surrogate reduce
    to vanilla policy gradient), entropy bonus on."""

    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        a2c_cfg: A2CConfig = A2CConfig(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
    ):
        ppo_cfg = PPOConfig(
            gamma=a2c_cfg.gamma,
            gae_lambda=a2c_cfg.gae_lambda,
            lr=a2c_cfg.lr,
            clip_eps=1e9,  # effectively unclipped
            vf_coeff=a2c_cfg.vf_coeff,
            entropy_coeff=a2c_cfg.entropy_coeff,
            rollout_days=a2c_cfg.rollout_days,
            num_minibatches=1,
            num_epochs=1,
            max_grad_norm=a2c_cfg.max_grad_norm,
            hidden=a2c_cfg.hidden,
        )
        super().__init__(
            env_cfg, num_envs, ppo_cfg, table=table, no_vol_prob=no_vol_prob
        )
