"""adcraft-tpu: SEM keyword-auction bidding benchmark in JAX.

A from-scratch JAX/XLA rewrite of the AdCraft reinforcement-learning
benchmark for Search Engine Marketing (SEM) keyword auction bidding
(reference: Mikata-Project/adcraft). The simulation core is a single fused,
jit-compiled step function over stateless PRNG keys, vmappable over thousands
of environment instances and shardable across the GPUs of a host.

Public API (mirrors the reference package surface, reference README.md:61-95):

- ``BiddingSimulation`` — Gymnasium single-env adapter
  (reference: adcraft/gymnasium_kw_env.py:22).
- ``VectorBiddingEnv`` — batched, jitted vector env (the main entry point).
- ``EnvConfig`` / functional ``reset`` / ``step`` — pure functional core.
- ``FlatArrayWrapper`` — flat Box adapter (reference: adcraft/wrappers/flat_array.py).
- ``metrics`` — AKNCP / NCP and oracle curves
  (reference: adcraft/experiment_utils/experiment_metrics.py).
- ``baselines`` — interpolation / zero-margin agents
  (reference: adcraft/baselines/interpolated_expectations.py).
- ``agents.ppo`` — plain-JAX/optax PPO learner (replaces RLlib configs,
  reference: adcraft/experiment_utils/agent_configs.py).

The Gymnasium adapter (``BiddingSimulation``, ``bidding_sim_creator``,
``FlatArrayWrapper``) loads on first access, so the env core, the agents
and the mesh code import without gymnasium installed.
"""

from adcraft_tpu.version import __version__
from adcraft_tpu.config import (
    EnvConfig,
    CostModel,
    CompetitorModel,
    KeywordKind,
    UpdaterConfig,
)
from adcraft_tpu.env import (
    EnvState,
    TimeStep,
    env_reset,
    env_step,
    VectorBiddingEnv,
)

_LAZY = {
    "BiddingSimulation": "adcraft_tpu.gym_env",
    "bidding_sim_creator": "adcraft_tpu.gym_env",
    "FlatArrayWrapper": "adcraft_tpu.wrappers",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(f"module 'adcraft_tpu' has no attribute {name!r}")


__all__ = [
    "__version__",
    "EnvConfig",
    "CostModel",
    "CompetitorModel",
    "KeywordKind",
    "UpdaterConfig",
    "EnvState",
    "TimeStep",
    "env_reset",
    "env_step",
    "VectorBiddingEnv",
    "BiddingSimulation",
    "bidding_sim_creator",
    "FlatArrayWrapper",
]
