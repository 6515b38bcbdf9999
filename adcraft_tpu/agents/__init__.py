"""Learning agents (plain JAX + optax) — the replacement for the
reference's Ray RLlib integration (adcraft/experiment_utils/agent_configs.py,
adcraft/RL/train_agent.ipynb)."""
