"""PPO on the vectorized bidding environment.

Replacement for the reference's RLlib PPO integration
(``sem_ppo_config``, adcraft/experiment_utils/agent_configs.py:56-71).
Defaults mirror that config where it makes sense: gamma=0.995,
lambda=0.95, lr=1e-4, clip=0.5, [32,32] relu nets, 2048-step train
batches. Instead of 46 env actors on a worker, envs are a batch axis of
the fused step; the whole (rollout -> GAE -> minibatch SGD) train step is
one jitted function, shardable over a device mesh on the env axis with
XLA inserting the gradient psums (see adcraft_tpu.parallel).
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from adcraft_tpu.agents.networks import GaussianPolicy, ValueNet, flatten_obs
from adcraft_tpu.config import EnvConfig
from adcraft_tpu.env import EnvState, env_reset, env_step
from adcraft_tpu.quantiles import QuantileTable

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class PPOConfig:
    """Hyper-parameters (defaults per agent_configs.py:56-71)."""

    gamma: float = 0.995
    gae_lambda: float = 0.95
    lr: float = 1e-4
    clip_eps: float = 0.5
    vf_coeff: float = 0.5
    entropy_coeff: float = 0.0
    rollout_days: int = 16
    num_minibatches: int = 4
    num_epochs: int = 4
    max_grad_norm: float = 0.5
    hidden: Tuple[int, int] = (32, 32)


class TrainState(NamedTuple):
    params: dict
    opt_state: optax.OptState
    env_state: EnvState  # batched (E, ...)
    last_obs: Array  # (E, obs_dim) — flattened current observation
    key: Array
    step: Array


class Transition(NamedTuple):
    obs: Array
    raw_action: Array
    log_prob: Array
    value: Array
    reward: Array
    done: Array


def _gaussian_log_prob(raw: Array, mean: Array, log_std: Array) -> Array:
    var = jnp.exp(2 * log_std)
    return jnp.sum(
        -0.5 * ((raw - mean) ** 2 / var + 2 * log_std + jnp.log(2 * jnp.pi)),
        axis=-1,
    )


class PPOTrainer:
    """Build once per (EnvConfig, num_envs); drives jitted train steps."""

    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        ppo_cfg: PPOConfig = PPOConfig(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
    ):
        self.env_cfg = env_cfg
        self.num_envs = num_envs
        self.cfg = ppo_cfg
        self.table = table
        self.no_vol_prob = no_vol_prob
        self.policy = GaussianPolicy(env_cfg.num_keywords, hidden=ppo_cfg.hidden)
        self.value = ValueNet(hidden=ppo_cfg.hidden)
        self.obs_dim = 5 * env_cfg.num_keywords + 2
        self.tx = optax.chain(
            optax.clip_by_global_norm(ppo_cfg.max_grad_norm),
            optax.adam(ppo_cfg.lr),
        )
        self._jit_train_step = jax.jit(self.train_step)

    # -- initialization --------------------------------------------------

    def init(self, key: Array) -> TrainState:
        k_pol, k_val, k_env, k_state = jax.random.split(key, 4)
        dummy = jnp.zeros((self.obs_dim,))
        params = {
            "policy": self.policy.init(k_pol, dummy),
            "value": self.value.init(k_val, dummy),
        }
        env_keys = jax.random.split(k_env, self.num_envs)
        env_state, obs0 = jax.vmap(
            lambda k: env_reset(
                self.env_cfg, k, table=self.table, no_vol_prob=self.no_vol_prob
            )
        )(env_keys)
        return TrainState(
            params=params,
            opt_state=self.tx.init(params),
            env_state=env_state,
            last_obs=flatten_obs(obs0),
            key=k_state,
            step=jnp.asarray(0, jnp.int32),
        )

    # -- acting ----------------------------------------------------------

    def _policy_step(self, params, env_state, obs_flat, key):
        """Sample an action batch and step every env one day."""
        mean, log_std = self.policy.apply(params["policy"], obs_flat)
        raw = mean + jnp.exp(log_std) * jax.random.normal(key, mean.shape)
        log_prob = _gaussian_log_prob(raw, mean, log_std)
        value = self.value.apply(params["value"], obs_flat)
        bids, budget = self.policy.squash(raw)
        new_env_state, ts = jax.vmap(
            lambda s, b, bud: env_step(self.env_cfg, s, b, bud)
        )(env_state, bids, budget)
        return new_env_state, ts, raw, log_prob, value

    def _auto_reset(self, env_state: EnvState, obs_flat: Array, done: Array, key: Array):
        """Reset finished envs in-place (keywords resampled per env)."""
        reset_keys = jax.random.split(key, self.num_envs)
        fresh, fresh_obs = jax.vmap(
            lambda k: env_reset(
                self.env_cfg, k, table=self.table, no_vol_prob=self.no_vol_prob
            )
        )(reset_keys)

        def pick(a, b):
            d = done.reshape(done.shape + (1,) * (a.ndim - 1))
            return jnp.where(d, a, b)

        new_state = jax.tree.map(pick, fresh, env_state)
        new_obs = pick(flatten_obs(fresh_obs), obs_flat)
        return new_state, new_obs

    # -- rollout ---------------------------------------------------------

    def rollout(self, state: TrainState):
        """Collect cfg.rollout_days of experience from every env."""

        def body(carry, _):
            env_state, obs_flat, key = carry
            key, k_act, k_reset = jax.random.split(key, 3)
            new_env, ts, raw, log_prob, value = self._policy_step(
                state.params, env_state, obs_flat, k_act
            )
            done = ts.terminated | ts.truncated
            new_env, next_obs = self._auto_reset(
                new_env, flatten_obs(ts.obs), done, k_reset
            )
            tr = Transition(
                obs=obs_flat,
                raw_action=raw,
                log_prob=log_prob,
                value=value,
                reward=ts.reward,
                done=done,
            )
            return (new_env, next_obs, key), tr

        (env_state, last_obs, key), traj = jax.lax.scan(
            body,
            (state.env_state, state.last_obs, state.key),
            None,
            length=self.cfg.rollout_days,
        )
        return env_state, last_obs, key, traj

    # -- objective -------------------------------------------------------

    def _gae(self, traj: Transition, last_value: Array):
        cfg = self.cfg

        def body(carry, tr):
            next_value, next_adv = carry
            not_done = 1.0 - tr.done.astype(jnp.float32)
            delta = tr.reward + cfg.gamma * next_value * not_done - tr.value
            adv = delta + cfg.gamma * cfg.gae_lambda * not_done * next_adv
            return (tr.value, adv), adv

        _, advs = jax.lax.scan(
            body,
            (last_value, jnp.zeros_like(last_value)),
            traj,
            reverse=True,
        )
        returns = advs + traj.value
        return advs, returns

    def _loss(self, params, batch, advs, returns):
        cfg = self.cfg
        mean, log_std = self.policy.apply(params["policy"], batch.obs)
        log_prob = _gaussian_log_prob(batch.raw_action, mean, log_std)
        ratio = jnp.exp(log_prob - batch.log_prob)
        norm_adv = (advs - advs.mean()) / (advs.std() + 1e-8)
        pg1 = ratio * norm_adv
        pg2 = jnp.clip(ratio, 1 - cfg.clip_eps, 1 + cfg.clip_eps) * norm_adv
        pg_loss = -jnp.mean(jnp.minimum(pg1, pg2))

        value = self.value.apply(params["value"], batch.obs)
        vf_loss = 0.5 * jnp.mean((value - returns) ** 2)

        entropy = jnp.mean(jnp.sum(log_std + 0.5 * jnp.log(2 * jnp.pi * jnp.e), -1))
        total = pg_loss + cfg.vf_coeff * vf_loss - cfg.entropy_coeff * entropy
        return total, {
            "pg_loss": pg_loss,
            "vf_loss": vf_loss,
            "entropy": entropy,
        }

    # -- full train step -------------------------------------------------

    def train_step(self, state: TrainState):
        """rollout -> GAE -> epochs x minibatch clipped-PPO updates.

        Fully jitted; under a sharded env batch the parameter gradients
        are reduced by XLA across the mesh automatically.
        """
        cfg = self.cfg
        env_state, last_obs, key, traj = self.rollout(state)
        last_value = self.value.apply(state.params["value"], last_obs)
        advs, returns = self._gae(traj, last_value)

        # flatten (T, E, ...) -> (T*E, ...)
        def fl(x):
            return x.reshape((-1,) + x.shape[2:])

        flat = Transition(*[fl(x) for x in traj])
        advs_f, returns_f = fl(advs), fl(returns)
        batch_size = flat.reward.shape[0]
        mb_size = batch_size // cfg.num_minibatches

        params, opt_state = state.params, state.opt_state
        metrics = None
        key, k_perm = jax.random.split(key)

        def epoch_body(carry, k_epoch):
            params, opt_state = carry
            perm = jax.random.permutation(k_epoch, batch_size)

            def mb_body(carry, i):
                params, opt_state = carry
                idx = jax.lax.dynamic_slice_in_dim(perm, i * mb_size, mb_size)
                mb = jax.tree.map(lambda x: x[idx], flat)
                (loss, aux), grads = jax.value_and_grad(
                    self._loss, has_aux=True
                )(params, mb, advs_f[idx], returns_f[idx])
                updates, opt_state = self.tx.update(grads, opt_state, params)
                params = optax.apply_updates(params, updates)
                return (params, opt_state), {**aux, "loss": loss}

            (params, opt_state), m = jax.lax.scan(
                mb_body, (params, opt_state), jnp.arange(cfg.num_minibatches)
            )
            return (params, opt_state), m

        (params, opt_state), metrics = jax.lax.scan(
            epoch_body,
            (params, opt_state),
            jax.random.split(k_perm, cfg.num_epochs),
        )
        metrics = jax.tree.map(lambda x: x.mean(), metrics)
        metrics["mean_reward"] = traj.reward.mean()
        new_state = TrainState(
            params=params,
            opt_state=opt_state,
            env_state=env_state,
            last_obs=last_obs,
            key=key,
            step=state.step + 1,
        )
        return new_state, metrics

    def train(self, state: TrainState, num_steps: int):
        """Run num_steps jitted train steps, returning the last metrics."""
        metrics = None
        for _ in range(num_steps):
            state, metrics = self._jit_train_step(state)
        return state, jax.tree.map(float, metrics)


