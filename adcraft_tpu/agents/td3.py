"""TD3 on the vectorized bidding environment.

Replacement for the reference's ``sem_td3_config`` (RLlib
TD3Config, adcraft/experiment_utils/agent_configs.py:92-128): gamma=0.995,
lr=1e-3, tau=0.005, replay capacity 1e6, 10k pure-random warmup steps,
Gaussian exploration noise sigma=0.1, [400, 300] relu nets.

Everything — replay buffer included — is a pytree of device arrays, so the
whole (collect -> store -> sample -> twin-critic update -> delayed actor
update -> polyak) cycle is one jitted function over the env batch.
Actions live in the squashed box via the shared GaussianPolicy squash.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import jax
import jax.numpy as jnp
import optax

from adcraft_tpu.agents.networks import MLP, GaussianPolicy, flatten_obs
from adcraft_tpu.config import EnvConfig
from adcraft_tpu.env import EnvState, env_reset, env_step
from adcraft_tpu.quantiles import QuantileTable

Array = jax.Array


@dataclasses.dataclass(frozen=True)
class TD3Config:
    """Hyper-parameters (defaults per agent_configs.py:92-128)."""

    gamma: float = 0.995
    lr: float = 1e-3
    tau: float = 0.005
    buffer_size: int = 100_000
    batch_size: int = 256
    warmup_steps: int = 1_000  # reference: 10k env steps (scaled down)
    exploration_stddev: float = 0.1
    policy_delay: int = 2
    target_noise: float = 0.2
    target_noise_clip: float = 0.5
    hidden: Tuple[int, int] = (400, 300)


@dataclasses.dataclass(frozen=True)
class Actor:
    """tanh-bounded raw action in [-1, 1]."""

    action_dim: int
    hidden: Tuple[int, int] = (400, 300)

    def init(self, key: Array, obs: Array) -> list:
        return MLP(self.hidden, self.action_dim).init(key, obs)

    def apply(self, params: list, obs: Array) -> Array:
        return jnp.tanh(MLP(self.hidden, self.action_dim).apply(params, obs))


@dataclasses.dataclass(frozen=True)
class Critic:
    """Q(obs, action) over the concatenated input."""

    hidden: Tuple[int, int] = (400, 300)

    def init(self, key: Array, obs: Array, action: Array) -> list:
        x = jnp.concatenate([obs, action], axis=-1)
        return MLP(self.hidden, 1).init(key, x)

    def apply(self, params: list, obs: Array, action: Array) -> Array:
        x = jnp.concatenate([obs, action], axis=-1)
        return MLP(self.hidden, 1).apply(params, x)[..., 0]


class ReplayBuffer(NamedTuple):
    obs: Array
    action: Array
    reward: Array
    next_obs: Array
    done: Array
    ptr: Array  # int32
    size: Array  # int32


class TD3State(NamedTuple):
    actor: dict
    critic1: dict
    critic2: dict
    target_actor: dict
    target_critic1: dict
    target_critic2: dict
    actor_opt: optax.OptState
    critic_opt: optax.OptState
    buffer: ReplayBuffer
    env_state: EnvState
    last_obs: Array
    key: Array
    step: Array


class TD3Trainer:
    def __init__(
        self,
        env_cfg: EnvConfig,
        num_envs: int,
        cfg: TD3Config = TD3Config(),
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
    ):
        self.env_cfg = env_cfg
        self.num_envs = num_envs
        self.cfg = cfg
        self.table = table
        self.no_vol_prob = no_vol_prob
        self.action_dim = env_cfg.num_keywords + 1
        self.obs_dim = 5 * env_cfg.num_keywords + 2
        self.actor = Actor(self.action_dim, cfg.hidden)
        self.critic = Critic(cfg.hidden)
        # squash [-1, 1] raw actions into the env's bid/budget box via the
        # shared policy box mapping (sigmoid((x+1)/2 shifted) equivalent)
        self._box = GaussianPolicy(env_cfg.num_keywords)
        self.actor_tx = optax.adam(cfg.lr)
        self.critic_tx = optax.adam(cfg.lr)
        self._jit_step = jax.jit(self.train_step)

    def _to_env_action(self, raw: Array) -> Tuple[Array, Array]:
        # map tanh output [-1,1] -> logits for the shared sigmoid squash
        return self._box.squash(2.0 * raw)

    def init(self, key: Array) -> TD3State:
        ka, kc1, kc2, kenv, kstate = jax.random.split(key, 5)
        dummy_o = jnp.zeros((self.obs_dim,))
        dummy_a = jnp.zeros((self.action_dim,))
        actor = self.actor.init(ka, dummy_o)
        c1 = self.critic.init(kc1, dummy_o, dummy_a)
        c2 = self.critic.init(kc2, dummy_o, dummy_a)
        env_keys = jax.random.split(kenv, self.num_envs)
        env_state, obs0 = jax.vmap(
            lambda k: env_reset(
                self.env_cfg, k, table=self.table, no_vol_prob=self.no_vol_prob
            )
        )(env_keys)
        n = self.cfg.buffer_size
        buf = ReplayBuffer(
            obs=jnp.zeros((n, self.obs_dim)),
            action=jnp.zeros((n, self.action_dim)),
            reward=jnp.zeros((n,)),
            next_obs=jnp.zeros((n, self.obs_dim)),
            done=jnp.zeros((n,), bool),
            ptr=jnp.asarray(0, jnp.int32),
            size=jnp.asarray(0, jnp.int32),
        )
        return TD3State(
            actor=actor,
            critic1=c1,
            critic2=c2,
            target_actor=actor,
            target_critic1=c1,
            target_critic2=c2,
            actor_opt=self.actor_tx.init(actor),
            critic_opt=self.critic_tx.init((c1, c2)),
            buffer=buf,
            env_state=env_state,
            last_obs=flatten_obs(obs0),
            key=kstate,
            step=jnp.asarray(0, jnp.int32),
        )

    # -- environment interaction ---------------------------------------

    def _collect(self, state: TD3State, key: Array):
        """One env day for every env, exploration noise on (or pure random
        during warmup, agent_configs.py:109-125)."""
        k_noise, k_rand, k_reset = jax.random.split(key, 3)
        raw = self.actor.apply(state.actor, state.last_obs)
        noise = self.cfg.exploration_stddev * jax.random.normal(
            k_noise, raw.shape
        )
        raw = jnp.clip(raw + noise, -1.0, 1.0)
        random_raw = jax.random.uniform(
            k_rand, raw.shape, minval=-1.0, maxval=1.0
        )
        warming = state.step * self.num_envs < self.cfg.warmup_steps
        raw = jnp.where(warming, random_raw, raw)
        bids, budget = self._to_env_action(raw)
        new_env, ts = jax.vmap(
            lambda s, b, bud: env_step(self.env_cfg, s, b, bud)
        )(state.env_state, bids, budget)
        done = ts.terminated | ts.truncated
        next_obs = flatten_obs(ts.obs)
        # auto-reset finished envs
        reset_keys = jax.random.split(k_reset, self.num_envs)
        fresh, fresh_obs = jax.vmap(
            lambda k: env_reset(
                self.env_cfg, k, table=self.table, no_vol_prob=self.no_vol_prob
            )
        )(reset_keys)

        def pick(a, b):
            d = done.reshape(done.shape + (1,) * (a.ndim - 1))
            return jnp.where(d, a, b)

        carry_env = jax.tree.map(pick, fresh, new_env)
        carry_obs = pick(flatten_obs(fresh_obs), next_obs)
        # reward scaled for critic stability (daily profits are O(100))
        tr = (state.last_obs, raw, ts.reward / 100.0, next_obs, done)
        return carry_env, carry_obs, tr

    def _store(self, buf: ReplayBuffer, tr) -> ReplayBuffer:
        obs, action, reward, next_obs, done = tr
        n = self.cfg.buffer_size
        idx = (buf.ptr + jnp.arange(self.num_envs)) % n
        return ReplayBuffer(
            obs=buf.obs.at[idx].set(obs),
            action=buf.action.at[idx].set(action),
            reward=buf.reward.at[idx].set(reward),
            next_obs=buf.next_obs.at[idx].set(next_obs),
            done=buf.done.at[idx].set(done),
            ptr=(buf.ptr + self.num_envs) % n,
            size=jnp.minimum(buf.size + self.num_envs, n),
        )

    # -- losses ---------------------------------------------------------

    def _critic_loss(self, critics, state: TD3State, batch, key):
        c1, c2 = critics
        obs, action, reward, next_obs, done = batch
        noise = jnp.clip(
            self.cfg.target_noise
            * jax.random.normal(key, action.shape),
            -self.cfg.target_noise_clip,
            self.cfg.target_noise_clip,
        )
        next_a = jnp.clip(
            self.actor.apply(state.target_actor, next_obs) + noise, -1.0, 1.0
        )
        q1t = self.critic.apply(state.target_critic1, next_obs, next_a)
        q2t = self.critic.apply(state.target_critic2, next_obs, next_a)
        target = reward + self.cfg.gamma * (1.0 - done) * jnp.minimum(q1t, q2t)
        target = jax.lax.stop_gradient(target)
        q1 = self.critic.apply(c1, obs, action)
        q2 = self.critic.apply(c2, obs, action)
        return jnp.mean((q1 - target) ** 2) + jnp.mean((q2 - target) ** 2)

    def _actor_loss(self, actor, state: TD3State, obs):
        a = self.actor.apply(actor, obs)
        return -jnp.mean(self.critic.apply(state.critic1, obs, a))

    # -- train step ------------------------------------------------------

    def train_step(self, state: TD3State):
        key, k_collect, k_sample, k_noise = jax.random.split(state.key, 4)
        env_state, last_obs, tr = self._collect(state, k_collect)
        buf = self._store(state.buffer, tr)

        idx = jax.random.randint(
            k_sample,
            (self.cfg.batch_size,),
            0,
            jnp.maximum(buf.size, 1),
        )
        batch = (
            buf.obs[idx],
            buf.action[idx],
            buf.reward[idx],
            buf.next_obs[idx],
            buf.done[idx].astype(jnp.float32),
        )
        closs, cgrads = jax.value_and_grad(self._critic_loss)(
            (state.critic1, state.critic2), state, batch, k_noise
        )
        cupd, critic_opt = self.critic_tx.update(
            cgrads, state.critic_opt, (state.critic1, state.critic2)
        )
        critic1, critic2 = optax.apply_updates(
            (state.critic1, state.critic2), cupd
        )

        def do_actor(_):
            aloss, agrads = jax.value_and_grad(self._actor_loss)(
                state.actor, state._replace(critic1=critic1), batch[0]
            )
            aupd, actor_opt = self.actor_tx.update(
                agrads, state.actor_opt, state.actor
            )
            actor = optax.apply_updates(state.actor, aupd)
            tau = self.cfg.tau
            pol = lambda t, o: jax.tree.map(
                lambda a, b: tau * a + (1 - tau) * b, o, t
            )
            return (
                actor,
                actor_opt,
                pol(state.target_actor, actor),
                pol(state.target_critic1, critic1),
                pol(state.target_critic2, critic2),
                aloss,
            )

        def skip_actor(_):
            return (
                state.actor,
                state.actor_opt,
                state.target_actor,
                state.target_critic1,
                state.target_critic2,
                jnp.asarray(0.0),
            )

        (actor, actor_opt, t_actor, t_c1, t_c2, aloss) = jax.lax.cond(
            state.step % self.cfg.policy_delay == 0, do_actor, skip_actor, None
        )
        new_state = TD3State(
            actor=actor,
            critic1=critic1,
            critic2=critic2,
            target_actor=t_actor,
            target_critic1=t_c1,
            target_critic2=t_c2,
            actor_opt=actor_opt,
            critic_opt=critic_opt,
            buffer=buf,
            env_state=env_state,
            last_obs=last_obs,
            key=key,
            step=state.step + 1,
        )
        metrics = {
            "critic_loss": closs,
            "actor_loss": aloss,
            "mean_reward": tr[2].mean() * 100.0,
            "buffer_size": buf.size,
        }
        return new_state, metrics

    def train(self, state: TD3State, num_steps: int):
        metrics = None
        for _ in range(num_steps):
            state, metrics = self._jit_step(state)
        return state, jax.tree.map(float, metrics)
