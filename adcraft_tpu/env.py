"""Functional environment core and the vectorized batch environment.

The functional API is the source of truth:

    state, obs = env_reset(cfg, key, kw=...)
    state, ts = env_step(cfg, state, bids, budget)

Both are pure, jit-able, vmap-able, and shard-able. The Gymnasium adapter
(adcraft_tpu.gym_env) and the vector env below are thin wrappers.

Reference semantics: ``BiddingSimulation.step/reset``
(adcraft/gymnasium_kw_env.py:160-346).
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import jax
import jax.numpy as jnp

from adcraft_tpu import distributions as dist
from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.keywords import (
    KeywordState,
    sample_explicit_keywords,
    sample_implicit_keywords,
)
from adcraft_tpu.quantiles import QuantileTable
from adcraft_tpu.step import DayOutcomes, simulate_day, update_keywords

Array = jax.Array


class EnvState(NamedTuple):
    """Complete dynamic environment state (a pytree — trivially
    checkpointable with orbax, unlike the reference where env state lives in
    object attributes and is never checkpointed, SURVEY.md §5)."""

    kw: KeywordState
    day: Array  # int32
    cumulative_profit: Array  # money
    budget: Array  # money — persists across steps; actions may override
    loss_threshold: Array  # money
    max_days: Array  # int32
    key: Array  # PRNG key


class TimeStep(NamedTuple):
    """One transition's outputs.

    ``obs`` matches the reference observation dict fields
    (gymnasium_kw_env.py:232-244); ``outcomes`` carries the full
    per-keyword day aggregates for metrics/diagnostics (the reference
    exposes these only as a string repr in ``info``).
    """

    obs: Dict[str, Array]
    reward: Array
    terminated: Array
    truncated: Array
    outcomes: DayOutcomes


def zero_observation(cfg: EnvConfig, dtype=jnp.float32) -> Dict[str, Array]:
    """The all-zeros reset observation.

    The reference builds ``abs(observation_space.sample() * 0)``
    (gymnasium_kw_env.py:339-343) which is exactly zeros.
    """
    k = cfg.num_keywords
    return {
        "impressions": jnp.zeros((k,), jnp.int32),
        "buyside_clicks": jnp.zeros((k,), jnp.int32),
        "cost": jnp.zeros((k,), dtype),
        "sellside_conversions": jnp.zeros((k,), jnp.int32),
        "revenue": jnp.zeros((k,), dtype),
        "cumulative_profit": jnp.zeros((1,), dtype),
        "days_passed": jnp.zeros((1,), jnp.int32),
    }


def batch_keys(key: Array, num: int, impl: str = "rbg") -> Array:
    """Derive ``num`` per-env root keys in the given PRNG implementation.

    The incoming key (any impl) seeds the derivation, so trajectories stay
    deterministic in (seed, num, impl) and placement-independent.
    """
    if impl in (None, "threefry2x32"):
        return jax.random.split(key, num)
    seeds = jax.random.randint(key, (num,), 0, jnp.iinfo(jnp.int32).max)
    return jax.vmap(lambda s: jax.random.key(s, impl=impl))(seeds)


def env_reset(
    cfg: EnvConfig,
    key: Array,
    kw: Optional[KeywordState] = None,
    table: Optional[QuantileTable] = None,
    no_vol_prob: float = 0.0,
    updater_mask=None,
):
    """Build a fresh environment state.

    If ``kw`` is given it is used as-is; otherwise keywords are sampled
    according to ``cfg.kind`` — implicit keywords need a quantile ``table``
    (mirrors reset's keyword_config branch, gymnasium_kw_env.py:303-314).
    Returns (state, zero observation).
    """
    k_kw, k_state = jax.random.split(key)
    if kw is None:
        if cfg.kind is KeywordKind.IMPLICIT:
            if table is None:
                raise ValueError("implicit envs need a quantile table")
            kw = sample_implicit_keywords(
                k_kw, cfg.num_keywords, table, no_vol_prob, updater_mask
            )
        else:
            kw = sample_explicit_keywords(k_kw, cfg.num_keywords, updater_mask)
    dtype = cfg.money_dtype
    state = EnvState(
        kw=kw,
        day=jnp.asarray(0, jnp.int32),
        cumulative_profit=jnp.asarray(0.0, dtype),
        budget=jnp.asarray(cfg.budget, dtype),
        loss_threshold=jnp.asarray(cfg.loss_threshold, dtype),
        max_days=jnp.asarray(cfg.max_days, jnp.int32),
        key=k_state,
    )
    return state, zero_observation(cfg, dtype)


def env_step(
    cfg: EnvConfig,
    state: EnvState,
    bids: Array,
    budget: Optional[Array] = None,
):
    """One day of bidding. Pure; returns (new_state, TimeStep).

    Mirrors ``BiddingSimulation.step`` (gymnasium_kw_env.py:160-269):
    bids floored at $0.01 and rounded to cents; optional budget override
    rounded to cents; day simulated; reward = total profit; truncation on
    cumulative loss; termination on max days; then non-stationary drift.
    The action's ``whether_to_bid`` field is intentionally ignored, as in
    the reference (gymnasium_kw_env.py:208-216).
    """
    dtype = cfg.money_dtype
    key, k_day, k_upd = jax.random.split(state.key, 3)

    new_budget = state.budget if budget is None else jnp.asarray(budget, dtype)
    new_budget = dist.round_cents(new_budget).reshape(())
    bids = dist.round_cents(
        jnp.maximum(jnp.asarray(bids, dtype), 0.01)
    ).reshape((cfg.num_keywords,))

    day = simulate_day(cfg, k_day, state.kw, bids, new_budget, dtype=dtype)

    profits = jnp.sum(day.profit)
    cumulative = state.cumulative_profit + profits
    truncated = cumulative < -state.loss_threshold
    new_day = state.day + 1
    terminated = new_day >= state.max_days

    obs = {
        "impressions": day.impressions,
        "buyside_clicks": day.buyside_clicks,
        "cost": day.cost,
        "sellside_conversions": day.sellside_conversions,
        "revenue": day.revenue,
        "cumulative_profit": cumulative.reshape((1,)),
        "days_passed": new_day.reshape((1,)).astype(jnp.int32),
    }

    new_kw = update_keywords(cfg, k_upd, state.kw)
    new_state = EnvState(
        kw=new_kw,
        day=new_day,
        cumulative_profit=cumulative,
        budget=new_budget,
        loss_threshold=state.loss_threshold,
        max_days=state.max_days,
        key=key,
    )
    ts = TimeStep(
        obs=obs,
        reward=profits,
        terminated=terminated,
        truncated=truncated,
        outcomes=day,
    )
    return new_state, ts


def env_rollout(
    cfg: EnvConfig,
    state: EnvState,
    bids: Array,
    num_days: int,
    budget: Optional[Array] = None,
):
    """Run ``num_days`` consecutive days inside ONE compiled program.

    A ``lax.scan`` over ``env_step`` — the shape RL rollouts already use
    (adcraft_tpu.agents.ppo.PPOTrainer.rollout) and the dispatch-free way
    to drive the env: a Python loop of day steps pays one host->device
    dispatch per day, while this runs the whole rollout device-side.

    ``bids`` is either a constant (K,) vector applied every day or a
    per-day (num_days, K) schedule; ``budget`` likewise scalar or
    (num_days,). Returns (final_state, TimeStep-stacked-over-days).
    Per-keyword day outcomes are bit-identical to ``num_days``
    sequential ``env_step`` calls (same key tree, exact integer money
    paths); the scalar reward / cumulative-profit K-sums can differ in
    the last float32 ulp because XLA may pick a different reduction
    order inside a different program.
    """
    bids = jnp.asarray(bids)
    xs_bids = (
        bids
        if bids.ndim == 2 and bids.shape[0] == num_days
        else jnp.broadcast_to(bids, (num_days,) + bids.shape)
    )
    if budget is None:

        def body_nb(st, b):
            return env_step(cfg, st, b, None)

        return jax.lax.scan(body_nb, state, xs_bids)

    bud = jnp.asarray(budget)
    xs_bud = (
        bud
        if bud.ndim >= 1 and bud.shape[0] == num_days
        else jnp.broadcast_to(bud, (num_days,) + bud.shape)
    )

    def body(st, xs):
        b, bd = xs
        return env_step(cfg, st, b, bd)

    return jax.lax.scan(body, state, (xs_bids, xs_bud))


def env_autoreset_step(
    cfg: EnvConfig,
    state: EnvState,
    bids: Array,
    budget: Optional[Array] = None,
    reset_kw: bool = False,
    table: Optional[QuantileTable] = None,
    no_vol_prob: float = 0.0,
):
    """Step with auto-reset on episode end (for RL training loops).

    On terminated|truncated, returns a freshly reset state (keeping the
    keyword set by default — the reference resamples keywords only when a
    new seed is passed, gymnasium_kw_env.py:303). The TimeStep still
    reports the pre-reset transition.
    """
    new_state, ts = env_step(cfg, state, bids, budget)
    done = ts.terminated | ts.truncated
    k_next, k_reset = jax.random.split(new_state.key)
    if reset_kw:
        reset_state, _ = env_reset(
            cfg, k_reset, kw=None, table=table, no_vol_prob=no_vol_prob
        )
    else:
        reset_state, _ = env_reset(cfg, k_reset, kw=new_state.kw)
    picked = jax.tree.map(
        lambda a, b: jnp.where(done, a, b),
        reset_state._replace(key=k_next),
        new_state._replace(key=k_next),
    )
    return picked, ts


class VectorBiddingEnv:
    """Batched, jitted environment: E independent envs stepped in lockstep.

    The replacement for Ray RLlib's ``num_rollout_workers x
    num_envs_per_worker`` actor parallelism (SURVEY.md §2b): instead of
    processes and object-store RPC, envs are a batch dimension. Shard the
    state's batch axis over a mesh (adcraft_tpu.parallel) to scale across
    devices.
    """

    def __init__(
        self,
        cfg: EnvConfig,
        num_envs: int,
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
        updater_mask=None,
    ):
        self.cfg = cfg
        self.num_envs = num_envs
        self._table = table
        self._no_vol_prob = no_vol_prob
        self._updater_mask = updater_mask

        def _reset_one(key):
            return env_reset(
                cfg,
                key,
                table=table,
                no_vol_prob=no_vol_prob,
                updater_mask=updater_mask,
            )

        def _step_one(state, bids, budget):
            return env_step(cfg, state, bids, budget)

        self._reset = jax.jit(jax.vmap(_reset_one))
        self._rollout_cache = {}
        self._step = jax.jit(jax.vmap(_step_one))
        self._step_nobudget = jax.jit(
            jax.vmap(lambda s, b: env_step(cfg, s, b, None))
        )

    def reset(self, key: Array):
        """Returns (state, obs) with a leading (num_envs,) batch axis.

        Per-env root keys are derived in the configured PRNG impl
        (cfg.prng_impl; threefry2x32 by default).
        """
        keys = batch_keys(key, self.num_envs, self.cfg.prng_impl)
        return self._reset(keys)

    def step(self, state: EnvState, bids: Array, budget: Optional[Array] = None):
        """bids: (E, K); budget: optional (E,). Returns (state, TimeStep)."""
        if budget is None:
            return self._step_nobudget(state, bids)
        return self._step(state, bids, budget)

    def lower_step(
        self, state: EnvState, bids: Array, budget: Optional[Array] = None
    ):
        """The lowered (not yet compiled) program ``step`` runs for these
        arguments; ``.compile()`` gives its memory and cost analysis and
        fills ``step``'s compile cache."""
        if budget is None:
            return self._step_nobudget.lower(state, bids)
        return self._step.lower(state, bids, budget)

    def rollout(
        self,
        state: EnvState,
        bids: Array,
        num_days: int,
        budget: Optional[Array] = None,
    ):
        """``num_days`` lockstep days in ONE device program (env_rollout).

        bids: (E, K) constant or (num_days, E, K) schedule; budget: (E,)
        or (num_days, E). Returns (state, TimeStep stacked over a leading
        (num_days,) axis). Matches ``num_days`` ``step`` calls (see
        env_rollout on last-ulp reward sums) but pays a single dispatch —
        the bench/RL hot path.
        """
        key = ("rollout", num_days, budget is None)
        fn = self._rollout_cache.get(key)
        if fn is None:
            cfg = self.cfg

            def _roll_one(state, bids, budget):
                return env_rollout(cfg, state, bids, num_days, budget)

            def _roll_one_nb(state, bids):
                return env_rollout(cfg, state, bids, num_days, None)

            if budget is None:
                fn = jax.jit(jax.vmap(_roll_one_nb, in_axes=(0, -2), out_axes=(0, 1)))
            else:
                fn = jax.jit(
                    jax.vmap(_roll_one, in_axes=(0, -2, -1), out_axes=(0, 1))
                )
            self._rollout_cache[key] = fn
        if budget is None:
            return fn(state, bids)
        return fn(state, bids, budget)
