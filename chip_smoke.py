"""Smoke run of the system's main path on the GPU.

    python chip_smoke.py             # one card: phases 1-4 below
    python chip_smoke.py --chips 4   # four cards: the sharded path only

Phases on one card, at the width of the bench (4096 envs x 100 keywords):

1. ``VectorBiddingEnv`` in the bench's fast sampling config: ``reset``,
   ``step`` with and without an explicit budget, one 8-day ``rollout``;
   day invariants, the step's compiled memory analysis and peak memory.
2. The other configs ``bench.py`` covers (sparse, dense explicit, dense
   binomial-pool) and the non-stationary dense config; day invariants.
3. Parity on the device: (a) the injected-draw parity path in float64
   against the pure-numpy oracle ``simulate_day_numpy``, bit-exact in
   counts and integer-cent money; (b) the fast samplers against the
   device's own parity samplers, distributionally; (c) the binomial-pool
   cost moments against a float64 numpy quadrature.
4. ``PPOTrainer`` at the reference's PPO defaults: init + 3 train steps.

With ``--chips 4``: ``sharded_vector_env`` over a 1-D ('envs',) mesh of
four cards against the same envs stepped on card 0 alone (bit-identical),
and one PPO train step with the env batch sharded and the learner
replicated against the same step on one card.

Every phase function takes its sizes as arguments, so the tests run each
one at tiny sizes on the CPU; only ``main`` insists on a GPU. A failed
check raises, and the script exits non-zero. The last line of standard
output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np

from adcraft_tpu.agents.ppo import PPOConfig, PPOTrainer
from adcraft_tpu.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu.distributions import _POOL_QUAD_NODES, pool_cost_deci_moments
from adcraft_tpu.env import VectorBiddingEnv
from adcraft_tpu.experiments.configs import (
    experiment_table,
    non_stationary_dense_env_config,
)
from adcraft_tpu.keywords import make_keyword_state
from adcraft_tpu.oracle.numpy_env import simulate_day_numpy
from adcraft_tpu.parallel.mesh import make_env_mesh, sharded_vector_env
from adcraft_tpu.profiling import (
    enable_compile_cache,
    nvidia_smi_name_power,
    require_gpu,
)
from adcraft_tpu.quantiles import simple_experiment_table
from adcraft_tpu.step import day_draw_table, simulate_day
from bench import bench_cfg

# Distributional tolerances, as the CPU tests use them
# (tests/test_step.py::test_cost_agg_mode_matches_lanes_distribution and
# ::test_binomial_inversion_matches_exact_distribution for per-keyword
# means; ::test_cost_agg_spend_matches_lanes_under_binding_budget for the
# mean day spend under a binding budget).
MEAN_RTOL, MEAN_ATOL = 0.05, 0.02
BINDING_SPEND_RTOL = 0.03
# Continuous-cost models (explicit rust-quirk, binomial pool) gate in
# float64 on costs that are not whole cents; their money is compared as
# tests/test_step.py::_assert_day_matches_oracle compares it.
FLOAT_MONEY_RTOL, FLOAT_MONEY_ATOL = 1e-5, 1e-4
# Pool cost moments vs the float64 quadrature, relative to the bid (the
# moments' scale; the mean itself can cross zero). TF32 contractions
# would miss this by orders of magnitude.
POOL_MOMENT_RTOL = 1e-5
# Spend <= budget: per-keyword costs come back as float32 dollars.
SPEND_SLACK = 1e-3


class CheckFailed(RuntimeError):
    pass


def check(cond, msg: str) -> None:
    if not bool(cond):
        raise CheckFailed(msg)


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------------------
# timing: wall clock per phase, compile time from JAX's own monitoring
# ---------------------------------------------------------------------------

_COMPILE_EVENTS = (
    "/jax/core/compile/jaxpr_trace_duration",
    "/jax/core/compile/jaxpr_to_mlir_module_duration",
    "/jax/core/compile/backend_compile_duration",
)
_compile_lock = threading.Lock()
_compile_secs = [0.0]


def _on_duration(event: str, secs: float, **_kw) -> None:
    if event in _COMPILE_EVENTS:
        with _compile_lock:
            _compile_secs[0] += secs


jax.monitoring.register_event_duration_secs_listener(_on_duration)


def run_phase(name: str, fn, *args, **kwargs):
    """Run one phase; print its result, wall time and compile time."""
    return run_group(name, fn, [args], **kwargs)[0]


def run_group(name: str, fn, arg_tuples, **kwargs):
    """Run ``fn`` over independent argument tuples, one thread each, so
    their compiles overlap (XLA compiles release the GIL); print each
    result, the group's wall time and its compile time summed over the
    threads. A failure in any thread re-raises here."""
    c0 = _compile_secs[0]
    t0 = time.perf_counter()
    results = _in_threads([lambda a=a: fn(*a, **kwargs) for a in arg_tuples])
    wall = time.perf_counter() - t0
    comp = _compile_secs[0] - c0
    log(f"[phase] {name}: ok  wall {wall:.1f} s  compile {comp:.1f} s")
    for r in results:
        log(f"    {json.dumps(r, sort_keys=True)}")
    return results


def _in_threads(thunks):
    with ThreadPoolExecutor(len(thunks)) as pool:
        futures = [pool.submit(t) for t in thunks]
        return [f.result() for f in futures]


# ---------------------------------------------------------------------------
# invariants
# ---------------------------------------------------------------------------


def check_days(ts, budget, days_passed, cfg: EnvConfig) -> dict:
    """Day invariants over a batched TimeStep (leading axes (..., E)).

    ``budget`` and ``days_passed`` broadcast against the (..., E) axes.
    """
    ts = jax.device_get(ts)
    out = ts.outcomes
    imp, clicks = out.impressions, out.buyside_clicks
    convs, vol = out.sellside_conversions, out.volume
    # explicit keywords keep the reference quirk of one zero-cost click
    # candidate in a sub-timestep that won no impression
    # (synthetic_kw_classes.py:514-515), so they may add one click per
    # sub-timestep
    extra = cfg.timesteps_per_day if cfg.kind is KeywordKind.EXPLICIT else 0
    check(np.all(clicks <= imp + extra), "clicks > impressions")
    check(np.all(imp <= vol), "impressions > volume")
    check(np.all(convs <= clicks), "conversions > clicks")
    check(np.all(np.isfinite(ts.reward)), "non-finite reward")
    for f in ("cost", "revenue", "profit"):
        check(np.all(np.isfinite(getattr(out, f))), f"non-finite {f}")
    check(np.all(out.revenue >= 0), "negative revenue")
    if cfg.cents_costs:
        check(np.all(out.cost >= 0), "negative cost in a whole-cent model")
    spend = out.cost.astype(np.float64).sum(-1)
    budget = np.broadcast_to(np.asarray(budget, np.float64), spend.shape)
    check(
        np.all(spend <= budget + SPEND_SLACK),
        f"spend over budget by {float(np.max(spend - budget)):.6f}",
    )
    dp = ts.obs["days_passed"][..., 0]
    check(
        np.array_equal(dp, np.broadcast_to(days_passed, dp.shape)),
        "days_passed does not count the days stepped",
    )
    return {
        "mean_reward": float(np.mean(ts.reward)),
        "budget_bound_share": float(np.mean(spend >= 0.9 * budget)),
    }


def _budgets(num_envs: int, seed: int) -> jax.Array:
    """Per-env daily budgets from $50 to $2000: some bind, some do not."""
    rng = np.random.default_rng(seed)
    return jnp.asarray(np.round(rng.uniform(50.0, 2000.0, num_envs), 2), jnp.float32)


def _compiled_memory(compiled) -> dict:
    ma = compiled.memory_analysis()
    return {
        f: int(getattr(ma, f))
        for f in (
            "argument_size_in_bytes",
            "output_size_in_bytes",
            "temp_size_in_bytes",
            "generated_code_size_in_bytes",
        )
    }


def _peak_bytes():
    stats = jax.devices()[0].memory_stats()
    return None if stats is None else int(stats["peak_bytes_in_use"])


# ---------------------------------------------------------------------------
# phase 1: the main env path
# ---------------------------------------------------------------------------


def phase_main_env(num_envs: int, num_keywords: int, steps: int = 3,
                   rollout_days: int = 8, seed: int = 0) -> dict:
    cfg = bench_cfg(num_keywords=num_keywords)
    venv = VectorBiddingEnv(cfg, num_envs, table=simple_experiment_table(128, 0.8))
    state, obs = venv.reset(jax.random.PRNGKey(seed))
    check(np.all(np.asarray(obs["days_passed"]) == 0), "reset obs not at day 0")
    bids = jnp.full((num_envs, num_keywords), 1.0, jnp.float32)
    budget = _budgets(num_envs, seed)

    compiled = venv.lower_step(state, bids, budget).compile()
    memory = _compiled_memory(compiled)

    day = 0
    for i in range(steps):
        if i % 2 == 0:  # explicit budget override
            state, ts = venv.step(state, bids, budget)
        else:  # no override: the last budget persists in the state
            state, ts = venv.step(state, bids)
        day += 1
        check_days(ts, state.budget, day, cfg)
    state, tss = venv.rollout(state, bids, rollout_days)
    days = day + 1 + np.arange(rollout_days)[:, None]
    summary = check_days(tss, state.budget, days, cfg)
    check(np.all(np.asarray(state.day) == day + rollout_days), "state.day wrong")
    return {
        "envs": num_envs,
        "keywords": num_keywords,
        "days": day + rollout_days,
        "step_memory_analysis": memory,
        "peak_bytes_in_use": _peak_bytes(),
        **summary,
    }


# ---------------------------------------------------------------------------
# phase 2: the other configs bench.py covers
# ---------------------------------------------------------------------------


def other_configs(num_keywords: int):
    """(name, cfg, table, updater_mask) for each non-headline config."""
    k = num_keywords
    dense = simple_experiment_table(128, 0.8)
    return [
        ("sparse_16_0.1", bench_cfg(max_volume=128, num_keywords=k),
         simple_experiment_table(16, 0.1), None),
        ("dense_explicit", bench_cfg(kind="explicit", num_keywords=k), dense, None),
        ("dense_pool", bench_cfg(num_keywords=k).replace(
            competitor_model=CompetitorModel.BINOMIAL_POOL), dense, None),
        ("non_stationary_dense", bench_cfg(num_keywords=k),
         experiment_table(non_stationary_dense_env_config), [True] * k),
    ]


def phase_other_config(name, cfg, table, updater_mask, num_envs: int,
                       steps: int = 2, seed: int = 1) -> dict:
    venv = VectorBiddingEnv(cfg, num_envs, table=table, updater_mask=updater_mask)
    state, _ = venv.reset(jax.random.PRNGKey(seed))
    kw0 = np.asarray(state.kw.vol_mean)
    bids = jnp.full((num_envs, cfg.num_keywords), 1.0, jnp.float32)
    budget = _budgets(num_envs, seed)
    summary = {}
    for day in range(1, steps + 1):
        state, ts = venv.step(state, bids, budget)
        summary = check_days(ts, budget, day, cfg)
    drifted = bool(np.any(np.asarray(state.kw.vol_mean) != kw0))
    check(drifted == (updater_mask is not None), f"{name}: keyword drift wrong")
    return {"config": name, "drifted": drifted, **summary}


# ---------------------------------------------------------------------------
# phase 3: parity on the device
# ---------------------------------------------------------------------------

MODELS = ("implicit", "explicit", "pool")


def parity_cfg(model: str, num_keywords: int, max_volume: int, **kw) -> EnvConfig:
    """The injected-draw parity path (lanes / exact samplers)."""
    kind = KeywordKind.EXPLICIT if model == "explicit" else KeywordKind.IMPLICIT
    comp = (CompetitorModel.BINOMIAL_POOL if model == "pool"
            else CompetitorModel.SINGLE_ABS_CENTS)
    return EnvConfig(num_keywords=num_keywords, kind=kind, competitor_model=comp,
                     max_volume=max_volume, timesteps_per_day=24, **kw)


def fast_cfg(model: str, num_keywords: int, max_volume: int) -> EnvConfig:
    """The bench's fast samplers for the same keyword model."""
    cfg = bench_cfg(max_volume=max_volume, num_keywords=num_keywords,
                    kind="explicit" if model == "explicit" else "implicit")
    if model == "pool":
        cfg = cfg.replace(competitor_model=CompetitorModel.BINOMIAL_POOL)
    return cfg


def make_keywords(model: str, num_keywords: int, max_volume: int, seed: int):
    """Random keyword parameters (and bids) for one env, daily volumes at
    15-35% of ``max_volume``."""
    rng = np.random.default_rng(seed)
    n = num_keywords
    common = dict(
        vol_mean=rng.uniform(0.15, 0.35, n) * max_volume,
        vol_std=rng.uniform(1.0, 8.0, n),
        bctr=rng.uniform(0.3, 0.8, n),
        sctr=rng.uniform(0.3, 0.8, n),
        rev_mean=rng.uniform(0.5, 1.5, n),
        rev_std=rng.uniform(0.05, 0.3, n),
    )
    if model == "implicit":
        kw = make_keyword_state(n, **common, bid_loc=rng.uniform(0.3, 1.0, n),
                                bid_scale=rng.uniform(0.05, 0.3, n),
                                max_bidders=1, participation_rate=1.0)
        bids = rng.uniform(0.3, 2.0, n)
    elif model == "explicit":
        kw = make_keyword_state(n, **common, imp_thresh=0.05,
                                imp_intercept=rng.uniform(0.1, 1.0, n),
                                imp_slope=rng.uniform(2.0, 20.0, n))
        bids = rng.uniform(0.1, 2.0, n)
    else:
        kw = make_keyword_state(n, **common, bid_loc=0.0, bid_scale=0.1,
                                max_bidders=30, participation_rate=0.6)
        bids = rng.uniform(0.1, 1.0, n)
    return kw, np.round(np.maximum(bids, 0.01) * 100) / 100


def _stack(trees):
    return jax.tree.map(lambda *xs: jnp.stack(xs), *trees)


def _compare_money(name, dev, ref, cents: bool):
    if cents:
        check(np.array_equal(np.round(dev * 100), np.round(ref * 100)),
              f"{name} differs in integer cents")
    else:
        np.testing.assert_allclose(dev, ref, rtol=FLOAT_MONEY_RTOL,
                                   atol=FLOAT_MONEY_ATOL, err_msg=name)


def phase_oracle_parity(model: str, num_envs: int, num_keywords: int,
                        max_volume: int, seed: int = 2) -> dict:
    """Device float64 parity path vs the numpy oracle on injected draws,
    with an unbound budget and a binding one."""
    with jax.enable_x64(True):
        cfg = parity_cfg(model, num_keywords, max_volume, use_x64=True)
        pairs = [make_keywords(model, num_keywords, max_volume, seed + e)
                 for e in range(num_envs)]
        kw = _stack([p[0] for p in pairs])
        bids = jnp.asarray(np.stack([p[1] for p in pairs]), jnp.float64)
        keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
        day_fn = jax.jit(jax.vmap(lambda k, w, b, bud: simulate_day(cfg, k, w, b, bud)))
        draws_fn = jax.jit(jax.vmap(lambda k, w, b: day_draw_table(cfg, k, w, b)))
        draws = jax.device_get(draws_fn(keys, kw, bids))
        bids_np = np.asarray(bids)
        result = {"model": model}
        budgets = np.full(num_envs, 1e6)
        for label in ("unbound", "binding"):
            day = jax.device_get(day_fn(keys, kw, bids, jnp.asarray(budgets)))
            spends = []
            for e in range(num_envs):
                ref = simulate_day_numpy(
                    bids_np[e], float(budgets[e]),
                    {f: v[e] for f, v in draws.items()},
                    timesteps=cfg.timesteps_per_day, cents=cfg.cents_costs,
                )
                for f in ("impressions", "buyside_clicks", "sellside_conversions",
                          "volume", "eligible_volume"):
                    check(np.array_equal(getattr(day, f)[e], ref[f]),
                          f"{model}/{label} env {e}: {f} differs from the oracle")
                _compare_money(f"{model}/{label} env {e} revenue",
                               day.revenue[e], ref["revenue"], cents=True)
                for f in ("cost", "profit"):
                    _compare_money(f"{model}/{label} env {e} {f}",
                                   getattr(day, f)[e], ref[f], cfg)
                check(ref["cost"].sum() <= budgets[e] + 1e-9, "oracle overspent")
                spends.append(float(ref["cost"].sum()))
            result[f"{label}_mean_spend"] = float(np.mean(spends))
            # the binding budget: half of each env's unbound spend
            budgets = np.maximum(np.round(0.5 * np.asarray(spends), 2), 0.01)
        return result


def phase_fast_vs_parity(model: str, num_envs: int, num_keywords: int,
                         max_volume: int, seed: int = 3) -> dict:
    """The fast samplers vs the parity samplers on the device, per-keyword
    means of day totals over the env batch (same keywords in every env,
    one key per env)."""
    kw, bids = make_keywords(model, num_keywords, max_volume, seed)
    bids = jnp.asarray(bids, jnp.float32)
    keys = jax.random.split(jax.random.PRNGKey(seed), num_envs)
    outs = {}
    for label, cfg in (("parity", parity_cfg(model, num_keywords, max_volume)),
                       ("fast", fast_cfg(model, num_keywords, max_volume))):
        fn = jax.jit(jax.vmap(lambda k, bud, _c=cfg: simulate_day(_c, k, kw, bids, bud),
                              in_axes=(0, None)))
        unbound = jax.device_get(fn(keys, jnp.asarray(1e6, jnp.float32)))
        outs[label] = (fn, unbound)
    p, f = outs["parity"][1], outs["fast"][1]
    # volume is drawn before any sampler choice: bit-identical
    check(np.array_equal(p.volume, f.volume), f"{model}: volume stream differs")
    for field in ("impressions", "buyside_clicks", "sellside_conversions",
                  "cost", "revenue"):
        np.testing.assert_allclose(
            getattr(f, field).mean(0), getattr(p, field).mean(0),
            rtol=MEAN_RTOL, atol=MEAN_ATOL, err_msg=f"{model} {field}",
        )
    # a budget that binds most days: mean day spend agrees
    binding = jnp.asarray(round(0.5 * float(p.cost.sum(-1).mean()), 2), jnp.float32)
    spend = {}
    for label, (fn, _) in outs.items():
        day = jax.device_get(fn(keys, binding))
        total = day.cost.astype(np.float64).sum(-1)
        check(np.all(total <= float(binding) + SPEND_SLACK), f"{model} {label} overspent")
        spend[label] = float(total.mean())
    np.testing.assert_allclose(spend["fast"], spend["parity"],
                               rtol=BINDING_SPEND_RTOL, err_msg=f"{model} binding spend")
    return {"model": model, "binding_budget": float(binding), "mean_spend": spend}


def pool_moments_reference(bid, loc, scale, k):
    """float64 numpy Gauss-Legendre quadrature of the same integral as
    ``pool_cost_deci_moments``: E[M^r | k] = k * sum_q omega_q *
    g(w_q)^r * w_q^(k-1), g(w) = icdf(F(bid) * w), floored at 0 for k < 3.
    Returns (mean, second moment) in dollars."""
    x, w = np.polynomial.legendre.leggauss(_POOL_QUAD_NODES)
    wq, om = 0.5 * (x + 1.0), 0.5 * w
    bid, loc, scale, k = (np.asarray(a, np.float64)[..., None] for a in (bid, loc, scale, k))
    z = (bid - loc) / scale
    f_bid = np.where(z < 0, 0.5 * np.exp(z), 1.0 - 0.5 * np.exp(-z))
    q = f_bid * wq
    g = loc + scale * np.where(q < 0.5, np.log(2.0 * q), -np.log(2.0 * (1.0 - q)))
    g = np.where(k < 3, np.maximum(g, 0.0), g)
    wk = wq ** np.maximum(k - 1, 0)
    m1 = k[..., 0] * np.sum(om * g * wk, -1)
    m2 = k[..., 0] * np.sum(om * g * g * wk, -1)
    return m1, m2


def phase_pool_moments(num_cells: int, seed: int = 4) -> dict:
    """The pool cost moments on the device (f32, HIGHEST-precision
    contractions) vs a float64 numpy quadrature of the same integral."""
    rng = np.random.default_rng(seed)
    bid = np.round(rng.uniform(0.05, 3.0, num_cells), 2)
    loc = rng.uniform(-0.3, 0.5, num_cells)
    scale = rng.uniform(0.05, 0.5, num_cells)
    k = rng.integers(1, 34, num_cells).astype(np.float64)
    mu_d, sig_d, _ = jax.device_get(jax.jit(pool_cost_deci_moments)(
        *(jnp.asarray(a, jnp.float32) for a in (bid, loc, scale, k))))
    m1, m2 = pool_moments_reference(bid, loc, scale, k)
    # compare the raw moments in dollars; their scale is the bid's
    mu = mu_d / 1000.0
    m2_dev = ((sig_d / 1000.0) ** 2 - 1.0 / 12.0 / 1e6) + mu * mu
    err1 = float(np.max(np.abs(mu - m1) / np.maximum(np.abs(bid), 1e-2)))
    err2 = float(np.max(np.abs(m2_dev - m2) / np.maximum(bid * bid, 1e-4)))
    check(err1 <= POOL_MOMENT_RTOL, f"pool mean off by {err1:.2e} of the bid")
    check(err2 <= POOL_MOMENT_RTOL, f"pool 2nd moment off by {err2:.2e}")
    return {"cells": num_cells, "mean_rel_err": err1, "m2_rel_err": err2}


# ---------------------------------------------------------------------------
# phase 4: PPO
# ---------------------------------------------------------------------------


def _all_finite(tree) -> bool:
    return all(bool(np.all(np.isfinite(np.asarray(x)))) for x in jax.tree.leaves(tree))


def phase_ppo(num_envs: int, num_keywords: int, steps: int = 3,
              ppo_cfg: PPOConfig = PPOConfig(), seed: int = 5) -> dict:
    cfg = bench_cfg(num_keywords=num_keywords)
    trainer = PPOTrainer(cfg, num_envs, ppo_cfg, table=simple_experiment_table(128, 0.8))
    state = trainer.init(jax.random.PRNGKey(seed))
    losses = []
    for _ in range(steps):
        prev_obs = np.asarray(state.last_obs)
        state, metrics = trainer.train(state, 1)
        losses.append(metrics["loss"])
        check(np.isfinite(metrics["loss"]), "non-finite PPO loss")
        check(not np.array_equal(np.asarray(state.last_obs), prev_obs),
              "env state did not advance")
    check(_all_finite(state.params), "non-finite PPO parameters")
    check(int(state.step) == steps, "train step counter wrong")
    return {"envs": num_envs, "losses": losses,
            "mean_reward": metrics["mean_reward"]}


# ---------------------------------------------------------------------------
# four cards: sharded env and sharded PPO step
# ---------------------------------------------------------------------------


def phase_sharded_env(devices, num_envs: int, num_keywords: int,
                      steps: int = 3, seed: int = 6) -> dict:
    """The env batch sharded over ``devices`` vs the same envs on
    ``devices[0]`` alone: every output bit-identical. The two runs go in
    two threads so their compiles overlap."""
    cfg = bench_cfg(num_keywords=num_keywords)
    table = simple_experiment_table(128, 0.8)
    bids = jnp.full((num_envs, num_keywords), 1.0, jnp.float32)
    budget = _budgets(num_envs, seed)

    def one_card():
        with jax.default_device(devices[0]):
            venv = VectorBiddingEnv(cfg, num_envs, table=table)
            state, _ = venv.reset(jax.random.PRNGKey(seed))
            b, bud = jax.device_put((bids, budget), devices[0])
            out = []
            for _ in range(steps):
                state, ts = venv.step(state, b, bud)
                out.append(jax.device_get((state, ts)))
            return out

    def sharded():
        venv = sharded_vector_env(cfg, num_envs, mesh=make_env_mesh(devices), table=table)
        state, _ = venv.reset(jax.random.PRNGKey(seed))
        out = []
        for _ in range(steps):
            state, ts = venv.step(state, bids, budget)
            check(len(ts.reward.sharding.device_set) == len(devices), "not sharded")
            out.append(jax.device_get((state, ts)))
        return out

    ones, shards = _in_threads([one_card, sharded])
    for day, (a, b) in enumerate(zip(ones, shards), start=1):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            check(np.array_equal(x, y), f"day {day}: sharded differs from one card")
        check_days(b[1], budget, day, cfg)
    return {"devices": len(devices), "envs": num_envs, "days": steps,
            "bit_identical": True}


# One PPO step, sharded vs one card, both with "highest" matmul precision
# (so no TF32): the env rollout inside the step is exact per env, but the
# learner's gradient means sum the minibatch in another order across
# shards (an all-reduce of per-shard partial sums), so parameters and
# losses agree to float32 rounding carried through 16 Adam updates.
PPO_SHARD_RTOL, PPO_SHARD_ATOL = 1e-3, 1e-5


def phase_sharded_ppo(devices, envs_per_device: int, num_keywords: int,
                      ppo_cfg: PPOConfig = PPOConfig(), seed: int = 7) -> dict:
    from jax.sharding import NamedSharding, PartitionSpec as P

    cfg = bench_cfg(num_keywords=num_keywords)
    num_envs = envs_per_device * len(devices)
    trainer = PPOTrainer(cfg, num_envs, ppo_cfg, table=simple_experiment_table(128, 0.8))
    mesh = make_env_mesh(devices)
    env_sh, repl = NamedSharding(mesh, P("envs")), NamedSharding(mesh, P())
    step = jax.jit(trainer.train_step)
    with jax.default_device(devices[0]):
        state = trainer.init(jax.random.PRNGKey(seed))
    state = jax.device_put(state, devices[0])

    def one_card():
        with jax.default_matmul_precision("highest"):
            return jax.device_get(step(state))

    def sharded():
        placed = state._replace(
            env_state=jax.device_put(state.env_state, env_sh),
            last_obs=jax.device_put(state.last_obs, env_sh),
            params=jax.device_put(state.params, repl),
            opt_state=jax.device_put(state.opt_state, repl),
            key=jax.device_put(state.key, repl),
            step=jax.device_put(state.step, repl),
        )
        with jax.default_matmul_precision("highest"):
            out, metrics = step(placed)
        check(len(out.env_state.day.sharding.device_set) == len(devices),
              "env state not sharded")
        return jax.device_get((out, metrics))

    (one, m_one), (four, m_four) = _in_threads([one_card, sharded])
    for name in ("loss", "pg_loss", "vf_loss", "mean_reward"):
        np.testing.assert_allclose(m_four[name], m_one[name], rtol=PPO_SHARD_RTOL,
                                   atol=PPO_SHARD_ATOL, err_msg=name)
    for x, y in zip(jax.tree.leaves(four.params), jax.tree.leaves(one.params)):
        np.testing.assert_allclose(x, y, rtol=PPO_SHARD_RTOL, atol=PPO_SHARD_ATOL)
    check(_all_finite(four.params), "non-finite parameters")
    env_equal = all(np.array_equal(x, y) for x, y in
                    zip(jax.tree.leaves(four.env_state), jax.tree.leaves(one.env_state)))
    return {"devices": len(devices), "envs": num_envs,
            "loss": [float(m_one["loss"]), float(m_four["loss"])],
            "env_state_bit_identical": env_equal}


# ---------------------------------------------------------------------------


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--chips", type=int, choices=(1, 4), default=1)
    args = ap.parse_args(argv)

    require_gpu()
    log(f"card: {nvidia_smi_name_power()}")
    log(f"jax {jax.__version__}")
    log(f"compile cache: {enable_compile_cache()}")
    devices = jax.devices()
    if args.chips == 4:
        check(len(devices) >= 4, f"--chips 4 needs 4 GPUs, JAX sees {len(devices)}")
        devices = devices[:4]
        run_phase("sharded env 16384x100 vs one card", phase_sharded_env,
                  devices, 16384, 100)
        run_phase("sharded PPO step vs one card", phase_sharded_ppo, devices, 4096, 100)
    else:
        envs, kws = 4096, 100
        run_phase("1 main env path", phase_main_env, envs, kws)
        run_group("2 other configs", phase_other_config,
                  [(*c, envs) for c in other_configs(kws)])
        run_group("3a oracle parity", phase_oracle_parity,
                  [(m, 8, kws, 576) for m in MODELS])
        run_group("3b fast vs parity", phase_fast_vs_parity,
                  [(m, envs, kws, 576) for m in MODELS])
        run_phase("3c pool moments", phase_pool_moments, 4096)
        run_phase("4 PPO", phase_ppo, envs, kws)
    dev = jax.devices()[0]
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices())}}))


if __name__ == "__main__":
    main()
