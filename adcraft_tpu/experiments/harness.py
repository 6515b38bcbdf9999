"""Sparsity heatmap experiment harness.

Replaces the reference's notebook runner
(adcraft/baseline_experiment_and_figs_notebooks/run_heatmap_experiments.ipynb):
sweep (mean_volume x conversion_rate) grids with the NaiveZeroMargin
baseline agent over env-seed x agent-seed repetitions, record per-day
per-keyword profits and oracle ideal profits, and save npz files in the
reference's ``{env_seed}_{agent_seed}.npz`` format (kw_profits,
ideal_profits). Resumable by filename scan, like the notebook's cell 3.

Difference from the reference: all (env_seed, agent_seed) repetitions of a grid
point run as one vectorized batch — a whole sweep cell is a single jit
rollout instead of 16 sequential 25-45s episodes.
"""

from __future__ import annotations

import itertools
import os
from pathlib import Path
from typing import Dict, Iterable, Optional

import jax
import jax.numpy as jnp
import numpy as np

from adcraft_tpu import metrics as M
from adcraft_tpu.baselines import (
    NaiveInterpolationStrategy,
    NaiveZeroMarginStrategy,
)
from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.env import env_reset, env_step
from adcraft_tpu.keywords import sample_implicit_keywords
from adcraft_tpu.quantiles import simple_experiment_table

BID_GRID = np.arange(0.01, 3.01, 0.01)  # oracle curve grid (notebook cell 3)


def run_episode_batch(
    cfg: EnvConfig,
    table,
    env_seeds: Iterable[int],
    agent_seeds: Iterable[int],
    num_days: Optional[int] = None,
    agent: str = "zero_margin",
    updater_mask=None,
) -> Dict[str, np.ndarray]:
    """Run |env_seeds| x |agent_seeds| episodes in one vectorized rollout.

    ``agent`` selects the baseline: "zero_margin" (the agent behind every
    reference heatmap figure) or "interpolation"
    (NaiveInterpolationStrategy, interpolated_expectations.py:298-439).
    ``updater_mask`` (per-keyword bools) makes masked keywords drift each
    day — the reference's non-stationary configs pass all-True
    (experiment_configs.py:60-82); per-day ideal profits are recomputed
    from the drifted keyword state, like the notebook's oracle loop.
    Returns kw_profits and ideal_profits of shape (B, T, K) where B is the
    seed-pair batch, plus the seed pairs.
    """
    pairs = list(itertools.product(env_seeds, agent_seeds))
    B = len(pairs)
    K = cfg.num_keywords
    T = num_days or cfg.max_days
    if agent == "zero_margin":
        agent = NaiveZeroMarginStrategy(K)
    elif agent == "interpolation":
        agent = NaiveInterpolationStrategy(K)
    elif isinstance(agent, str):
        raise ValueError(f"unknown agent {agent!r}")

    env_keys = jnp.stack(
        [jax.random.PRNGKey(int(es)) for es, _ in pairs]
    )
    agent_keys = jnp.stack(
        [jax.random.PRNGKey(10_000 + int(asd)) for _, asd in pairs]
    )

    def init_one(env_key):
        kw = sample_implicit_keywords(
            env_key, K, table, updater_mask=updater_mask
        )
        state, _ = env_reset(cfg, jax.random.fold_in(env_key, 1), kw=kw)
        # oracle ideal profit per keyword for this env's keywords
        # (experiment_metrics.py:20-61; per-step ideal is constant given
        # the kw params in stationary configs, recomputed per day for
        # non-stationary ones below)
        return state

    def ideal_profits_of(kw, key):
        win_rate, exp_cpc = M.implicit_kw_bid_curves(
            kw, jnp.asarray(BID_GRID), key
        )
        best, _, _ = M.max_expected_bid_profits(
            kw.vol_mean, kw.bctr, kw.sctr, kw.rev_mean, exp_cpc, win_rate
        )
        return best

    def rollout(env_key, agent_key):
        state = init_one(env_key)
        astate = agent.init()

        def day(carry, i):
            state, astate, k = carry
            k, k_act = jax.random.split(k)
            astate, action = agent.act(astate, k_act)
            ideal = ideal_profits_of(state.kw, jax.random.fold_in(env_key, 100 + i))
            state, ts = env_step(
                cfg, state, action["keyword_bids"], action["budget"]
            )
            astate = agent.update(astate, action["keyword_bids"], ts.obs)
            return (state, astate, k), (ts.outcomes.profit, ideal)

        (_, _, _), (profits, ideals) = jax.lax.scan(
            day, (state, astate, agent_key), jnp.arange(T)
        )
        return profits, ideals  # (T, K) each

    profits, ideals = jax.jit(jax.vmap(rollout))(env_keys, agent_keys)
    return {
        "kw_profits": np.asarray(profits),
        "ideal_profits": np.asarray(ideals),
        "pairs": np.asarray(pairs),
    }


def run_sparsity_experiments(
    out_dir: str,
    mean_volumes: Iterable[float] = tuple(2.0**p for p in range(11)),
    cvrs: Iterable[float] = tuple(np.linspace(0.01, 1.0, 10)),
    env_seeds: Iterable[int] = (5, 6, 7, 8),
    agent_seeds: Iterable[int] = (0, 1, 2, 3),
    num_keywords: int = 100,
    max_days: int = 60,
    verbose: bool = True,
    agent: str = "zero_margin",
    updater_mask=None,
) -> None:
    """Full vol x cvr sweep, npz-per-(cell, seed-pair), resumable.

    Output layout matches run_heatmap_experiments.ipynb cell 3: one
    directory per grid cell, files ``{env_seed}_{agent_seed}.npz``
    containing kw_profits and ideal_profits. ``updater_mask`` runs the
    sweep with non-stationary (drifting) keywords, like the reference's
    non-stationary experiment configs.
    """
    for vol, cvr in itertools.product(mean_volumes, cvrs):
        cell_dir = Path(out_dir) / f"vol_{vol:g}_cvr_{cvr:.2f}"
        cell_dir.mkdir(parents=True, exist_ok=True)
        todo = [
            (es, asd)
            for es in env_seeds
            for asd in agent_seeds
            if not (cell_dir / f"{es}_{asd}.npz").exists()
        ]
        if not todo:
            continue
        cfg = EnvConfig(
            num_keywords=num_keywords,
            max_days=max_days,
            kind=KeywordKind.IMPLICIT,
            max_volume=int(max(32, 4 * vol + 64)),
        )
        table = simple_experiment_table(vol, cvr)
        out = run_episode_batch(
            cfg,
            table,
            env_seeds=sorted({es for es, _ in todo}),
            agent_seeds=sorted({a for _, a in todo}),
            agent=agent,
            updater_mask=updater_mask,
        )
        for i, (es, asd) in enumerate(out["pairs"]):
            np.savez(
                cell_dir / f"{es}_{asd}.npz",
                kw_profits=out["kw_profits"][i],
                ideal_profits=out["ideal_profits"][i],
            )
        if verbose:
            print(f"cell vol={vol:g} cvr={cvr:.2f}: {len(out['pairs'])} runs saved")


def summarize_cell(cell_dir: str) -> Dict[str, float]:
    """AKNCP/NCP over all npz runs in a cell (figs notebook cells 2, 6)."""
    akncp, ncp = [], []
    for f in sorted(Path(cell_dir).glob("*.npz")):
        d = np.load(f)
        akncp.append(float(M.compute_AKNCP(d["kw_profits"], d["ideal_profits"])))
        ncp.append(float(M.compute_NCP(d["kw_profits"], d["ideal_profits"])))
    return {
        "AKNCP": float(np.mean(akncp)),
        "NCP": float(np.mean(ncp)),
        "runs": len(akncp),
    }
