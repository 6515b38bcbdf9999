"""End-to-end AKNCP / NCP computation example.

Script version of the reference's metrics notebook
(adcraft/experiment_utils/example_compute_metrics.ipynb): build an env
from quantiles, roll out a constant-bid policy, compute oracle curves and
the AKNCP/NCP metrics.

Run: JAX_PLATFORMS=cpu python examples/compute_metrics_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from adcraft_tpu import metrics as M
from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.env import env_reset, env_step
from adcraft_tpu.keywords import sample_implicit_keywords
from adcraft_tpu.quantiles import simple_experiment_table


def main() -> None:
    cfg = EnvConfig(
        num_keywords=20, kind=KeywordKind.IMPLICIT, max_volume=576, max_days=30
    )
    table = simple_experiment_table(mean_volume=128, cvr=0.8)
    key = jax.random.PRNGKey(0)

    kw = sample_implicit_keywords(key, cfg.num_keywords, table)
    state, _ = env_reset(cfg, jax.random.fold_in(key, 1), kw=kw)

    # oracle curves: win rate and conditional second price per bid
    bid_grid = jnp.arange(0.01, 3.01, 0.01)
    win, cpc = M.implicit_kw_bid_curves(kw, bid_grid, jax.random.fold_in(key, 2))
    ideal, pos_share, best_idx = M.max_expected_bid_profits(
        kw.vol_mean, kw.bctr, kw.sctr, kw.rev_mean, cpc, win
    )
    print("per-keyword max expected daily profit (oracle):")
    print("  ", np.round(np.asarray(ideal), 2))
    print("optimal bids:", np.round(np.asarray(bid_grid)[np.asarray(best_idx)], 2))

    # constant-bid rollout
    bids = jnp.full((cfg.num_keywords,), 1.0)
    profits = []
    for _ in range(cfg.max_days):
        state, ts = env_step(cfg, state, bids, jnp.asarray(1000.0))
        profits.append(np.asarray(ts.outcomes.profit))
    profits = np.stack(profits)  # (T, K)
    ideal_t = np.broadcast_to(np.asarray(ideal), profits.shape)

    print(f"\nconstant $1 bids over {cfg.max_days} days:")
    print(f"  total profit  {profits.sum():10.2f}")
    print(f"  AKNCP         {float(M.compute_AKNCP(profits, ideal_t)):10.4f}")
    print(f"  NCP           {float(M.compute_NCP(profits, ideal_t)):10.4f}")


if __name__ == "__main__":
    main()
