"""Manual step-by-step reconstruction of one day of bidding.

Script version of the reference's appendix notebook
(adcraft/appendix_bidding_outcomes_example/manual_bidding_example.ipynb,
paper Appendix F): build a tiny env, run one day, then reconstruct the
outcome quantities from the draw table by hand to show exactly how
impressions, clicks, costs, conversions, revenues, and profit compose.

Run: JAX_PLATFORMS=cpu python examples/manual_bidding_example.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.keywords import make_keyword_state
from adcraft_tpu.oracle import simulate_day_numpy
from adcraft_tpu.step import sample_day_draws, simulate_day


def main() -> None:
    cfg = EnvConfig(
        num_keywords=2,
        kind=KeywordKind.IMPLICIT,
        max_volume=48,
        timesteps_per_day=4,  # few sub-timesteps so the table is readable
    )
    kw = make_keyword_state(
        2,
        vol_mean=[20.0, 12.0],
        vol_std=[2.0, 1.0],
        bctr=[0.6, 0.4],
        sctr=[0.5, 0.7],
        rev_mean=[1.2, 0.9],
        rev_std=[0.2, 0.1],
        bid_loc=[0.4, 0.3],
        bid_scale=[0.15, 0.1],
        max_bidders=1,
        participation_rate=1.0,
    )
    bids = jnp.asarray([0.8, 0.5])
    budget = 6.0
    key = jax.random.PRNGKey(42)

    print("== fused kernel ==")
    day = simulate_day(cfg, key, kw, bids, jnp.asarray(budget, jnp.float32))
    for f in ("volume", "impressions", "buyside_clicks", "cost",
              "sellside_conversions", "revenue", "profit"):
        print(f"  {f:22s} {np.asarray(getattr(day, f))}")

    print("\n== manual reconstruction from the draw table ==")
    draws = sample_day_draws(cfg, key, kw, bids)
    print("  daily volumes:", draws["volume"])
    print("  per-sub-timestep auction counts (first gets the remainder):")
    from adcraft_tpu.step import split_volume

    print(np.asarray(split_volume(cfg, jnp.asarray(draws["volume"]))))
    print("  won auctions per (t, kw):\n", draws["impressions"])
    print("  clicked candidates per (t, kw):\n", draws["n_clicks"])
    b = budget
    print(f"  walking the shared budget (start {b:.2f}):")
    for t in range(cfg.timesteps_per_day):
        for k in range(cfg.num_keywords):
            nc = int(draws["n_clicks"][t, k])
            costs = draws["costs"][t, k, :nc]
            prefix = np.cumsum(np.round(costs * 100).astype(int))
            acc = int(np.sum(prefix <= round(b * 100)))
            spend = prefix[acc - 1] / 100 if acc else 0.0
            b -= spend
            convs = int(np.sum(draws["conv_flags"][t, k, :acc]))
            rev = float(np.sum(np.round(draws["revs"][t, k, :convs] * 100)) / 100)
            print(
                f"    t={t} kw={k}: clicks {nc} -> accepted {acc}, "
                f"spend {spend:.2f}, convs {convs}, revenue {rev:.2f}, "
                f"budget left {b:.2f}"
            )

    oracle = simulate_day_numpy(
        np.asarray(bids), budget, draws, timesteps=cfg.timesteps_per_day
    )
    print("\n== oracle check (must equal the kernel) ==")
    for f in ("impressions", "buyside_clicks", "cost",
              "sellside_conversions", "revenue", "profit"):
        kernel_v = np.asarray(getattr(day, f))
        print(f"  {f:22s} {oracle[f]}  match={np.allclose(kernel_v, oracle[f], atol=1e-4)}")


if __name__ == "__main__":
    main()
