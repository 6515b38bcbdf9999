"""Distributional parity: closed-form JAX kernels vs literal simulation.

The fused kernel replaces the reference's literal nth-price auction with
exact sufficient statistics (adcraft_tpu.auction). These tests verify the
reduction empirically: a seeded literal simulation in the reference's own
style (materialized competitor bids, sorting, per-auction searchsorted —
``NumpyOracleEnv``) must match the vectorized env in distribution on
every observable.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adcraft_tpu.config import CompetitorModel, EnvConfig, KeywordKind
from adcraft_tpu.env import env_reset, env_step
from adcraft_tpu.keywords import make_keyword_state
from adcraft_tpu.oracle import NumpyOracleEnv
from adcraft_tpu.oracle.numpy_env import OracleKeyword, nth_price_auction_numpy

KW_ARGS = dict(
    vol_mean=[40.0, 24.0, 60.0, 12.0],
    vol_std=[4.0, 2.0, 5.0, 1.0],
    bctr=[0.5, 0.3, 0.7, 0.4],
    sctr=[0.5, 0.6, 0.3, 0.8],
    rev_mean=[1.0, 0.8, 1.2, 0.6],
    rev_std=[0.2, 0.1, 0.3, 0.05],
)
BIDS = np.asarray([0.6, 0.4, 0.9, 0.3])
DAYS = 6


def _jax_stats(cfg, kw, num_envs=384, budget=1e6):
    """Per-keyword daily means over a big vectorized batch."""
    def one(key):
        state, _ = env_reset(cfg, key, kw=kw)
        def day(s, _):
            s, ts = env_step(cfg, s, jnp.asarray(BIDS), jnp.asarray(budget))
            return s, ts.outcomes
        _, outs = jax.lax.scan(day, state, None, length=DAYS)
        return outs
    keys = jax.random.split(jax.random.PRNGKey(0), num_envs)
    outs = jax.jit(jax.vmap(one))(keys)
    return {
        "impressions": np.asarray(outs.impressions, float).mean(axis=(0, 1)),
        "clicks": np.asarray(outs.buyside_clicks, float).mean(axis=(0, 1)),
        "convs": np.asarray(outs.sellside_conversions, float).mean(axis=(0, 1)),
        "cost": np.asarray(outs.cost).mean(axis=(0, 1)),
        "revenue": np.asarray(outs.revenue).mean(axis=(0, 1)),
        "volume": np.asarray(outs.volume, float).mean(axis=(0, 1)),
    }


def _oracle_stats(kws, num_episodes=60, budget=1e6):
    acc = {k: [] for k in ("impressions", "clicks", "convs", "cost", "revenue", "volume")}
    for ep in range(num_episodes):
        env = NumpyOracleEnv(
            [OracleKeyword(**kw) for kw in kws],
            budget=budget,
            max_days=DAYS,
            seed=1000 + ep,
        )
        for _ in range(DAYS):
            out = env.step(BIDS, budget=budget)
            acc["impressions"].append(out["obs"]["impressions"])
            acc["clicks"].append(out["obs"]["buyside_clicks"])
            acc["convs"].append(out["obs"]["sellside_conversions"])
            acc["cost"].append(out["obs"]["cost"])
            acc["revenue"].append(out["obs"]["revenue"])
            acc["volume"].append(out["volume"])
    return {k: np.mean(np.asarray(v, float), axis=0) for k, v in acc.items()}


def _compare(jx, orc, rtol=0.08, atol=0.35):
    for field in jx:
        np.testing.assert_allclose(
            jx[field], orc[field], rtol=rtol, atol=atol,
            err_msg=f"distributional mismatch in {field}: jax={jx[field]} oracle={orc[field]}",
        )


@pytest.mark.parity
def test_implicit_single_distributional_parity():
    kw = make_keyword_state(
        4, **KW_ARGS,
        bid_loc=[0.4, 0.3, 0.6, 0.2], bid_scale=[0.15, 0.1, 0.2, 0.08],
        max_bidders=1, participation_rate=1.0,
    )
    cfg = EnvConfig(
        num_keywords=4, kind=KeywordKind.IMPLICIT,
        competitor_model=CompetitorModel.SINGLE_ABS_CENTS,
        max_volume=128, max_days=DAYS,
    )
    oracle_kws = [
        dict(
            vol_mean=KW_ARGS["vol_mean"][i], vol_std=KW_ARGS["vol_std"][i],
            bctr=KW_ARGS["bctr"][i], sctr=KW_ARGS["sctr"][i],
            rev_mean=KW_ARGS["rev_mean"][i], rev_std=KW_ARGS["rev_std"][i],
            explicit=False, single_competitor=True,
            bid_loc=[0.4, 0.3, 0.6, 0.2][i], bid_scale=[0.15, 0.1, 0.2, 0.08][i],
        )
        for i in range(4)
    ]
    _compare(_jax_stats(cfg, kw), _oracle_stats(oracle_kws))


@pytest.mark.parity
def test_explicit_distributional_parity():
    kw = make_keyword_state(
        4, **KW_ARGS,
        imp_thresh=0.05, imp_intercept=[0.3, 0.6, 0.2, 0.8],
        imp_slope=[5.0, 8.0, 4.0, 10.0],
    )
    cfg = EnvConfig(
        num_keywords=4, kind=KeywordKind.EXPLICIT, max_volume=128, max_days=DAYS
    )
    oracle_kws = [
        dict(
            vol_mean=KW_ARGS["vol_mean"][i], vol_std=KW_ARGS["vol_std"][i],
            bctr=KW_ARGS["bctr"][i], sctr=KW_ARGS["sctr"][i],
            rev_mean=KW_ARGS["rev_mean"][i], rev_std=KW_ARGS["rev_std"][i],
            explicit=True, imp_thresh=0.05,
            imp_intercept=[0.3, 0.6, 0.2, 0.8][i], imp_slope=[5.0, 8.0, 4.0, 10.0][i],
        )
        for i in range(4)
    ]
    # explicit cost draws are continuous (~2.4 each) so costs are larger;
    # loosen atol for the cost/revenue channels via rtol dominance
    _compare(_jax_stats(cfg, kw), _oracle_stats(oracle_kws), rtol=0.08, atol=0.6)


@pytest.mark.parity
def test_pool_distributional_parity():
    kw = make_keyword_state(
        4, **KW_ARGS,
        bid_loc=0.0, bid_scale=0.1, max_bidders=30, participation_rate=0.6,
    )
    cfg = EnvConfig(
        num_keywords=4, kind=KeywordKind.IMPLICIT,
        competitor_model=CompetitorModel.BINOMIAL_POOL,
        max_volume=128, max_days=DAYS,
    )
    oracle_kws = [
        dict(
            vol_mean=KW_ARGS["vol_mean"][i], vol_std=KW_ARGS["vol_std"][i],
            bctr=KW_ARGS["bctr"][i], sctr=KW_ARGS["sctr"][i],
            rev_mean=KW_ARGS["rev_mean"][i], rev_std=KW_ARGS["rev_std"][i],
            explicit=False, single_competitor=False,
            bid_loc=0.0, bid_scale=0.1, max_bidders=30, participation_rate=0.6,
        )
        for i in range(4)
    ]
    _compare(_jax_stats(cfg, kw), _oracle_stats(oracle_kws))


@pytest.mark.unit
def test_literal_auction_semantics():
    """Sanity-pin the literal auction the oracle uses: win iff bid beats
    every competitor (and 0), pay the top competitor bid (floored at 0
    when fewer than 3 bidders due to zero padding)."""
    other = np.asarray([[0.5, 0.3], [0.9, 0.2], [0.1, 0.05]])
    imp, places, costs = nth_price_auction_numpy(0.6, other, n=2, num_winners=1)
    assert imp == 2
    np.testing.assert_allclose(costs, [0.5, 0.1])
    np.testing.assert_array_equal(places, [0, 0])
    # tie does not win (strict searchsorted-left semantics)
    imp, _, _ = nth_price_auction_numpy(0.5, np.asarray([[0.5]]), 2, 1)
    assert imp == 0
    # negative competitor bids: cost floored at 0 via padding
    imp, _, costs = nth_price_auction_numpy(0.5, np.asarray([[-0.3]]), 2, 1)
    assert imp == 1 and costs[0] == 0.0

@pytest.mark.unit
def test_nth_price_auction_device_matches_numpy_oracle():
    """The device-path general nth-price auction (arbitrary n,
    multi-winner, placements; adcraft_tpu.auction.nth_price_auction_device)
    must reproduce the numpy oracle's ragged outputs exactly — including
    the zero-padding of short auctions, strict-tie losses, and the n=1
    pay-your-own-bid rule (reference synthetic_kw_helpers.py:116-180)."""
    from adcraft_tpu.auction import nth_price_auction_device

    rng = np.random.default_rng(7)
    cases = [
        # (num_bidders, n, num_winners) incl. num_bidders < n + winners
        (8, 2, 1), (8, 1, 1), (8, 3, 2), (8, 2, 4), (2, 3, 2), (1, 2, 2),
        (5, 1, 3), (30, 2, 1),
    ]
    for nb, n, w in cases:
        for trial in range(4):
            a = 17
            other = np.round(rng.laplace(0.0, 0.4, (a, nb)), 2)
            bid = float(np.round(abs(rng.laplace(0.0, 0.5)) + 0.01, 2))
            ri, rp, rc = nth_price_auction_numpy(bid, other, n=n, num_winners=w)
            di, won, dp, dc = jax.tree.map(
                np.asarray,
                nth_price_auction_device(bid, jnp.asarray(other), n=n,
                                         num_winners=w),
            )
            msg = f"nb={nb} n={n} w={w} trial={trial}"
            assert int(di) == ri, msg
            assert int(won.sum()) == ri, msg
            np.testing.assert_array_equal(dp[won], rp, err_msg=msg)
            np.testing.assert_allclose(dc[won], rc, rtol=1e-6, err_msg=msg)
    # exact ties lose (searchsorted-left strictness)
    di, won, _, _ = nth_price_auction_device(
        0.5, jnp.asarray([[0.5, 0.1]]), n=2, num_winners=1
    )
    assert int(di) == 0


@pytest.mark.unit
def test_implicit_pool_auction_general_device():
    """Keyed pool-model general auction: distributional + structural
    checks. Win rate must match the closed-form pool reduction's
    F(bid)^k; zero-participation auctions win at zero cost via the
    reference's zero-padding quirk; placements stay in range."""
    from adcraft_tpu.auction import implicit_pool_auction_general
    from adcraft_tpu.distributions import laplace_cdf

    key = jax.random.PRNGKey(3)
    bid, loc, scale, bmax, rate = 0.35, 0.0, 0.1, 30, 0.6
    imp, won, places, costs = jax.tree.map(
        np.asarray,
        implicit_pool_auction_general(
            key, bid, 4096, loc, scale, jnp.asarray(bmax),
            jnp.asarray(rate), n=2, num_winners=1,
        ),
    )
    assert int(imp) == int(won.sum())
    assert places.max() <= 0 and costs[won].min() >= 0.0
    assert np.all(costs[won] <= bid)
    # k is drawn once per call (reference quirk); win prob = F(bid)^k
    k_bidders = jax.random.split(key)[0]
    from adcraft_tpu import distributions as dist

    kk = int(dist.binomial(k_bidders, jnp.asarray(bmax), jnp.asarray(rate)))
    p_win = float(laplace_cdf(jnp.asarray(bid), loc, scale)) ** kk
    se = (p_win * (1 - p_win) / 4096) ** 0.5
    assert abs(won.mean() - p_win) < 5 * se + 1e-3
    # zero participation -> all-zero padding -> win at cost 0
    imp0, won0, pl0, c0 = jax.tree.map(
        np.asarray,
        implicit_pool_auction_general(
            key, 0.25, 64, loc, scale, jnp.asarray(bmax),
            jnp.asarray(0.0), n=2, num_winners=1,
        ),
    )
    assert int(imp0) == 64 and np.all(c0 == 0.0) and np.all(pl0 == 0)


@pytest.mark.unit
def test_keyword_drift_matches_oracle_distribution():
    """Non-stationary drift parity (VERDICT r2 item 5): 20 drifted days of
    the vectorized ``update_keywords`` must match the oracle's
    ``_update_keywords`` (reference gymnasium_kw_env.py:114-158 semantics:
    vol_mean += U(-s, s) * drift_ref clipped >= 0; ctr/cvr *= 1 + U(-s, s)
    clipped to [0, 1]) in distribution across replicas."""
    from adcraft_tpu.step import update_keywords

    K, DRIFT_DAYS, REPS = 4, 20, 300
    cfg = EnvConfig(num_keywords=K, kind=KeywordKind.IMPLICIT)
    kw = make_keyword_state(
        K,
        **KW_ARGS,
        bid_loc=[0.0] * K,
        bid_scale=[0.1] * K,
        max_bidders=1,
        participation_rate=1.0,
        updater_mask=[True, True, True, False],  # one keyword frozen
    )

    def drift_chain(key):
        def body(s, k):
            return update_keywords(cfg, k, s), None

        out, _ = jax.lax.scan(body, kw, jax.random.split(key, DRIFT_DAYS))
        return out.vol_mean, out.bctr, out.sctr

    keys = jax.random.split(jax.random.PRNGKey(123), REPS)
    jv, jb, js = jax.jit(jax.vmap(drift_chain))(keys)
    jv, jb, js = np.asarray(jv), np.asarray(jb), np.asarray(js)

    ov = np.zeros((REPS, K))
    ob = np.zeros((REPS, K))
    os_ = np.zeros((REPS, K))
    for r in range(REPS):
        env = NumpyOracleEnv(
            [
                OracleKeyword(
                    vol_mean=KW_ARGS["vol_mean"][i],
                    vol_std=KW_ARGS["vol_std"][i],
                    bctr=KW_ARGS["bctr"][i],
                    sctr=KW_ARGS["sctr"][i],
                    rev_mean=KW_ARGS["rev_mean"][i],
                    rev_std=KW_ARGS["rev_std"][i],
                )
                for i in range(K)
            ],
            seed=1000 + r,
            updater_mask=[True, True, True, False],
        )
        for _ in range(DRIFT_DAYS):
            env._update_keywords()
        ov[r] = [k.vol_mean for k in env.keywords]
        ob[r] = [k.bctr for k in env.keywords]
        os_[r] = [k.sctr for k in env.keywords]

    # the frozen keyword never moves, bit-exactly, on both paths
    np.testing.assert_array_equal(jv[:, 3], KW_ARGS["vol_mean"][3])
    np.testing.assert_array_equal(ov[:, 3], KW_ARGS["vol_mean"][3])
    # drifted keywords match in distribution (cross-replica mean and std)
    np.testing.assert_allclose(jv[:, :3].mean(0), ov[:, :3].mean(0), rtol=0.02)
    np.testing.assert_allclose(
        jv[:, :3].std(0), ov[:, :3].std(0), rtol=0.25, atol=0.05
    )
    np.testing.assert_allclose(jb[:, :3].mean(0), ob[:, :3].mean(0), rtol=0.02)
    np.testing.assert_allclose(js[:, :3].mean(0), os_[:, :3].mean(0), rtol=0.02)
