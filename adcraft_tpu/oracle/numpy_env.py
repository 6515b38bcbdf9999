"""Pure-numpy reference-parity oracle.

The reference cannot be reproduced bit-exactly as published: its Rust
kernels draw from an unseeded ``thread_rng()`` (src/lib.rs:25,44,61,75,320),
so explicit impressions, cost draws, and volume draws differ run to run
even under a fixed env seed. This module is the parity anchor instead
(SURVEY.md §7 step 4): a fully seeded, loop-level reimplementation of the
reference *semantics*.

Two layers:

* ``simulate_day_numpy`` — the reference's campaign-day control flow
  (sub-timestep x keyword loops, shared depleting budget, per-click budget
  break) executed on an *injected draw table*. Driving it with the exact
  draws the fused JAX kernel generates must reproduce the kernel's outputs
  bit-for-bit; this pins down every piece of deterministic logic (gating,
  breaks, accounting, observation assembly).

* ``NumpyOracleEnv`` — a literal, seeded simulation in the reference's own
  style: competitor bids materialized per auction, an honest nth-price
  auction with sorting and padding (semantics of
  adcraft/synthetic_kw_helpers.py:116-180), per-impression click loops.
  Used for *distributional* parity: the closed-form JAX kernels must match
  this literal simulation in distribution.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np


# ---------------------------------------------------------------------------
# literal nth-price auction (semantics of synthetic_kw_helpers.py:116-180)
# ---------------------------------------------------------------------------


def nth_price_auction_numpy(
    bid: float, other_bids: np.ndarray, n: int = 2, num_winners: int = 1
) -> Tuple[int, np.ndarray, np.ndarray]:
    """Literal nth-price auction over (num_auctions, num_bidders) bids.

    Semantics: per auction, keep the top (num_winners + n) competitor bids
    (zero-padded when there are fewer bidders); our bid's insertion index
    (left searchsorted = count of strictly smaller entries) must exceed n
    to win; a winner in place p pays the entry (n-1) positions below.
    """
    num_auctions, n_bidders = other_bids.shape
    width = num_winners + n
    if n_bidders >= width:
        top = np.sort(np.partition(other_bids, -width, axis=1)[:, -width:], axis=1)
    else:
        pad = np.zeros((num_auctions, width - n_bidders))
        top = np.sort(np.hstack([pad, other_bids]), axis=1)

    impressions = 0
    placements: List[int] = []
    costs: List[float] = []
    for row in top:
        idx = int(np.searchsorted(row, bid))
        if idx > n:
            impressions += 1
            placements.append(width - idx)
            if n > 1:
                costs.append(row[max(idx - (n - 1), 0)])
            else:
                costs.append(bid)
    return impressions, np.asarray(placements), np.asarray(costs)


# ---------------------------------------------------------------------------
# injected-draw day simulation (logic-parity layer)
# ---------------------------------------------------------------------------


def split_volume_numpy(volume: np.ndarray, timesteps: int) -> np.ndarray:
    """(K,) volumes -> (T, K) auction counts (bidding_simulation.py:151-167)."""
    per = volume // timesteps
    first = volume - (timesteps - 1) * per
    return np.vstack([first] + [per] * (timesteps - 1))


def simulate_day_numpy(
    bids: np.ndarray,
    budget: float,
    draws: Dict[str, np.ndarray],
    timesteps: int = 24,
    cents: bool = True,
) -> Dict[str, np.ndarray]:
    """Run one campaign day from an injected draw table.

    ``draws`` fields (T = timesteps, K keywords, M click-buffer):
      volume (K,) int   — daily volume per keyword
      impressions (T, K) int — auctions won per cell (pre-gating)
      n_clicks (T, K) int — clicked candidates per cell (pre-budget)
      costs (T, K, M) float — i.i.d. cost-per-click draws
      conv_flags (T, K, M) bool — per-accepted-click conversion coinflips
      revs (T, K, M) float — i.i.d. per-conversion revenue draws

    Control flow mirrors ``simulate_epoch_of_bidding_on_campaign``
    (bidding_simulation.py:170-234): keywords iterated in order inside each
    sub-timestep, shared budget, break-both-loops when it hits zero; a
    keyword's clicks are accepted while each running cost sum stays within
    the budget the keyword started with (bidding_simulation.py:97-104).

    ``cents=True`` gates and accounts in exact integer cents (the parity
    contract for cent-quantized cost models, see EnvConfig.cents_costs);
    otherwise gating runs in float64. Revenue is always cent-quantized.
    """
    T, K = draws["impressions"].shape
    out = {
        "impressions": np.zeros(K, np.int64),
        "buyside_clicks": np.zeros(K, np.int64),
        "cost": np.zeros(K, np.float64),
        "sellside_conversions": np.zeros(K, np.int64),
        "revenue": np.zeros(K, np.float64),
        "eligible_volume": np.zeros(K, np.int64),
    }
    n_auctions = split_volume_numpy(draws["volume"], timesteps)
    cost_cents = np.zeros(K, np.int64)
    rev_cents = np.zeros(K, np.int64)
    if cents:
        b = int(np.round(float(budget) * 100))
        costs_all = np.round(draws["costs"] * 100.0).astype(np.int64)
    else:
        b = float(budget)
        costs_all = draws["costs"].astype(np.float64)
    revs_all = np.round(draws["revs"] * 100.0).astype(np.int64)
    broken = False
    for t in range(T):
        if broken:
            break
        for k in range(K):
            imp = int(draws["impressions"][t, k])
            n_clicks = int(draws["n_clicks"][t, k])
            # accept the maximal prefix of clicked costs whose running sums
            # all stay within the keyword's starting budget — identical to
            # the reference's click loop with break-at-first-overspend
            # (bidding_simulation.py:97-104)
            accepted = 0
            spend = 0 if cents else 0.0
            prefix = np.cumsum(costs_all[t, k, :n_clicks])
            for j in range(n_clicks):
                if prefix[j] <= b:
                    accepted += 1
                    spend = prefix[j]
                else:
                    break
            b -= spend
            n_conv = int(np.sum(draws["conv_flags"][t, k, :accepted]))
            revenue_c = int(np.sum(revs_all[t, k, :n_conv]))

            out["impressions"][k] += imp
            out["buyside_clicks"][k] += accepted
            if cents:
                cost_cents[k] += spend
            else:
                out["cost"][k] += spend
            out["sellside_conversions"][k] += n_conv
            rev_cents[k] += revenue_c
            if imp >= 1:
                out["eligible_volume"][k] += n_auctions[t, k]
            if b <= 0:
                broken = True
                break
    if cents:
        out["cost"] = cost_cents / 100.0
    out["revenue"] = rev_cents / 100.0
    out["profit"] = out["revenue"] - out["cost"]
    out["volume"] = draws["volume"].astype(np.int64)
    return out


def simulate_day_native(
    bids: np.ndarray,
    budget: float,
    draws: Dict[str, np.ndarray],
    timesteps: int = 24,
    cents: bool = True,
) -> Dict[str, np.ndarray]:
    """C++ implementation of :func:`simulate_day_numpy` (adcraft_tpu._native).

    Same injected-draw semantics, ~100x faster — for parity testing at
    production scale. Fills the role the reference's Rust extension plays
    for its host-side hot loops (src/lib.rs).
    """
    from adcraft_tpu import _native

    n_auctions = split_volume_numpy(
        draws["volume"].astype(np.int64), timesteps
    ).astype(np.int64)
    out = _native.gate_day(
        np.ascontiguousarray(draws["costs"], np.float64),
        np.ascontiguousarray(draws["n_clicks"], np.int64),
        np.ascontiguousarray(draws["impressions"], np.int64),
        np.ascontiguousarray(n_auctions),
        np.ascontiguousarray(draws["conv_flags"], np.uint8),
        np.ascontiguousarray(np.round(draws["revs"] * 100.0), np.int64),
        float(budget),
        int(cents),
    )
    out["profit"] = out["revenue"] - out["cost"]
    out["volume"] = draws["volume"].astype(np.int64)
    return out


# ---------------------------------------------------------------------------
# literal seeded oracle env (distributional-parity layer)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class OracleKeyword:
    """One keyword's parameters for the literal oracle."""

    vol_mean: float
    vol_std: float
    bctr: float
    sctr: float
    rev_mean: float
    rev_std: float
    # explicit
    explicit: bool = False
    imp_thresh: float = 0.0
    imp_intercept: float = 0.1
    imp_slope: float = 3.0
    cost_model: str = "rust_quirk"  # or "python"
    # implicit
    single_competitor: bool = True
    bid_loc: float = 0.0
    bid_scale: float = 0.1
    max_bidders: int = 30
    participation_rate: float = 0.6


def _threshold_sigmoid_np(bid, thresh, intercept, slope) -> float:
    halver = 2.0 + 1e-10
    t = np.clip(halver * thresh, 0.0, 1.0) / halver
    r = 1.0 / (1.0 + np.exp(-slope * (bid - intercept)))
    return float(np.clip((1 + 2 * t) * r - t, 0.0, 1.0))


class NumpyOracleEnv:
    """Seeded, literal simulation of the reference env semantics.

    Python loops and materialized competitor bids, exactly in the
    reference's style but with every draw taken from one seeded
    ``np.random.Generator`` (substituting seeded draws at the reference's
    unseeded thread_rng sites, which is the fix its TODOs intend,
    src/lib.rs:316-319).
    """

    def __init__(
        self,
        keywords: List[OracleKeyword],
        budget: float = 1000.0,
        loss_threshold: float = 10000.0,
        max_days: int = 60,
        timesteps: int = 24,
        seed: int = 0,
        updater_mask: Optional[List[bool]] = None,
        updater_scales: Tuple[float, float, float] = (0.03, 0.03, 0.03),
    ):
        self.keywords = keywords
        self.budget = budget
        self.loss_threshold = loss_threshold
        self.max_days = max_days
        self.timesteps = timesteps
        self.rng = np.random.default_rng(seed)
        self.updater_mask = updater_mask
        self.updater_scales = updater_scales
        self.vol_drift_ref = [kw.vol_std for kw in keywords]
        self.day = 0
        self.cumulative_profit = 0.0

    # -- sampling primitives (reference semantics, seeded) --------------

    def _sample_volume(self, kw: OracleKeyword) -> int:
        draw = self.rng.normal(kw.vol_mean, kw.vol_std)
        return int(np.round(max(draw, 0.0)))

    def _auction(self, kw: OracleKeyword, bid: float, n_auctions: int):
        """(impressions, costs) for one cell — literal simulation."""
        if kw.explicit:
            rate = _threshold_sigmoid_np(
                bid, kw.imp_thresh, kw.imp_intercept, kw.imp_slope
            )
            imp = int(self.rng.binomial(n_auctions, rate)) if n_auctions > 0 else 0
            if imp < 1:
                # reference quirk: zero-impression cells yield one zero-cost
                # click candidate (synthetic_kw_classes.py:514-515)
                return imp, np.zeros(1)
            s = np.sqrt(bid)
            noise = self.rng.normal(0.0, 1e-10 + s / 6.0, imp)
            if kw.cost_model == "rust_quirk":
                costs = np.clip(s / 4 + 2.2 + noise, 0.0, 4.4)
            else:
                costs = np.around(np.clip(s / 4 + bid / 2 + noise, 0.0, bid), 2)
            return imp, costs
        # implicit: materialize competitor bids, run the literal auction
        if n_auctions == 0:
            return 0, np.zeros(0)
        if kw.single_competitor:
            k = 1
            other = np.around(
                np.abs(self.rng.laplace(kw.bid_loc, kw.bid_scale, (k, n_auctions))),
                2,
            ).T
        else:
            k = int(self.rng.binomial(kw.max_bidders, kw.participation_rate))
            if k == 0:
                other = np.zeros((n_auctions, 0))
            else:
                other = self.rng.laplace(
                    kw.bid_loc, kw.bid_scale, (k, n_auctions)
                ).T
        imp, _, costs = nth_price_auction_numpy(bid, other, n=2, num_winners=1)
        return imp, costs

    # -- day simulation --------------------------------------------------

    def step(self, bids: np.ndarray, budget: Optional[float] = None) -> Dict:
        """One day (reference step semantics, gymnasium_kw_env.py:160-269)."""
        if budget is not None:
            self.budget = float(np.round(budget, 2))
        bids = np.asarray(
            [round(max(float(b), 0.01), 2) for b in np.asarray(bids).ravel()]
        )
        K = len(self.keywords)
        T = self.timesteps
        volumes = [self._sample_volume(kw) for kw in self.keywords]
        n_auctions = split_volume_numpy(np.asarray(volumes), T)

        agg = {
            "impressions": np.zeros(K, np.int64),
            "buyside_clicks": np.zeros(K, np.int64),
            "cost": np.zeros(K, np.float64),
            "sellside_conversions": np.zeros(K, np.int64),
            "revenue": np.zeros(K, np.float64),
            "eligible_volume": np.zeros(K, np.int64),
        }
        b = self.budget
        broken = False
        for t in range(T):
            if broken:
                break
            for k, kw in enumerate(self.keywords):
                imp, costs = self._auction(kw, bids[k], int(n_auctions[t, k]))
                clicked = self.rng.random(len(costs)) <= kw.bctr
                accepted = 0
                spend = 0.0
                for cl, c in zip(clicked, costs):
                    if cl:
                        if b >= c:
                            accepted += 1
                            spend += c
                            b -= c
                        else:
                            break
                convs = int(np.sum(self.rng.random(accepted) <= kw.sctr))
                revs = np.around(
                    np.maximum(
                        self.rng.normal(kw.rev_mean, kw.rev_std, convs), 0.01
                    ),
                    2,
                )
                agg["impressions"][k] += imp
                agg["buyside_clicks"][k] += accepted
                agg["cost"][k] += spend
                agg["sellside_conversions"][k] += convs
                agg["revenue"][k] += float(np.sum(revs))
                if imp >= 1:
                    agg["eligible_volume"][k] += n_auctions[t, k]
                if b <= 0:
                    broken = True
                    break

        profit = agg["revenue"] - agg["cost"]
        reward = float(np.sum(profit))
        self.cumulative_profit += reward
        self.day += 1
        truncated = self.cumulative_profit < -self.loss_threshold
        terminated = self.day >= self.max_days

        self._update_keywords()
        obs = {
            "impressions": agg["impressions"],
            "buyside_clicks": agg["buyside_clicks"],
            "cost": agg["cost"],
            "sellside_conversions": agg["sellside_conversions"],
            "revenue": agg["revenue"],
            "cumulative_profit": np.asarray([self.cumulative_profit]),
            "days_passed": np.asarray([self.day]),
        }
        return {
            "obs": obs,
            "reward": reward,
            "terminated": terminated,
            "truncated": truncated,
            "profit": profit,
            "volume": np.asarray(volumes),
            "eligible_volume": agg["eligible_volume"],
        }

    def _update_keywords(self) -> None:
        """Non-stationary drift (gymnasium_kw_env.py:114-158 semantics)."""
        if self.updater_mask is None:
            return
        sv, sc, sr = self.updater_scales
        K = len(self.keywords)
        u_vol = self.rng.uniform(-sv, sv, K)
        u_ctr = self.rng.uniform(-sc, sc, K)
        u_cvr = self.rng.uniform(-sr, sr, K)
        for k, kw in enumerate(self.keywords):
            if self.updater_mask[k]:
                kw.vol_mean = max(kw.vol_mean + u_vol[k] * self.vol_drift_ref[k], 0.0)
                kw.bctr = float(np.clip(kw.bctr * (1 + u_ctr[k]), 0.0, 1.0))
                kw.sctr = float(np.clip(kw.sctr * (1 + u_cvr[k]), 0.0, 1.0))
