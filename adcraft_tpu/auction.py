"""Closed-form auction kernels.

The reference simulates implicit keywords by literally materializing every
competitor bid and running a per-auction python loop
(``nth_price_auction``, adcraft/synthetic_kw_helpers.py:116-180 — a
partition/sort plus a searchsorted loop per auction). That design is hostile
to accelerators: dynamic shapes, tiny tensors, host loops.

Here the auction is reduced to its exact sufficient statistics:

* With ``num_winners=1, n=2`` (the only configuration the reference ever
  uses — ``ImplicitKeyword.auction`` defaults, synthetic_kw_classes.py:623-646)
  the nth-price auction with zero-padding degenerates to: *you win an
  auction iff your bid strictly exceeds every competitor bid (and 0), and
  you pay the highest competitor bid (floored at 0 when there are fewer
  than 3 bidders)*.

* Therefore impressions ~ Binomial(n_auctions, p_win) with a closed-form
  win probability, and each won auction's cost is an exact inverse-CDF
  draw from the competitor-max distribution conditioned on losing to us.

No per-auction tensor is ever built; a cell (one keyword in one
sub-timestep) costs O(max_clicks) memory regardless of volume.

Explicit keywords (parametric sigmoid + parametric cost,
synthetic_kw_classes.py:457-575) were already distributional in the
reference; they map 1:1.
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from adcraft_tpu.config import CompetitorModel, CostModel, EnvConfig, KeywordKind
from adcraft_tpu import distributions as dist

Array = jax.Array


class CellAuction(NamedTuple):
    """Auction outcome sufficient statistics for a batch of cells.

    A "cell" is (one keyword, one sub-timestep). Shapes below use ``...``
    for the cell batch shape (usually ``(K,)``) and M for the static click
    buffer ``cfg.max_clicks_per_cell``.
    """

    impressions: Array  # (...), int32 — auctions won
    n_candidates: Array  # (...), int32 — click-coinflip count (see quirk below)
    cost_draws: Array  # (M, ...), money — i.i.d. cost-per-click draws,
    # lane-major so the keyword axis is the minor (contiguous) dimension


def cell_binomial_fn(cfg: EnvConfig, max_clicks: int):
    """The binomial sampler for buffer-bounded hot-path draws.

    ``cfg.binomial_sampler="inversion"`` swaps ``jax.random.binomial``'s
    rejection loops for the one-uniform inverse-CDF walk
    (``distributions.binomial_inv``) — valid exactly because impressions,
    clicks and conversions in a cell are all bounded by the static click
    buffer ``max_clicks``.
    """
    if cfg.binomial_sampler == "inversion":
        def bfn(key, n, p, shape=None):
            return dist.binomial_inv(
                key, n, p, nmax=max_clicks, bits=cfg.lane_bits, shape=shape
            )

        return bfn
    return dist.binomial


def bidder_binomial_fn(cfg: EnvConfig):
    """The sampler for the pool model's per-cell bidder-count draw.

    Bounded by ``cfg.max_bidders_bound`` (not the click buffer). Under
    binomial_sampler="inversion" this builds the (nmax, K) CDF ladder
    from the PER-KEYWORD (max_bidders, participation_rate) — constant
    across cells and days — and spends ONE half-word uniform per cell
    (``binomial_inv_from_cdf``). The alternatives are the exact
    rejection sampler's lockstep while-loops, the sequential 64-level
    inversion walk (unfusable dependency chain), and a parallel
    Bernoulli-sum (32x the PRNG words). Stream changes with
    the flag, like every other inversion site (PARITY.md "Inversion
    binomial sampling")."""
    if cfg.binomial_sampler == "inversion":
        def bfn(key, n, p, shape=None):
            ladder = dist.binomial_cdf(n, p, cfg.max_bidders_bound)
            return dist.binomial_inv_from_cdf(
                key, ladder, bits=cfg.lane_bits
            )

        return bfn
    return dist.binomial


def _single_abs_cents_win_threshold(bid: Array) -> Array:
    """|Laplace| threshold equivalent to beating a cents-rounded competitor.

    Competitor bid C = round(|L|, 2) (``bid_abs_laplace``,
    synthetic_kw_helpers.py:104-113). Our bid is on the cents grid, and the
    win requires C < bid strictly (searchsorted-left semantics,
    synthetic_kw_helpers.py:167-171), i.e. C <= bid - 0.01, i.e.
    |L| < bid - 0.005 (rounding boundary has measure zero).
    """
    return bid - 0.005


def implicit_single_win_prob(bid: Array, bid_loc: Array, bid_scale: Array) -> Array:
    """Closed-form win probability of the single-competitor auction.

    Win iff ``round(|Laplace(loc, scale)|, 2) < bid`` i.e.
    ``|L| < bid - 0.005`` (``_single_abs_cents_win_threshold``).
    """
    y0 = _single_abs_cents_win_threshold(bid)
    p = dist.laplace_cdf(y0, bid_loc, bid_scale) - dist.laplace_cdf(
        -y0, bid_loc, bid_scale
    )
    return jnp.clip(p, 0.0, 1.0)


def implicit_single_auction(
    key: Array,
    bid: Array,
    n_auctions: Array,
    bid_loc: Array,
    bid_scale: Array,
    max_clicks: int,
    dtype=jnp.float32,
    lane_bits: int = 32,
    binomial_fn=dist.binomial,
) -> CellAuction:
    """Single-competitor implicit auction (reference experiment config).

    Reference: ``single_competitor`` + ``bid_abs_laplace``
    (gymnasium_kw_utils.py:159-195). Exact semantics: win iff
    round(|Laplace(loc, scale)|, 2) < bid; pay the competitor's rounded bid.
    """
    k_imp, k_cost = jax.random.split(key)
    y0 = _single_abs_cents_win_threshold(bid)
    p_win = implicit_single_win_prob(bid, bid_loc, bid_scale)
    impressions = binomial_fn(k_imp, n_auctions, p_win)

    # cost | win: L ~ Laplace(loc, scale) truncated to (-y0, y0), cost
    # = round(|L|, 2). Exact inverse-CDF; i.i.d. across won auctions.
    shape = (max_clicks,) + bid.shape
    trunc = dist.truncated_laplace(
        k_cost,
        bid_loc[None, ...],
        bid_scale[None, ...],
        -y0[None, ...],
        y0[None, ...],
        shape,
        bits=lane_bits,
    )
    costs = dist.round_cents(jnp.abs(trunc)).astype(dtype)
    return CellAuction(impressions, impressions, costs)


def implicit_pool_auction(
    key: Array,
    bid: Array,
    n_auctions: Array,
    bid_loc: Array,
    bid_scale: Array,
    max_bidders: Array,
    participation_rate: Array,
    max_clicks: int,
    dtype=jnp.float32,
    binomial_fn=dist.binomial,
    bidder_fn=dist.binomial,
) -> CellAuction:
    """Binomial-pool implicit auction (``ImplicitKeyword`` defaults).

    Reference synthetic_kw_classes.py:648-688: ``k ~ Binomial(max_bidders,
    participation_rate)`` bidders drawn ONCE per auction() call (i.e. per
    cell — "iffy: same num bidders in every sample", :621), each bidder's
    bid raw Laplace(loc, scale) (signed, unrounded). Win iff bid > max of
    the k bids (strict; and bid > padded 0s, always true for bid >= 0.01);
    cost = max bid, floored at 0 when k < 3 because zero-padding enters the
    top-3 array (synthetic_kw_helpers.py:153-161).
    """
    k_bidders, k_imp, k_cost = jax.random.split(key, 3)
    k = bidder_fn(k_bidders, max_bidders, participation_rate).astype(jnp.float32)

    f_bid = dist.laplace_cdf(bid, bid_loc, bid_scale)
    p_win = jnp.where(k > 0, f_bid ** jnp.maximum(k, 1.0), 1.0)
    impressions = binomial_fn(k_imp, n_auctions, p_win)

    # cost | win: M = max of k Laplace draws given M < bid has CDF
    # (F(y)/F(bid))^k, so M = F^{-1}(F(bid) * u^{1/k}).
    shape = (max_clicks,) + bid.shape
    u = jax.random.uniform(key=k_cost, shape=shape)
    ksafe = jnp.maximum(k, 1.0)[None, ...]
    m = dist.laplace_icdf(
        jnp.clip(f_bid[None, ...] * u ** (1.0 / ksafe), 1e-38, 1.0 - 1e-12),
        bid_loc[None, ...],
        bid_scale[None, ...],
    )
    kcol = k[None, ...]
    costs = jnp.where(kcol == 0, 0.0, jnp.where(kcol < 3, jnp.maximum(m, 0.0), m))
    return CellAuction(impressions, impressions, costs.astype(dtype))


def explicit_auction(
    key: Array,
    bid: Array,
    n_auctions: Array,
    imp_thresh: Array,
    imp_intercept: Array,
    imp_slope: Array,
    cost_model: CostModel,
    max_clicks: int,
    dtype=jnp.float32,
    binomial_fn=dist.binomial,
) -> CellAuction:
    """Explicit parametric auction.

    Reference ``ExplicitKeyword.auction`` (synthetic_kw_classes.py:520-538):
    impressions ~ Binomial(n_auctions, threshold_sigmoid(bid)); costs are
    i.i.d. ``cost_create`` draws.

    Phantom-click quirk (reproduced): ``sample_buyside_costs`` with
    impressions < 1 returns ``np.array([0])`` (synthetic_kw_classes.py:514-515),
    so a zero-impression cell still performs ONE buyside-click coinflip on a
    zero-cost item (bidding_simulation.py:94-104) — explicit keywords can
    convert and earn revenue on days with no impressions. ``n_candidates``
    carries this: max(impressions, 1), with the cost draw zeroed when
    impressions == 0.
    """
    k_imp, k_cost = jax.random.split(key)
    rate = dist.threshold_sigmoid(bid, imp_thresh, imp_intercept, imp_slope)
    impressions = binomial_fn(k_imp, n_auctions, rate)

    shape = (max_clicks,) + bid.shape
    if cost_model is CostModel.RUST_QUIRK:
        costs = dist.cost_create(k_cost, bid[None, ...], shape, dtype=dtype)
    else:
        costs = dist.generic_cost(k_cost, bid[None, ...], shape, dtype=dtype)
    # phantom-click path: single zero-cost candidate when no impressions
    phantom = impressions == 0
    n_candidates = jnp.maximum(impressions, 1)
    costs = jnp.where(phantom[None, ...], 0.0, costs)
    return CellAuction(impressions, n_candidates, costs)


def nth_price_auction_device(
    bid: Array,
    other_bids: Array,
    n: int = 2,
    num_winners: int = 2,
):
    """Device-path general nth-price auction over materialized bids.

    The full generality of the reference's ``nth_price_auction``
    (synthetic_kw_helpers.py:116-180) — arbitrary price index ``n``,
    multi-winner placements, zero-padding when an auction has fewer than
    ``num_winners + n`` bidders — vectorized over the auction axis for
    the device instead of the reference's per-auction searchsorted loop.
    The env hot path never needs this (the reference only ever calls it
    with n=2, num_winners=1, where the closed-form reductions above are
    exact); it exists for API parity with users who call the helper
    directly, and for pool-model experiments with several ad slots.

    Args: ``bid`` scalar (or (A,) per-auction), ``other_bids`` (A, B).
    Returns static-shape per-auction arrays instead of the reference's
    ragged lists:
      impressions — scalar int32, number of auctions won;
      won         — (A,) bool, win mask;
      placements  — (A,) int32, 0 = top spot .. num_winners-1; valid
                    where ``won`` (0 elsewhere);
      costs       — (A,) money, the (n-1)-below clearing price (``bid``
                    itself for n=1); valid where ``won`` (0 elsewhere).
    ``costs[won]`` / ``placements[won]`` reproduce the reference's lists
    (order preserved; cross-checked against the numpy/C++ oracles in
    tests/test_parity.py).
    """
    if n < 1 or num_winners < 1:
        raise ValueError("n and num_winners must be >= 1")
    other_bids = jnp.asarray(other_bids)
    a, b = other_bids.shape
    width = num_winners + n
    # top `width` competitor bids per auction, ascending, zero-padded on
    # the low side when the auction has fewer than `width` bidders
    # (synthetic_kw_helpers.py:152-161)
    if b >= width:
        top = jnp.flip(jax.lax.top_k(other_bids, width)[0], axis=1)
    else:
        pad = jnp.zeros((a, width - b), other_bids.dtype)
        top = jnp.sort(jnp.concatenate([pad, other_bids], axis=1), axis=1)
    # -inf entries mark ABSENT bidders (variable per-auction bidder counts
    # under static shapes). The reference instead zero-pads short auctions
    # (synthetic_kw_helpers.py:157-161) and its zeros PARTICIPATE in the
    # sort (they sit above negative bids), so convert surviving -inf slots
    # to 0 and re-sort the (small) top array.
    top = jnp.sort(jnp.where(jnp.isneginf(top), 0.0, top), axis=1)
    bid = jnp.broadcast_to(jnp.asarray(bid, top.dtype), (a,))
    # left-searchsorted insertion index = count of strictly smaller bids
    idx = jnp.sum((top < bid[:, None]).astype(jnp.int32), axis=1)
    won = idx > n
    placements = jnp.where(won, width - idx, 0).astype(jnp.int32)
    if n > 1:
        cost_idx = jnp.maximum(idx - (n - 1), 0)
        cleared = jnp.take_along_axis(top, cost_idx[:, None], axis=1)[:, 0]
    else:
        cleared = bid  # 1st price: pay your own bid
    costs = jnp.where(won, cleared, jnp.zeros_like(cleared))
    impressions = jnp.sum(won.astype(jnp.int32))
    return impressions, won, placements, costs


def implicit_pool_auction_general(
    key: Array,
    bid: Array,
    n_auctions: int,
    bid_loc: Array,
    bid_scale: Array,
    max_bidders: Array,
    participation_rate: Array,
    n: int = 2,
    num_winners: int = 2,
):
    """Keyed pool-model auctions through the general device clearing path.

    Materializes the reference's competitor tensor for ONE keyword-day
    cell — ``k ~ Binomial(max_bidders, participation_rate)`` drawn once
    per call (the reference's "iffy: same num bidders in every sample"
    quirk, synthetic_kw_classes.py:610-621), each bidder raw
    Laplace(loc, scale) — and clears every auction with
    ``nth_price_auction_device``. Shapes are static in
    ``(n_auctions, max_bidders_static)``; non-participating bidder slots
    are masked to -inf so they can never place.

    This is the opt-in general capability (arbitrary n / num_winners /
    placements); the env hot path uses the closed-form
    ``implicit_pool_auction`` reduction instead, which is exact for the
    n=2, num_winners=1 configuration the reference uses.
    """
    k_bidders, k_bids = jax.random.split(key)
    bmax = int(max_bidders)
    k = dist.binomial(k_bidders, jnp.asarray(bmax), participation_rate)
    u = jax.random.uniform(
        k_bids, (int(n_auctions), bmax), minval=1e-7, maxval=1.0 - 1e-7
    )
    lap = dist.laplace_icdf(u, bid_loc, bid_scale)
    mask = jnp.arange(bmax)[None, :] < k
    other = jnp.where(mask, lap, -jnp.inf)
    return nth_price_auction_device(bid, other, n=n, num_winners=num_winners)


def run_cell_auctions(
    cfg: EnvConfig,
    key: Array,
    bids: Array,
    n_auctions: Array,
    kw,  # KeywordState with (K,)-shaped fields
    dtype=jnp.float32,
    max_clicks: int = None,
) -> CellAuction:
    """Dispatch on the env's (static) keyword kind/competitor model."""
    m = cfg.max_clicks_per_cell if max_clicks is None else max_clicks
    bfn = cell_binomial_fn(cfg, m)
    if cfg.kind is KeywordKind.EXPLICIT:
        return explicit_auction(
            key,
            bids,
            n_auctions,
            kw.imp_thresh,
            kw.imp_intercept,
            kw.imp_slope,
            cfg.cost_model,
            m,
            dtype=dtype,
            binomial_fn=bfn,
        )
    if cfg.competitor_model is CompetitorModel.SINGLE_ABS_CENTS:
        return implicit_single_auction(
            key, bids, n_auctions, kw.bid_loc, kw.bid_scale, m, dtype=dtype,
            lane_bits=cfg.lane_bits, binomial_fn=bfn,
        )
    return implicit_pool_auction(
        key,
        bids,
        n_auctions,
        kw.bid_loc,
        kw.bid_scale,
        kw.max_bidders,
        kw.participation_rate,
        m,
        dtype=dtype,
        binomial_fn=bfn,
        bidder_fn=bidder_binomial_fn(cfg),
    )
