"""Baseline bidding agents.

Pure-functional, vmappable rewrites of the reference's
torch-based baselines (adcraft/baselines/interpolated_expectations.py).
Agent state is a pytree of arrays; ``update`` folds in one day's
observations and ``act`` produces the next action. vmap over the leading
axis to run one agent per env across a whole batch.

The reference draws its exploration randomness from a per-agent numpy
Generator inside data-dependent branches; here every keyword draws each
step and branches select via ``where`` — identical per-draw distribution,
different stream alignment (documented deviation; the reference's own runs
are not reproducible anyway, SURVEY.md §2a).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

# hard-coded pseudo-empirical revenue priors
# (interpolated_expectations.py:168-175)
EMPIRICAL_REV_PER_BUYSIDE_CLICK = 0.3
EMPIRICAL_REV_PER_SELLSIDE_CLICK = 0.7


# ---------------------------------------------------------------------------
# shared rpc / sctr cache (interpolated_expectations.py:67-152, 286-295)
# ---------------------------------------------------------------------------


class RpcCache(NamedTuple):
    """Running averages of revenue-per-conversion and conversion rate."""

    ave_rpc: Array  # f32 (K,)
    num_rpc_obs: Array  # i32 (K,)
    ave_sctr: Array  # f32 (K,) — initialized at the 0.4 prior
    num_sctr_obs: Array  # f32 (K,) — float in the reference (:292)


def init_rpc_cache(num_keywords: int) -> RpcCache:
    return RpcCache(
        ave_rpc=jnp.zeros(num_keywords),
        num_rpc_obs=jnp.zeros(num_keywords, jnp.int32),
        ave_sctr=jnp.full((num_keywords,), 0.4),
        num_sctr_obs=jnp.zeros(num_keywords),
    )


def update_rpc_cache(cache: RpcCache, obs: dict) -> RpcCache:
    """One day's observation -> cache update.

    Reference ``update_cached_rpc_and_sctr`` +
    ``process_rpc_and_update_cache`` / ``process_sctr_and_update_cache``
    (interpolated_expectations.py:67-152) specialized to the single-step
    window the reference always uses (observations tensor of length 1).
    Reproduces its quirks: sctr is click-weighted against a step-counted
    denominator, and num_sctr_obs increments once per step with clicks.
    """
    # accumulate in the cache's dtype (f64 under x64 parity tests)
    dt = cache.ave_rpc.dtype
    clicks = jnp.asarray(obs["buyside_clicks"]).astype(dt)
    convs = jnp.asarray(obs["sellside_conversions"]).astype(dt)
    revenue = jnp.asarray(obs["revenue"]).astype(dt)

    has_clicks = clicks > 0
    has_rev = has_clicks & (convs > 0)

    # rpc update: new sample revenue/convs, weight 1, only when observed
    new_rpc = jnp.where(has_rev, revenue / jnp.maximum(convs, 1.0), 0.0)
    n_new = has_rev.astype(jnp.int32)
    total = cache.num_rpc_obs + n_new
    rpc = jnp.where(
        n_new > 0,
        (new_rpc * n_new + cache.ave_rpc * cache.num_rpc_obs)
        / jnp.maximum(total, 1),
        cache.ave_rpc,
    )

    # sctr update: click-weighted conversions vs step-counted cache
    # (all_convs = sctr_step*clicks + cached*num_cached; all_obs =
    # clicks + num_cached; interpolated_expectations.py:89-104,147-152)
    all_obs = clicks + cache.num_sctr_obs
    all_convs = convs + cache.ave_sctr * cache.num_sctr_obs
    sctr = jnp.where(
        has_clicks & (all_obs > 0),
        all_convs / jnp.maximum(all_obs, 1.0),
        cache.ave_sctr,
    )
    new_sctr_obs = jnp.where(
        has_clicks, cache.num_sctr_obs + 1.0, cache.num_sctr_obs
    )
    return RpcCache(
        ave_rpc=rpc,
        num_rpc_obs=jnp.where(has_rev, total, cache.num_rpc_obs),
        ave_sctr=sctr,
        num_sctr_obs=new_sctr_obs,
    )


def expected_rev_per_buyside_click(cache: RpcCache) -> Array:
    """rpc * sctr with empirical-prior fallbacks.

    Reference ``get_expected_rev_per_buyside_click``
    (interpolated_expectations.py:178-200).
    """
    no_rpc = cache.num_rpc_obs < 1
    no_sctr = cache.num_sctr_obs < 1
    return jnp.where(
        no_rpc & no_sctr,
        EMPIRICAL_REV_PER_BUYSIDE_CLICK,
        jnp.where(
            no_rpc,
            EMPIRICAL_REV_PER_SELLSIDE_CLICK * cache.ave_sctr,
            cache.ave_rpc * cache.ave_sctr,
        ),
    )


# ---------------------------------------------------------------------------
# NaiveZeroMarginStrategy (interpolated_expectations.py:442-515)
# ---------------------------------------------------------------------------


class ZeroMarginState(NamedTuple):
    cache: RpcCache
    max_bids: Array  # f32 (K,) — bid ramp per keyword
    prev_bids: Array  # f32 (K,)


class NaiveZeroMarginStrategy:
    """Bid the estimated revenue-per-click; ramp bids until revenue observed.

    Second-price-auction logic: in a one-shot second-price auction the
    optimal bid is your value per click (rpc * sctr); before any revenue
    is observed, step the bid up 0.03 at a time (with probability
    1/sqrt(#click-steps), certain at first) or fall back to
    sctr * default_rpc. Budget is 100x a per-keyword confidence score.
    """

    def __init__(
        self,
        num_keywords: int,
        default_expected_revenue_per_conversion: float = 3.0,
    ):
        self.num_keywords = num_keywords
        self.default_rpc = default_expected_revenue_per_conversion

    def init(self) -> ZeroMarginState:
        return ZeroMarginState(
            cache=init_rpc_cache(self.num_keywords),
            max_bids=jnp.full((self.num_keywords,), 0.01),
            prev_bids=jnp.full((self.num_keywords,), 0.01),
        )

    def update(self, state: ZeroMarginState, prev_bids: Array, obs: dict):
        return ZeroMarginState(
            cache=update_rpc_cache(state.cache, obs),
            max_bids=state.max_bids,
            prev_bids=jnp.asarray(prev_bids),
        )

    def act(self, state: ZeroMarginState, key: Array) -> Tuple[ZeroMarginState, dict]:
        """Reference ``sample_action`` (interpolated_expectations.py:496-515)."""
        cache = state.cache
        u = jax.random.uniform(key, (self.num_keywords,))
        # 1/sqrt(0) -> inf in the reference: always ramp before any clicks
        ramp_prob = jnp.where(
            cache.num_sctr_obs > 0,
            1.0 / jnp.sqrt(jnp.maximum(cache.num_sctr_obs, 1e-12)),
            jnp.inf,
        )
        ramping = u <= ramp_prob

        ramp_bid = jnp.clip(state.max_bids + 0.03, 0.01, 3.0)
        fallback_bid = cache.ave_sctr * self.default_rpc
        rpc_bid = expected_rev_per_buyside_click(cache)

        has_rpc = cache.num_rpc_obs >= 1
        bids = jnp.where(
            has_rpc, rpc_bid, jnp.where(ramping, ramp_bid, fallback_bid)
        )
        budget_score = jnp.where(
            has_rpc, 3.0, jnp.where(ramping, 1.0, 2.0)
        ).sum()
        new_max = jnp.where(~has_rpc & ramping, ramp_bid, state.max_bids)
        new_state = ZeroMarginState(cache, new_max, bids)
        return new_state, {"budget": 100.0 * budget_score, "keyword_bids": bids}


# ---------------------------------------------------------------------------
# NaiveInterpolationStrategy (interpolated_expectations.py:298-439)
# ---------------------------------------------------------------------------


class InterpolationState(NamedTuple):
    cache: RpcCache
    # per (keyword, bid-bin) running averages over the 300-point grid
    ave_cpc: Array  # f32 (K, B)
    n_cpc: Array  # i32 (K, B)
    ave_clicks: Array  # f32 (K, B)
    n_clicks: Array  # i32 (K, B)
    prev_bids: Array  # f32 (K,)


def _compact_smooth(values: Array, observed: Array) -> Array:
    """The reference's ``smoothed`` over the COMPACT observed-point sequence.

    ``smoothed`` (interpolated_expectations.py:203-211) convolves the
    vector of observed-bin averages — NOT the dense bid grid — with a
    Bartlett window of length ``min(5, max(1, n-1))`` for n observed
    points. ``np.bartlett`` endpoints are zero, so this collapses to:

    * n <= 4: identity (lengths 1-2 have zero mass -> [1]; length 3 is
      the [0, 1, 0] hat);
    * n == 5: length-4 window == backward pair average
      ``out[i] = (v[i-1] + v[i]) / 2`` (np.convolve 'same' centering),
      first element halved (zero pad);
    * n >= 6: length-5 window == [.25, .5, .25] over observed NEIGHBORS,
      zero-padded at the sequence ends.

    Returned values are meaningful only at observed bins. Neighbor means
    the previous/next OBSERVED bin, however far away on the grid.
    """
    B = values.shape[-1]
    idx = jnp.arange(B)
    big = B + 1
    # nearest observed index at or left/right of each bin
    left_incl = jax.lax.associative_scan(jnp.maximum, jnp.where(observed, idx, -1))
    right_incl = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(jnp.where(observed, idx, big)))
    )
    # previous/next observed STRICTLY before/after each bin
    prev = jnp.concatenate([jnp.full((1,), -1), left_incl[:-1]])
    nxt = jnp.concatenate([right_incl[1:], jnp.full((1,), big)])
    prev_v = jnp.where(prev >= 0, values[jnp.clip(prev, 0, B - 1)], 0.0)
    next_v = jnp.where(nxt < big, values[jnp.clip(nxt, 0, B - 1)], 0.0)
    n = jnp.sum(observed.astype(jnp.int32))
    sm = jnp.where(
        n >= 6,
        0.25 * prev_v + 0.5 * values + 0.25 * next_v,
        jnp.where(n == 5, 0.5 * prev_v + 0.5 * values, values),
    )
    return jnp.where(observed, sm, values)


def _interp_observed(grid_vals: Array, observed: Array, query_x: Array, query_fill):
    """np.interp over observed CENT-grid points, queried at ``query_x``.

    Faithful to the reference (interpolated_expectations.py:254-270):
    the observed x-coordinates are the cent values ``0.01 + 0.01*bin``
    (cache keys scanned over np.arange(0.01, 3.01, 0.01), :155-165)
    and the queries are ``np.linspace(0.01, 3.0, 300)``, whose step
    (3.0-0.01)/299 is exactly 0.01 in f64 — the two grids are
    bit-identical, so every query hits an observed knot exactly and
    np.interp returns the knot value (no off-by-epsilon quirk; ADVICE
    r2 corrected an earlier wrong rationale here — the code was right).
    ``query_fill`` = (left_fill, right_fill) outside the observed range.
    """
    B = grid_vals.shape[-1]
    idx = jnp.arange(B)
    big = B + 1
    x_obs = 0.01 + 0.01 * idx.astype(query_x.dtype)  # cent grid
    left_incl = jax.lax.associative_scan(jnp.maximum, jnp.where(observed, idx, -1))
    right_incl = jnp.flip(
        jax.lax.associative_scan(jnp.minimum, jnp.flip(jnp.where(observed, idx, big)))
    )
    # largest bin with x_obs <= q / smallest with x_obs >= q (exact float
    # comparisons, like np.interp's)
    cap = jnp.searchsorted(x_obs, query_x, side="right") - 1
    lo = jnp.searchsorted(x_obs, query_x, side="left")
    left = jnp.where(cap >= 0, left_incl[jnp.clip(cap, 0, B - 1)], -1)
    right = jnp.where(lo <= B - 1, right_incl[jnp.clip(lo, 0, B - 1)], big)
    left_c = jnp.clip(left, 0, B - 1)
    right_c = jnp.clip(right, 0, B - 1)
    lv = grid_vals[left_c]
    rv = grid_vals[right_c]
    xl = x_obs[left_c]
    xr = x_obs[right_c]
    denom = jnp.where(right_c > left_c, xr - xl, 1.0)
    frac = jnp.clip((query_x - xl) / denom, 0.0, 1.0)
    interp = jnp.where(right_c > left_c, lv + (rv - lv) * frac, lv)
    left_fill, right_fill = query_fill
    out = jnp.where(left < 0, left_fill, interp)
    out = jnp.where(right >= big, right_fill, out)
    return out


class NaiveInterpolationStrategy:
    """Sample bids proportional to expected profit above a threshold.

    Estimates clicks-per-bid and cpc-per-bid by per-bin averaging over a
    300-point bid grid, smooths (Bartlett), interpolates across unobserved
    bins, scores expected margin
    ``(rev_per_click - cpc(b)) * (0.01 + clicks(b))`` and samples bids
    with probability proportional to margin above an adaptive threshold
    (reference class docstring, interpolated_expectations.py:298-314).
    """

    def __init__(
        self,
        num_keywords: int,
        profit_acquisition_threshold: float = -0.2,
        num_bins: int = 300,
        bid_step: float = 0.03,
    ):
        self.num_keywords = num_keywords
        self.threshold = profit_acquisition_threshold
        self.bid_step = bid_step
        # np.linspace in f64 — its step is exactly 0.01, so the grid is
        # bit-identical to the 0.01+0.01*k cent grid (verified; ADVICE r2)
        import numpy as _np

        self.allowed_bids = jnp.asarray(_np.linspace(0.01, 3.00, num_bins))
        self.num_bins = num_bins
        # Decimal-rounded doubles for each bin's cent value, matching the
        # reference's string cache keys float(str(round(bid, 2)))
        # (interpolated_expectations.py:10-12). These differ from the raw
        # 0.01+0.01*b grid by 1 ulp for 80/300 bins, which can flip
        # int(100*(mob+bid_step)-1) by one bin (ADVICE r2).
        self._cent_key_vals = jnp.asarray(
            _np.array(
                [float(str(round(float(v), 2))) for v in _np.linspace(0.01, 3.00, num_bins)]
            )
        )

    def init(self) -> InterpolationState:
        K, B = self.num_keywords, self.num_bins
        return InterpolationState(
            cache=init_rpc_cache(K),
            ave_cpc=jnp.zeros((K, B)),
            n_cpc=jnp.zeros((K, B), jnp.int32),
            ave_clicks=jnp.zeros((K, B)),
            n_clicks=jnp.zeros((K, B), jnp.int32),
            prev_bids=jnp.full((K,), 0.01),
        )

    def _bin_of(self, bids: Array) -> Array:
        return jnp.clip(
            jnp.round((jnp.asarray(bids) - 0.01) / 0.01).astype(jnp.int32),
            0,
            self.num_bins - 1,
        )

    def update(self, state: InterpolationState, prev_bids: Array, obs: dict):
        """Fold one day's observation into the caches
        (full_cache_update, interpolated_expectations.py:214-235)."""
        cache = update_rpc_cache(state.cache, obs)
        dt = state.ave_cpc.dtype
        clicks = jnp.asarray(obs["buyside_clicks"]).astype(dt)
        cost = jnp.asarray(obs["cost"]).astype(dt)
        cpc = jnp.where(clicks > 0, cost / jnp.maximum(clicks, 1.0), jnp.nan)
        bins = self._bin_of(prev_bids)
        K = self.num_keywords
        onehot = jax.nn.one_hot(bins, self.num_bins, dtype=jnp.float32)

        # cpc bin average updates only on steps with clicks (:50-64)
        has_cpc = ~jnp.isnan(cpc)
        upd = onehot * has_cpc[:, None]
        n_cpc = state.n_cpc + upd.astype(jnp.int32)
        new_ave_cpc = jnp.where(
            upd > 0,
            (jnp.nan_to_num(cpc)[:, None] + state.ave_cpc * state.n_cpc)
            / jnp.maximum(n_cpc, 1),
            state.ave_cpc,
        )
        # clicks bin average updates every step (:22-41)
        n_clk = state.n_clicks + onehot.astype(jnp.int32)
        new_ave_clk = jnp.where(
            onehot > 0,
            (clicks[:, None] + state.ave_clicks * state.n_clicks)
            / jnp.maximum(n_clk, 1),
            state.ave_clicks,
        )
        return InterpolationState(
            cache=cache,
            ave_cpc=new_ave_cpc,
            n_cpc=n_cpc,
            ave_clicks=new_ave_clk,
            n_clicks=n_clk,
            prev_bids=jnp.asarray(prev_bids),
        )

    def expected_margins(self, state: InterpolationState):
        """(margins, costs) per (keyword, bid) —
        get_expected_profit_per_bid_from_cache
        (interpolated_expectations.py:238-283)."""
        rev_pc = expected_rev_per_buyside_click(state.cache)  # (K,)
        cpc_obs = state.n_cpc > 0
        clk_obs = state.n_clicks > 0

        def per_kw(cpc_obs_k, ave_cpc_k, clk_obs_k, ave_clk_k):
            any_obs = jnp.any(cpc_obs_k)
            sm_cpc_k = _compact_smooth(ave_cpc_k, cpc_obs_k)
            sm_clk_k = _compact_smooth(ave_clk_k, clk_obs_k)
            max_cpc = jnp.max(jnp.where(cpc_obs_k, ave_cpc_k, -jnp.inf))
            cpc = _interp_observed(
                sm_cpc_k, cpc_obs_k, self.allowed_bids, (0.01, max_cpc)
            )
            first_clk = jnp.argmax(clk_obs_k)
            last_clk = self.num_bins - 1 - jnp.argmax(jnp.flip(clk_obs_k))
            clk = _interp_observed(
                sm_clk_k,
                clk_obs_k,
                self.allowed_bids,
                (ave_clk_k[first_clk], ave_clk_k[last_clk]),
            )
            # no data: assume cpc = 0.9*bid, 1 click (:271-275)
            cpc = jnp.where(any_obs, cpc, 0.9 * self.allowed_bids)
            clk = jnp.where(any_obs, clk, 1.0)
            return cpc, clk

        cpc, clk = jax.vmap(per_kw)(
            cpc_obs, state.ave_cpc, clk_obs, state.ave_clicks
        )
        margins = (-cpc + rev_pc[:, None]) * (0.01 + clk)
        costs = cpc * (0.01 + clk)
        return margins, costs

    def acquisition(self, state: InterpolationState):
        """(margins, costs, probs, has_mass) per keyword.

        The normalized profit-acquisition distribution over the bid grid
        (get_profit_acquisition_function,
        interpolated_expectations.py:370-398); ``has_mass=False`` is the
        reference's ``None`` return (bid 0.01).
        """
        margins, costs = self.expected_margins(state)
        cache = state.cache
        # adaptive threshold loosens with observations (:377-384)
        thresh = -(
            1.0 / (1.0 + cache.num_rpc_obs + cache.num_sctr_obs / 5.0)
        ) * jnp.abs(self.threshold)
        acq = jnp.maximum(margins, thresh[:, None]) - thresh[:, None]
        # zero out bids beyond max observed bid + step (:386-393). The
        # observed-bid keys are the reference's DECIMAL-rounded doubles
        # float(str(round(bid, 2))) — use the precomputed per-bin table,
        # not the raw 0.01+0.01*bin floats, or int(100*(mob+step)-1)
        # flips by one bin for 40/300 max-bid bins (under f32 the
        # truncation can still differ from the reference's f64 —
        # PARITY.md).
        observed_any = state.n_clicks > 0
        bin_idx = jnp.arange(self.num_bins)
        max_obs_bin = jnp.max(jnp.where(observed_any, bin_idx[None, :], -1), axis=1)
        cents = jnp.where(
            max_obs_bin >= 0,
            self._cent_key_vals[jnp.clip(max_obs_bin, 0, self.num_bins - 1)].astype(
                margins.dtype
            ),
            0.0,
        )
        max_obs_bid = jnp.maximum(cents, 0.03)
        end_index = jnp.minimum(
            (100.0 * (max_obs_bid + self.bid_step) - 1.0).astype(jnp.int32),
            self.num_bins,
        )
        acq = jnp.where(bin_idx[None, :] < end_index[:, None], acq, 0.0)
        mass = jnp.sum(acq, axis=1)
        has_mass = mass > 0
        probs = acq / jnp.maximum(mass[:, None], 1e-30)
        return margins, costs, probs, has_mass

    def act(self, state: InterpolationState, key: Array, idx: Array = None):
        """Sample bids from the profit acquisition distribution
        (sample_action, interpolated_expectations.py:405-439). ``idx``
        pins the per-keyword grid choices (parity tests) instead of
        sampling them."""
        margins, costs, probs, has_mass = self.acquisition(state)
        cache = state.cache
        if idx is None:
            keys = jax.random.split(key, self.num_keywords)
            idx = jax.vmap(
                lambda k, p: jax.random.choice(k, self.num_bins, p=p)
            )(keys, jnp.where(has_mass[:, None], probs, 1.0 / self.num_bins))
        bids = jnp.where(has_mass, self.allowed_bids[idx], 0.01)

        # budget heuristic (:424-439)
        exp_cost = jnp.sum(
            jnp.where(
                has_mass,
                jnp.where(
                    cache.num_sctr_obs > 0,
                    jnp.take_along_axis(costs, idx[:, None], axis=1)[:, 0],
                    bids,
                ),
                0.0,
            )
        )
        exp_profit = jnp.sum(
            jnp.where(
                has_mass & (cache.num_rpc_obs > 0),
                jnp.take_along_axis(margins, idx[:, None], axis=1)[:, 0],
                0.0,
            )
        )
        budget = jnp.where(
            exp_profit > 0,
            1.5 * jnp.maximum(jnp.minimum(exp_cost, 10000.0), 1000.0),
            jnp.where(
                exp_profit > self.num_keywords * self.threshold,
                jnp.maximum(jnp.minimum(exp_cost, 10000.0), 1000.0),
                1000.0,
            ),
        )
        new_state = state._replace(prev_bids=bids)
        return new_state, {"budget": budget, "keyword_bids": bids}
