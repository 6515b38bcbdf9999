"""The fused day-of-bidding kernel.

Replaces the reference hot path (SURVEY.md §3.1):
``BiddingSimulation.step`` -> ``simulate_epoch_of_bidding_on_campaign`` ->
24 sub-timesteps x keywords x per-click Python loops with hundreds of
Python<->Rust FFI crossings per env-step
(adcraft/gymnasium_kw_env.py:160-269, adcraft/bidding_simulation.py:44-234).

Structure:

* All stochastic sampling for a sub-timestep (impressions, click counts,
  cost draws, conversion counts, revenue draws) is vectorized over the K
  keywords; the only sequential computation is budget threading.
* The per-click budget-break loop (bidding_simulation.py:97-104) becomes a
  prefix-sum rule: a click is accepted iff every prefix sum of clicked
  costs up to and including it stays <= the keyword's starting budget
  (identical semantics, including break-at-first-overspend, for costs of
  any sign).
* The shared depleting budget across (sub-timestep, keyword) cells
  (bidding_simulation.py:216-233) is resolved by a budget gate over cells
  in lexicographic (sub-timestep, keyword) order — a parallel Jacobi fixed
  point by default (a handful of O(K*M) sweeps per sub-timestep;
  ``cfg.gate_scope`` picks per-sub-timestep vs whole-day gating), or a
  sequential ``lax.scan`` for cross-validation. Both break conditions
  (keyword loop and timestep loop, :230-233) collapse into one ``broken``
  flag because a break permanently ends the day.
* ALL stochastic sampling is hoisted out of any sequential structure: the
  per-sub-timestep draw tables are produced by a ``vmap`` over the
  sub-timestep index (same ``fold_in`` key tree as a sequential loop, so
  draw values are identical), giving XLA one wide, fully parallel sampling
  phase followed by the cheap gate.

Everything is shape-static: cost/revenue buffers have length
``cfg.max_clicks_per_cell`` and invalid lanes are poisoned with +inf before
the prefix sum.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import jax
import jax.numpy as jnp
from jax import lax
from jax.custom_batching import custom_vmap

from adcraft_tpu import distributions as dist
from adcraft_tpu.auction import cell_binomial_fn, run_cell_auctions
from adcraft_tpu.config import (
    CompetitorModel,
    CostModel,
    EnvConfig,
    KeywordKind,
)
from adcraft_tpu.keywords import KeywordState

Array = jax.Array


# Profiling hook (scripts/gate_stats.py): when set to a callable, every
# lazy-agg gate call invokes it with the final sweep-counter array `it`
# (per-env under vmap — batched while_loop freezes each element's carry
# once its own cond is false, so `it` is each env's true convergence
# count while the LOCKSTEP cost is max(it) over the batch). None (the
# default) adds no ops.
_GATE_STATS_HOOK = None


class DayOutcomes(NamedTuple):
    """Per-keyword aggregates for one simulated day, shape (K,).

    Mirrors the fields of ``BiddingOutcomes``
    (adcraft/bidding_simulation.py:10-38) that survive into observations
    (gymnasium_kw_env.py:232-244), plus the impression-share bookkeeping.
    """

    impressions: Array  # int32
    buyside_clicks: Array  # int32
    cost: Array  # money — sum of accepted click costs
    sellside_conversions: Array  # int32
    revenue: Array  # money — sum of per-conversion revenues
    profit: Array  # money — revenue - cost
    volume: Array  # int32 — total day volume sampled
    # Impression-share denominator with the reference's accounting quirk:
    # ``combine_outcomes`` re-derives a cell's volume as 0 whenever the cell
    # won no impressions (bidding_simulation.py:129-137), and cells after a
    # budget break are never simulated, so the day's share is
    # impressions / sum(cell volume where cell simulated & impressions>=1).
    eligible_volume: Array  # int32

    @property
    def impression_share(self) -> Array:
        return jnp.where(
            self.eligible_volume > 0,
            self.impressions / jnp.maximum(self.eligible_volume, 1),
            0.0,
        )


def split_volume(cfg: EnvConfig, volume: Array) -> Array:
    """Split daily volume uniformly over sub-timesteps.

    Reference ``uniform_get_auctions_per_timestep``
    (bidding_simulation.py:151-167): sub-timestep 0 gets
    ``vol - (T-1)*(vol//T)``, all others get ``vol//T``.
    Returns (T, K) int32 from (K,) volumes.
    """
    t = cfg.timesteps_per_day
    per = volume // t
    first = volume - (t - 1) * per
    rest = jnp.broadcast_to(per, (t - 1,) + volume.shape)
    return jnp.concatenate([first[None], rest], axis=0)


def _gate_keywords(
    budget0: Array,
    broken0: Array,
    prefix: Array,
    n_clicks: Array,
    unroll: int = 1,
) -> Tuple[Tuple[Array, Array], Tuple[Array, Array, Array]]:
    """Thread the shared budget through keywords in order.

    ``prefix`` is (M+1, K): prefix[j, k] = sum of keyword k's first j
    clicked-cost draws; lanes at or beyond ``n_clicks[k]`` are invalid and
    masked here. (Lane-major layout so the big tensors keep K on the
    128-lane axis.) Returns final (budget, broken) and per-keyword
    (accepted_clicks, spend, simulated).
    """
    m = prefix.shape[0] - 1
    lane = jnp.arange(m)
    prefix = prefix.T  # (K, M+1) — scan iterates keywords; test-only path

    def body(carry, xs):
        b, broken = carry
        prefix_k, nk = xs
        # accept the maximal prefix whose running sums all stay <= b
        valid = (prefix_k[1:] <= b) & (lane < nk)
        ok = jnp.cumprod(valid.astype(jnp.int32))
        p = jnp.sum(ok).astype(jnp.int32)
        spend = prefix_k[p]
        p = jnp.where(broken, 0, p)
        spend = jnp.where(broken, jnp.zeros_like(spend), spend)
        nb = b - spend
        # reference: ``remaining_budget -= ...; if remaining_budget <= 0:
        # break`` (bidding_simulation.py:225-233)
        return (nb, broken | (nb <= 0)), (p, spend, ~broken)

    return lax.scan(body, (budget0, broken0), (prefix, n_clicks), unroll=unroll)


def _gate_keywords_jacobi(
    budget0: Array,
    broken0: Array,
    prefix: Array,
    n_clicks: Array,
    max_iter: int,
) -> Tuple[Tuple[Array, Array], Tuple[Array, Array, Array]]:
    """Budget threading as a parallel fixed-point instead of a scan.

    The sequential recurrence (``_gate_keywords``) is forward substitution
    on a triangular system:

        b_k      = b0 - sum_{j<k} spend_j
        sim_k    = !broken0 and all_{1<=j<=k} b_j > 0
        spend_k  = sim_k ? g_k(b_k) : 0

    where g_k is the per-keyword prefix-acceptance rule. Jacobi iteration
    on these equations is fully parallel over keywords (one O(K*M) sweep
    per iteration) and after i sweeps the first i cells are
    exact, so it terminates in <= K sweeps; in practice budget either
    doesn't bind (1-2 sweeps) or a break cell zeroes the whole tail
    (3-4 sweeps). The while_loop exits as soon as a sweep is a no-op, at
    which point every equation holds exactly — bit-identical to the scan
    (tests/test_step.py cross-checks).
    """
    m1, K = prefix.shape
    m = m1 - 1
    lane = jnp.arange(m)
    zero = jnp.zeros((), prefix.dtype)

    def g(B):
        """Per-cell acceptance for start-budgets B (K,). Lane-major
        (M+1, K) layout keeps keywords on the vector lane axis."""
        valid = (prefix[1:, :] <= B[None, :]) & (lane[:, None] < n_clicks[None, :])
        ok = jnp.cumprod(valid.astype(jnp.int32), axis=0)
        p = jnp.sum(ok, axis=0).astype(jnp.int32)
        spend = jnp.take_along_axis(prefix, p[None, :], axis=0)[0]
        return p, spend

    def sweep(spend):
        excl = jnp.concatenate([zero[None], jnp.cumsum(spend)[:-1]])
        B = budget0 - excl
        p2, s2 = g(B)
        # sim_k: no break strictly before cell k (b_1..b_k all > 0)
        nb = B - s2
        alive = jnp.cumprod((nb > 0).astype(jnp.int32))
        sim = ~broken0 & jnp.concatenate(
            [jnp.ones((1,), bool), alive[:-1].astype(bool)]
        )
        return jnp.where(sim, s2, zero), jnp.where(sim, p2, 0), sim

    def cond(carry):
        spend, p, sim, changed, it = carry
        return changed & (it < max_iter)

    def body(carry):
        spend, p, sim, _c, it = carry
        s2, p2, sim2 = sweep(spend)
        changed = jnp.any(s2 != spend) | jnp.any(p2 != p)
        return s2, p2, sim2, changed, it + 1

    p0, s0 = g(jnp.full((K,), budget0, prefix.dtype))
    sim0 = jnp.full((K,), ~broken0)
    s0 = jnp.where(sim0, s0, zero)
    p0 = jnp.where(sim0, p0, 0)
    spend, p, sim, _, _ = lax.while_loop(
        cond, body, (s0, p0, sim0, jnp.asarray(True), jnp.asarray(0, jnp.int32))
    )
    b_path = budget0 - jnp.cumsum(spend)
    b_out = b_path[-1]
    broken_out = broken0 | jnp.any(b_path <= 0)
    return (b_out, broken_out), (p, spend, sim)


def _gate_keywords_lazy(
    budget0: Array,
    broken0: Array,
    prefix: Array,
    n_clicks: Array,
    max_iter: int,
) -> Tuple[Tuple[Array, Array], Tuple[Array, Array, Array]]:
    """Budget threading for NONDECREASING prefix columns (cents models).

    Same forward substitution as ``_gate_keywords_jacobi``, restructured
    around the observation that with non-negative costs a cell's response
    to its start budget B falls into three bulk-checkable classes:

      full    s_k <= B          accept all n_k clicks, spend s_k
      zero    prefix_k[1] > B   accept nothing (monotone prefix)
      partial otherwise         budget lands strictly inside the cell

    Per iteration the classes are evaluated for ALL cells with O(K) scalar
    math (s_k and the first-click cost are precomputed once), and only the
    FIRST partial cell is lane-resolved (O(M)). Exact after
    (#partial cells before the break) + 1 iterations — typically one day
    has at most one partial cell (where the budget runs out) — versus one
    O(K*M) sweep per iteration for Jacobi. Bit-identical outputs
    (tests/test_step.py cross-checks all gates).
    """
    m1, K = prefix.shape
    m = m1 - 1
    lane = jnp.arange(m)
    karange = jnp.arange(K)
    zero = jnp.zeros((), prefix.dtype)
    s_full = jnp.take_along_axis(prefix, n_clicks[None, :], axis=0)[0]
    first_cost = prefix[1] if m >= 1 else jnp.zeros((K,), prefix.dtype)

    # Invariant used throughout (proved by induction over cells within one
    # state snapshot): with B = budget0 - exclusive-cumsum(spend), every
    # cell before the first "bad" cell — one that is neither full
    # (s <= B, value independent of B), zero (first cost > B), nor
    # lane-resolved against exactly this B — holds its exact forward-
    # substitution value. One sweep reassigns class values, lane-resolves
    # the first bad cell, and exits when (a) the state is a fixed point
    # (=> no bad cells), or (b) the prefix before the first bad cell is
    # stable and breaks the budget there (later cells are masked anyway).
    def body(carry):
        spend, p, fixed, bres, _done, it = carry
        excl = jnp.concatenate([zero[None], jnp.cumsum(spend)[:-1]])
        B = budget0 - excl
        okres = fixed & (bres == B)
        okfull = s_full <= B
        okzero = first_cost > B
        spend2 = jnp.where(
            okres, spend, jnp.where(okfull, s_full, jnp.where(okzero, zero, spend))
        )
        p2 = jnp.where(
            okres, p, jnp.where(okfull, n_clicks, jnp.where(okzero, 0, p))
        )
        bad = ~(okres | okfull | okzero)
        j = jnp.min(jnp.where(bad, karange, K))
        jc = jnp.minimum(j, K - 1)
        # lane-resolve the first bad cell against its start budget
        col = jax.lax.dynamic_slice(prefix, (0, jc), (m1, 1))[:, 0]
        Bj = jnp.take(B, jc)
        okj = (col[1:] <= Bj) & (lane < jnp.take(n_clicks, jc))
        pj = jnp.sum(okj.astype(jnp.int32)).astype(jnp.int32)
        hit = (karange == j)
        spend2 = jnp.where(hit, col[pj], spend2)
        p2 = jnp.where(hit, pj, p2)
        fixed2 = fixed | hit
        bres2 = jnp.where(hit, Bj, bres)

        changed = (
            jnp.any(spend2 != spend)
            | jnp.any(p2 != p)
            | jnp.any(fixed2 != fixed)
            | jnp.any(bres2 != bres)
        )
        # early exit: prefix before j unchanged this sweep (so exact) and
        # the budget breaks inside it — everything after is masked
        stable_pre = ~jnp.any(((spend2 != spend) | (p2 != p)) & (karange < j))
        b_path = budget0 - jnp.cumsum(spend2)
        first_brk = jnp.min(jnp.where(b_path <= 0, karange, K))
        done = ~changed | (stable_pre & (first_brk < j))
        return spend2, p2, fixed2, bres2, done, it + 1

    def cond(carry):
        _s, _p, _f, _b, done, it = carry
        return ~done & (it < max_iter)

    spend, p, _f, _b, _done, _it = lax.while_loop(
        cond,
        body,
        (
            jnp.zeros((K,), prefix.dtype),
            jnp.zeros((K,), jnp.int32),
            jnp.zeros((K,), bool),
            jnp.zeros((K,), prefix.dtype),
            jnp.asarray(broken0),
            jnp.asarray(0, jnp.int32),
        ),
    )
    # identical epilogue to the Jacobi gate: mask cells at/after the break
    nb = budget0 - jnp.cumsum(spend)
    alive = jnp.cumprod((nb > 0).astype(jnp.int32))
    sim = ~broken0 & jnp.concatenate(
        [jnp.ones((1,), bool), alive[:-1].astype(bool)]
    )
    spend = jnp.where(sim, spend, zero)
    p = jnp.where(sim, p, 0)
    b_path = budget0 - jnp.cumsum(spend)
    return (b_path[-1], broken0 | jnp.any(b_path <= 0)), (p, spend, sim)


def _gate_keywords_lazy_agg(
    budget0: Array,
    broken0: Array,
    s_full: Array,
    lite_costs: Array,
    n_clicks: Array,
    resolve_fn,
    max_iter: int,
) -> Tuple[Tuple[Array, Array], Tuple[Array, Array, Array]]:
    """Lazy budget gate over AGGREGATE per-cell spend draws.

    ``cost_sampling="agg"``'s counterpart of ``_gate_keywords_lazy``:
    instead of (M+1, N) prefix tables each cell carries the aggregate
    full-cell spend ``s_full[j]`` plus a small "lite" lane table
    ``lite_costs[:, j]`` — its FIRST L per-click cost draws (L =
    ``EnvConfig.agg_lite_lanes``), drawn in the sampling phase from the
    lane stream's dedicated lite key so they are bit-consistent with the
    first L entries of ``resolve_fn``'s lane column. The per-cell
    acceptance rule evaluated each sweep is

        g_j(B) = (n_j, s_full[j])       if s_full[j] <= B           (full)
                 lite-prefix resolution if n_j <= L or
                                           lite_prefix[L, j] > B    (lite)
                 resolve_fn(j, B, n_j, onehot(j))  otherwise        (deep)

    The lite class is resolved for ALL cells in the bulk O(L*N) pass: when
    acceptance is decided within the first L lanes (every lane < n_j is in
    the table, or the L-lane prefix already exceeds B), the maximal
    affordable prefix over the lite table IS the full resolution. This is
    what keeps budget-decay tails cheap — after the budget is effectively
    exhausted mid-day (remaining B below a few click costs but still > 0;
    the reference only breaks at B <= 0), every remaining cell accepts
    0..L clicks and bulk-classifies, so the while loop runs only for
    cells whose budget lands beyond lane L (typically the single
    exhaustion cell of the day). Without it each tail cell with a cheap
    first click costs one full lockstep sweep — across a vmapped batch
    the WORST env's chain length serializes everyone.

    (Multi-round resolution per iteration — W classify+resolve rounds —
    was tried and removed: the deep-resolve RNG chain makes a round
    about as expensive as a lockstep iteration, and budget-decay chains
    expose exactly one new deep cell per classification.)

    Before the while loop one resolve-free classification pass runs
    UNROLLED (the "warm init"): with zero initial spends every cell sees
    B = budget0, so the pass is pure bulk math that XLA fuses into the
    sampling phase — gates whose budget never binds then converge after
    a single in-loop confirmation sweep.

    Shape discipline: every per-sweep op is elementwise, a reduction,
    or a scalar-indexed slice/take. In particular the lite resolution
    uses the prefix-mask identity ``spend = sum(costs * accept_mask)``
    instead of a per-column gather (a (L+1, N) take_along_axis in the
    while body lowered to a serialized gather under vmap), and the deep
    resolution writes back through a broadcast one-hot select, not a
    scatter. Whether each idiom still pays on the GPU is ROADMAP S5. Sweep scheme and epilogue
    identical to ``_gate_keywords_lazy``; bit-identical to the
    sequential ``_gate_keywords_scan_agg`` cross-validation gate
    (tests/test_step.py cross-checks all scopes and resolve widths).
    """
    state = _lazy_agg_warm(budget0, broken0, s_full, lite_costs, n_clicks)
    state = _lazy_agg_loop(
        budget0, s_full, lite_costs, n_clicks, resolve_fn, max_iter, state
    )
    if _GATE_STATS_HOOK is not None:
        _GATE_STATS_HOOK(state[5])
    return _lazy_agg_epilogue(budget0, broken0, state[0], state[1])


def _lazy_agg_classify(budget0, s_full, n_clicks, lite_costs, spend, p, fixed, bres):
    """One bulk class pass of the lazy-agg gate: returns updated
    (spend, p) and the bad mask (cells neither full, cached-resolved,
    nor lite-decided)."""
    L = lite_costs.shape[0]
    lane_l = jnp.arange(L)
    zero = jnp.zeros((), s_full.dtype)
    # (L, N) lite prefix — B-independent; XLA CSEs it across the passes
    # of one gate call
    lite_cum = jnp.cumsum(lite_costs, axis=0)
    lite_end = lite_cum[L - 1]
    lite_decided_static = n_clicks <= L  # all relevant lanes in the table

    excl = jnp.concatenate([zero[None], jnp.cumsum(spend)[:-1]])
    B = budget0 - excl
    # class order matters: scan-agg checks FULL first, so a cached
    # deep resolution (okres) must never shadow a full-by-aggregate
    # cell — resolutions are stored for budgets where the cell was
    # bad (s_full > B), so okres and okfull are disjoint anyway
    okfull = s_full <= B
    okres = ~okfull & fixed & (bres == B)
    # lite resolution: accepted clicks = lanes before the FIRST prefix
    # violation (cumprod turns the feasibility mask into a stop-at-first
    # -violation prefix mask — identical for non-negative costs, where
    # the cumsum is nondecreasing, and exact for the pool model's
    # possibly-negative costs); the accepted spend is then the masked
    # cost sum — no gather.
    okl = (lite_cum <= B[None, :]) & (lane_l[:, None] < n_clicks[None, :])
    okl_i = jnp.cumprod(okl.astype(jnp.int32), axis=0)
    p_lite = jnp.sum(okl_i, axis=0).astype(jnp.int32)
    s_lite = jnp.sum(lite_costs * okl_i.astype(lite_costs.dtype), axis=0)
    oklite = ~okfull & (lite_decided_static | (lite_end > B))
    spend2 = jnp.where(
        okfull, s_full, jnp.where(okres, spend, jnp.where(oklite, s_lite, spend))
    )
    p2 = jnp.where(
        okfull, n_clicks, jnp.where(okres, p, jnp.where(oklite, p_lite, p))
    )
    bad = ~(okres | okfull | oklite)
    return spend2, p2, bad


def _lazy_agg_warm(budget0, broken0, s_full, lite_costs, n_clicks):
    """Warm init: TWO resolve-free class passes outside the loop (pure
    bulk math, fused into the sampling phase by XLA — no lockstep
    iteration cost). Pass 1 classifies everything against B = budget0;
    pass 2 re-classifies against the resulting budget path AND
    evaluates the done-condition on it, so a gate whose budget never
    binds (or breaks early with a stable prefix) enters the while loop
    with done already True and runs ZERO iterations — under vmap this
    keeps quiet gate calls from paying the worst env's chain, and under
    the compacted batch gate it is what makes those envs skippable
    entirely. Returns the full loop state tuple
    (spend, p, fixed, bres, done, it) with broken0 folded into done and
    the iteration counter at 2 (the two warm passes).
    """
    n = s_full.shape[0]
    karange = jnp.arange(n)
    f0 = jnp.zeros((n,), bool)
    br0 = jnp.zeros((n,), s_full.dtype)
    spend1, p1, _bad1 = _lazy_agg_classify(
        budget0, s_full, n_clicks, lite_costs,
        jnp.zeros((n,), s_full.dtype), jnp.zeros((n,), jnp.int32), f0, br0,
    )
    spend2w, p2w, bad2 = _lazy_agg_classify(
        budget0, s_full, n_clicks, lite_costs, spend1, p1, f0, br0
    )
    j2 = jnp.min(jnp.where(bad2, karange, n))
    changed2 = jnp.any(spend2w != spend1) | jnp.any(p2w != p1)
    stable2 = ~jnp.any(((spend2w != spend1) | (p2w != p1)) & (karange < j2))
    b_path2 = budget0 - jnp.cumsum(spend2w)
    brk2 = jnp.min(jnp.where(b_path2 <= 0, karange, n))
    done0 = (~changed2 & ~jnp.any(bad2)) | (stable2 & (brk2 < j2))
    return (
        spend2w,
        p2w,
        f0,
        br0,
        jnp.asarray(broken0) | done0,
        jnp.asarray(2, jnp.int32),
    )


def _lazy_agg_loop(
    budget0, s_full, lite_costs, n_clicks, resolve_fn, max_iter, state
):
    """The lockstep classify+deep-resolve while loop.

    ``state`` is the (spend, p, fixed, bres, done, it) tuple produced by
    ``_lazy_agg_warm`` (or by a previous, iteration-capped call — the
    compacted batch gate runs a bounded full-batch phase and RESUMES the
    stragglers from their exact mid-loop state, cached deep resolutions
    included). Returns the updated state; ``it`` counts warm passes +
    loop iterations so per-env gate_stats records line up across
    rounds."""
    n = s_full.shape[0]
    karange = jnp.arange(n)
    zero = jnp.zeros((), s_full.dtype)

    def body(carry):
        spend, p, fixed, bres, _done, it = carry
        spend2, p2, bad = _lazy_agg_classify(
            budget0, s_full, n_clicks, lite_costs, spend, p, fixed, bres
        )
        j = jnp.min(jnp.where(bad, karange, n))
        # deep-resolve the first bad cell against budgets recomputed
        # from this round's classified spends. All cell-indexed
        # reads go through the one-hot mask (never jnp.take /
        # dynamic_slice with a traced index: under vmap those lower
        # to per-env gathers inside the loop). When no cell is
        # bad the mask is all-false, the resolver runs on zero
        # inputs and its output is discarded by the same mask.
        hit = karange == j
        excl = jnp.concatenate([zero[None], jnp.cumsum(spend2)[:-1]])
        B = budget0 - excl
        hot = hit.astype(B.dtype)
        Bj = jnp.sum(B * hot)
        nkj = jnp.sum(n_clicks * hit.astype(n_clicks.dtype))
        pj, sj = resolve_fn(j, Bj, nkj, hit)
        spend2 = jnp.where(hit, sj, spend2)
        p2 = jnp.where(hit, pj, p2)
        fixed2 = fixed | hit
        bres2 = jnp.where(hit, Bj, bres)
        changed = (
            jnp.any(spend2 != spend)
            | jnp.any(p2 != p)
            | jnp.any(fixed2 != fixed)
            | jnp.any(bres2 != bres)
        )

        # exit checks: ~changed means the sweep was a no-op, i.e. a
        # genuine fixed point; the second exit needs the pre-j prefix
        # stable this sweep and a budget break strictly before j
        stable_pre = ~jnp.any(((spend2 != spend) | (p2 != p)) & (karange < j))
        b_path = budget0 - jnp.cumsum(spend2)
        first_brk = jnp.min(jnp.where(b_path <= 0, karange, n))
        done = ~changed | (stable_pre & (first_brk < j))
        return spend2, p2, fixed2, bres2, done, it + 1

    def cond(carry):
        _s, _p, _f, _b, done, it = carry
        return ~done & (it < max_iter)

    return lax.while_loop(cond, body, state)


def _lazy_agg_epilogue(budget0, broken0, spend, p):
    """Identical epilogue to the lazy/Jacobi gates: mask cells at/after
    the first budget break, thread the final budget.

    One cumsum instead of the r4 cumsum+cumprod+cumsum: cells at/after
    the first break are masked to zero, so the post-mask budget path is
    the pre-mask path frozen at the break cell — its final value is the
    budget AT the break (a one-hot read), and the break flag is just
    "a break exists". Bit-identical outputs (tests cross-check vs the
    sequential scan gate)."""
    n = spend.shape[0]
    karange = jnp.arange(n)
    zero = jnp.zeros((), spend.dtype)
    nb = budget0 - jnp.cumsum(spend)
    brk = nb <= 0
    first_brk = jnp.min(jnp.where(brk, karange, n))
    sim = ~broken0 & (karange <= first_brk)
    spend = jnp.where(sim, spend, zero)
    p = jnp.where(sim, p, 0)
    any_brk = jnp.any(brk)
    # post-mask final budget: nb at the break cell if one exists (cells
    # after it spend nothing), else nb[-1]; if broken0 nothing ran
    b_at = jnp.sum(jnp.where(karange == first_brk, nb, zero))
    b_out = jnp.where(broken0, budget0, jnp.where(any_brk, b_at, nb[-1]))
    return (b_out, broken0 | (~broken0 & any_brk)), (p, spend, sim)


def _make_agg_gate(
    make_resolve,
    gate_mode: str,
    compact: bool,
    phase_a: int,
    cap: int,
    min_batch: int = 64,
):
    """Build the callable for one agg gate call site, with the STRAGGLER
    COMPACTION batching rule.

    The returned function has the pure-array signature

        gate(budget0, broken0, s_full, lite, n_clicks, cell_aux, t_base,
             k_cells, *params) -> ((b, broken), (p, spend, sim))

    where ``make_resolve(lite, cell_aux, t_base, k_cells, *params)``
    builds the deep-resolution closure from those same arrays
    (everything the resolver touches is an explicit argument, so the
    function is batchable with no captured per-env tracers).
    ``cell_aux`` is a per-cell (N,) side table for models whose
    resolver needs per-cell state beyond the lite costs — the binomial
    pool's bidder counts; zeros for the other models.

    Unbatched (or ``compact=False``, or the "scan" cross-validation
    mode) it is exactly the round-4 gate. Under ``jax.vmap`` a
    ``jax.custom_batching.custom_vmap`` rule replaces the lockstep
    batched while loop with a three-phase schedule:

      1. warm init for the whole batch (pure bulk math — fused);
      2. ``phase_a`` full-batch lockstep iterations (quiet envs are
         already done and cost nothing; most active envs finish here —
         the budget-break chunk activates ~95% of envs but the median
         env needs only a couple of sweeps, scripts/gate_stats.py);
      3. the (usually few) still-unconverged envs are COMPACTED —
         gathered into a ``cap``-row buffer, resumed from their exact
         mid-loop state (cached deep resolutions included) to
         convergence, and scattered back. Every lockstep iteration of
         the deep tail then costs O(cap * N) instead of O(E * N) —
         under vmap the batch pays the worst env's iteration count.

    If more than ``cap`` envs are still unconverged, the whole batch
    resumes lockstep (the round-4 behavior) — a runtime branch, so
    correctness never depends on the cap. Per-env results are
    bit-identical in all paths: a batched while loop freezes each row's
    carry once that row's cond is false, so batch composition cannot
    change any row's values.
    """
    from functools import partial

    def impl(
        budget0, broken0, s_full, lite, n_clicks, cell_aux, t_base,
        k_cells, *params,
    ):
        # literal operands can reach here as bare numpy wrappers through
        # the custom_vmap machinery (observed under vmap-of-scan); make
        # them jnp values before any operator touches them
        budget0 = jnp.asarray(budget0)
        broken0 = jnp.asarray(broken0)
        t_base = jnp.asarray(t_base)
        resolve = make_resolve(lite, cell_aux, t_base, k_cells, *params)
        if gate_mode == "scan":
            return _gate_keywords_scan_agg(
                budget0, broken0, s_full, n_clicks, resolve
            )
        return _gate_keywords_lazy_agg(
            budget0, broken0, s_full, lite, n_clicks, resolve,
            max_iter=s_full.shape[0] + 2,
        )

    if gate_mode == "scan" or not compact:
        return impl

    gate = custom_vmap(impl)

    @gate.def_vmap
    def _rule(axis_size, in_batched, *args):
        out_batched = ((True, True), (True, True, True))
        flat_batched = jax.tree.leaves(in_batched)

        def plain(*a):
            in_axes = tuple(0 if b else None for b in flat_batched)
            return jax.vmap(impl, in_axes=in_axes)(*a)

        if axis_size < min_batch:
            return plain(*args), out_batched

        def bc(x):
            return jnp.broadcast_to(x, (axis_size,) + jnp.shape(x))

        args = tuple(a if b else bc(a) for a, b in zip(args, flat_batched))
        b0, br0, sf, lt, ncl, aux, t_base, kc, *params = args
        b0 = jnp.asarray(b0)
        br0 = jnp.asarray(br0)
        t_base = jnp.asarray(t_base)
        n = sf.shape[1]
        max_iter = n + 2

        state = jax.vmap(_lazy_agg_warm)(b0, br0, sf, lt, ncl)
        loop_args = (b0, sf, lt, ncl, aux, t_base, kc) + tuple(params)

        def loop_one(cap_it, state, b0, sf, lt, ncl, aux, t_base, kc, *params):
            resolve = make_resolve(lt, aux, t_base, kc, *params)
            return _lazy_agg_loop(
                b0, sf, lt, ncl, resolve, cap_it, state
            )

        if phase_a > 0:
            state = jax.vmap(
                partial(loop_one, min(max_iter, 2 + phase_a))
            )(state, *loop_args)

        S = cap if cap > 0 else max(min_batch, axis_size // 4)
        S = min(S, axis_size)
        not_done = ~state[4]
        n_strag = jnp.sum(not_done.astype(jnp.int32))
        finish = jax.vmap(partial(loop_one, max_iter))

        def run_full(state):
            return finish(state, *loop_args)

        def run_compact(state):
            # the first S straggler rows; fill rows re-run an
            # already-done env, whose frozen loop is a no-op, so
            # duplicate scatters write back unchanged values
            idx = jnp.nonzero(not_done, size=S, fill_value=0)[0]

            def take(x):
                return jax.tree.map(lambda a: a[idx], x)

            sub = finish(take(state), *(take(a) for a in loop_args))
            return jax.tree.map(lambda a, s: a.at[idx].set(s), state, sub)

        def run_any(state):
            return lax.cond(n_strag <= S, run_compact, run_full, state)

        # quiet-call fast path: when warm init converged EVERY env (the
        # common case away from the budget-break chunk, and every call
        # in budget-unconstrained regimes) skip the gather/loop/scatter
        # machinery entirely — this is what keeps the compaction rule
        # from taxing configs whose gates never bind
        state = lax.cond(n_strag == 0, lambda s: s, run_any, state)
        if _GATE_STATS_HOOK is not None:
            _GATE_STATS_HOOK(state[5])
        outs = jax.vmap(_lazy_agg_epilogue)(b0, br0, state[0], state[1])
        return outs, out_batched

    return gate


def _gate_keywords_scan_agg(
    budget0: Array,
    broken0: Array,
    s_full: Array,
    n_clicks: Array,
    resolve_fn,
) -> Tuple[Tuple[Array, Array], Tuple[Array, Array, Array]]:
    """Sequential cross-validation gate for ``cost_sampling="agg"``.

    Evaluates the same per-cell rule as ``_gate_keywords_lazy_agg`` —
    aggregate draw when it fits, lane resolution otherwise — one cell at
    a time (resolving EVERY cell, so it re-pays the lane cost; test use
    only). The lazy gate's lite class needs no special case here:
    ``resolve_fn``'s lane column starts with the SAME draws as the lite
    table (both come from the dedicated lite key), so full lane
    resolution agrees wherever acceptance is decided within the first L
    lanes. Bit-identical to the lazy-agg gate by construction.
    """
    n = s_full.shape[0]
    karange = jnp.arange(n)

    def body(carry, xs):
        b, broken = carry
        sfull_j, nk, j = xs
        full = sfull_j <= b
        pj, sj = resolve_fn(j, b, nk, karange == j)
        p = jnp.where(full, nk, pj)
        spend = jnp.where(full, sfull_j, sj)
        p = jnp.where(broken, 0, p)
        spend = jnp.where(broken, jnp.zeros_like(spend), spend)
        nb = b - spend
        return (nb, broken | (nb <= 0)), (p, spend, ~broken)

    return lax.scan(body, (budget0, broken0), (s_full, n_clicks, karange))


def _cell_tables(
    cfg: EnvConfig, k_cells, kw, bids, t, n_auc_t, m: int, dtype,
    cost_moments=None, lite_lanes: int = 0, imp_ladder=None,
    agg_scale: float = 100.0,
):
    """Sample one sub-timestep's draw tables, prefix-summed for gating.

    Returns (impressions (K,), n_clicks (K,), cost_prefix (m+1, K),
    conv_prefix (m+1, K), rev_prefix (m+1, K)). The key tree
    (``fold_in(k_cells, t)`` then a 4-way site split) is the contract
    mirrored by ``sample_day_draws``; it is identical whether cells are
    sampled sequentially or vmapped over ``t``.

    With ``cost_sampling="agg"`` (``cost_moments`` = the day's
    (mu, sigma, cmax) per-keyword cent moments) the (m, K) cost table is
    replaced by ONE aggregate full-cell spend draw per cell: the third
    output is ``s_full`` (K,) in integer cents instead of a prefix table.
    The impression/click draws use the same key slots either way (their
    streams are bit-identical across cost modes); the cost stream
    differs (``k_cost`` is split into aggregate/lane-resolution sites).
    """
    K = kw.num_keywords
    kt = jax.random.fold_in(k_cells, t)
    k_auc, k_click, k_conv, k_rev = jax.random.split(kt, 4)

    if cfg.cost_sampling == "agg":
        from adcraft_tpu.auction import implicit_single_win_prob

        cents_dtype = jnp.int64 if cfg.use_x64 else jnp.int32
        explicit = cfg.kind is KeywordKind.EXPLICIT
        pool = (
            cfg.kind is KeywordKind.IMPLICIT
            and cfg.competitor_model is CompetitorModel.BINOMIAL_POOL
        )
        bfn = cell_binomial_fn(cfg, m)
        if pool:
            # mirror implicit_pool_auction's key structure exactly
            # (k_bidders/k_imp/k_cost) so the bidder-count and impression
            # streams are bit-identical to the lanes path; per-click cost
            # moments are CONDITIONAL on the cell's bidder count k (drawn
            # once per cell, reference synthetic_kw_classes.py:621), so
            # the k-correlation of a cell's clicks is preserved exactly
            # at the aggregate level
            from adcraft_tpu.auction import bidder_binomial_fn

            k_bidders, k_imp, k_cost = jax.random.split(k_auc, 3)
            kvec = bidder_binomial_fn(cfg)(
                k_bidders, kw.max_bidders, kw.participation_rate
            ).astype(jnp.float32)
            f_bid = dist.laplace_cdf(bids, kw.bid_loc, kw.bid_scale)
            p_win = jnp.where(
                kvec > 0, f_bid ** jnp.maximum(kvec, 1.0), 1.0
            )
            # barrier: without it XLA rematerializes the transcendental
            # p_win (exp/log power) inside every unrolled level of the
            # impression walk below
            kvec, p_win = jax.lax.optimization_barrier((kvec, p_win))
            impressions = bfn(k_imp, n_auc_t, p_win)
            n_clicks = bfn(k_click, impressions, kw.bctr)
            mu_c, sig_c, cmax_c = dist.pool_cost_deci_moments(
                bids, kw.bid_loc, kw.bid_scale, kvec
            )
            k_sfull, k_lanes = jax.random.split(k_cost)
            # k >= 3 cells can have NEGATIVE costs (raw Laplace max):
            # clip the aggregate draw to [-n*cmax, n*cmax] there
            cmin_c = jnp.where(kvec >= 3.0, -cmax_c, 0.0)
            s_full = dist.agg_cost_cents(
                k_sfull, n_clicks, mu_c, sig_c, cmax_c, cents_dtype,
                cmin=cmin_c, bits=cfg.agg_draw_bits,
            )
            k_lite = jax.random.split(k_lanes)[0]
            d0 = dist.pool_cost_lane_draws(
                k_lite, bids[None, :], kw.bid_loc[None, :],
                kw.bid_scale[None, :], kvec[None, :], (lite_lanes, K),
                bits=cfg.lane_bits,
            )
            lite_costs = jnp.round(d0 * agg_scale).astype(cents_dtype)
            out = [impressions, n_clicks, s_full, lite_costs, kvec]
            return _append_conv_rev_tables(
                cfg, kw, out, k_conv, k_rev, m, K, dtype
            )
        # same key slots as implicit_single_auction / explicit_auction
        # (k_imp for the win binomial); k_cost's aggregate site is
        # split(k_cost)[0], its lane-resolution site split(k_cost)[1]
        # (consumed in the gate's resolve_fn for budget-partial cells
        # only)
        k_imp, k_cost = jax.random.split(k_auc)
        if imp_ladder is not None and cfg.binomial_sampler == "inversion":
            # tier-1 hoist: n_auc_t = vol//T and the win probability are
            # sub-timestep-invariant, so the caller built the CDF ladder
            # once for the whole day; only the one-uniform compare runs
            # here (same key slot and bit width — stream-identical).
            impressions = dist.binomial_inv_from_cdf(
                k_imp, imp_ladder, bits=cfg.lane_bits
            )
        else:
            if explicit:
                p_win = dist.threshold_sigmoid(
                    bids, kw.imp_thresh, kw.imp_intercept, kw.imp_slope
                )
            else:
                p_win = implicit_single_win_prob(bids, kw.bid_loc, kw.bid_scale)
            impressions = bfn(k_imp, n_auc_t, p_win)
        if explicit:
            # phantom-click quirk (auction.explicit_auction): a
            # zero-impression cell still flips ONE zero-cost candidate,
            # so its clicks can convert but never spend
            phantom = impressions == 0
            candidates = jnp.maximum(impressions, 1)
        else:
            phantom = None
            candidates = impressions
        n_clicks = bfn(k_click, candidates, kw.bctr)
        k_sfull, k_lanes = jax.random.split(k_cost)
        mu_c, sig_c, cmax_c = cost_moments
        s_full = dist.agg_cost_cents(
            k_sfull, n_clicks, mu_c, sig_c, cmax_c, cents_dtype,
            bits=cfg.agg_draw_bits,
        )
        # each cell's FIRST L per-click costs (the "lite" lane table),
        # from the lane stream's dedicated lite key (split(k_lanes)[0]) —
        # the gate's bulk resolution of cells decided within L lanes
        # (budget-exhausted tails), bit-consistent with _resolve_cell's
        # lane column whose first L entries are exactly these draws
        lite = lite_lanes
        k_lite = jax.random.split(k_lanes)[0]
        if explicit:
            cost_fn = (
                dist.cost_create
                if cfg.cost_model is CostModel.RUST_QUIRK
                else dist.generic_cost
            )
            d0 = cost_fn(k_lite, bids[None, :], (lite, K))
            lite_costs = jnp.round(d0 * agg_scale).astype(cents_dtype)
            s_full = jnp.where(phantom, 0, s_full)
            lite_costs = jnp.where(phantom[None, :], 0, lite_costs)
        else:
            y0 = bids - 0.005
            tr0 = dist.truncated_laplace(
                k_lite, kw.bid_loc[None, :], kw.bid_scale[None, :],
                -y0[None, :], y0[None, :], (lite, K), bits=cfg.lane_bits,
            )
            lite_costs = jnp.round(jnp.abs(tr0) * 100.0).astype(cents_dtype)
        # trailing zeros: the per-cell aux table (bidder counts) only the
        # pool model populates — kept in the tuple so gate plumbing is
        # uniform across agg models
        out = [
            impressions, n_clicks, s_full, lite_costs,
            jnp.zeros((K,), jnp.float32),
        ]
    else:
        # NB all (M, K) tensors are lane-major: K rides the 128-lane axis
        # (K ~ 100 pads 1.28x vs 2.7x for M ~ 48 on the lane axis)
        cell = run_cell_auctions(
            cfg, k_auc, bids, n_auc_t, kw, dtype=dtype, max_clicks=m
        )
        impressions = cell.impressions
        # buyside click coinflips per candidate
        # (synthetic_kw_classes.py:207-219)
        n_clicks = cell_binomial_fn(cfg, m)(k_click, cell.n_candidates, kw.bctr)
        # prefix-sum the clicked-cost draws for budget gating. Cents models
        # gate in exact integer cents (cfg.cents_costs — association-free,
        # exact even in f32 mode); continuous models gate in the money
        # dtype. Lanes at/after n_clicks are masked inside the gate.
        if cfg.cents_costs:
            cents_dtype = jnp.int64 if cfg.use_x64 else jnp.int32
            costs = jnp.round(cell.cost_draws * 100.0).astype(cents_dtype)
            pad = jnp.zeros((1, K), cents_dtype)
        else:
            costs = cell.cost_draws
            pad = jnp.zeros((1, K), dtype)
        cost_prefix = jnp.concatenate([pad, jnp.cumsum(costs, axis=0)], axis=0)
        out = [impressions, n_clicks, cost_prefix]
    return _append_conv_rev_tables(cfg, kw, out, k_conv, k_rev, m, K, dtype)


def _append_conv_rev_tables(cfg, kw, out, k_conv, k_rev, m, K, dtype):
    """Shared tail of ``_cell_tables``: the lanes-mode conversion and
    revenue prefix tables (skipped entirely in counts/sum/day modes,
    which draw after gating from the same key slots)."""
    if cfg.conv_sampling == "lanes":
        # sellside conversion coinflips (bidding_simulation.py:106-109;
        # coinflips are `u <= p`, synthetic_kw_helpers.py:73-77). Flags are
        # drawn per candidate and the first `accepted` consumed, so the
        # draw table is independent of budget gating (the oracle injects
        # these, tests/test_step.py). In "counts" mode conversions are
        # instead drawn per cell AFTER gating as Binomial(accepted, sctr)
        # from the same k_conv key slot.
        conv_flags = (
            jax.random.uniform(k_conv, (m, K)) <= kw.sctr[None, :]
        ).astype(jnp.int32)
        conv_prefix = jnp.concatenate(
            [jnp.zeros((1, K), jnp.int32), jnp.cumsum(conv_flags, axis=0)],
            axis=0,
        )
        out.append(conv_prefix)
    if cfg.rev_sampling == "lanes":
        # revenue draws are always cent-quantized (rev_normal_cents); sum
        # them as exact integer cents so accumulation order cannot matter.
        # In "sum" mode one aggregate draw per cell is taken AFTER gating
        # from the same k_rev key slot (dist.rev_sum_cents).
        rev_draws = dist.rev_normal_cents(
            k_rev, kw.rev_mean[None, :], kw.rev_std[None, :], (m, K), dtype=dtype
        )
        rev_dtype = jnp.int64 if cfg.use_x64 else jnp.int32
        rev_cents = jnp.round(rev_draws * 100.0).astype(rev_dtype)
        rev_prefix = jnp.concatenate(
            [jnp.zeros((1, K), rev_dtype), jnp.cumsum(rev_cents, axis=0)],
            axis=0,
        )
        out.append(rev_prefix)
    return tuple(out)


def simulate_day(
    cfg: EnvConfig,
    key: Array,
    kw: KeywordState,
    bids: Array,
    budget: Array,
    dtype=None,
) -> DayOutcomes:
    """Simulate one full day (24 sub-timesteps) of campaign bidding.

    Pure function: (key, keyword state, bids (K,), scalar budget) ->
    per-keyword DayOutcomes. Equivalent to
    ``simulate_epoch_of_bidding_on_campaign`` (bidding_simulation.py:170-234).

    Structure: (1) one fully parallel sampling phase over the whole
    (sub-timestep, keyword) grid — vmap over the sub-timestep index with
    the same fold_in key tree as a sequential loop, so draws are
    bit-identical either way; (2) ONE budget gate over all T*K cells in
    lexicographic order (the only sequential dependency of the day);
    (3) parallel gathers and reductions.
    """
    if dtype is None:
        dtype = cfg.money_dtype
    K = kw.num_keywords
    T = cfg.timesteps_per_day
    cents = cfg.cents_costs

    k_vol, k_cells = jax.random.split(key)
    volume = dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std)
    volume = jnp.minimum(volume, cfg.max_volume)
    n_auctions = split_volume(cfg, volume)  # (T, K)

    agg = cfg.cost_sampling == "agg"
    gate_mode = cfg.gate_mode
    if gate_mode == "auto":
        gate_mode = "lazy" if cents else "jacobi"
    if gate_mode == "lazy" and not cents:
        gate_mode = "jacobi"  # lazy needs nondecreasing (nonneg-cost) prefixes

    def gate(b, broken, prefix, n_clicks):
        if gate_mode == "lazy":
            return _gate_keywords_lazy(
                b, broken, prefix, n_clicks, max_iter=prefix.shape[1] + 2
            )
        if gate_mode == "jacobi":
            return _gate_keywords_jacobi(
                b, broken, prefix, n_clicks, max_iter=prefix.shape[1] + 2
            )
        return _gate_keywords(b, broken, prefix, n_clicks)

    if agg:
        cdt_agg = jnp.int64 if cfg.use_x64 else jnp.int32
        agg_explicit = cfg.kind is KeywordKind.EXPLICIT
        agg_pool = (
            cfg.kind is KeywordKind.IMPLICIT
            and cfg.competitor_model is CompetitorModel.BINOMIAL_POOL
        )
        # exact per-click cost moments — once per day (bid-dependent,
        # sub-timestep-independent). Units: the agg gate always runs in
        # exact integers — cents for cent-quantized models, DECICENTS for
        # the continuous rust-quirk explicit and binomial-pool models (a
        # documented agg-only quantization, PARITY.md "Aggregate cost
        # sampling").
        if agg_pool:
            # moments are conditional on each cell's bidder-count draw,
            # so they live in the sampling phase (_cell_tables), not here
            agg_scale = 1000.0
            cost_moments = None
        elif agg_explicit:
            if cfg.cost_model is CostModel.RUST_QUIRK:
                agg_scale = 1000.0
                cost_moments = dist.cost_create_deci_moments(bids)
            else:
                agg_scale = 100.0
                cost_moments = dist.generic_cost_cent_moments(
                    bids, cfg.agg_cost_grid
                )
            expl_cost_fn = (
                dist.cost_create
                if cfg.cost_model is CostModel.RUST_QUIRK
                else dist.generic_cost
            )
        else:
            agg_scale = 100.0
            # closed-form geometric-series moments (exact for every bid,
            # no (grid, K) tail table in the step — the grid version
            # remains the cross-check, tests/test_distributions.py)
            cost_moments = dist.single_cost_cent_moments_closed(
                bids, kw.bid_loc, kw.bid_scale
            )
        # uniform lite-lane count across both buffer tiers so the global
        # scope can stack the (L, K) lite tables over sub-timesteps
        L_lite = min(cfg.agg_lite_lanes, cfg.max_clicks_rest)

        bids_f = jnp.asarray(bids)

        def _resolve_cell(kc, t, k, lite_col, loc, scale, y0, kj, B, nk, m):
            """Lane-materialize ONE budget-partial cell's cost draws.

            The column's first L entries are the already-sampled lite
            lane draws ``lite_col`` (drawn from split(k_lanes)[0] in
            _cell_tables — the gate's bulk-resolution values); lanes
            L..m-1 come from a fresh keyed stream (split(k_lanes)[1]
            folded by keyword), distinct from the aggregate-draw site.
            Per-keyword params (lite_col, loc, scale, y0) arrive
            pre-read by the caller's one-hot contractions — this body
            contains NO traced-index memory op (see the gate docstring
            on shape discipline); ``t``/``k`` feed only scalar
            fold_ins. (Precomputing these keys in the sampling phase
            and one-hot-reading them in the gate was slower, so the
            in-gate fold chain stays.) For
            explicit keywords the lane sampler is the parametric cost
            model on the one-hot-read bid (``y0`` carries bid - 0.005;
            phantom cells never deep-resolve, their s_full is 0); for
            the binomial pool it is the conditional max-of-k law on the
            cell's one-hot-read bidder count ``kj`` (cell_aux). Returns
            the first-violation-stop prefix (accepted clicks, spend in
            gate units)."""
            kt = jax.random.fold_in(kc, t)
            k_auc = jax.random.split(kt, 4)[0]
            if agg_pool:
                k_cost = jax.random.split(k_auc, 3)[2]
            else:
                k_cost = jax.random.split(k_auc)[1]
            k_lanes = jax.random.split(k_cost)[1]
            k_rest = jax.random.split(k_lanes)[1]
            k_col = jax.random.fold_in(k_rest, k)
            if m > L_lite:
                if agg_pool:
                    d = dist.pool_cost_lane_draws(
                        k_col, y0 + 0.005, loc, scale, kj, (m - L_lite,),
                        bits=cfg.lane_bits,
                    )
                    rest = jnp.round(d * agg_scale).astype(cdt_agg)
                elif agg_explicit:
                    d = expl_cost_fn(k_col, y0 + 0.005, (m - L_lite,))
                    rest = jnp.round(d * agg_scale).astype(cdt_agg)
                else:
                    tr = dist.truncated_laplace(
                        k_col, loc, scale, -y0, y0, (m - L_lite,),
                        bits=cfg.lane_bits,
                    )
                    rest = jnp.round(jnp.abs(tr) * 100.0).astype(cdt_agg)
                costs = jnp.concatenate([lite_col.astype(cdt_agg), rest])
            else:
                costs = lite_col[:m].astype(cdt_agg)
            csum = jnp.cumsum(costs)
            # stop at the FIRST violating prefix (cumprod) — same as the
            # feasibility mask for non-negative costs, exact for the
            # pool model's signed costs
            ok = jnp.cumprod(
                ((csum <= B) & (jnp.arange(m) < nk)).astype(jnp.int32)
            )
            pj = jnp.sum(ok).astype(jnp.int32)
            sj = jnp.sum(costs * ok.astype(cdt_agg))
            return pj, sj

        def _make_resolve(m):
            """``make_resolve`` builder for ``_make_agg_gate``: one call
            site's deep resolver, built from that site's EXPLICIT arrays
            (lite table, sub-timestep base, cell-stream key, bids and —
            implicit only — Laplace params). Nothing per-env is captured
            from the enclosing trace, so the custom_vmap batching rule
            can re-invoke it on gathered straggler rows. All cell reads
            are one-hot contractions: ``hit`` is a (N,) at-most-one-hot
            mask (all-false on the gate's no-bad-cell sweep — the
            resolver then runs on zero inputs and its output is
            discarded by the same mask); the cell's sub-timestep is
            ``t_base + j // K`` and its keyword ``j % K`` (N is K, or a
            ct*K / (T-1)*K lexicographic flattening)."""

            def make(lite_n, aux_n, t_base, kc, *params):
                if agg_explicit:
                    (bids_r,) = params
                    loc_r = scale_r = None
                else:
                    bids_r, loc_r, scale_r = params
                kr = bids_r.shape[0]

                def resolve(j, B, nk, hit):
                    hit_k = jnp.any(hit.reshape(-1, kr), axis=0)
                    if agg_explicit:
                        loc_j = scale_j = jnp.zeros((), jnp.float32)
                    else:
                        loc_j = jnp.sum(jnp.where(hit_k, loc_r, 0.0))
                        scale_j = jnp.sum(jnp.where(hit_k, scale_r, 0.0))
                    y0 = jnp.sum(jnp.where(hit_k, bids_r, 0.0)) - 0.005
                    # pool: the cell's bidder-count draw, one-hot-read
                    # from the aux table (zeros for other models)
                    kj = jnp.sum(jnp.where(hit, aux_n, 0.0))
                    lite_col = jnp.sum(
                        jnp.where(hit[None, :], lite_n, 0), axis=1
                    )
                    return _resolve_cell(
                        kc, t_base + j // kr, j % kr, lite_col,
                        loc_j, scale_j, y0, kj, B, nk, m,
                    )

                return resolve

            return make

        gate_params = (
            (bids_f,) if agg_explicit else (bids_f, kw.bid_loc, kw.bid_scale)
        )
        # (the pool resolver reads loc/scale from the same params and its
        # bidder count from cell_aux, so no extra pool params are needed)
        _compact = cfg.gate_compact == "auto"
        gate_site0 = _make_agg_gate(
            _make_resolve(cfg.max_clicks_per_cell), gate_mode, _compact,
            cfg.gate_compact_phase_a, cfg.gate_compact_cap,
        )
        gate_site1 = _make_agg_gate(
            _make_resolve(cfg.max_clicks_rest), gate_mode, _compact,
            cfg.gate_compact_phase_a, cfg.gate_compact_cap,
        )
    else:
        cost_moments = None

    if agg:
        # the agg gate always runs in exact integer units (agg_scale
        # per dollar); for cent models this is identical to the cents
        # branch below
        cmax = float(jnp.iinfo(cdt_agg).max)
        init_b = jnp.minimum(
            jnp.round(jnp.asarray(budget) * agg_scale), cmax
        ).astype(cdt_agg)
    elif cents:
        cdt = jnp.int64 if cfg.use_x64 else jnp.int32
        cmax = float(jnp.iinfo(cdt).max)
        init_b = jnp.minimum(jnp.round(jnp.asarray(budget) * 100.0), cmax).astype(cdt)
    else:
        init_b = jnp.asarray(budget, dtype)

    # ---- phase 1: parallel sampling ----
    # Two-tier lane buffers: sub-timestep 0 carries the volume remainder
    # (bound max_clicks_per_cell); sub-timesteps 1..T-1 each run exactly
    # vol//T auctions (bound max_clicks_rest, roughly half) — nearly
    # halving the per-day sampling work.
    counts = cfg.conv_sampling == "counts"
    rev_sum = cfg.rev_sampling == "sum"
    rev_day = cfg.rev_sampling == "day"
    no_rev_table = rev_sum or rev_day

    def _unpack(tab):
        it = iter(tab)
        imp, ncl, cpre = next(it), next(it), next(it)
        lite = next(it) if agg else None  # agg: (L, K) lite lane costs
        aux = next(it) if agg else None  # agg: (K,) per-cell aux (pool k)
        vpre = None if counts else next(it)
        rpre = None if no_rev_table else next(it)
        return imp, ncl, cpre, lite, aux, vpre, rpre

    tab0 = _cell_tables(
        cfg, k_cells, kw, bids, jnp.asarray(0), n_auctions[0],
        cfg.max_clicks_per_cell, dtype, cost_moments=cost_moments,
        lite_lanes=L_lite if agg else 0,
        agg_scale=agg_scale if agg else 100.0,
    )
    imp0, ncl0, cpre0, lite0, aux0, vpre0, rpre0 = _unpack(tab0)
    if T > 1:
        # gate_scope="global" wants lane-major stacked tables (the (T-1, K)
        # cell grid flattens to lexicographic order for free); "per_t"
        # wants t-major so the gate scan slices per-sub-timestep tiles.
        # agg mode's s_full is (K,) per t — always t-major; its (L, K)
        # lite table is lane-major like the prefix tables.
        pax = 1 if cfg.gate_scope == "global" else 0
        axes = (0, 0, 0 if agg else pax)
        axes += (pax, 0) if agg else ()  # lite table, aux table
        axes += () if counts else (pax,)
        axes += () if no_rev_table else (pax,)
        imp_ladder1 = None
        if agg and cfg.binomial_sampler == "inversion" and not agg_pool:
            # (pool: the win probability depends on each cell's bidder
            # draw, so there is no day-constant ladder to hoist)
            # every tier-1 sub-timestep runs exactly vol//T auctions with
            # the same day-constant win probability: build the auction
            # binomial's CDF ladder once (dist.binomial_cdf) instead of
            # 23x inside the vmap — the ladder recurrence is the bulk of
            # the sampler's cost. Closure-captured, so vmap broadcasts it.
            from adcraft_tpu.auction import implicit_single_win_prob

            if agg_explicit:
                p_day = dist.threshold_sigmoid(
                    bids, kw.imp_thresh, kw.imp_intercept, kw.imp_slope
                )
            else:
                p_day = implicit_single_win_prob(bids, kw.bid_loc, kw.bid_scale)
            imp_ladder1 = dist.binomial_cdf(
                n_auctions[1], p_day, cfg.max_clicks_rest
            )
        tabs1 = jax.vmap(
            lambda t, n: _cell_tables(
                cfg, k_cells, kw, bids, t, n, cfg.max_clicks_rest, dtype,
                cost_moments=cost_moments,
                lite_lanes=L_lite if agg else 0,
                imp_ladder=imp_ladder1,
                agg_scale=agg_scale if agg else 100.0,
            ),
            out_axes=axes,
        )(jnp.arange(1, T), n_auctions[1:])
        imp1, ncl1, cpre1, lite1, aux1, vpre1, rpre1 = _unpack(tabs1)

    # ---- phase 2: the budget gate ----
    if agg:
        (b, broken), (acc0, spend0, sim0) = gate_site0(
            init_b, jnp.asarray(False), cpre0, lite0, ncl0, aux0,
            jnp.asarray(0, jnp.int32), k_cells, *gate_params,
        )
    else:
        (b, broken), (acc0, spend0, sim0) = gate(
            init_b, jnp.asarray(False), cpre0, ncl0
        )
    if T > 1:
        t1 = T - 1
        if agg:
            if cfg.gate_scope == "global":
                lite1f = lite1.reshape(L_lite, t1 * K)
                (b, broken), (acc1f, spend1f, sim1f) = gate_site1(
                    b, broken, cpre1.reshape(t1 * K), lite1f,
                    ncl1.reshape(t1 * K), aux1.reshape(t1 * K),
                    jnp.asarray(1, jnp.int32),
                    k_cells, *gate_params,
                )
                acc1 = acc1f.reshape(t1, K)
                spend1 = spend1f.reshape(t1, K)
                sim1 = sim1f.reshape(t1, K)
            elif cfg.gate_scope == "chunk":
                # scan over groups of ct sub-timesteps, each gated in one
                # flattened (ct*K,) call: fewer sequential gates than
                # per_t (whose ~2-sweep floor pays T dispatch chains) and
                # shorter worst-env Jacobi chains than global. Tier-1 is
                # zero-cell-padded to a multiple of ct — padding cells
                # have s_full=0/n=0, classify as full (B >= 0) or lite
                # (B < 0) with zero spend either way, so the budget
                # thread and break flags are unchanged.
                ct = min(cfg.gate_chunk_t, t1)
                G = -(-t1 // ct)
                pad = G * ct - t1
                sf1, nc1, lt1, ax1 = cpre1, ncl1, lite1, aux1
                if pad:
                    sf1 = jnp.concatenate(
                        [sf1, jnp.zeros((pad, K), sf1.dtype)])
                    nc1 = jnp.concatenate(
                        [nc1, jnp.zeros((pad, K), nc1.dtype)])
                    lt1 = jnp.concatenate(
                        [lt1, jnp.zeros((pad, L_lite, K), lt1.dtype)])
                    ax1 = jnp.concatenate(
                        [ax1, jnp.zeros((pad, K), ax1.dtype)])
                sf1 = sf1.reshape(G, ct * K)
                nc1 = nc1.reshape(G, ct * K)
                ax1 = ax1.reshape(G, ct * K)
                lt1 = lt1.reshape(G, ct, L_lite, K).transpose(
                    0, 2, 1, 3).reshape(G, L_lite, ct * K)

                def gate_chunk(carry, xs):
                    sf_g, lt_g, nc_g, ax_g, g = xs
                    return gate_site1(
                        carry[0], carry[1], sf_g, lt_g, nc_g, ax_g,
                        1 + g * ct, k_cells, *gate_params,
                    )

                (b, broken), (acc1f, spend1f, sim1f) = lax.scan(
                    gate_chunk, (b, broken),
                    (sf1, lt1, nc1, ax1, jnp.arange(G)),
                    unroll=min(cfg.gate_scan_unroll, G),
                )
                acc1 = acc1f.reshape(G * ct, K)[:t1]
                spend1 = spend1f.reshape(G * ct, K)[:t1]
                sim1 = sim1f.reshape(G * ct, K)[:t1]
            else:
                def gate_body(carry, xs):
                    sfull_t, lite_t, ncl_t, aux_t, t = xs
                    return gate_site1(
                        carry[0], carry[1], sfull_t, lite_t, ncl_t, aux_t,
                        t, k_cells, *gate_params,
                    )

                (b, broken), (acc1, spend1, sim1) = lax.scan(
                    gate_body, (b, broken),
                    (cpre1, lite1, ncl1, aux1, jnp.arange(1, T)),
                    unroll=min(cfg.gate_scan_unroll, T - 1),
                )
        elif cfg.gate_scope == "global":
            m1p = cpre1.shape[0]
            (b, broken), (acc1f, spend1f, sim1f) = gate(
                b, broken, cpre1.reshape(m1p, t1 * K), ncl1.reshape(t1 * K)
            )
            acc1 = acc1f.reshape(t1, K)
            spend1 = spend1f.reshape(t1, K)
            sim1 = sim1f.reshape(t1, K)
        else:
            def gate_body(carry, xs):
                cpre_t, ncl_t = xs
                return gate(carry[0], carry[1], cpre_t, ncl_t)

            (b, broken), (acc1, spend1, sim1) = lax.scan(
                gate_body, (b, broken), (cpre1, ncl1)
            )

    # ---- phase 3: gathers + reductions ----
    if counts:
        # conversions | accepted ~ Binomial(accepted, sctr): identical in
        # distribution to consuming the first `accepted` iid flips, one
        # count draw per cell instead of an (M, K) flag table. Same
        # k_conv key slot as the lanes path (stream differs; see config).
        def _nconv_counts(t, accepted, m):
            kt = jax.random.fold_in(k_cells, t)
            k_conv = jax.random.split(kt, 4)[2]
            return cell_binomial_fn(cfg, m)(k_conv, accepted, kw.sctr)

        nconv0 = _nconv_counts(jnp.asarray(0), acc0, cfg.max_clicks_per_cell)
    else:
        nconv0 = jnp.take_along_axis(vpre0, acc0[None, :], axis=0)[0]
    rev_dtype = jnp.int64 if cfg.use_x64 else jnp.int32
    if rev_day:
        # revenue is drawn ONCE per keyword per day from the day's total
        # conversions (after the gather/mask phase below); per-cell
        # revenue carries zeros through the reduction
        rev0 = jnp.zeros_like(nconv0)
    elif rev_sum:
        # one aggregate draw per cell instead of an (M, K) revenue table;
        # same k_rev key slot as the lanes path (stream differs; config).

        def _rev_sum(t, nconv):
            kt = jax.random.fold_in(k_cells, t)
            k_rev = jax.random.split(kt, 4)[3]
            return dist.rev_sum_cents(
                k_rev, nconv, kw.rev_mean, kw.rev_std, rev_dtype
            )

        rev0 = _rev_sum(jnp.asarray(0), nconv0)
    else:
        rev0 = jnp.take_along_axis(rpre0, nconv0[None, :], axis=0)[0]

    def cell_out(imp_c, acc_c, spend_c, nconv_c, rev_c, sim_c, n_auc_c):
        imp_m = jnp.where(sim_c, imp_c, 0)
        return (
            imp_m,
            jnp.where(sim_c, acc_c, 0),
            jnp.where(sim_c, spend_c, jnp.zeros_like(spend_c)),
            jnp.where(sim_c, nconv_c, 0),
            jnp.where(sim_c, rev_c, 0),
            jnp.where(sim_c & (imp_m >= 1), n_auc_c, 0),
        )

    out0 = cell_out(imp0, acc0, spend0, nconv0, rev0, sim0, n_auctions[0])
    if T > 1:
        if counts:
            nconv1 = jax.vmap(
                lambda t, a: _nconv_counts(t, a, cfg.max_clicks_rest)
            )(jnp.arange(1, T), acc1)
        elif cfg.gate_scope == "global":  # conv table is (M1+1, T-1, K)
            nconv1 = jnp.take_along_axis(vpre1, acc1[None, :, :], axis=0)[0]
        else:  # (T-1, M1+1, K)
            nconv1 = jnp.take_along_axis(vpre1, acc1[:, None, :], axis=1)[:, 0, :]
        if rev_day:
            rev1 = jnp.zeros_like(nconv1)
        elif rev_sum:
            rev1 = jax.vmap(_rev_sum)(jnp.arange(1, T), nconv1)
        elif cfg.gate_scope == "global":  # rev table is (M1+1, T-1, K)
            rev1 = jnp.take_along_axis(rpre1, nconv1[None, :, :], axis=0)[0]
        else:  # (T-1, M1+1, K)
            rev1 = jnp.take_along_axis(
                rpre1, nconv1[:, None, :], axis=1
            )[:, 0, :]
        out1 = cell_out(imp1, acc1, spend1, nconv1, rev1, sim1, n_auctions[1:])
        outs = tuple(
            jnp.concatenate([o0[None], o1], axis=0)
            for o0, o1 in zip(out0, out1)
        )
    else:
        outs = tuple(o0[None] for o0 in out0)
    imp, clicks, cost, conv, rev_c, elig = outs

    impressions = jnp.sum(imp, axis=0).astype(jnp.int32)
    buyside_clicks = jnp.sum(clicks, axis=0).astype(jnp.int32)
    if agg:
        cost_sum = jnp.sum(cost, axis=0).astype(dtype) / agg_scale
    elif cents:
        cost_sum = jnp.sum(cost, axis=0).astype(dtype) / 100.0
    else:
        cost_sum = jnp.sum(cost, axis=0)
    conversions = jnp.sum(conv, axis=0).astype(jnp.int32)
    if rev_day:
        # day-level aggregate revenue: ONE censored-normal draw per
        # keyword from the masked day-total conversions. Key slot: the
        # k_rev site of the (never-sampled) sub-timestep T, so the
        # stream is fresh and the tree stays fold_in-structured.
        # Distribution note (PARITY.md "Aggregate revenue sampling"):
        # vs "sum" only the cent rounding differs — one rounded normal
        # instead of T, a (T-1)/12 cent^2 variance difference.
        k_rev_day = jax.random.split(jax.random.fold_in(k_cells, T), 4)[3]
        rev_cents_day = dist.rev_sum_cents(
            k_rev_day, conversions, kw.rev_mean, kw.rev_std, rev_dtype
        )
        revenue_sum = rev_cents_day.astype(dtype) / 100.0
    else:
        revenue_sum = jnp.sum(rev_c, axis=0).astype(dtype) / 100.0
    return DayOutcomes(
        impressions=impressions,
        buyside_clicks=buyside_clicks,
        cost=cost_sum,
        sellside_conversions=conversions,
        revenue=revenue_sum,
        profit=revenue_sum - cost_sum,
        volume=volume,
        eligible_volume=jnp.sum(elig, axis=0).astype(jnp.int32),
    )


def sample_day_draws(
    cfg: EnvConfig, key: Array, kw: KeywordState, bids: Array, dtype=None
):
    """Materialize the full day's draw table — parity-test use only.

    Replicates ``simulate_day``'s key tree exactly (k_vol/k_cells split,
    per-sub-timestep fold_in, 4-way site split) so the numpy oracle
    (adcraft_tpu.oracle.simulate_day_numpy) can be driven with the very
    draws the fused kernel consumes. Memory scales with T*K*M; do not use
    on large configs. Returns numpy arrays; ``day_draw_table`` is the
    jittable (and vmappable) form.
    """
    import numpy as np

    return {
        name: np.asarray(x)
        for name, x in day_draw_table(cfg, key, kw, bids, dtype).items()
    }


def day_draw_table(
    cfg: EnvConfig, key: Array, kw: KeywordState, bids: Array, dtype=None
):
    """``sample_day_draws`` as device arrays (jittable)."""
    if dtype is None:
        dtype = cfg.money_dtype
    if (
        cfg.conv_sampling != "lanes"
        or cfg.rev_sampling != "lanes"
        or cfg.cost_sampling != "lanes"
    ):
        raise ValueError(
            "injected-draw parity requires conv_sampling='lanes', "
            "rev_sampling='lanes' and cost_sampling='lanes' (the aggregate "
            "modes draw after/without lane tables; they are validated "
            "distributionally, tests/test_step.py)"
        )
    K = kw.num_keywords
    M = cfg.max_clicks_per_cell
    T = cfg.timesteps_per_day

    k_vol, k_cells = jax.random.split(key)
    volume = dist.nonneg_int_normal(k_vol, kw.vol_mean, kw.vol_std)
    volume = jnp.minimum(volume, cfg.max_volume)
    n_auctions = split_volume(cfg, volume)

    def cell_draws(t, n_auc_t, m):
        """One sub-timestep's draws as (K, M) oracle-table rows. ``m`` is
        the sub-timestep's lane buffer (two-tier, as in simulate_day);
        lanes beyond it are zero padding the oracle never reaches, since
        n_clicks <= m."""
        kt = jax.random.fold_in(k_cells, t)
        k_auc, k_click, k_conv, k_rev = jax.random.split(kt, 4)
        cell = run_cell_auctions(
            cfg, k_auc, bids, n_auc_t, kw, dtype=dtype, max_clicks=m
        )
        n_clicks = cell_binomial_fn(cfg, m)(k_click, cell.n_candidates, kw.bctr)
        conv_flags = jax.random.uniform(k_conv, (m, K)) <= kw.sctr[None, :]
        rev_draws = dist.rev_normal_cents(
            k_rev, kw.rev_mean[None, :], kw.rev_std[None, :], (m, K), dtype=dtype
        )

        def pad(x_mk):
            """(m, K) lane-major draws -> (K, M) oracle-table rows."""
            return jnp.pad(x_mk.T, ((0, 0), (0, M - m)))

        return (
            cell.impressions,
            n_clicks,
            pad(cell.cost_draws),
            pad(conv_flags),
            pad(rev_draws),
        )

    # t = 0 on the full buffer, t >= 1 vmapped over the sub-timestep on
    # the rest buffer: the same fold_in key tree as a loop over t, so the
    # draws are identical, with one copy of the sampling program instead
    # of T
    first = cell_draws(0, n_auctions[0], M)
    if T > 1:
        rest = jax.vmap(
            lambda t, n: cell_draws(t, n, cfg.max_clicks_rest)
        )(jnp.arange(1, T), n_auctions[1:])
        cells = [
            jnp.concatenate([f[None], r]) for f, r in zip(first, rest)
        ]
    else:
        cells = [f[None] for f in first]
    names = ("impressions", "n_clicks", "costs", "conv_flags", "revs")
    return {"volume": volume, **dict(zip(names, cells))}


def update_keywords(
    cfg: EnvConfig, key: Array, kw: KeywordState
) -> KeywordState:
    """Non-stationarity drift after a day of bidding.

    Reference ``update_keywords`` (gymnasium_kw_env.py:114-158): per masked
    keyword, mean volume takes a uniform additive step scaled by the
    drift reference (see KeywordState.vol_drift_ref), clipped nonnegative;
    ctr and cvr take uniform multiplicative steps, clipped to [0, 1].
    """
    K = kw.num_keywords
    u = cfg.updater
    # one (3, K) uniform draw instead of three keyed (K,) draws — the
    # same U(-s, s) law per slot (drift parity is distributional,
    # tests/test_parity.py), one threefry call instead of a 3-way split
    # plus three
    u3 = jax.random.uniform(key, (3, K), minval=-1.0, maxval=1.0)
    vol_step = u3[0] * u.vol_scale
    ctr_step = u3[1] * u.ctr_scale
    cvr_step = u3[2] * u.cvr_scale
    mask = kw.updater_mask
    new_vol = dist.nonnegify(kw.vol_mean + vol_step * kw.vol_drift_ref)
    new_bctr = dist.probify(kw.bctr * (1.0 + ctr_step))
    new_sctr = dist.probify(kw.sctr * (1.0 + cvr_step))
    return kw._replace(
        vol_mean=jnp.where(mask, new_vol, kw.vol_mean),
        bctr=jnp.where(mask, new_bctr, kw.bctr),
        sctr=jnp.where(mask, new_sctr, kw.sctr),
    )
