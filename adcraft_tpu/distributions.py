"""Stateless, key-driven distribution kernels.

JAX replacements for the reference's numpy samplers
(adcraft/synthetic_kw_helpers.py) and Rust kernels (src/lib.rs). Every
function takes an explicit PRNG key; nothing here holds state. All are pure
jnp and fuse into the surrounding jit — the reference's Rust reductions
(``sum_list`` etc., src/lib.rs:108-140) have no counterpart because they
vanish into the fused step.

The reference's Rust samplers use an *unseeded* ``thread_rng()``
(src/lib.rs:25,44,61,75,320) so they are non-reproducible; these kernels are
the seeded versions its TODOs (src/lib.rs:316-319) intended.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array

# ---------------------------------------------------------------------------
# scalar helpers (reference: synthetic_kw_helpers.py:10-25, 82-89)
# ---------------------------------------------------------------------------


def probify(x: Array) -> Array:
    """Clip to [0, 1] (reference synthetic_kw_helpers.py:10-16)."""
    return jnp.clip(x, 0.0, 1.0)


def nonnegify(x: Array) -> Array:
    """Clip below at 0 (reference synthetic_kw_helpers.py:19-25)."""
    return jnp.maximum(x, 0.0)


def beta_param(mean: Array) -> Array:
    """Beta distribution's beta for alpha=1 and given mean.

    Reference synthetic_kw_helpers.py:82-84.
    """
    return (1.0 - mean) / mean


def sigmoid(x: Array, slope: Array, intercept: Array) -> Array:
    """Logistic ``1/(1+exp(-slope*(x-intercept)))``.

    Reference synthetic_kw_helpers.py:87-89 and src/lib.rs:290-294.
    """
    return jax.nn.sigmoid(slope * (x - intercept))


def round_cents(x: Array) -> Array:
    """Round to 2 decimals, matching ``np.around(x, 2)`` (half-to-even).

    The reference rounds bids, costs and revenues to cents everywhere
    (synthetic_kw_helpers.py:63,69,96-113; gymnasium_kw_env.py:199,215).
    """
    return jnp.round(x * 100.0) / 100.0


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------


def nonneg_int_normal(key: Array, mean: Array, std: Array, shape=None) -> Array:
    """Non-negative integer draws from a clipped, rounded normal.

    ``round(max(N(mean, std), 0))`` — replaces
    ``rust.nonneg_int_normal_sampler`` (src/lib.rs:314-325, called from
    synthetic_kw_helpers.py:183-193). The Rust version rounds half away from
    zero; the boundary set has measure zero so plain round is used.
    Returns int32.
    """
    mean = jnp.asarray(mean, jnp.float32)
    std = jnp.asarray(std, jnp.float32)
    if shape is None:
        shape = jnp.broadcast_shapes(mean.shape, std.shape)
    draw = mean + std * jax.random.normal(key, shape, dtype=jnp.float32)
    return jnp.round(jnp.maximum(draw, 0.0)).astype(jnp.int32)


def binomial(key: Array, n: Array, p: Array, shape=None) -> Array:
    """Binomial(n, p) draws as int32.

    Replaces ``rust.binomial_impressions`` (src/lib.rs:70-76) and the
    counting of ``coinflips`` Bernoulli arrays
    (synthetic_kw_helpers.py:73-77). Guards against p outside [0, 1] and
    n == 0 (jax.random.binomial returns nan for degenerate inputs on some
    paths).
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.clip(jnp.asarray(p, jnp.float32), 0.0, 1.0)
    if shape is None:
        shape = jnp.broadcast_shapes(n.shape, p.shape)
    draw = jax.random.binomial(key, n, p, shape=shape, dtype=jnp.float32)
    draw = jnp.where(jnp.isnan(draw), 0.0, draw)
    return jnp.clip(draw, 0.0, n).astype(jnp.int32)


def binomial_inv(
    key: Array, n: Array, p: Array, nmax: int, bits: int = 32, shape=None
) -> Array:
    """Binomial(n, p) draws by exact inverse-CDF walk, for small static n.

    ``jax.random.binomial`` pays for generality: it evaluates both an
    inversion while_loop and a BTRS rejection loop per draw (several
    uniforms each, and under ``vmap`` every loop runs to the batch max).
    The env's hot-path binomials all have n bounded by the static click
    buffer (n <= nmax ~ 24-64), where a direct CDF walk is cheaper and
    spends exactly ONE uniform per draw (HALF a threefry word at
    ``bits=16``):

        count = #{ j in [0, nmax) : P(X <= j) < u }   (== the quantile
        function min{k : CDF(k) >= u}, i.e. exact inverse-CDF sampling)

    The pmf walk uses the stable ratio recurrence on q = min(p, 1-p) (so
    the start term (1-q)^n >= 2^-n never underflows and the ratio
    q/(1-q) <= 1), flipping the count to n - count when p > 1/2. f32 CDF
    rounding perturbs bucket probabilities by O(n*eps) ~ 1e-5 — the same
    order as the bits=16 uniform quantization (PARITY.md "16-bit lane
    uniforms"). Stream-incompatible with ``binomial`` (one uniform vs
    rejection draws); selected by ``EnvConfig.binomial_sampler``.

    The walk is UNROLLED over the nmax levels with scalar carries
    (pmf, cdf, count) so XLA fuses it into one elementwise pass over
    (n, p, u) — nothing of shape (nmax+1, ...) is ever materialized.
    The varying-``n`` hot sites (clicks given impressions, conversions
    given accepted clicks) build their ladder per CELL, where the
    materialized cumprod/cumsum intermediates were the step's largest
    memory-traffic term at bench shape.
    Same uniform consumption as the materialized ``binomial_cdf`` path;
    counts can differ from it at exact f32 CDF ties (sequential vs
    parallel-scan rounding), within the documented O(n*eps) tolerance.
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.clip(jnp.asarray(p, jnp.float32), 0.0, 1.0)
    if shape is None:
        shape = jnp.broadcast_shapes(n.shape, p.shape)
    n = jnp.broadcast_to(n, shape)
    p = jnp.broadcast_to(p, shape)
    flip = p > 0.5
    q = jnp.where(flip, 1.0 - p, p)  # q <= 0.5
    r = q / (1.0 - q)  # <= 1
    u = uniform16(key, shape) if bits == 16 else jax.random.uniform(key, shape)
    pmf = (1.0 - q) ** n
    cdf = pmf
    cnt = (cdf < u).astype(jnp.int32)
    one = jnp.ones((), jnp.int32)
    for j in range(1, nmax):
        # pmf_j = pmf_{j-1} * (n - j + 1)/j * r; terms past j = n hit an
        # exact zero factor (n integer); the clamp keeps j > n+1 out
        pmf = jnp.maximum(pmf * ((n - (j - 1.0)) * (r / j)), 0.0)
        cdf = cdf + pmf
        cnt = cnt + jnp.where(cdf < u, one, 0)
    ni = jnp.round(n).astype(jnp.int32)
    cnt = jnp.clip(cnt, 0, ni)
    return jnp.where(flip, ni - cnt, cnt).astype(jnp.int32)


def binomial_bernoulli_sum(
    key: Array, n: Array, p: Array, nmax: int, bits: int = 32, shape=None
) -> Array:
    """EXACT Binomial(n, p) as a sum of ``nmax`` masked Bernoulli flips.

    One uniform per POTENTIAL trial instead of one per draw — more PRNG
    words than the inversion walk, but zero sequential structure: the
    (nmax,) + shape flip tensor reduces in one fused pass, where the
    walk's nmax-level recurrence is a dependency chain XLA stops fusing
    well past ~32 levels. Use for draws whose n-bound is moderate and word budget
    irrelevant (the pool bidder count: nmax = max_bidders_bound,
    +nmax*T*K/2 16-bit words per env-day).
    Distribution-exact for n <= nmax (integer n; trials beyond n are
    masked); counts truncate at nmax like ``binomial_inv``.
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.clip(jnp.asarray(p, jnp.float32), 0.0, 1.0)
    if shape is None:
        shape = jnp.broadcast_shapes(n.shape, p.shape)
    full = (nmax,) + tuple(shape)
    u = uniform16(key, full) if bits == 16 else jax.random.uniform(key, full)
    lanes = jnp.arange(nmax, dtype=jnp.float32).reshape(
        (nmax,) + (1,) * len(shape)
    )
    flips = (u <= p) & (lanes < n)
    return jnp.sum(flips.astype(jnp.int32), axis=0)


def binomial_cdf(n: Array, p: Array, nmax: int, shape=None):
    """Precompute ``binomial_inv``'s CDF ladder for fixed (n, p).

    Returns an opaque ladder tuple ``(cdf, flip, ni)`` consumed by
    ``binomial_inv_from_cdf``. Splitting the walk this way lets a caller
    with a (n, p) that repeats across draw sites — e.g. the per-day
    tier-1 auction binomial, whose ``n = vol//T`` and win probability
    are identical for all T-1 sub-timesteps — build the ladder ONCE and
    pay only the one-uniform compare per site.
    ``binomial_inv_from_cdf(key, binomial_cdf(n, p, ...))`` consumes the
    same uniform as ``binomial_inv(key, n, p, ...)`` and walks the same
    recurrence; counts agree except at exact f32 CDF ties, where the
    materialized cumprod/cumsum (parallel-scan rounding) can differ in
    the last ulp from the fused sequential walk (within binomial_inv's
    documented O(n*eps) tolerance).
    """
    n = jnp.asarray(n, jnp.float32)
    p = jnp.clip(jnp.asarray(p, jnp.float32), 0.0, 1.0)
    if shape is None:
        shape = jnp.broadcast_shapes(n.shape, p.shape)
    n = jnp.broadcast_to(n, shape)
    p = jnp.broadcast_to(p, shape)

    flip = p > 0.5
    q = jnp.where(flip, 1.0 - p, p)  # q <= 0.5
    r = q / (1.0 - q)  # <= 1
    j = jnp.arange(1.0, nmax + 1.0, dtype=jnp.float32)
    j = j.reshape((nmax,) + (1,) * len(shape))
    # pmf_j = pmf_{j-1} * (n - j + 1)/j * r; terms past j = n hit an exact
    # zero factor (n integer), and the clamp keeps any j > n+1 negativity out
    f = jnp.maximum((n[None] - (j - 1.0)) / j * r[None], 0.0)
    pmf0 = (1.0 - q) ** n
    pmf = jnp.concatenate([pmf0[None], pmf0[None] * jnp.cumprod(f, axis=0)])
    cdf = jnp.cumsum(pmf, axis=0)  # cdf[j] = P(X <= j), j = 0..nmax
    ni = jnp.round(n).astype(jnp.int32)
    return cdf, flip, ni


def binomial_inv_from_cdf(key: Array, ladder, bits: int = 32) -> Array:
    """One inverse-CDF draw against a ``binomial_cdf`` ladder.

    Consumes exactly the same uniform (same key, same bit width) and
    performs the same compare-count as ``binomial_inv``, so hoisting the
    ladder does not change the sample stream.
    """
    cdf, flip, ni = ladder
    nmax = cdf.shape[0] - 1
    shape = cdf.shape[1:]
    u = uniform16(key, shape) if bits == 16 else jax.random.uniform(key, shape)
    cnt = jnp.sum((cdf[:nmax] < u[None]).astype(jnp.int32), axis=0, dtype=jnp.int32)
    cnt = jnp.clip(cnt, 0, ni)
    return jnp.where(flip, ni - cnt, cnt).astype(jnp.int32)


def rev_normal_cents(
    key: Array, mean: Array, std: Array, shape, dtype=jnp.float32
) -> Array:
    """Per-conversion revenue draws: ``round(max(N(mean, std), 0.01), 2)``.

    Replaces the ``rev_normal`` sampler factory
    (synthetic_kw_helpers.py:66-70).
    """
    draw = mean + std * jax.random.normal(key, shape, dtype=dtype)
    return round_cents(jnp.maximum(draw, 0.01))


def abs_laplace_cents(
    key: Array, loc: Array, scale: Array, shape, dtype=jnp.float32,
    lowest_bid: float = 0.0,
) -> Array:
    """``round(max(|Laplace(loc, scale)|, lowest_bid), 2)`` draws.

    Replaces ``bid_abs_laplace`` (synthetic_kw_helpers.py:104-113);
    ``lowest_bid=0`` is what single-competitor implicit keywords use
    (gymnasium_kw_utils.py:184). The floor applies BEFORE cent rounding,
    as in the reference.
    """
    draw = loc + scale * jax.random.laplace(key, shape, dtype=dtype)
    return round_cents(jnp.maximum(jnp.abs(draw), lowest_bid))


def abs_normal_cents(
    key: Array, loc: Array, scale: Array, shape, dtype=jnp.float32,
    lowest_bid: float = 0.0,
) -> Array:
    """``round(max(|N(loc, scale)|, lowest_bid), 2)`` draws.

    Replaces ``bid_abs_normal`` (synthetic_kw_helpers.py:92-101) — defined
    by the reference as an alternative competitor-bid sampler (no shipped
    config uses it, but it is part of the public helper surface).
    """
    draw = loc + scale * jax.random.normal(key, shape, dtype=dtype)
    return round_cents(jnp.maximum(jnp.abs(draw), lowest_bid))


def beta_mean_alpha1(key: Array, mean: Array, shape=None) -> Array:
    """Beta(1, (1-m)/m) draw — the reference's default CTR/CVR prior.

    Reference synthetic_kw_classes.py:391-437: ctr/cvr are drawn from a
    Beta with alpha=1 and beta chosen to hit a target mean.
    """
    mean = jnp.asarray(mean, jnp.float32)
    if shape is None:
        shape = mean.shape
    b = beta_param(probify(mean))
    return jax.random.beta(key, 1.0, b, shape=shape)


# ---------------------------------------------------------------------------
# explicit-keyword models (reference: src/lib.rs:54-67,93-105)
# ---------------------------------------------------------------------------

_RUST_COST_PLACEHOLDER = 4.4  # Array::from_elem fill value, src/lib.rs:55


def threshold_sigmoid(
    bid: Array, thresh: Array, intercept: Array, slope: Array
) -> Array:
    """Thresholded sigmoid bid -> impression rate.

    Reference ``rust.threshold_sigmoid`` (src/lib.rs:93-105):
    ``t = clip((2+1e-10)*thresh, 0, 1)/(2+1e-10)``,
    ``rate = clip((1+2t)*sigmoid(slope*(bid-intercept)) - t, 0, 1)``.
    Rates below the threshold snap to 0 and above (1-thresh) snap to 1.
    (The Rust default-handling bug — defaults unreachable, missing key
    panics, src/lib.rs:302-308 — is fixed by taking explicit parameters.)
    """
    halver = 2.0 + 1e-10
    t = jnp.clip(halver * thresh, 0.0, 1.0) / halver
    r = sigmoid(bid, slope, intercept)
    return jnp.clip((1.0 + 2.0 * t) * r - t, 0.0, 1.0)


def cost_create(key: Array, bid: Array, shape, dtype=jnp.float32) -> Array:
    """Cost-per-click draws reproducing ``rust.cost_create`` exactly.

    src/lib.rs:54-67: each draw is
    ``clamp(sqrt(bid)/4 + 4.4/2 + N(0, 1e-10 + sqrt(bid)/6), 0, 4.4)``
    because the output array is pre-filled with 4.4 and the fill value is
    used as both the additive ``p/2`` term and the clamp ceiling. NOT
    rounded to cents (unlike the Python ``generic_cost``).
    """
    s = jnp.sqrt(jnp.asarray(bid, dtype))
    noise = (1e-10 + s / 6.0) * jax.random.normal(key, shape, dtype=dtype)
    raw = s / 4.0 + _RUST_COST_PLACEHOLDER / 2.0 + noise
    return jnp.clip(raw, 0.0, _RUST_COST_PLACEHOLDER)


def generic_cost(key: Array, bid: Array, shape, dtype=jnp.float32) -> Array:
    """Cost-per-click draws per the documented Python model.

    synthetic_kw_helpers.py:56-63:
    ``round(clip(sqrt(bid)/4 + bid/2 + N(0, 1e-10+sqrt(bid)/6), 0, bid), 2)``.
    """
    bid = jnp.asarray(bid, dtype)
    s = jnp.sqrt(bid)
    noise = (1e-10 + s / 6.0) * jax.random.normal(key, shape, dtype=dtype)
    raw = s / 4.0 + bid / 2.0 + noise
    return round_cents(jnp.clip(raw, 0.0, bid))


# ---------------------------------------------------------------------------
# aggregate-draw helpers (rev_sampling="sum" / cost_sampling="agg")
# ---------------------------------------------------------------------------


def uniform16(key: Array, shape, dtype=jnp.float32) -> Array:
    """Uniforms in (0, 1) built from 16-bit PRNG halves.

    Each output consumes HALF a threefry word (jax packs sub-32-bit draws
    two-per-word), at the price of quantizing the uniform to 2^-16 steps —
    the midpoint mapping ``(bits + 0.5) / 65536`` keeps it unbiased and
    bounded away from {0, 1}. Used for cent-quantized cost lanes
    (``EnvConfig.lane_bits=16``) where outputs land in a few hundred cent
    buckets, so each bucket probability moves by < 2^-16.
    """
    bits = jax.random.bits(key, shape, dtype=jnp.uint16)
    return (bits.astype(dtype) + 0.5) * (1.0 / 65536.0)


def normal16(key: Array, shape, dtype=jnp.float32) -> Array:
    """Standard normals from 16-bit uniforms (half a threefry word each).

    ``ndtri`` of the midpoint-mapped 16-bit uniform: the value grid has
    ~2^-16 probability resolution, so tails are cut at +-4.17 sigma
    (P ~ 1.5e-5 per side) and the density is step-quantized — far below
    the CLT error of the aggregate draws this feeds
    (``EnvConfig.agg_draw_bits=16``; PARITY.md). Mean stays exactly 0 by
    the symmetry of the midpoint grid.
    """
    from jax.scipy.special import ndtri

    return ndtri(uniform16(key, shape, dtype))


def censored_normal_moments(mean: Array, std: Array, low) -> tuple:
    """Exact mean/std of ``max(N(mean, std), low)`` (censored normal).

    With a = (low - mean)/std, F = Phi(a), f = phi(a):
      E[Y]  = low*F + mean*(1-F) + std*f
      E[Y^2]= low^2*F + (mean^2+std^2)*(1-F) + std*(mean+low)*f
    Degenerate std == 0 returns (max(mean, low), 0).
    """
    mean = jnp.asarray(mean, jnp.float32)
    std = jnp.asarray(std, jnp.float32)
    safe = jnp.maximum(std, 1e-20)
    a = (low - mean) / safe
    big_f = jax.scipy.stats.norm.cdf(a)
    small_f = jax.scipy.stats.norm.pdf(a)
    m1 = low * big_f + mean * (1.0 - big_f) + safe * small_f
    m2 = (
        low * low * big_f
        + (mean * mean + safe * safe) * (1.0 - big_f)
        + safe * (mean + low) * small_f
    )
    var = jnp.maximum(m2 - m1 * m1, 0.0)
    deg = std <= 0.0
    m1 = jnp.where(deg, jnp.maximum(mean, low), m1)
    var = jnp.where(deg, 0.0, var)
    return m1, jnp.sqrt(var)


def clipped_normal_moments(mean: Array, std: Array, low, high) -> tuple:
    """Exact mean/std of ``clip(N(mean, std), low, high)`` (two-sided
    censored normal).

    With a = (low-mean)/std, b = (high-mean)/std, Fa/Fb = Phi(a)/Phi(b),
    fa/fb = phi(a)/phi(b):
      E[Y]   = low*Fa + high*(1-Fb) + mean*(Fb-Fa) + std*(fa-fb)
      E[Y^2] = low^2*Fa + high^2*(1-Fb) + (mean^2+std^2)*(Fb-Fa)
               + 2*mean*std*(fa-fb) + std^2*(a*fa - b*fb)
    (reduces to ``censored_normal_moments`` as high -> inf).
    Degenerate std == 0 returns (clip(mean, low, high), 0).
    """
    mean = jnp.asarray(mean, jnp.float32)
    std = jnp.asarray(std, jnp.float32)
    safe = jnp.maximum(std, 1e-20)
    a = (low - mean) / safe
    b = (high - mean) / safe
    fa = jax.scipy.stats.norm.cdf(a)
    fb = jax.scipy.stats.norm.cdf(b)
    pa = jax.scipy.stats.norm.pdf(a)
    pb = jax.scipy.stats.norm.pdf(b)
    mid = fb - fa
    m1 = low * fa + high * (1.0 - fb) + mean * mid + safe * (pa - pb)
    m2 = (
        low * low * fa
        + high * high * (1.0 - fb)
        + (mean * mean + safe * safe) * mid
        + 2.0 * mean * safe * (pa - pb)
        + safe * safe * (a * pa - b * pb)
    )
    var = jnp.maximum(m2 - m1 * m1, 0.0)
    deg = std <= 0.0
    m1 = jnp.where(deg, jnp.clip(mean, low, high), m1)
    var = jnp.where(deg, 0.0, var)
    return m1, jnp.sqrt(var)


def generic_cost_cent_moments(bid: Array, grid: int):
    """Exact per-click cost moments (in CENTS) for the PYTHON explicit model.

    ``generic_cost`` (synthetic_kw_helpers.py:56-63) draws
    ``X = 100 * round(clip(sqrt(b)/4 + b/2 + N(0, 1e-10+sqrt(b)/6), 0, b), 2)``
    — discrete on the cent grid {0, 1, .., round(100 b)}. The pmf is
    normal-CDF differences over the rounding cells capped at b, and the
    moments follow by the same Abel summation over the tail CDF as
    ``single_cost_cent_moments`` (this is that function's explicit-keyword
    counterpart; unconditional — explicit costs are not conditioned on a
    win event). Exact whenever ``bid <= grid/100``; enlarge
    ``EnvConfig.agg_cost_grid`` for larger bids.

    Returns (mean_cents, std_cents, cmax_cents); ``cmax_cents =
    round(100 b)`` (the clip ceiling b itself is reachable and rounds onto
    the grid).
    """
    bid = jnp.asarray(bid, jnp.float32)
    s = jnp.sqrt(bid)
    mu_r = s / 4.0 + bid / 2.0
    sig_r = 1e-10 + s / 6.0
    shape = bid.shape
    # sum all `grid` cells i = 0..grid-1 so the top cell cmax = grid is
    # covered at bid == grid/100 (tail terms above cmax are exactly zero,
    # so the extra cell is free for smaller bids)
    i = jnp.arange(grid, dtype=jnp.float32)
    ii = i.reshape((grid,) + (1,) * len(shape))
    # G_i = P(X <= i cents) = Phi((min((i+.5)/100, b) - mu)/sigma); edges
    # at/above b saturate to 1 and contribute zero tail mass
    e = jnp.minimum((ii + 0.5) / 100.0, bid)
    at_cap = (ii + 0.5) / 100.0 >= bid
    g = jax.scipy.stats.norm.cdf((e - mu_r) / sig_r)
    g = jnp.where(at_cap, 1.0, g)
    tail = jnp.maximum(1.0 - g, 0.0)
    mu = jnp.sum(tail, axis=0)
    m2 = jnp.sum((2.0 * ii + 1.0) * tail, axis=0)
    var = jnp.maximum(m2 - mu * mu, 0.0)
    cmax = jnp.round(bid * 100.0)
    return mu, jnp.sqrt(var), cmax


def cost_create_deci_moments(bid: Array):
    """Per-click cost moments in DECICENTS for the RUST_QUIRK explicit model.

    ``cost_create`` (src/lib.rs:54-67) draws the CONTINUOUS
    ``clamp(sqrt(b)/4 + 2.2 + N(0, 1e-10+sqrt(b)/6), 0, 4.4)``. The agg
    path gates in exact integers, so this model's aggregate support is
    the 0.1-cent grid: exact clipped-normal moments scaled by 1000 plus
    the per-click quantization variance 1/12 (PARITY.md "Aggregate cost
    sampling" documents the 0.1-cent quantization as an agg-only
    deviation — the lanes path keeps continuous costs).

    Returns (mean_deci, std_deci, cmax_deci = 4400).
    """
    bid = jnp.asarray(bid, jnp.float32)
    s = jnp.sqrt(bid)
    m1, s1 = clipped_normal_moments(
        s / 4.0 + _RUST_COST_PLACEHOLDER / 2.0,
        1e-10 + s / 6.0,
        0.0,
        _RUST_COST_PLACEHOLDER,
    )
    mu = 1000.0 * m1
    sig = jnp.sqrt((1000.0 * s1) ** 2 + (1.0 / 12.0))
    cmax = jnp.full_like(mu, _RUST_COST_PLACEHOLDER * 1000.0)
    return mu, sig, cmax


def rev_sum_cents(
    key: Array, nconv: Array, rev_mean: Array, rev_std: Array, cents_dtype
) -> Array:
    """Aggregate revenue for ``nconv`` conversions, in integer cents.

    One draw approximating ``sum of nconv iid round_cents(max(N(mean, std),
    0.01))`` (the ``rev_normal_cents`` per-conversion model): a normal with
    the exact censored-normal per-draw moments plus the cent-quantization
    variance 1/12 cent^2, rounded to cents and floored at nconv * 1 cent
    (each conversion is worth >= $0.01). Exact when rev_std == 0; CLT-
    approximate otherwise (PARITY.md "Aggregate revenue sampling").
    """
    m1, s1 = censored_normal_moments(rev_mean, rev_std, 0.01)
    mean_c = 100.0 * m1
    std_c = jnp.sqrt((100.0 * s1) ** 2 + (1.0 / 12.0))
    n = nconv.astype(jnp.float32)
    z = jax.random.normal(key, nconv.shape, dtype=jnp.float32)
    clt = jnp.round(n * mean_c + jnp.sqrt(n) * std_c * z)
    exact = n * jnp.round(mean_c)
    cents = jnp.where(rev_std <= 0.0, exact, clt)
    cents = jnp.maximum(cents, n)  # >= 1 cent per conversion
    return jnp.where(nconv > 0, cents, 0.0).astype(cents_dtype)


def single_cost_cent_moments(bid: Array, loc: Array, scale: Array, grid: int):
    """Exact per-click cost moments (in CENTS) for implicit-single keywords.

    The per-click cost is ``X = 100 * round(|L|, 2)`` conditioned on the
    win event ``|L| < y0 = bid - 0.005`` with ``L ~ Laplace(loc, scale)``
    (``bid_abs_laplace`` + strict win, synthetic_kw_helpers.py:104-113,
    167-171; adcraft_tpu.auction.implicit_single_auction). X is discrete
    on the cent grid {0, 1, .., bid_cents-1}; its exact pmf is Laplace-CDF
    differences over the rounding cells [i-0.5, i+0.5)/100 capped at y0:

        G_i  = P(|L| < min((i+0.5)/100, y0))
        p_i  = (G_i - G_{i-1}) / Z,   Z = P(|L| < y0)  (the win prob)

    Moments follow by Abel summation over the tail CDF (numerically sums
    of small non-negative terms, no cancellation):

        E[X]   = sum_{i=0}^{grid-2} (Z - G_i) / Z
        E[X^2] = sum_{i=0}^{grid-2} (2i+1) (Z - G_i) / Z

    Exact whenever ``bid <= grid/100`` (edges at/above y0 saturate to Z
    and contribute zero); for larger bids the moments are those of the
    cost capped at the grid — enlarge ``EnvConfig.agg_cost_grid``.

    Returns (mean_cents, std_cents, cmax_cents) each shaped like ``bid``;
    ``cmax_cents = bid_cents - 1`` is the largest possible per-click cost.
    """
    bid = jnp.asarray(bid, jnp.float32)
    loc = jnp.asarray(loc, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    y0 = jnp.maximum(bid - 0.005, 0.0)
    shape = jnp.broadcast_shapes(bid.shape, loc.shape, scale.shape)
    y0 = jnp.broadcast_to(y0, shape)
    i = jnp.arange(grid - 1, dtype=jnp.float32)
    ii = i.reshape((grid - 1,) + (1,) * len(shape))
    e = jnp.minimum((ii + 0.5) / 100.0, y0)
    gt = laplace_cdf(e, loc, scale) - laplace_cdf(-e, loc, scale)
    z = laplace_cdf(y0, loc, scale) - laplace_cdf(-y0, loc, scale)
    tail = jnp.maximum(z - gt, 0.0)  # (grid-1,) + shape
    zsafe = jnp.maximum(z, 1e-12)
    mu = jnp.sum(tail, axis=0) / zsafe
    m2 = jnp.sum((2.0 * ii + 1.0) * tail, axis=0) / zsafe
    var = jnp.maximum(m2 - mu * mu, 0.0)
    cmax = jnp.maximum(jnp.round(bid * 100.0) - 1.0, 0.0)
    return mu, jnp.sqrt(var), cmax


def single_cost_cent_moments_closed(bid: Array, loc: Array, scale: Array):
    """Closed-form ``single_cost_cent_moments`` — no cent grid.

    The grid version sums Laplace tail-CDF values over ``grid`` cent
    cells; those are geometric series in the cell index (the Laplace CDF
    is piecewise exponential with per-cent ratio exp(-1/(100 s))), so
    both Abel sums collapse to a handful of scalar terms:

        sum_{i<I} (Z - G_i)      and      sum_{i<I} i (Z - G_i)

    with I = bid_cents - 1 cells, split at the |loc| breakpoint m where
    the CDF changes branch. Exact for EVERY bid (the grid version is
    exact only for bids <= grid/100), identical values up to f32
    rounding (tests cross-check against the grid). All exponents are
    arranged to be <= 0 in their selected branch (expm1-stabilized
    geometric ratios; out-of-branch overflows are discarded by the
    selects), so the formulas are safe for any (bid, loc, scale).

    Replaces the materialized (grid-1, K) tail table in the hot step.
    |Laplace(loc, s)| depends on loc only through |loc|,
    so a = |loc| throughout. Returns (mean_cents, std_cents,
    cmax_cents) like the grid version.
    """
    bid = jnp.asarray(bid, jnp.float32)
    a = jnp.abs(jnp.asarray(loc, jnp.float32))
    s = jnp.maximum(jnp.asarray(scale, jnp.float32), 1e-12)
    shape = jnp.broadcast_shapes(bid.shape, a.shape, s.shape)
    bid = jnp.broadcast_to(bid, shape)
    a = jnp.broadcast_to(a, shape)
    s = jnp.broadcast_to(s, shape)

    y0 = jnp.maximum(bid - 0.005, 0.0)
    c = 1.0 / (100.0 * s)  # per-cent decay exponent
    bc = jnp.round(bid * 100.0)
    big_i = jnp.maximum(bc - 1.0, 0.0)  # number of summed cells
    # cells below the |loc| breakpoint: e_i = (i+0.5)/100 < a
    m = jnp.clip(jnp.ceil(100.0 * a - 0.5), 0.0, big_i)

    em1 = -jnp.expm1(-c)  # 1 - exp(-c), stable for small c

    def geo0(n):
        # sum_{k<n} exp(-k c)
        return -jnp.expm1(-n * c) / em1

    def geo1(n):
        # sum_{k<n} k exp(-k c)
        e_c = jnp.exp(-c)
        return (
            e_c
            * (1.0 - n * jnp.exp(-(n - 1.0) * c) + (n - 1.0) * jnp.exp(-n * c))
            / (em1 * em1)
        )

    def safe_exp(x):
        # exponents are <= 0 in their selected branch; clamp so the
        # unselected branch cannot produce inf (then nan via 0*inf)
        return jnp.exp(jnp.minimum(x, 0.0))

    e_half = jnp.exp(-0.5 * c)
    e_y0 = safe_exp(-y0 / s)  # exp(-y0/s)

    # B_i = 0.5 exp(-a/s) (exp(-e_i/s) - exp(-y0/s)), for all i < I
    b_fac = safe_exp(-(a + 0.005) / s)  # exp(-a/s) exp(-c/2)
    b_cut = safe_exp(-(a + y0) / s)  # exp(-a/s) exp(-y0/s)
    sum_b = 0.5 * (b_fac * geo0(big_i) - big_i * b_cut)
    sum_ib = 0.5 * (b_fac * geo1(big_i) - 0.5 * big_i * (big_i - 1.0) * b_cut)

    # case y0 <= a: A_i = 0.5 (exp(-(a-y0)/s) - exp(-(a-e_i)/s)), all i
    e_ay = safe_exp(-(a - y0) / s)
    # R2 over i < n: sum exp(-(a - e_i)/s) = t2(n) * geo0(n) reindexed
    # from the top (largest term at i = n-1), t2 = exp(-(100a - n + 0.5)c)
    def r2(n):
        t2 = safe_exp(-(100.0 * a - n + 0.5) * c)
        return t2 * geo0(n), t2 * ((n - 1.0) * geo0(n) - geo1(n))

    r2_i, r2w_i = r2(big_i)
    sum_a_low = 0.5 * (big_i * e_ay - r2_i)
    sum_ia_low = 0.5 * (0.5 * big_i * (big_i - 1.0) * e_ay - r2w_i)

    # case y0 > a:
    #   i < m:  A_i = 1 - 0.5 exp(-(y0-a)/s) - 0.5 exp(-(a-e_i)/s)
    #   i >= m: A_i = 0.5 exp(a/s)(exp(-e_i/s) - exp(-y0/s))
    #           = 0.5 (exp(-(e_i-a)/s) - exp(-(y0-a)/s))
    e_ya = safe_exp(-(y0 - a) / s)
    r2_m, r2w_m = r2(m)
    sum_a_pre = m * (1.0 - 0.5 * e_ya) - 0.5 * r2_m
    sum_ia_pre = 0.5 * m * (m - 1.0) * (1.0 - 0.5 * e_ya) - 0.5 * r2w_m
    # top part: exp(-(e_i - a)/s) = t3 exp(-(i-m)c), t3 = exp(-(m+0.5-100a)c)
    # (m + 0.5 - 100a is in (-0.5, 0.5]; the slight positive exponent is
    # bounded by e^{c/2}, not clamped)
    n_top = big_i - m
    t3 = jnp.exp(jnp.minimum(-(m + 0.5 - 100.0 * a) * c, 30.0))
    s3 = t3 * geo0(n_top)
    s3w = t3 * geo1(n_top) + m * s3  # sum of i * exp(...) via i = k + m
    sum_a_top = 0.5 * (s3 - n_top * e_ya)
    # sum over i in [m, I) of i: m..I-1
    sum_i_top = 0.5 * (big_i - 1.0 + m) * n_top
    sum_ia_top = 0.5 * s3w - 0.5 * sum_i_top * e_ya

    low = y0 <= a
    sum_a = jnp.where(low, sum_a_low, sum_a_pre + sum_a_top)
    sum_ia = jnp.where(low, sum_ia_low, sum_ia_pre + sum_ia_top)

    z = laplace_cdf(y0, a, s) - laplace_cdf(-y0, a, s)
    zsafe = jnp.maximum(z, 1e-12)
    tail0 = jnp.maximum(sum_a + sum_b, 0.0)
    tail1 = jnp.maximum(sum_ia + sum_ib, 0.0)
    mu = tail0 / zsafe
    m2 = (2.0 * tail1 + tail0) / zsafe
    var = jnp.maximum(m2 - mu * mu, 0.0)
    cmax = jnp.maximum(bc - 1.0, 0.0)
    return mu, jnp.sqrt(var), cmax


def agg_cost_cents(
    key: Array, n_clicks: Array, mu: Array, sigma: Array, cmax: Array,
    cents_dtype, cmin: Array = None, bits: int = 32,
) -> Array:
    """One aggregate spend draw per cell, in integer cents.

    Approximates the sum of ``n_clicks`` iid per-click cost draws with
    exact discrete moments (mu, sigma) in cents: one normal
    ``N(n*mu, n*sigma^2)`` rounded to an integer and clipped to the
    support ``[n*cmin, n*cmax]`` (``cmin`` defaults to 0 — every model
    except the binomial pool has non-negative costs; the pool's k >= 3
    cells can have a negative max bid, so they pass an explicitly
    negative floor). Exact for n == 0 (returns 0) and for sigma == 0;
    CLT-approximate otherwise with O(1/sqrt(n)) distribution error — the
    ``rev_sum_cents`` playbook applied to the cost side (PARITY.md
    "Aggregate cost sampling").
    """
    n = n_clicks.astype(jnp.float32)
    if bits == 16:
        z = normal16(key, n_clicks.shape)
    else:
        z = jax.random.normal(key, n_clicks.shape, dtype=jnp.float32)
    s = jnp.round(n * mu + jnp.sqrt(n) * sigma * z)
    lo = 0.0 if cmin is None else n * cmin
    s = jnp.clip(s, lo, n * cmax)
    return s.astype(cents_dtype)


_POOL_QUAD_NODES = 48


def _pool_quad():
    import numpy as _np

    x, w = _np.polynomial.legendre.leggauss(_POOL_QUAD_NODES)
    # map [-1, 1] -> (0, 1)
    return (
        jnp.asarray(0.5 * (x + 1.0), jnp.float32),
        jnp.asarray(0.5 * w, jnp.float32),
    )


def pool_cost_deci_moments(bid: Array, loc: Array, scale: Array, k: Array):
    """Per-click cost moments (DECICENTS) for the BINOMIAL_POOL model,
    conditional on the win event, given the cell's bidder count ``k``.

    The reference pool auction (synthetic_kw_classes.py:648-688 +
    synthetic_kw_helpers.py:153-161; adcraft_tpu.auction.
    implicit_pool_auction) draws ``k`` once per cell, each bidder's bid
    raw Laplace(loc, scale); conditional on winning (max bid < our bid)
    the per-click cost is

        M = F^{-1}(F(bid) * U^{1/k}),  U ~ Uniform(0, 1)

    (the max of k iid Laplaces truncated below ``bid``), with the
    reference quirks: k == 0 -> cost identically 0; k < 3 -> floored at
    0 (zero padding enters the top-3 array); k >= 3 raw (possibly
    NEGATIVE — losing pools can pay the advertiser). There is no
    elementary closed form (the y > loc CDF branch integrates to an
    incomplete-beta series with catastrophic f32 cancellation at large
    k), so the moments are Gauss-Legendre quadrature over U — smooth
    integrand with an integrable log tail at U -> 0; with 48 nodes the
    error sits orders below the CLT error of the aggregate draw this
    feeds (validated vs 1e6-sample brute force per k,
    tests/test_distributions.py).

    Returns (mu_deci, sig_deci, cmax_deci = round(1000*bid)) with the
    1/12 decicent^2 quantization variance folded into sigma, matching
    ``cost_create_deci_moments``'s convention for continuous-cost
    models gated on the 0.1-cent grid.

    Implementation (round-5 perf rewrite, same math): substituting
    u = w^k turns the integral into

        E[M^r | k] = k * sum_q omega_q * g_r(w_q) * w_q^(k-1)

    where g_r(w) = icdf(F(bid) * w)^r is k-INDEPENDENT. The g tables
    are (Q, K) per day (the only transcendental work; they hoist out of
    the per-sub-timestep vmap because bid/loc/scale are day-constant),
    the node powers w_q^(k-1) over INTEGER k are a static (Q, kmax)
    constant, and the per-cell work collapses to a one-hot contraction
    over k -- ~100x fewer transcendental evaluations than the naive
    per-cell quadrature. The k < 3 floor clamps g
    before the k = 1, 2 table columns; GL-48 is exact for polynomials
    past degree 90, so the w^(k-1) weight is handled exactly for every
    k <= kmax.
    """
    kmax = 33  # table columns k = 1..kmax (reference default 30)
    bid = jnp.asarray(bid, jnp.float32)
    loc = jnp.asarray(loc, jnp.float32)
    scale = jnp.asarray(scale, jnp.float32)
    k = jnp.asarray(k, jnp.float32)
    pshape = jnp.broadcast_shapes(bid.shape, loc.shape, scale.shape)
    nd = len(pshape)
    w_nodes, omega = _pool_quad()
    wq = w_nodes.reshape((_POOL_QUAD_NODES,) + (1,) * nd)
    og = omega.reshape((_POOL_QUAD_NODES,) + (1,) * nd)
    f_bid = laplace_cdf(bid, loc, scale)
    q = jnp.clip(f_bid * wq, 1e-38, 1.0 - 1e-12)
    g = laplace_icdf(q, loc, scale)  # (Q,) + pshape, k-independent
    gc = jnp.maximum(g, 0.0)  # the k < 3 zero-padding floor
    # static node-power table W[q, j] = w_q^j, j = k-1 in 0..kmax-1 —
    # built host-side from the raw leggauss nodes (f64) so it is a
    # compile-time constant
    import numpy as _np

    _x, _ = _np.polynomial.legendre.leggauss(_POOL_QUAD_NODES)
    _w_np = 0.5 * (_x + 1.0)
    W = jnp.asarray(
        _w_np[:, None] ** _np.arange(kmax)[None, :], jnp.float32
    )  # (Q, kmax)
    js = jnp.arange(kmax, dtype=jnp.float32)  # j = k - 1
    clamp_col = js[None, :] < 2.0  # k = 1, 2 use the floored g

    def table(gr, gr_c):
        # A[j] + pshape: sum_q omega_q * (g or clamped g)^r * w_q^j.
        # HIGHEST: the env path's only f32 matrix products; a GPU would
        # otherwise run them in TF32 (~10-bit mantissa) and blur the
        # cost moments the aggregate spend draws use
        hi = jax.lax.Precision.HIGHEST
        t_raw = jnp.tensordot(W, og * gr, axes=((0,), (0,)), precision=hi)
        t_cl = jnp.tensordot(W, og * gr_c, axes=((0,), (0,)), precision=hi)
        cc = clamp_col.reshape((1, kmax) + (1,) * nd)[0].reshape(
            (kmax,) + (1,) * nd
        )
        return jnp.where(cc, t_cl, t_raw)  # (kmax,) + pshape

    A1 = table(g, gc)
    A2 = table(g * g, gc * gc)
    # per-cell: one-hot over integer k contracts the tables
    ki = jnp.clip(jnp.round(k), 0.0, float(kmax)).astype(jnp.int32)
    onehot = jax.nn.one_hot(ki - 1, kmax, dtype=jnp.float32)  # (..., kmax)
    # move the table's leading j axis last for the contraction
    perm = tuple(range(1, 1 + nd)) + (0,)
    mu = k * jnp.sum(onehot * jnp.transpose(A1, perm), axis=-1)
    m2 = k * jnp.sum(onehot * jnp.transpose(A2, perm), axis=-1)
    zero_k = k <= 0.0
    mu = jnp.where(zero_k, 0.0, mu)
    m2 = jnp.where(zero_k, 0.0, m2)
    var = jnp.maximum(m2 - mu * mu, 0.0)
    mu_d = 1000.0 * mu
    sig_d = jnp.sqrt(1e6 * var + jnp.where(zero_k, 0.0, 1.0 / 12.0))
    cmax_d = jnp.round(1000.0 * bid) * jnp.where(zero_k, 0.0, 1.0)
    return mu_d, sig_d, cmax_d


def pool_cost_lane_draws(
    key: Array, bid: Array, loc: Array, scale: Array, k: Array, shape,
    bits: int = 32,
) -> Array:
    """Per-click pool cost draws (in DOLLARS, continuous) for the agg
    path's lite/deep lanes: M = F^{-1}(F(bid) * u^{1/k}) with the k<3
    floor and k==0 zeroing, exactly ``implicit_pool_auction``'s per-lane
    law for the cell's bidder count ``k`` (stream keyed here, so
    lite-table and deep-resolution lanes agree bit-for-bit)."""
    if bits == 16:
        u = uniform16(key, shape)
    else:
        u = jax.random.uniform(key, shape)
    f_bid = laplace_cdf(bid, loc, scale)
    ksafe = jnp.maximum(k, 1.0)
    m = laplace_icdf(
        jnp.clip(f_bid * u ** (1.0 / ksafe), 1e-38, 1.0 - 1e-12), loc, scale
    )
    m = jnp.where(k < 3.0, jnp.maximum(m, 0.0), m)
    return jnp.where(k <= 0.0, 0.0, m)


# ---------------------------------------------------------------------------
# Laplace CDF utilities (for the closed-form implicit auction)
# ---------------------------------------------------------------------------


def laplace_cdf(x: Array, loc: Array, scale: Array) -> Array:
    """CDF of Laplace(loc, scale)."""
    z = (x - loc) / scale
    return jnp.where(z < 0, 0.5 * jnp.exp(z), 1.0 - 0.5 * jnp.exp(-z))


def laplace_icdf(u: Array, loc: Array, scale: Array) -> Array:
    """Inverse CDF of Laplace(loc, scale). u in (0, 1)."""
    # Branch at u = 0.5; clamp logs away from 0 to stay finite.
    lo = jnp.log(jnp.maximum(2.0 * u, 1e-38))
    hi = -jnp.log(jnp.maximum(2.0 * (1.0 - u), 1e-38))
    return loc + scale * jnp.where(u < 0.5, lo, hi)


def truncated_laplace(
    key: Array, loc: Array, scale: Array, low: Array, high: Array, shape,
    bits: int = 32,
) -> Array:
    """Exact inverse-CDF draws of Laplace(loc, scale) truncated to [low, high].

    ``bits=16`` drives the inverse CDF with half-word uniforms
    (``uniform16``) — two draws per threefry word (EnvConfig.lane_bits).
    """
    f_lo = laplace_cdf(low, loc, scale)
    f_hi = laplace_cdf(high, loc, scale)
    if bits == 16:
        u = uniform16(key, shape)
    else:
        u = jax.random.uniform(key, shape)
    return laplace_icdf(f_lo + u * (f_hi - f_lo), loc, scale)
