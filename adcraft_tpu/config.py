"""Static environment configuration.

The reference spreads configuration across env kwargs
(adcraft/gymnasium_kw_env.py:54-103), keyword-param dicts with a
"explicit value OR alternative generating params OR sampled default" cascade
(adcraft/synthetic_kw_classes.py:28-117), and experiment dicts
(adcraft/experiment_utils/experiment_configs.py:8-98).

Here everything that determines *shapes or compiled control flow* lives in a
single frozen, hashable ``EnvConfig`` so it can be a static argument to jit.
Everything stochastic or time-varying lives in the ``EnvState`` /
``KeywordState`` pytrees (see adcraft_tpu.keywords / adcraft_tpu.env).
"""

from __future__ import annotations

import dataclasses
import enum


class KeywordKind(enum.Enum):
    """Which auction mechanism the env's keywords use.

    The reference subclasses ``Keyword`` into ``ExplicitKeyword``
    (parametric bid->impression sigmoid + parametric cost model,
    adcraft/synthetic_kw_classes.py:457) and ``ImplicitKeyword`` (literal
    nth-price auction against sampled competitor bids, :578). Envs are
    homogeneous in keyword kind, so it is a static config flag here rather
    than per-object subclassing.
    """

    EXPLICIT = "explicit"
    IMPLICIT = "implicit"


class CostModel(enum.Enum):
    """Cost-per-click model for explicit keywords.

    RUST_QUIRK reproduces ``rust.cost_create`` (src/lib.rs:54-67): cost
    draws are ``clamp(sqrt(bid)/4 + 2.2 + N(0, 1e-10+sqrt(bid)/6), 0, 4.4)``
    — the 4.4/2.2 constants come from the placeholder fill value the Rust
    code halves and clamps against. This is what the reference env actually
    runs (synthetic_kw_classes.py:575, gymnasium_kw_utils.py:90).

    PYTHON reproduces the documented model ``generic_cost``
    (synthetic_kw_helpers.py:56-63):
    ``round(clip(sqrt(bid)/4 + bid/2 + N(0, 1e-10+sqrt(bid)/6), 0, bid), 2)``.
    """

    RUST_QUIRK = "rust_quirk"
    PYTHON = "python"


class CompetitorModel(enum.Enum):
    """Competitor-bid model for implicit keywords.

    SINGLE_ABS_CENTS: one competitor whose bid is ``round(|Laplace(loc,
    scale)|, 2)`` — the configuration used by every reference experiment
    (gymnasium_kw_utils.py:159-195: ``single_competitor`` +
    ``bid_abs_laplace``).

    BINOMIAL_POOL: ``Binomial(max_bidders, participation_rate)`` bidders per
    auction batch, raw (signed, unrounded) Laplace bids — the
    ``ImplicitKeyword`` defaults (synthetic_kw_classes.py:648-688).
    """

    SINGLE_ABS_CENTS = "single_abs_cents"
    BINOMIAL_POOL = "binomial_pool"


@dataclasses.dataclass(frozen=True)
class UpdaterConfig:
    """Non-stationarity drift magnitudes.

    Mirrors ``updater_params=[["vol",0.03],["ctr",0.03],["cvr",0.03]]``
    (gymnasium_kw_env.py:62). Volume drifts by an additive uniform step
    proportional to the *initial* mean volume; ctr/cvr drift
    multiplicatively, clipped to [0, 1] (gymnasium_kw_env.py:114-158).
    """

    vol_scale: float = 0.03
    ctr_scale: float = 0.03
    cvr_scale: float = 0.03


@dataclasses.dataclass(frozen=True)
class EnvConfig:
    """Static (shape- and control-flow-determining) environment parameters.

    Defaults mirror ``BiddingSimulation.__init__``
    (adcraft/gymnasium_kw_env.py:54-65).
    """

    num_keywords: int = 10
    max_days: int = 60
    budget: float = 1000.0
    loss_threshold: float = 10000.0

    kind: KeywordKind = KeywordKind.EXPLICIT
    cost_model: CostModel = CostModel.RUST_QUIRK
    competitor_model: CompetitorModel = CompetitorModel.SINGLE_ABS_CENTS

    # The day is split into this many sub-timesteps with a shared depleting
    # budget (hardcoded 24 at bidding_simulation.py:213).
    timesteps_per_day: int = 24

    # Static shape bounds. ``max_volume`` bounds a keyword's daily auction
    # count; the per-sub-timestep auction bound and the per-(t,kw) click
    # buffer size are derived from it. Volume draws above the bound are
    # clipped (and counted in diagnostics).
    max_volume: int = 1024

    # Non-stationarity. ``updater`` magnitudes are always carried; whether a
    # keyword actually drifts is the per-keyword ``updater_mask`` in state
    # (None mask in the reference == all False).
    updater: UpdaterConfig = UpdaterConfig()

    # use float64 for money arithmetic (parity-vs-oracle mode). Requires
    # jax_enable_x64. Default float32 for speed.
    use_x64: bool = False

    # budget-threading implementation — all bit-identical
    # (tests/test_step.py cross-checks):
    #   "auto"   (default) "lazy" for cents-quantized cost models,
    #            "jacobi" otherwise;
    #   "lazy"   bulk full/zero classification + one O(M) lane resolution
    #            per partial cell (nonneg costs only);
    #   "jacobi" parallel fixed point, one O(K*M) sweep per iteration;
    #   "scan"   sequential over cells; reference shape, cross-validation.
    gate_mode: str = "auto"

    # budget-gate granularity: "per_t" (default) runs one gate per
    # sub-timestep inside a T-step lax.scan — Jacobi chains stay short
    # (cells within one sub-timestep) and each sweep touches only an
    # (M+1, K) tile; "global" gates all T*K cells in one call — fewer
    # dispatches but worst-case Jacobi sweep counts grow with the length
    # of budget-decay chains across the whole day (slow when the budget
    # binds gradually); "chunk" (agg cost sampling only) scans groups of
    # ``gate_chunk_t`` sub-timesteps, each gated in one flattened call —
    # the sweet spot between scan length and per-sweep width when both
    # dispatch overhead and worst-env sweep counts matter. Bit-identical
    # results in every mode.
    gate_scope: str = "per_t"

    # sub-timesteps per gate call when gate_scope="chunk"; tier-1's T-1
    # sub-timesteps are zero-cell-padded up to a multiple (padding cells
    # classify as full with zero spend, so results are unchanged).
    gate_chunk_t: int = 4

    # How sellside conversions are sampled:
    #   "lanes"  (default) one Bernoulli flag per candidate click lane,
    #            first `accepted` consumed — mirrors the reference's
    #            per-click coinflips (bidding_simulation.py:106-109) and
    #            is the injected-draw parity path (the flag table is
    #            independent of budget gating);
    #   "counts" one Binomial(accepted, sctr) draw per cell —
    #            distribution-identical given the gate (conversions of
    #            `accepted` iid flips ARE Binomial(accepted, sctr)), but a
    #            different PRNG stream; removes a third of the step's
    #            random draws. Used by bench.py.
    conv_sampling: str = "lanes"

    # How per-conversion revenues are sampled:
    #   "lanes" (default) one cent-quantized normal draw per candidate
    #           click lane, first `nconv` summed — mirrors the reference's
    #           per-conversion draws (bidding_simulation.py:111) and is the
    #           injected-draw parity path;
    #   "sum"   one aggregate draw per cell: the sum of `nconv` iid
    #           quantized censored normals is approximated by one normal
    #           with the exact per-draw mean/variance (closed-form censored
    #           -normal moments + cent-quantization variance), rounded to
    #           cents — exact for rev_std == 0, CLT-approximate otherwise
    #           (PARITY.md "Aggregate revenue sampling"). Removes the
    #           entire (M, K) revenue table.
    #   "day"   ONE aggregate draw per keyword per DAY from the day's
    #           total conversions. Per-(sub-timestep, keyword) revenue is
    #           never observed (only day sums reach observations /
    #           metrics), so this differs from "sum" only in per-cell
    #           cent rounding (T rounded normals vs one; variance differs
    #           by (T-1)/12 cent^2 — PARITY.md "Aggregate revenue
    #           sampling"). Removes the whole (T, K) revenue-draw grid;
    #           used by bench.py.
    rev_sampling: str = "lanes"

    # How per-click costs are sampled and budget-gated:
    #   "lanes" (default) one cost draw per candidate click lane, the
    #           (M, K) prefix-summed tables feeding the budget gate —
    #           mirrors the reference's per-click draws
    #           (synthetic_kw_helpers.py:104-113) and is the
    #           injected-draw parity path;
    #   "agg"   one aggregate full-cell spend draw per cell — a normal
    #           with the EXACT per-click cost moments (cent-grid pmfs:
    #           distributions.single_cost_cent_moments for implicit
    #           SINGLE_ABS_CENTS, generic_cost_cent_moments for explicit
    #           PYTHON; exact clipped-normal moments on a 0.1-cent grid,
    #           cost_create_deci_moments, for explicit RUST_QUIRK),
    #           rounded to the grid and clipped to the support. The lazy
    #           budget gate classifies cells full/lite against the
    #           aggregate and lane-materializes ONLY the budget-partial
    #           cell(s), so the (M, K) cost tables (~83% of all PRNG
    #           words at bench shape) vanish. CLT-approximate at the
    #           full/partial boundary; distribution-validated in
    #           tests/test_step.py, deviations in PARITY.md. The
    #           BINOMIAL_POOL competitor model (round 5) uses per-cell
    #           quadrature moments CONDITIONAL on the cell's bidder-count
    #           draw (distributions.pool_cost_deci_moments) on the
    #           0.1-cent grid, with first-violation-stop prefix masks
    #           since k >= 3 pool costs can be negative. Used by bench.py.
    cost_sampling: str = "lanes"

    # Straggler compaction for the BATCHED lazy-agg gate (a
    # jax.custom_batching rule in step._make_agg_gate): under vmap the
    # batch pays the worst env's lockstep while-loop iteration count at
    # ~O(E * N) per iteration; the compacted schedule runs warm init +
    # ``gate_compact_phase_a`` full-batch iterations (default 0 — the
    # measured chunk4 straggler profile has most calls well under the
    # cap immediately, and full-batch iterations are exactly the cost
    # being avoided; scripts/gate_stats.py), then gathers the
    # still-unconverged envs into a ``gate_compact_cap``-row buffer
    # (0 = auto: max(64, E // 4), sized so only the budget-break chunk
    # — where ~95% of envs run real chains — falls back) and finishes
    # only those. Falls back to the full-batch loop at runtime when
    # stragglers exceed the cap, so results are bit-identical in every
    # mode ("off" = round-4 behavior; tests cross-check).
    gate_compact: str = "auto"
    gate_compact_phase_a: int = 0
    gate_compact_cap: int = 0

    # Unroll factor for the scan over chunk/per-t gate calls (lax.scan
    # unroll): >1 inlines that many gate calls per scan step so XLA can
    # fuse one chunk's epilogue with the next chunk's warm init.
    gate_scan_unroll: int = 1

    # Cent-grid size for the exact per-click cost moments under
    # cost_sampling="agg": moments are exact for bids <= agg_cost_grid/100
    # (the reference's bid grid tops out at $3.00). Used by the explicit
    # PYTHON cost model's normal-CDF pmf; the implicit path uses the
    # closed-form geometric-series moments (exact for every bid, no
    # grid — distributions.single_cost_cent_moments_closed).
    agg_cost_grid: int = 304

    # Number of per-click cost lanes pre-materialized per cell under
    # cost_sampling="agg" (the "lite" lane table). Any cell whose budget
    # acceptance is decided within the first L lanes (n_clicks <= L, or
    # the L-lane prefix already exceeds the cell's start budget) is
    # resolved in the gate's BULK O(N) class pass instead of costing one
    # lockstep while-loop sweep. This is what keeps budget-decay tails
    # cheap: once the day's budget is nearly exhausted, cells accept
    # 0..L clicks and bulk-resolve, so the while loop only runs for the
    # (typically single) cell where the budget lands beyond lane L.
    # Costs L extra 16/32-bit draws per cell (~t*k*L words/env-day).
    agg_lite_lanes: int = 4

    # Static bound for the binomial-pool bidder-count draw when
    # binomial_sampler="inversion": the exact Bernoulli-sum sampler
    # flips this many masked coins per cell (the reference's
    # ImplicitKeyword default is max_bidders=30; the exact rejection
    # sampler runs lockstep while-loops and a sequential 64-level
    # inversion walk is long). Counts for keywords with max_bidders > this bound would
    # truncate — keep it above your largest max_bidders.
    max_bidders_bound: int = 32

    # Bit width of the uniform behind each AGGREGATE spend draw under
    # cost_sampling="agg": 32 (default; jax.random.normal) or 16 (ndtri
    # of a half-word uniform — tails cut at ~4.17 sigma and the density
    # step-quantized, both far below the CLT error the aggregate draw
    # already carries; PARITY.md "Aggregate cost sampling"). bench.py
    # uses 16.
    agg_draw_bits: int = 32

    # Bit width of the uniform driving each implicit-single cost lane draw:
    # 32 (default; full jax.random.uniform words) or 16 (two lane draws per
    # threefry word — the inverse-CDF input is quantized to 2^-16, which
    # perturbs each cent-bucket probability by < 2^-16; PARITY.md). Only
    # the SINGLE_ABS_CENTS cost lane sampler honors this; other models
    # always use 32.
    lane_bits: int = 32

    # Binomial sampler for the hot-path draws whose n is bounded by the
    # static click buffer (impressions, buyside clicks, conversion counts):
    #   "exact"     (default) jax.random.binomial — inversion/BTRS rejection
    #               loops, several uniforms per draw; the stream the
    #               injected-draw oracle tests pin.
    #   "inversion" one-uniform exact inverse-CDF walk over the <= nmax+1
    #               CDF terms (distributions.binomial_inv) — half a threefry
    #               word per draw at lane_bits=16. Distribution-identical up
    #               to O(n*eps_f32) CDF rounding; different stream. Used by
    #               bench.py. The binomial-pool bidder-count draw (n =
    #               max_bidders, not buffer-bounded) always stays "exact".
    binomial_sampler: str = "exact"

    # PRNG implementation for per-env root keys created by the batch APIs
    # ("threefry2x32" | "rbg" | "unsafe_rbg"). The step itself is
    # impl-agnostic (it uses whatever key it is handed). rbg uses XLA's
    # RngBitGenerator path; it is untried on the GPU, so threefry stays
    # the default.
    prng_impl: str = "threefry2x32"

    def __post_init__(self) -> None:
        if self.num_keywords < 1:
            raise ValueError("num_keywords must be >= 1")
        if self.timesteps_per_day < 1:
            raise ValueError("timesteps_per_day must be >= 1")
        if self.max_volume < 1:
            raise ValueError("max_volume must be >= 1")
        if self.conv_sampling not in ("lanes", "counts"):
            raise ValueError("conv_sampling must be 'lanes' or 'counts'")
        if self.rev_sampling not in ("lanes", "sum", "day"):
            raise ValueError("rev_sampling must be 'lanes', 'sum' or 'day'")
        if self.cost_sampling not in ("lanes", "agg"):
            raise ValueError("cost_sampling must be 'lanes' or 'agg'")
        if self.agg_cost_grid < 2:
            raise ValueError("agg_cost_grid must be >= 2")
        if self.agg_lite_lanes < 1:
            raise ValueError("agg_lite_lanes must be >= 1")
        if self.gate_scope not in ("per_t", "global", "chunk"):
            raise ValueError("gate_scope must be 'per_t', 'global' or 'chunk'")
        if self.gate_scope == "chunk" and self.cost_sampling != "agg":
            raise ValueError("gate_scope='chunk' requires cost_sampling='agg'")
        if self.gate_chunk_t < 1:
            raise ValueError("gate_chunk_t must be >= 1")
        if self.gate_compact not in ("auto", "off"):
            raise ValueError("gate_compact must be 'auto' or 'off'")
        if self.gate_compact_phase_a < 0:
            raise ValueError("gate_compact_phase_a must be >= 0")
        if self.gate_compact_cap < 0:
            raise ValueError("gate_compact_cap must be >= 0")
        if self.gate_scan_unroll < 1:
            raise ValueError("gate_scan_unroll must be >= 1")
        if self.lane_bits not in (16, 32):
            raise ValueError("lane_bits must be 16 or 32")
        if self.agg_draw_bits not in (16, 32):
            raise ValueError("agg_draw_bits must be 16 or 32")
        if self.max_bidders_bound < 1:
            raise ValueError("max_bidders_bound must be >= 1")
        if self.binomial_sampler not in ("exact", "inversion"):
            raise ValueError("binomial_sampler must be 'exact' or 'inversion'")

    # ---- derived static shapes ----

    @property
    def max_auctions_per_cell(self) -> int:
        """Upper bound on auctions in one (sub-timestep, keyword) cell.

        The volume splitter gives the first sub-timestep
        ``vol - (T-1)*(vol//T) = vol//T + vol%T`` auctions and every later
        one ``vol//T`` (bidding_simulation.py:151-167). Over all volumes
        <= max_volume the first-cell count is bounded by
        ``max_volume//T + (T-1)`` (and by max_volume itself).
        """
        t = self.timesteps_per_day
        return min(self.max_volume, self.max_volume // t + (t - 1))

    @property
    def max_clicks_per_cell(self) -> int:
        """Click/cost buffer length per (sub-timestep, keyword) cell."""
        return self.max_auctions_per_cell

    @property
    def max_clicks_rest(self) -> int:
        """Buffer length for sub-timesteps after the first.

        Sub-timesteps t >= 1 each run exactly ``vol // T`` auctions
        (bidding_simulation.py:151-167), bounded by ``max_volume // T`` —
        typically half the first cell's bound, so the 23-step scan runs
        with a much smaller lane buffer than sub-timestep 0.
        """
        return max(1, min(self.max_volume, self.max_volume // self.timesteps_per_day))

    @property
    def cents_costs(self) -> bool:
        """True when the cost model only produces cent-quantized values.

        Implicit single-competitor costs are ``round(|Laplace|, 2)`` and
        the documented Python explicit cost model rounds to cents; for
        these, budget gating and money accounting run in exact integer
        cents — association-free (bit-identical under any XLA reduction
        order) and exact even in float32 mode. The rust-quirk explicit
        cost model and the binomial-pool competitor model produce
        continuous costs and gate in floating point.
        """
        if self.kind is KeywordKind.IMPLICIT:
            return self.competitor_model is CompetitorModel.SINGLE_ABS_CENTS
        return self.cost_model is CostModel.PYTHON

    @property
    def money_dtype(self):
        import jax.numpy as jnp

        return jnp.float64 if self.use_x64 else jnp.float32

    def replace(self, **kw) -> "EnvConfig":
        return dataclasses.replace(self, **kw)
