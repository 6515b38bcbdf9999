"""Headline benchmark: vectorized env-step throughput on one GPU.

Reference baseline (BASELINE.md): ~1.4-2.4 env-steps/s on CPU for a
100-keyword, 60-day episode (timing notebook cells 5-7); midpoint 1.9
env-steps/s used as the comparison point.

Prints ONE JSON line. Headline fields:
  {"metric": "env_steps_per_sec_per_chip", "value": N,
   "unit": "env-steps/s/chip", "vs_baseline": N, "device": {...}, ...}
plus (unless BENCH_QUICK=1):
  "scaling"  — env-batch scaling points (reference timing had none),
  "regimes"  — the reference's sparse timing config (cells 5-6), dense
               explicit and dense binomial-pool keywords,
  "roofline" — threefry words/env-day, measured words/s, and the
               PRNG-bound throughput ceiling of this config.

Needs a GPU: with no GPU it exits non-zero before measuring anything.
``device`` names what ran (JAX's platform, device_kind and count, plus
the card's name and power limit from nvidia-smi). Every timing waits for
the device with ``jax.block_until_ready``. A failing section fails the
run. Headline config matches the reference's densest timing run: 100
implicit quantile keywords, mean_volume=128, cvr=0.8, 1000 budget —
with the reduced-draw sampling modes (conv counts, aggregate revenue,
16-bit lane uniforms, inversion binomials; each validated in
tests/test_step.py, deviations documented in PARITY.md).
"""

import json
import os
import sys
import time

import jax
import jax.numpy as jnp

from adcraft_tpu.profiling import device_info, enable_compile_cache, require_gpu

NUM_ENVS = int(os.environ.get("BENCH_NUM_ENVS", 4096))
NUM_KEYWORDS = int(os.environ.get("BENCH_NUM_KEYWORDS", 100))
STEPS = int(os.environ.get("BENCH_STEPS", 12))
QUICK = os.environ.get("BENCH_QUICK", "0") == "1"
BASELINE_ENV_STEPS_PER_SEC = 1.9  # BASELINE.md derived midpoint


def bench_cfg(
    max_volume: int = 576, kind: str = "implicit", num_keywords: int = NUM_KEYWORDS
):
    from adcraft_tpu.config import EnvConfig, KeywordKind

    return EnvConfig(
        num_keywords=num_keywords,
        kind=KeywordKind(kind),
        max_volume=max_volume,
        max_days=60,
        prng_impl=os.environ.get("BENCH_PRNG", "threefry2x32"),
        # reduced-draw sampling modes (see the roofline output). Each is
        # distribution-validated; "lanes"/"exact"/32 are the
        # injected-parity paths.
        conv_sampling=os.environ.get("BENCH_CONV", "counts"),
        rev_sampling=os.environ.get("BENCH_REV", "sum"),
        cost_sampling=os.environ.get("BENCH_COST", "agg"),
        lane_bits=int(os.environ.get("BENCH_LANE_BITS", "16")),
        binomial_sampler=os.environ.get("BENCH_BINOM", "inversion"),
        # chunked lazy-agg gate (scan of gate_chunk_t-sub-timestep
        # groups) + straggler compaction
        gate_scope=os.environ.get("BENCH_GATE_SCOPE", "chunk"),
        agg_lite_lanes=int(os.environ.get("BENCH_LITE", "1")),
        gate_chunk_t=int(os.environ.get("BENCH_CHUNK_T", "4")),
        gate_compact=os.environ.get("BENCH_COMPACT", "auto"),
        gate_compact_phase_a=int(os.environ.get("BENCH_PHASE_A", "0")),
        gate_compact_cap=int(os.environ.get("BENCH_COMPACT_CAP", "0")),
        gate_scan_unroll=int(os.environ.get("BENCH_UNROLL", "1")),
        agg_draw_bits=int(os.environ.get("BENCH_AGG_BITS", "32")),
    )


def measure(cfg, num_envs: int, table, steps: int = STEPS,
            dispatch: str = None) -> float:
    """env-steps/s for one config, timed on the host clock around work
    that ends in ``jax.block_until_ready``.

    ``dispatch`` picks how days are driven:
      "percall"  (default) a Python loop of day steps, one dispatch per
                 day — the interactive/gym-adapter shape.
      "scan"     the whole timing window is ONE device program
                 (VectorBiddingEnv.rollout, lax.scan over days) — the
                 shape RL rollouts use (agents/ppo.py); reported as an
                 extra.
    """
    from adcraft_tpu.env import VectorBiddingEnv

    dispatch = dispatch or os.environ.get("BENCH_DISPATCH", "percall")
    venv = VectorBiddingEnv(cfg, num_envs, table=table)
    key = jax.random.PRNGKey(0)
    state, _ = venv.reset(key)
    bids = jnp.full((num_envs, cfg.num_keywords), 1.0, jnp.float32)
    if dispatch == "scan":
        out = jax.block_until_ready(venv.rollout(state, bids, steps))  # compile + warm
        state = out[0]
        t0 = time.perf_counter()
        jax.block_until_ready(venv.rollout(state, bids, steps))
        dt = time.perf_counter() - t0
        return num_envs * steps / dt
    state, _ = jax.block_until_ready(venv.step(state, bids))  # compile + warm
    t0 = time.perf_counter()
    out = None
    for _ in range(steps):
        out = venv.step(state, bids)
        state = out[0]
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0
    return num_envs * steps / dt


def main() -> None:
    require_gpu()
    enable_compile_cache()

    from adcraft_tpu.config import CompetitorModel
    from adcraft_tpu.profiling import (
        measure_threefry_words_per_sec,
        prng_words_per_env_day,
    )
    from adcraft_tpu.quantiles import simple_experiment_table

    def note(msg):
        # progress to stderr as each number lands
        print(f"[bench] {msg}", file=sys.stderr, flush=True)

    n_chips = jax.device_count()
    dense = simple_experiment_table(128, 0.8)
    cfg = bench_cfg()

    headline = measure(cfg, NUM_ENVS, dense) / n_chips
    note(f"headline {NUM_ENVS} envs: {headline:.1f} env-steps/s/chip")
    out = {
        "dispatch": os.environ.get("BENCH_DISPATCH", "percall"),
        "metric": "env_steps_per_sec_per_chip",
        "value": round(headline, 1),
        "unit": "env-steps/s/chip",
        "vs_baseline": round(headline / BASELINE_ENV_STEPS_PER_SEC, 1),
        "device": device_info(),
        "config": {
            "num_envs": NUM_ENVS,
            "num_keywords": NUM_KEYWORDS,
            "regime": "dense (mean_volume=128, cvr=0.8)",
            "max_volume": cfg.max_volume,
            "conv_sampling": cfg.conv_sampling,
            "rev_sampling": cfg.rev_sampling,
            "cost_sampling": cfg.cost_sampling,
            "lane_bits": cfg.lane_bits,
            "binomial_sampler": cfg.binomial_sampler,
            "gate_scope": cfg.gate_scope,
            "gate_chunk_t": cfg.gate_chunk_t,
            "agg_lite_lanes": cfg.agg_lite_lanes,
            "gate_compact": cfg.gate_compact,
            "gate_compact_cap": cfg.gate_compact_cap,
        },
    }

    if not QUICK:
        # the in-program rollout shape (one lax.scan program per timing
        # window — how RL consumes the env); the delta vs the headline
        # bounds per-day dispatch cost
        scan_v = measure(cfg, NUM_ENVS, dense, dispatch="scan") / n_chips
        out["scan_rollout"] = round(scan_v, 1)
        note(f"scan-rollout dispatch variant: {scan_v:.1f}")

        # env-batch scaling
        scaling = {str(NUM_ENVS): round(headline, 1)}
        points = os.environ.get("BENCH_SCALING", "1024,8192")
        for e in (int(x) for x in points.split(",") if x):
            if e != NUM_ENVS:
                scaling[str(e)] = round(measure(cfg, e, dense) / n_chips, 1)
                note(f"scaling {e} envs: {scaling[str(e)]}")
        out["scaling"] = scaling

        out["regimes"] = {}
        # the reference's sparse timing regime (cells 5-6: vol=16, cvr=0.1)
        sparse = simple_experiment_table(16, 0.1)
        sparse_cfg = bench_cfg(max_volume=128)  # covers round(N(16, 1+8))
        out["regimes"]["very_sparse_16_0.1"] = round(
            measure(sparse_cfg, NUM_ENVS, sparse) / n_chips, 1
        )
        note(f"sparse regime: {out['regimes']['very_sparse_16_0.1']}")

        # dense EXPLICIT keywords on the same agg/gate knobs
        expl_cfg = bench_cfg(kind="explicit")
        out["regimes"]["dense_explicit"] = round(
            measure(expl_cfg, NUM_ENVS, dense) / n_chips, 1
        )
        note(f"dense explicit regime: {out['regimes']['dense_explicit']}")

        # the reference's DEFAULT ImplicitKeyword — binomial-pool
        # competitors — on the agg fast path
        pool_cfg = bench_cfg().replace(
            competitor_model=CompetitorModel.BINOMIAL_POOL
        )
        out["regimes"]["dense_pool"] = round(
            measure(pool_cfg, NUM_ENVS, dense) / n_chips, 1
        )
        note(f"dense pool regime: {out['regimes']['dense_pool']}")

        # PRNG roofline: words/day and the measured threefry rate bound
        # what a sampling-dominated config can reach; utilization > 1
        # means the step is NOT PRNG-bound at this word count
        words = prng_words_per_env_day(cfg)
        rate = measure_threefry_words_per_sec()
        if words:
            ceiling = rate["median"] / words
            out["roofline"] = {
                "prng_words_per_env_day": round(words),
                "threefry_words_per_sec": round(rate["median"]),
                "threefry_rate_spread": round(rate["spread"], 2),
                "prng_bound_env_steps_per_sec": round(ceiling, 1),
                "prng_utilization": round(headline * n_chips / ceiling, 3),
            }
            note(f"roofline: {out['roofline']}")

    print(json.dumps(out))


if __name__ == "__main__":
    main()
