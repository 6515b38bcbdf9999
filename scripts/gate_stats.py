"""Measure lazy-agg gate sweep counts per gate call — CPU, no GPU needed.

The lockstep while_loop in ``_gate_keywords_lazy_agg`` makes a vmapped
batch pay the WORST env's sweep count at every gate call. Sweep counts
are hardware-independent, so the right (gate_scope, gate_chunk_t,
agg_lite_lanes) combination can be narrowed here on CPU and only the top
candidates timed on the GPU.

Implementation notes: ``step._GATE_STATS_HOOK`` delivers each gate call's
final sweep counter; under vmap ``jax.debug.callback`` fires once per env
with a scalar, in no guaranteed order, so every record is tagged with its
trace-time call-site id — and ``lax.scan`` inside ``simulate_day`` is
shimmed to a Python loop so each chunk/sub-timestep gate becomes its own
call site instead of one site executed G times.

For each config this prints per-call [max over envs] sweep counts plus
two per-step cost proxies: sum(max_sweeps) — the lockstep chain length —
and sum(max_sweeps * cell_width) — the bulk classification work — and the
per-call STRAGGLER counts (envs whose warm init leaves them not-done, i.e.
sweep counter > 2): the quantity that sizes the compacted gate's gather
capacity (step.py straggler compaction).

Usage:
  JAX_PLATFORMS=cpu python scripts/gate_stats.py [envs] [steps]
Env knobs: GATE_STATS_CONFIGS="scope:ct:L:W,..." overrides the grid;
GATE_STATS_VOL / GATE_STATS_CVR pick the regime (default dense 128/0.8).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax as real_lax

NUM_ENVS = int(sys.argv[1]) if len(sys.argv) > 1 else 512
STEPS = int(sys.argv[2]) if len(sys.argv) > 2 else 4
NUM_KEYWORDS = int(os.environ.get("BENCH_NUM_KEYWORDS", 100))


class _UnrolledLax:
    """lax passthrough whose scan is a Python loop (one trace site per
    iteration, so the stats hook can tell chunk gates apart)."""

    def __getattr__(self, name):
        return getattr(real_lax, name)

    @staticmethod
    def scan(f, init, xs, **kw):
        n = jax.tree.leaves(xs)[0].shape[0]
        carry, ys = init, []
        for i in range(n):
            x = jax.tree.map(lambda a: a[i], xs)
            carry, y = f(carry, x)
            ys.append(y)
        stacked = jax.tree.map(lambda *a: jnp.stack(a), *ys)
        return carry, stacked


def run_config(scope, ct, lite):
    import adcraft_tpu.step as step_mod
    from adcraft_tpu.config import EnvConfig, KeywordKind
    from adcraft_tpu.env import VectorBiddingEnv
    from adcraft_tpu.quantiles import simple_experiment_table

    cfg = EnvConfig(
        num_keywords=NUM_KEYWORDS,
        kind=KeywordKind.IMPLICIT,
        max_volume=int(os.environ.get("BENCH_MAX_VOLUME", 576)),
        max_days=60,
        conv_sampling="counts",
        rev_sampling="sum",
        cost_sampling="agg",
        lane_bits=16,
        binomial_sampler="inversion",
        gate_scope=scope,
        gate_chunk_t=ct,
        agg_lite_lanes=lite,
    )

    records = {}  # site id -> list of per-env sweep counts
    site_width = {}
    sites = [0]

    def hook(it):
        site = sites[0]
        sites[0] += 1
        site_width[site] = None

        def record(v, _site=site):
            vals = np.asarray(v).ravel()
            records.setdefault(_site, []).extend(int(x) for x in vals)

        jax.debug.callback(record, it)

    old_lax = step_mod.lax
    step_mod.lax = _UnrolledLax()
    step_mod._GATE_STATS_HOOK = hook
    try:
        table = simple_experiment_table(
            float(os.environ.get("GATE_STATS_VOL", 128)),
            float(os.environ.get("GATE_STATS_CVR", 0.8)),
        )
        venv = VectorBiddingEnv(cfg, NUM_ENVS, table=table)
        state, _ = venv.reset(jax.random.PRNGKey(0))
        bids = jnp.full((NUM_ENVS, cfg.num_keywords), 1.0, jnp.float32)
        state, ts = venv.step(state, bids)  # compile + warm
        float(ts.reward.sum())
        records.clear()
        for _ in range(STEPS):
            state, ts = venv.step(state, bids)
        float(ts.reward.sum())
    finally:
        step_mod._GATE_STATS_HOOK = None
        step_mod.lax = old_lax

    t1 = cfg.timesteps_per_day - 1
    if scope == "global":
        cell_w = [cfg.num_keywords, t1 * cfg.num_keywords]
    elif scope == "chunk":
        g = -(-t1 // ct)
        cell_w = [cfg.num_keywords] + [ct * cfg.num_keywords] * g
    else:
        cell_w = [cfg.num_keywords] * cfg.timesteps_per_day
    site_ids = sorted(records)
    maxs = [max(records[s]) for s in site_ids]
    means = [float(np.mean(records[s])) for s in site_ids]
    # per-call distribution of env iteration counters (2 = warm only):
    # p50/p90/p99/max — sizes the staged/compacted gate's phase split
    quants = [
        tuple(int(np.percentile(records[s], q)) for q in (50, 90, 99, 100))
        for s in site_ids
    ]
    # stragglers: envs that actually entered the while loop (the warm
    # init leaves done=True for quiet envs, whose counter stays at 2)
    strag = [sum(1 for v in records[s] if v > 2) for s in site_ids]
    assert len(site_ids) == len(cell_w), (len(site_ids), len(cell_w))
    tot_sweeps = sum(maxs)
    tot_work = sum(m * cw for m, cw in zip(maxs, cell_w))
    show = maxs if len(maxs) <= 13 else maxs[:13] + ["..."]
    show_s = strag if len(strag) <= 13 else strag[:13] + ["..."]
    n_calls = max(len(records[s]) for s in site_ids) if site_ids else 0
    print(
        f"{scope:>6} ct={ct} L={lite}: calls={len(site_ids)} "
        f"sum(max_sweeps)={tot_sweeps} sum(max*width)={tot_work} "
        f"max_per_call={show} mean0={means[0]:.2f} "
        f"stragglers/call={show_s} (of {n_calls // max(STEPS, 1)} envs x "
        f"{STEPS} steps)\n        it p50/p90/p99/max per call: "
        f"{quants if len(quants) <= 13 else quants[:13]}",
        flush=True,
    )
    return tot_sweeps, tot_work


if __name__ == "__main__":
    grid = os.environ.get("GATE_STATS_CONFIGS")
    if grid:
        configs = [
            (p.split(":")[0],) + tuple(int(x) for x in p.split(":")[1:])
            for p in grid.split(",")
        ]
    else:
        configs = []
        for lite in (1, 2, 4):
            configs += [
                ("global", 4, lite),
                ("chunk", 4, lite),
                ("chunk", 8, lite),
            ]
    print(f"[gate_stats] envs={NUM_ENVS} steps={STEPS}", flush=True)
    for c in configs:
        run_config(*c)
