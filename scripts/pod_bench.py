"""Multi-host benchmark: per-host and global env-step throughput.

The 1-device -> 1-host -> N-host scaling table (BASELINE.json metric) in
one command per host:

    # host i of N (give all three flags; nothing detects them):
    python scripts/pod_bench.py --coordinator <host0>:8476 \
        --num-processes N --process-id i

Uses the production multi-host surface (adcraft_tpu.parallel.mesh):
``initialize_multihost`` -> global ``make_env_mesh`` ->
``sharded_vector_env`` stepping with process-spanning shardings. Every
process prints ONE JSON line with global and per-host env-steps/s; the
numbers are identical across hosts (same global clockline) so any one
line is the result. Smoke-tested on a 2-process CPU mesh
(tests/test_multiprocess.py::test_pod_bench_two_process_smoke).

Env knobs mirror bench.py: BENCH_NUM_ENVS / BENCH_NUM_KEYWORDS /
BENCH_STEPS / BENCH_CONV / BENCH_REV / BENCH_COST / BENCH_LANE_BITS /
BENCH_BINOM / BENCH_GATE_SCOPE.
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp

from adcraft_tpu.profiling import enable_compile_cache


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--coordinator", default=None, help="host:port of process 0")
    ap.add_argument("--num-processes", type=int, default=None)
    ap.add_argument("--process-id", type=int, default=None)
    ap.add_argument(
        "--num-envs", type=int, default=int(os.environ.get("BENCH_NUM_ENVS", 4096))
    )
    ap.add_argument(
        "--steps", type=int, default=int(os.environ.get("BENCH_STEPS", 12))
    )
    ap.add_argument("--gloo", action="store_true", help="CPU collectives (tests)")
    args = ap.parse_args()

    if args.gloo:
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    enable_compile_cache()

    from adcraft_tpu.config import EnvConfig, KeywordKind
    from adcraft_tpu.parallel.mesh import (
        initialize_multihost,
        make_env_mesh,
        sharded_vector_env,
    )
    from adcraft_tpu.quantiles import simple_experiment_table

    if args.coordinator or args.num_processes:
        initialize_multihost(args.coordinator, args.num_processes, args.process_id)

    cfg = EnvConfig(
        num_keywords=int(os.environ.get("BENCH_NUM_KEYWORDS", 100)),
        kind=KeywordKind.IMPLICIT,
        max_volume=int(os.environ.get("BENCH_MAX_VOLUME", 576)),
        max_days=60,
        conv_sampling=os.environ.get("BENCH_CONV", "counts"),
        rev_sampling=os.environ.get("BENCH_REV", "sum"),
        cost_sampling=os.environ.get("BENCH_COST", "agg"),
        lane_bits=int(os.environ.get("BENCH_LANE_BITS", "16")),
        binomial_sampler=os.environ.get("BENCH_BINOM", "inversion"),
        gate_scope=os.environ.get("BENCH_GATE_SCOPE", "global"),
    )
    table = simple_experiment_table(128, 0.8)

    n_dev = jax.device_count()
    n_proc = jax.process_count()
    # round the global batch to the device count
    num_envs = max(n_dev, args.num_envs // n_dev * n_dev)

    mesh = make_env_mesh()
    venv = sharded_vector_env(cfg, num_envs, mesh=mesh, table=table)
    state, _ = venv.reset(jax.random.PRNGKey(0))
    bids = jnp.full((num_envs, cfg.num_keywords), 1.0, jnp.float32)

    state, _ = jax.block_until_ready(venv.step(state, bids))  # compile + warm

    t0 = time.perf_counter()
    out = None
    for _ in range(args.steps):
        out = venv.step(state, bids)
        state = out[0]
    jax.block_until_ready(out)
    dt = time.perf_counter() - t0

    global_rate = num_envs * args.steps / dt
    print(
        json.dumps(
            {
                "metric": "pod_env_steps_per_sec",
                "global": round(global_rate, 1),
                "per_host": round(global_rate / n_proc, 1),
                "per_device": round(global_rate / n_dev, 1),
                "num_envs": num_envs,
                "devices": n_dev,
                "processes": n_proc,
                "process_id": jax.process_index(),
                "steps": args.steps,
            }
        ),
        flush=True,
    )


if __name__ == "__main__":
    main()
