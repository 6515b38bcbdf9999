"""True multi-process distributed validation (SURVEY.md §2b).

Spawns TWO separate python processes that form one jax.distributed job
over an 8-device global CPU mesh (4 forced host devices each — the
stand-in for a 2-host job), steps the sharded env across the
process boundary, reduces metrics with ``psum_metrics`` inside
``shard_map``, and checks the trajectories are BIT-IDENTICAL to the
single-process 8-device run. This is the contract the reference meets
with its Ray rollout workers
(/root/reference/adcraft/experiment_utils/agent_configs.py:85,107): more
workers change wall-clock, never results.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.parallel import make_env_mesh, sharded_vector_env
from adcraft_tpu.quantiles import simple_experiment_table

WORKER = os.path.join(os.path.dirname(__file__), "mp_worker.py")
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _worker_env() -> dict:
    env = os.environ.copy()
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    return env


@pytest.mark.slow
def test_two_process_trajectories_bit_identical(tmp_path):
    port = _free_port()
    out = str(tmp_path / "mp")
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, str(pid), "2", str(port), out],
            env=_worker_env(),
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"worker failed:\n{log[-4000:]}"

    a = np.load(out + "_0.npz")
    b = np.load(out + "_1.npz")
    # both processes observe the same global trajectory and psum
    np.testing.assert_array_equal(a["rewards"], b["rewards"])
    assert a["psum_reward"] == b["psum_reward"]

    # single-process 8-virtual-device run (this pytest process) must
    # match the 2-process run bit-for-bit: same seed, same trajectories,
    # regardless of process layout.
    cfg = EnvConfig(
        num_keywords=5, kind=KeywordKind.IMPLICIT, max_volume=96, max_days=10
    )
    venv = sharded_vector_env(
        cfg, 16, mesh=make_env_mesh(), table=simple_experiment_table(32, 0.5)
    )
    state, _ = venv.reset(jax.random.PRNGKey(0))
    bids = jnp.full((16, cfg.num_keywords), 1.0, jnp.float32)
    rewards = []
    for _ in range(3):
        state, ts = venv.step(state, bids)
        rewards.append(np.asarray(ts.reward))
    np.testing.assert_array_equal(np.stack(rewards), a["rewards"])
    # psum reduces per-shard partials then across shards — a different
    # f32 association than numpy's sequential sum, so allclose not equal
    np.testing.assert_allclose(
        a["psum_reward"], rewards[-1].sum(), rtol=1e-6, atol=1e-4
    )


@pytest.mark.slow
def test_pod_bench_two_process_smoke():
    """scripts/pod_bench.py forms a 2-process jax.distributed job on the
    CPU stand-in mesh and reports consistent global/per-host throughput
    from both processes (VERDICT r2 item 8: the 1-host -> N-host scaling
    table is one command per host when real hardware appears)."""
    port = _free_port()
    script = os.path.join(REPO, "scripts", "pod_bench.py")
    env = _worker_env()
    env["BENCH_NUM_KEYWORDS"] = "4"
    env["BENCH_MAX_VOLUME"] = "64"
    procs = [
        subprocess.Popen(
            [
                sys.executable, script,
                "--coordinator", f"localhost:{port}",
                "--num-processes", "2",
                "--process-id", str(pid),
                "--num-envs", "16",
                "--steps", "2",
                "--gloo",
            ],
            env=env,
            stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT,
            text=True,
        )
        for pid in range(2)
    ]
    logs = []
    for p in procs:
        try:
            stdout, _ = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            raise
        logs.append(stdout)
    import json as _json

    outs = []
    for p, log in zip(procs, logs):
        assert p.returncode == 0, f"pod_bench worker failed:\n{log[-4000:]}"
        line = [l for l in log.splitlines() if l.startswith("{")][-1]
        outs.append(_json.loads(line))
    for o in outs:
        assert o["devices"] == 8 and o["processes"] == 2
        assert o["num_envs"] == 16
        assert o["global"] > 0
        # per_host/global are independently rounded to 1 decimal
        assert o["per_host"] * 2 == pytest.approx(o["global"], abs=0.2)
    assert {o["process_id"] for o in outs} == {0, 1}
