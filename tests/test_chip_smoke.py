"""chip_smoke.py's phases at tiny sizes on the CPU.

The script runs them at full width on the GPU; here each phase runs end
to end at 16 envs x 4 keywords so its control flow and checks stay
covered without a card. The full script on the card is the ``gpu``-marked
test at the bottom.
"""

import json
import os
import shutil
import subprocess
import sys

import jax
import pytest

from adcraft_tpu.agents.ppo import PPOConfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

E, K = 16, 4
SMALL_PPO = PPOConfig(rollout_days=3, num_minibatches=2, num_epochs=1)


@pytest.mark.unit
def test_phase_main_env():
    out = cs.phase_main_env(E, K, steps=3, rollout_days=4)
    assert out["days"] == 7
    assert out["step_memory_analysis"]["argument_size_in_bytes"] > 0


@pytest.mark.unit
@pytest.mark.parametrize("index", range(4))
def test_phase_other_config(index):
    name, cfg, table, mask = cs.other_configs(K)[index]
    out = cs.phase_other_config(name, cfg, table, mask, E)
    assert out["drifted"] == (name == "non_stationary_dense")


@pytest.mark.unit
def test_phase_ppo():
    out = cs.phase_ppo(E, K, steps=2, ppo_cfg=SMALL_PPO)
    assert len(out["losses"]) == 2


@pytest.mark.unit
def test_phase_sharded_env():
    out = cs.phase_sharded_env(jax.devices()[:4], E, K, steps=2)
    assert out["bit_identical"]


@pytest.mark.unit
def test_phase_sharded_ppo():
    out = cs.phase_sharded_ppo(jax.devices()[:4], E // 4, K, ppo_cfg=SMALL_PPO)
    assert out["devices"] == 4


@pytest.mark.unit
def test_check_days_catches_overspend():
    import jax.numpy as jnp

    from adcraft_tpu.env import VectorBiddingEnv
    from adcraft_tpu.quantiles import simple_experiment_table

    cfg = cs.bench_cfg(num_keywords=K, max_volume=96)
    venv = VectorBiddingEnv(cfg, E, table=simple_experiment_table(128, 0.8))
    state, _ = venv.reset(jax.random.PRNGKey(0))
    budget = jnp.full((E,), 1000.0)
    state, ts = venv.step(state, jnp.full((E, K), 1.0), budget)
    cs.check_days(ts, budget, 1, cfg)
    with pytest.raises(cs.CheckFailed, match="over budget"):
        cs.check_days(ts, 0.0 * budget, 1, cfg)
    with pytest.raises(cs.CheckFailed, match="days_passed"):
        cs.check_days(ts, budget, 2, cfg)


@pytest.fixture
def gpu_card():
    """Skip unless this machine has an NVIDIA card (asked of nvidia-smi:
    this process itself is held to the CPU by conftest)."""
    smi = shutil.which("nvidia-smi")
    if smi is None or subprocess.run([smi, "-L"], capture_output=True).returncode:
        pytest.skip("no NVIDIA GPU on this machine")


@pytest.mark.gpu
def test_chip_smoke_on_the_card(gpu_card):
    env = {k: v for k, v in os.environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    proc = subprocess.run(
        [sys.executable, os.path.join(REPO, "chip_smoke.py")],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=1200,
    )
    assert proc.returncode == 0, proc.stdout[-4000:] + proc.stderr[-4000:]
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert last["ok"] and last["device"]["platform"] == "gpu"
