"""Smoke coverage for auxiliary modules: viz, multi_agent, timing, profiling.

The reference validates these only through notebooks; here they get
headless smoke tests so regressions surface in CI.
"""

import matplotlib

matplotlib.use("Agg")

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.env import VectorBiddingEnv
from adcraft_tpu.quantiles import (
    make_experiment_quantiles,
    load_experiment_quantiles,
    simple_experiment_table,
)


def _kwcfg(tmp_path):
    return {
        "outer_directory": str(tmp_path),
        "mean_volume": 16,
        "conversion_rate": 0.5,
        "make_quant_func": make_experiment_quantiles,
        "load_quant_func": load_experiment_quantiles,
    }


@pytest.mark.unit
def test_multi_flat_env_contract(tmp_path):
    from adcraft_tpu.multi_agent import basic_policy_mapping_fn, make_multi_flat

    env = make_multi_flat(
        2, {"keyword_config": _kwcfg(tmp_path), "num_keywords": 3, "max_days": 3}
    )
    obs, infos = env.reset(seed=11)
    assert set(obs) == {0, 1}
    acts = {i: env.action_space.sample() for i in obs}
    obs, rewards, terms, truncs, infos = env.step(acts)
    assert set(rewards) == {0, 1}
    assert "__all__" in terms and "__all__" in truncs
    # reference semantics: agent_id -> str(agent_id) (multi_agent/train.py:11-13)
    assert basic_policy_mapping_fn(1) == "1"


@pytest.mark.unit
def test_viz_functions_render_headless(key):
    import matplotlib.pyplot as plt

    from adcraft_tpu import viz
    from adcraft_tpu.keywords import sample_explicit_keywords

    rng = np.random.default_rng(0)
    profits = rng.normal(size=(7, 5))  # (T days, K keywords)
    bids = np.abs(rng.normal(size=(7, 5)))
    viz.show_keyword_profits(profits, bids)
    viz.show_cumulative_rewards(profits.sum(axis=1))
    viz.print_agg_metric(profits[:, 0])
    viz.akncp_ncp_heatmap(
        rng.uniform(size=(3, 4)), [1, 2, 4], np.linspace(0.1, 1, 4)
    )
    kw = sample_explicit_keywords(key, 3)
    viz.plot_explicit_kw_properties(kw, key=key, show=False)
    plt.close("all")


@pytest.mark.unit
def test_timing_episode_smoke():
    from adcraft_tpu.experiments.timing import time_episode

    out = time_episode(16.0, 0.5, num_envs=4, num_keywords=3, max_days=2)
    assert out["episodes"] == 4
    assert out["s_per_episode"] > 0
    assert np.isfinite(out["episodes_per_s"])


@pytest.mark.unit
def test_profiling_measure_steps(key):
    from adcraft_tpu.profiling import measure_steps_per_sec

    cfg = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48)
    venv = VectorBiddingEnv(cfg, 4, table=simple_experiment_table(16, 0.5))
    state, _ = venv.reset(key)
    bids = jnp.full((4, 3), 1.0)

    def step_fn(carry):
        new_state, ts = venv.step(carry, bids)
        return new_state, ts.reward

    res = measure_steps_per_sec(step_fn, state, num_steps=2, items_per_step=4)
    assert res["items_per_sec"] > 0


@pytest.mark.slow
def test_multi_train_end_to_end():
    """Two heterogeneous policies round-robin trained over independent env
    copies (reference multi_agent/train.py:63-96): both parameter sets must
    move, and the result must expose the reference's
    sampler_results/policy_reward_mean surface."""
    import jax

    from adcraft_tpu.agents.ppo import PPOConfig
    from adcraft_tpu.config import EnvConfig, KeywordKind
    from adcraft_tpu.multi_agent import make_multi_trainers, multi_train
    from adcraft_tpu.quantiles import simple_experiment_table

    cfg = EnvConfig(
        num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, max_days=6
    )
    small = dict(rollout_days=4, num_minibatches=2, num_epochs=1, hidden=(8, 8))
    trainers, states = make_multi_trainers(
        cfg,
        num_policies=2,
        num_envs=4,
        ppo_cfgs=[PPOConfig(lr=1e-3, **small), PPOConfig(lr=3e-4, **small)],
        table=simple_experiment_table(16, 0.5),
        seed=5,
    )
    before = [jax.tree.map(lambda x: x.copy(), s.params) for s in states]

    out = multi_train(trainers, states, epochs=2)

    rm = out["sampler_results"]["policy_reward_mean"]
    assert set(rm) == {"0", "1"}
    assert all(np.isfinite(v) for v in rm.values())
    for i, state in enumerate(out["states"]):
        assert int(state.step) == 2  # one step per epoch per policy
        moved = jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
            before[i],
            state.params,
        )
        assert max(jax.tree.leaves(moved)) > 0.0, f"policy {i} did not move"
    # the two policies trained independently: different hyper-params,
    # different seeds -> different parameters
    d01 = jax.tree.map(
        lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
        out["states"][0].params,
        out["states"][1].params,
    )
    assert max(jax.tree.leaves(d01)) > 0.0


@pytest.mark.slow
def test_multi_train_mixed_algorithms():
    """Mixed-family multi-policy training (reference multi_agent/train.py
    accepts an arbitrary per-policy algo config_list): a PPO + TD3 pair
    round-robin through multi_train and BOTH parameter sets move."""
    import jax

    from adcraft_tpu.agents.ppo import PPOConfig
    from adcraft_tpu.agents.td3 import TD3Config
    from adcraft_tpu.config import EnvConfig, KeywordKind
    from adcraft_tpu.multi_agent import make_multi_trainers, multi_train
    from adcraft_tpu.quantiles import simple_experiment_table

    cfg = EnvConfig(
        num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, max_days=6
    )
    trainers, states = make_multi_trainers(
        cfg,
        num_policies=2,
        num_envs=4,
        algo_cfgs=[
            PPOConfig(
                lr=1e-3, rollout_days=4, num_minibatches=2, num_epochs=1,
                hidden=(8, 8),
            ),
            TD3Config(
                buffer_size=256, batch_size=16, warmup_steps=4, hidden=(16, 16)
            ),
        ],
        table=simple_experiment_table(16, 0.5),
        seed=9,
    )
    ppo_before = jax.tree.map(lambda x: x.copy(), states[0].params)
    td3_before = jax.tree.map(lambda x: x.copy(), states[1].critic1)

    out = multi_train(trainers, states, epochs=3)

    rm = out["sampler_results"]["policy_reward_mean"]
    assert set(rm) == {"0", "1"}
    assert all(np.isfinite(v) for v in rm.values())
    ppo_moved = jax.tree.leaves(
        jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
            ppo_before,
            out["states"][0].params,
        )
    )
    td3_moved = jax.tree.leaves(
        jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
            td3_before,
            out["states"][1].critic1,
        )
    )
    assert max(ppo_moved) > 0.0, "PPO policy did not move"
    assert max(td3_moved) > 0.0, "TD3 critic did not move"


@pytest.mark.unit
def test_make_multi_trainers_algo_name_dispatch():
    """String specs build the right trainer families."""
    from adcraft_tpu.agents.a2c import A2CTrainer
    from adcraft_tpu.agents.ppo import PPOTrainer
    from adcraft_tpu.agents.td3 import TD3Trainer
    from adcraft_tpu.config import EnvConfig, KeywordKind
    from adcraft_tpu.multi_agent import make_multi_trainers
    from adcraft_tpu.quantiles import simple_experiment_table

    cfg = EnvConfig(
        num_keywords=2, kind=KeywordKind.IMPLICIT, max_volume=24, max_days=4
    )
    trainers, states = make_multi_trainers(
        cfg,
        num_policies=3,
        num_envs=2,
        algo_cfgs=["ppo", "a2c", "td3"],
        table=simple_experiment_table(8, 0.5),
    )
    assert isinstance(trainers[0], PPOTrainer)
    assert isinstance(trainers[1], A2CTrainer)
    assert isinstance(trainers[2], TD3Trainer)
    assert len(states) == 3


@pytest.mark.unit
def test_compile_cache_dir_honours_env_else_fixed_repo_path():
    import os

    from adcraft_tpu.profiling import compile_cache_dir

    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/cache/x"}) == "/cache/x"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    default = compile_cache_dir({})
    assert default == os.path.join(repo, ".jax_cache")
    # fixed: no temp name, PID or time in it
    assert compile_cache_dir({}) == default
    assert compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == default


@pytest.mark.unit
def test_require_gpu_refuses_the_cpu():
    from adcraft_tpu.profiling import require_gpu

    with pytest.raises(SystemExit, match="needs a GPU"):
        require_gpu()


@pytest.mark.unit
def test_env_and_ppo_import_without_optional_packages():
    """The env core and the PPO learner import with gymnasium, flax,
    pandas and orbax absent (the card's machine has none of them), and
    the Gymnasium adapter still loads on first access."""
    import os
    import subprocess
    import sys

    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = """
import importlib.abc, sys
OPTIONAL = ("gymnasium", "flax", "pandas", "orbax")
class Block(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in OPTIONAL:
            raise ImportError("blocked " + name)
sys.meta_path.insert(0, Block())
import adcraft_tpu, adcraft_tpu.env, adcraft_tpu.agents.ppo, adcraft_tpu.parallel
loaded = sorted(m for m in sys.modules if m.split(".")[0] in OPTIONAL)
assert not loaded, loaded
try:
    adcraft_tpu.BiddingSimulation
except ImportError as exc:
    assert "gymnasium" in str(exc), exc
else:
    raise AssertionError("adapter loaded with gymnasium blocked")
print("ok")
"""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env["PYTHONPATH"] = repo + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-c", code], env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr[-3000:]


@pytest.mark.unit
def test_gym_adapter_is_a_lazy_package_attribute():
    import adcraft_tpu
    from adcraft_tpu.gym_env import BiddingSimulation
    from adcraft_tpu.wrappers import FlatArrayWrapper

    assert adcraft_tpu.BiddingSimulation is BiddingSimulation
    assert adcraft_tpu.FlatArrayWrapper is FlatArrayWrapper
    with pytest.raises(AttributeError):
        adcraft_tpu.no_such_name
