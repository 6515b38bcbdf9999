"""A2C / TD3 smoke tests (reference agent families, agent_configs.py)."""

import jax
import numpy as np
import pytest

from adcraft_tpu.agents.a2c import A2CConfig, A2CTrainer
from adcraft_tpu.agents.td3 import TD3Config, TD3Trainer
from adcraft_tpu.config import EnvConfig, KeywordKind
from adcraft_tpu.quantiles import simple_experiment_table


CFG = EnvConfig(num_keywords=3, kind=KeywordKind.IMPLICIT, max_volume=48, max_days=6)


@pytest.mark.unit
def test_a2c_train_step(key):
    trainer = A2CTrainer(
        CFG,
        num_envs=4,
        a2c_cfg=A2CConfig(rollout_days=3, hidden=(16, 16)),
        table=simple_experiment_table(16, 0.5),
    )
    state = trainer.init(key)
    p0 = jax.tree.map(np.asarray, state.params)
    state, metrics = trainer.train(state, 2)
    assert np.isfinite(metrics["loss"])
    changed = jax.tree.leaves(
        jax.tree.map(lambda a, b: float(np.abs(np.asarray(a) - b).max()), state.params, p0)
    )
    assert max(changed) > 0


@pytest.mark.unit
def test_td3_train_step(key):
    trainer = TD3Trainer(
        CFG,
        num_envs=4,
        cfg=TD3Config(
            buffer_size=256, batch_size=32, warmup_steps=8, hidden=(16, 16)
        ),
        table=simple_experiment_table(16, 0.5),
    )
    state = trainer.init(key)
    c0 = jax.tree.map(np.asarray, state.critic1)
    state, metrics = trainer.train(state, 3)
    assert np.isfinite(metrics["critic_loss"])
    assert metrics["buffer_size"] == 12.0
    changed = jax.tree.leaves(
        jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - b).max()), state.critic1, c0
        )
    )
    assert max(changed) > 0
    # targets move slowly (polyak)
    tdiff = jax.tree.leaves(
        jax.tree.map(
            lambda a, b: float(np.abs(np.asarray(a) - np.asarray(b)).max()),
            state.target_critic1,
            state.critic1,
        )
    )
    assert max(tdiff) > 0


@pytest.mark.unit
def test_mlp_shapes_and_apply_match_matmul_chain(key):
    from adcraft_tpu.agents.networks import MLP

    mlp = MLP((32, 16), 5)
    x = jax.random.normal(jax.random.PRNGKey(1), (3, 7))
    params = mlp.init(key, x[0])
    shapes = [(p["kernel"].shape, p["bias"].shape) for p in params]
    assert shapes == [((7, 32), (32,)), ((32, 16), (16,)), ((16, 5), (5,))]
    for p in params:
        assert not np.any(np.asarray(p["bias"]))
    h = np.asarray(x, np.float64)
    for i, p in enumerate(params):
        h = h @ np.asarray(p["kernel"], np.float64) + np.asarray(p["bias"])
        if i < len(params) - 1:
            h = np.maximum(h, 0.0)
    np.testing.assert_allclose(np.asarray(mlp.apply(params, x)), h, rtol=1e-5, atol=1e-5)


@pytest.mark.unit
def test_lecun_normal_init_scale(key):
    from adcraft_tpu.agents.networks import MLP

    params = MLP((), 256).init(key, np.zeros(400, np.float32))
    std = float(np.asarray(params[0]["kernel"]).std())
    # lecun normal: variance 1 / fan_in
    assert abs(std - (1 / 400) ** 0.5) < 0.1 * (1 / 400) ** 0.5


@pytest.mark.unit
def test_policy_value_and_td3_networks(key):
    from adcraft_tpu.agents.networks import GaussianPolicy, ValueNet
    from adcraft_tpu.agents.td3 import Actor, Critic

    obs = np.ones((4, 17), np.float32)
    pol = GaussianPolicy(3, hidden=(8, 8))
    pp = pol.init(key, obs[0])
    mean, log_std = pol.apply(pp, obs)
    assert mean.shape == log_std.shape == (4, 4)
    np.testing.assert_array_equal(np.asarray(log_std), -0.5)
    bids, budget = pol.squash(mean)
    assert bids.shape == (4, 3) and budget.shape == (4,)
    vn = ValueNet((8,))
    assert vn.apply(vn.init(key, obs[0]), obs).shape == (4,)
    actor, critic = Actor(4, (8, 8)), Critic((8, 8))
    a = actor.apply(actor.init(key, obs[0]), obs)
    assert a.shape == (4, 4) and float(np.abs(np.asarray(a)).max()) <= 1.0
    q = critic.apply(critic.init(key, obs[0], a[0]), obs, a)
    assert q.shape == (4,)
