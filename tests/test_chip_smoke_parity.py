"""chip_smoke.py's parity phases at tiny sizes on the CPU: the device
parity path against the numpy oracle, the fast samplers against the
parity samplers, and the pool cost moments against a float64 quadrature.
"""

import os
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if REPO not in sys.path:
    sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

K, MAX_VOLUME = 4, 96


@pytest.mark.unit
@pytest.mark.parametrize("model", cs.MODELS)
def test_phase_oracle_parity(model):
    out = cs.phase_oracle_parity(model, 4, K, MAX_VOLUME)
    # the binding budget is half the unbound spend, so it binds
    assert out["binding_mean_spend"] < out["unbound_mean_spend"]


@pytest.mark.unit
@pytest.mark.parametrize("model", cs.MODELS)
def test_phase_fast_vs_parity(model):
    out = cs.phase_fast_vs_parity(model, 512, K, MAX_VOLUME)
    assert out["mean_spend"]["fast"] <= out["binding_budget"] + cs.SPEND_SLACK


@pytest.mark.unit
def test_phase_pool_moments():
    out = cs.phase_pool_moments(512)
    assert out["mean_rel_err"] <= cs.POOL_MOMENT_RTOL


@pytest.mark.unit
def test_pool_moments_reference_matches_monte_carlo():
    """The float64 quadrature the device moments are held to is itself
    right: the max of k Laplace bids below ours, by sampling."""
    rng = np.random.default_rng(0)
    bid, loc, scale = 0.4, 0.1, 0.2
    for k in (1, 2, 5, 30):
        x = rng.laplace(loc, scale, (400_000, k)).max(1)
        x = x[x < bid]
        if k < 3:
            x = np.maximum(x, 0.0)
        m1, m2 = cs.pool_moments_reference(bid, loc, scale, k)
        np.testing.assert_allclose(m1, x.mean(), rtol=0.01, atol=1e-3)
        np.testing.assert_allclose(m2, (x * x).mean(), rtol=0.02, atol=1e-3)
