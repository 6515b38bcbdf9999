"""Policy / value networks.

Plain-JAX MLPs mirroring the reference's RLlib model configs: PPO uses
[32, 32] relu (agent_configs.py:64-67), A2C [256, 256] (:79-82), TD3
[400, 300] (:97-100). Observations are the flattened dict (sorted keys,
5K+2 floats — gymnasium_kw_utils.py:383-390).

Each network is a frozen description with ``init(key, x) -> params`` and
``apply(params, x)``; params are plain pytrees (lists and dicts of
arrays) that optax and the checkpointer take as they are. Dense layers
use lecun-normal kernels and zero biases.
"""

from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple

import jax
import jax.numpy as jnp

Array = jax.Array

_KERNEL_INIT = jax.nn.initializers.lecun_normal()


@dataclasses.dataclass(frozen=True)
class MLP:
    """Dense layers ``hidden + (out,)`` with ``activation`` between them.

    Params: one ``{"kernel": (in, out), "bias": (out,)}`` dict per layer.
    """

    hidden: Sequence[int]
    out: int
    activation: str = "relu"

    def init(self, key: Array, x: Array) -> List[dict]:
        sizes = (jnp.shape(x)[-1],) + tuple(self.hidden) + (self.out,)
        keys = jax.random.split(key, len(sizes) - 1)
        return [
            {
                "kernel": _KERNEL_INIT(k, (n_in, n_out), jnp.float32),
                "bias": jnp.zeros((n_out,), jnp.float32),
            }
            for k, n_in, n_out in zip(keys, sizes[:-1], sizes[1:])
        ]

    def apply(self, params: List[dict], x: Array) -> Array:
        act = getattr(jax.nn, self.activation)
        for layer in params[:-1]:
            x = act(x @ layer["kernel"] + layer["bias"])
        return x @ params[-1]["kernel"] + params[-1]["bias"]


@dataclasses.dataclass(frozen=True)
class GaussianPolicy:
    """Diagonal-Gaussian policy over the flat action vector.

    Outputs are squashed to the env's valid box: per-keyword bids in
    [min_bid, max_bid] and a budget in [min_budget, max_budget] via
    sigmoid scaling. (The reference trains RLlib policies directly on the
    unbounded Box and relies on env-side clamping; squashing keeps PPO's
    log-probs well-defined.) ``log_std`` is a state-independent learned
    vector, initialised to -0.5.
    """

    num_keywords: int
    hidden: Sequence[int] = (32, 32)
    min_bid: float = 0.01
    max_bid: float = 3.0
    min_budget: float = 100.0
    max_budget: float = 10000.0

    @property
    def _mlp(self) -> MLP:
        return MLP(self.hidden, self.num_keywords + 1)

    def init(self, key: Array, obs: Array) -> dict:
        return {
            "mlp": self._mlp.init(key, obs),
            "log_std": jnp.full((self.num_keywords + 1,), -0.5, jnp.float32),
        }

    def apply(self, params: dict, obs: Array) -> Tuple[Array, Array]:
        mean = self._mlp.apply(params["mlp"], obs)
        return mean, jnp.broadcast_to(params["log_std"], mean.shape)

    def squash(self, raw: Array) -> Tuple[Array, Array]:
        """Map a raw Gaussian sample to (bids (…,K), budget (…,))."""
        u = jax.nn.sigmoid(raw)
        bids = self.min_bid + (self.max_bid - self.min_bid) * u[..., :-1]
        budget = self.min_budget + (self.max_budget - self.min_budget) * u[..., -1]
        return bids, budget


@dataclasses.dataclass(frozen=True)
class ValueNet:
    hidden: Sequence[int] = (32, 32)

    def init(self, key: Array, obs: Array) -> List[dict]:
        return MLP(self.hidden, 1).init(key, obs)

    def apply(self, params: List[dict], obs: Array) -> Array:
        return MLP(self.hidden, 1).apply(params, obs)[..., 0]


def flatten_obs(obs: dict) -> Array:
    """Flatten an obs dict (sorted keys) along the last axis — the batched
    jnp analogue of ``flatten_dict_array`` (gymnasium_kw_utils.py:383-390)."""
    parts = [jnp.asarray(obs[k], jnp.float32) for k in sorted(obs.keys())]
    return jnp.concatenate(parts, axis=-1)
