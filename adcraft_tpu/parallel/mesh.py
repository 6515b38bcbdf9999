"""Mesh construction and env-batch sharding.

The replacement for the reference's process-level Ray actor
parallelism (SURVEY.md §2b: ``num_rollout_workers x num_envs_per_worker``
RLlib actors + object-store RPC, agent_configs.py:60,85,107). Here the env
batch is an array axis:

* a 1-D ``('envs',)`` mesh spans all devices (the GPUs of a host, which
  NVLink joins all to all, so the mesh needs no shape beyond the env
  axis; across hosts when ``jax.distributed`` is initialized);
* every leaf of the batched ``EnvState`` pytree is sharded on its leading
  axis; the fused step runs under jit with these shardings and XLA keeps
  each env's work resident on its shard — zero communication during
  stepping;
* metric reductions (mean reward, AKNCP inputs) and learner gradients are
  the only collectives (``psum``/``pmean``), which XLA hands to NCCL.

Per-env PRNG keys are split from a root seed before sharding, so results
are placement-independent: the same seed gives the same trajectories on 1
device or 4.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from adcraft_tpu.config import EnvConfig
from adcraft_tpu.env import EnvState, batch_keys, env_reset, env_step
from adcraft_tpu.quantiles import QuantileTable

Array = jax.Array

ENV_AXIS = "envs"


def make_env_mesh(devices=None) -> Mesh:
    """1-D mesh over all (or given) devices with a single 'envs' axis."""
    if devices is None:
        devices = jax.devices()
    return Mesh(np.asarray(devices), (ENV_AXIS,))


def env_sharding(mesh: Mesh) -> NamedSharding:
    """Sharding for batched env-state leaves: leading axis over 'envs'."""
    return NamedSharding(mesh, P(ENV_AXIS))


def shard_env_batch(mesh: Mesh, state: EnvState) -> EnvState:
    """Place every leaf of a batched EnvState on the mesh's env axis."""
    sh = env_sharding(mesh)
    return jax.tree.map(lambda x: jax.device_put(x, sh), state)


def psum_metrics(tree, axis_name: str = ENV_AXIS):
    """Cross-shard sum of a metrics pytree (use inside shard_map/pmap)."""
    return jax.tree.map(lambda x: jax.lax.psum(x, axis_name), tree)


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Initialize jax.distributed for multi-host pods.

    Call once per host before building meshes; afterwards
    ``jax.devices()`` spans every host's devices and ``make_env_mesh``
    shards envs globally. Without a cluster manager to detect them, pass
    all three arguments (coordinator ``host:port``, process count, this
    process's id).
    """
    kwargs = {}
    if coordinator_address is not None:
        kwargs["coordinator_address"] = coordinator_address
    if num_processes is not None:
        kwargs["num_processes"] = num_processes
    if process_id is not None:
        kwargs["process_id"] = process_id
    jax.distributed.initialize(**kwargs)


class sharded_vector_env:
    """Batched env whose state is sharded over a device mesh.

    Like ``VectorBiddingEnv`` but every array carries an explicit
    NamedSharding; jit compiles the vmapped step once with the sharding
    baked in. ``num_envs`` must divide evenly over the mesh.
    """

    def __init__(
        self,
        cfg: EnvConfig,
        num_envs: int,
        mesh: Optional[Mesh] = None,
        table: Optional[QuantileTable] = None,
        no_vol_prob: float = 0.0,
    ):
        self.cfg = cfg
        self.num_envs = num_envs
        self.mesh = mesh if mesh is not None else make_env_mesh()
        n_dev = self.mesh.devices.size
        if num_envs % n_dev != 0:
            raise ValueError(f"num_envs={num_envs} must divide over {n_dev} devices")
        self._sh = env_sharding(self.mesh)

        def _reset_batch(keys):
            return jax.vmap(
                lambda k: env_reset(cfg, k, table=table, no_vol_prob=no_vol_prob)
            )(keys)

        def _step_batch(state, bids, budget):
            return jax.vmap(lambda s, b, bud: env_step(cfg, s, b, bud))(
                state, bids, budget
            )

        def _step_batch_nobudget(state, bids):
            return jax.vmap(lambda s, b: env_step(cfg, s, b, None))(state, bids)

        self._reset = jax.jit(_reset_batch, out_shardings=(self._sh, self._sh))
        self._step = jax.jit(
            _step_batch, in_shardings=(self._sh, self._sh, self._sh),
            out_shardings=(self._sh, self._sh),
        )
        self._step_nobudget = jax.jit(
            _step_batch_nobudget,
            in_shardings=(self._sh, self._sh),
            out_shardings=(self._sh, self._sh),
        )

    def reset(self, key: Array):
        keys = batch_keys(key, self.num_envs, self.cfg.prng_impl)
        keys = jax.device_put(keys, self._sh)
        return self._reset(keys)

    def step(self, state: EnvState, bids: Array, budget: Optional[Array] = None):
        bids = jax.device_put(jnp.asarray(bids), self._sh)
        if budget is None:
            return self._step_nobudget(state, bids)
        budget = jax.device_put(jnp.asarray(budget), self._sh)
        return self._step(state, bids, budget)
