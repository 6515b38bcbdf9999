"""One process of the 2-process jax.distributed test (test_multiprocess.py).

Not a pytest module — spawned as ``python tests/mp_worker.py <pid> <nproc>
<port> <outprefix>`` with JAX_PLATFORMS=cpu and 4 forced host devices, so
two processes form an 8-device global mesh (the CPU stand-in for a
2-host job, SURVEY.md §2b).

Exercises the full multi-host surface of ``adcraft_tpu.parallel.mesh``:
``initialize_multihost`` (the jax.distributed entry), ``make_env_mesh``
over the GLOBAL device list, ``sharded_vector_env`` stepping with
process-spanning shardings, and ``psum_metrics`` inside ``shard_map``.
Writes per-process results for bit-identity checks against the
single-process run (the reference analogue is RLlib's multi-worker
rollouts, /root/reference/adcraft/experiment_utils/agent_configs.py:85).
"""

import sys

import jax

jax.config.update("jax_cpu_collectives_implementation", "gloo")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import NamedSharding, PartitionSpec as P  # noqa: E402

from adcraft_tpu.config import EnvConfig, KeywordKind  # noqa: E402
from adcraft_tpu.parallel.mesh import (  # noqa: E402
    ENV_AXIS,
    initialize_multihost,
    make_env_mesh,
    psum_metrics,
    sharded_vector_env,
)
from adcraft_tpu.quantiles import simple_experiment_table  # noqa: E402

try:
    from jax import shard_map  # jax >= 0.6 style
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map


def replicated_np(mesh, x):
    """Fetch a process-spanning array by replicating it onto every shard."""
    rep = jax.jit(lambda a: a, out_shardings=NamedSharding(mesh, P()))(x)
    return np.asarray(rep.addressable_data(0))


def main() -> None:
    pid, nproc, port, out = (
        int(sys.argv[1]),
        int(sys.argv[2]),
        sys.argv[3],
        sys.argv[4],
    )
    initialize_multihost(f"localhost:{port}", nproc, pid)
    assert jax.process_count() == nproc
    assert jax.local_device_count() == 4
    assert jax.device_count() == 4 * nproc

    cfg = EnvConfig(
        num_keywords=5, kind=KeywordKind.IMPLICIT, max_volume=96, max_days=10
    )
    table = simple_experiment_table(32, 0.5)
    n_envs = 16
    mesh = make_env_mesh()  # global: spans both processes
    venv = sharded_vector_env(cfg, n_envs, mesh=mesh, table=table)

    state, _ = venv.reset(jax.random.PRNGKey(0))
    # the state must actually live across the pod: 8 global shards, of
    # which this process can address its own 4 (2 envs each)
    leaf = state.kw.vol_mean
    assert len(leaf.sharding.device_set) == 8
    local = {s.data.shape for s in leaf.addressable_shards}
    assert local == {(2, cfg.num_keywords)}, local
    assert len(leaf.addressable_shards) == 4

    bids = jnp.full((n_envs, cfg.num_keywords), 1.0, jnp.float32)
    rewards = []
    for _ in range(3):
        state, ts = venv.step(state, bids)
        rewards.append(replicated_np(mesh, ts.reward))

    # DCN-side metric reduction: psum_metrics inside shard_map
    @jax.jit
    def global_metrics(r):
        def local_fn(r_shard):
            return psum_metrics(
                {"reward_sum": jnp.sum(r_shard), "envs": jnp.float32(r_shard.size)}
            )

        return shard_map(
            local_fn, mesh=mesh, in_specs=P(ENV_AXIS), out_specs=P()
        )(r)

    m = global_metrics(ts.reward)
    reward_sum = float(np.asarray(m["reward_sum"].addressable_data(0)))
    n_seen = float(np.asarray(m["envs"].addressable_data(0)))
    assert n_seen == n_envs, n_seen

    np.savez(
        f"{out}_{pid}.npz",
        rewards=np.stack(rewards),
        psum_reward=np.float32(reward_sum),
    )
    print(f"mp_worker pid={pid} OK")


if __name__ == "__main__":
    main()
