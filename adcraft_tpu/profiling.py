"""Profiling and throughput measurement helpers.

The reference's only performance tooling is ad-hoc ``%timeit`` cells
(SURVEY.md §5). Here: a throughput harness that waits for the device
with ``jax.block_until_ready``, a jax.profiler trace wrapper, and the
one place that decides where the persistent compilation cache lives.
"""

from __future__ import annotations

import contextlib
import os
import subprocess
import time
from typing import Callable, Dict, Mapping, Optional

import jax

_REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def compile_cache_dir(environ: Mapping[str, str] = os.environ) -> str:
    """Where the persistent compilation cache lives.

    ``JAX_COMPILATION_CACHE_DIR`` when it is set (JAX reads it itself);
    otherwise the fixed ``<repo>/.jax_cache`` (listed in .gitignore). The
    path is part of the cache key, so it never depends on a temp name,
    a PID or the time.
    """
    return environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _REPO_ROOT, ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at ``compile_cache_dir()``.

    Sets nothing when ``JAX_COMPILATION_CACHE_DIR`` is in the environment.
    Call before the first compile. Returns the directory in use.
    """
    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path


def require_gpu() -> None:
    """Exit non-zero unless JAX's default device is a GPU.

    Measurement entry points call this first: a number taken on the CPU
    must never be reported as a device number.
    """
    platform = jax.devices()[0].platform
    if platform != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default device is {platform!r}")


def nvidia_smi_name_power() -> str:
    """The card's name and power limit, as
    ``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader``
    prints them (one line per card)."""
    out = subprocess.run(
        [
            "nvidia-smi",
            "--query-gpu=name,power.limit",
            "--format=csv,noheader",
        ],
        capture_output=True,
        text=True,
        check=True,
        timeout=60,
    )
    return out.stdout.strip()


def device_info() -> Dict[str, object]:
    """What a measurement ran on: JAX's platform, device_kind and device
    count, plus the nvidia-smi name and power limit of each card."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "count": jax.device_count(),
        "nvidia_smi": nvidia_smi_name_power().splitlines(),
    }


def measure_steps_per_sec(
    step_fn: Callable,
    init_carry,
    num_steps: int = 10,
    warmup: int = 1,
    items_per_step: int = 1,
) -> Dict[str, float]:
    """Time ``carry, out = step_fn(carry)`` loops, waiting for the device.

    Returns steps/s, items/s (e.g. env-steps/s for a batch env), and
    ms/step.
    """
    carry = init_carry
    out = None
    for _ in range(warmup):
        carry, out = step_fn(carry)
    jax.block_until_ready((carry, out))
    t0 = time.perf_counter()
    for _ in range(num_steps):
        carry, out = step_fn(carry)
    jax.block_until_ready((carry, out))
    dt = time.perf_counter() - t0
    return {
        "ms_per_step": 1e3 * dt / num_steps,
        "steps_per_sec": num_steps / dt,
        "items_per_sec": num_steps * items_per_step / dt,
    }


@contextlib.contextmanager
def trace(logdir: str):
    """jax.profiler trace context (view with tensorboard/xprof)."""
    with jax.profiler.trace(logdir):
        yield


def prng_words_per_env_day(cfg, num_keywords: Optional[int] = None):
    """32-bit threefry words one env consumes per simulated day.

    This count divided by the measured threefry word rate bounds the
    throughput of a config whose step is random-bits-bound. Well-defined
    only for the reduced-draw samplers (``binomial_sampler="inversion"``) —
    ``jax.random.binomial``'s rejection path consumes a data-dependent
    number of words — and for non-pool competitor models; returns None
    otherwise.
    """
    from adcraft_tpu.config import CompetitorModel, KeywordKind

    if cfg.binomial_sampler != "inversion":
        return None
    if (
        cfg.kind is KeywordKind.IMPLICIT
        and cfg.competitor_model is CompetitorModel.BINOMIAL_POOL
    ):
        return None  # bidder-count draw stays on the rejection sampler
    k = cfg.num_keywords if num_keywords is None else num_keywords
    t = cfg.timesteps_per_day
    half = 0.5 if cfg.lane_bits == 16 else 1.0
    lanes = (cfg.max_clicks_per_cell + (t - 1) * cfg.max_clicks_rest) * k
    words = float(k)  # daily volume normals (1 word per f32 normal)
    # cost draws: per-lane tables, or one aggregate normal per cell
    # (cost_sampling="agg"; budget-partial lane resolutions are rare and
    # data-dependent, so they are excluded from this static count).
    # The implicit-single lane sampler honors lane_bits; the explicit
    # cost models always draw full-word normals.
    if cfg.cost_sampling == "agg":
        words += t * k  # aggregate spend normals
        # per-cell lite lane costs (the gate's bulk-resolution table)
        lite = min(cfg.agg_lite_lanes, cfg.max_clicks_rest)
        words += t * k * lite * half
    else:
        cost_half = half if cfg.kind is KeywordKind.IMPLICIT else 1.0
        words += lanes * cost_half
    # conversion draws: per-lane flags or one inversion binomial per cell
    words += lanes if cfg.conv_sampling == "lanes" else t * k * half
    # revenue draws: per-lane normals, one aggregate normal per cell
    # ("sum"), or one per keyword per day ("day")
    if cfg.rev_sampling == "lanes":
        words += lanes
    elif cfg.rev_sampling == "sum":
        words += t * k
    else:  # "day"
        words += k
    # impressions + clicks inversion binomials (one uniform each)
    words += 2 * t * k * half
    return words


def measure_threefry_words_per_sec(
    num_words: int = 1 << 25, iters: int = 32, repeats: int = 3
) -> Dict[str, float]:
    """Measured threefry uniform generation rate (words/s) on this backend.

    Each f32 ``jax.random.uniform`` consumes one 32-bit threefry word. The
    ``iters`` generations run inside ONE jit program (lax.fori_loop), so
    the rate excludes per-dispatch overhead. The measurement runs
    ``repeats`` times and reports the median plus the spread:
    ``{"median": w/s, "min": ..., "max": ..., "spread": max/min}``.
    """
    import jax.numpy as jnp
    from jax import lax

    @jax.jit
    def gen(key):
        def body(i, acc):
            # full jnp.sum so XLA cannot dead-code-eliminate any lane
            u = jax.random.uniform(jax.random.fold_in(key, i), (num_words,))
            return acc + jnp.sum(u)

        return lax.fori_loop(0, iters, body, jnp.float32(0.0))

    key = jax.random.PRNGKey(0)
    jax.block_until_ready(gen(key))  # compile + warm
    rates = []
    for r in range(max(repeats, 1)):
        t0 = time.perf_counter()
        acc = jax.block_until_ready(gen(jax.random.fold_in(key, 1 + r)))
        dt = time.perf_counter() - t0
        assert acc == acc  # not nan
        rates.append(num_words * iters / dt)
    rates.sort()
    med = rates[len(rates) // 2]
    return {
        "median": med,
        "min": rates[0],
        "max": rates[-1],
        "spread": rates[-1] / max(rates[0], 1.0),
    }
