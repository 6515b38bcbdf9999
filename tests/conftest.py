"""Test configuration: run on a virtual 8-device CPU mesh.

Multi-device behaviour is validated without accelerators by forcing the
host platform and splitting it into 8 virtual devices (the stand-in for
multi-host recommended in SURVEY.md §4).
"""

import os

# Force CPU: unit tests never depend on an accelerator being present.
os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402  (import after env vars)

import pytest  # noqa: E402


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)
