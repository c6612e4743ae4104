"""Test config: an 8-device virtual CPU mesh, set before JAX backends init.

Backends resolve lazily, so jax.config.update here wins even when JAX was
imported earlier. Unless JAX_PLATFORMS names the platforms, the suite is
hermetic: all tests (including multi-chip sharding tests) run on a
virtual 8-device CPU mesh. Tests that need the card carry the `gpu`
marker and skip without one (the `gpu_device` fixture); on the card they
run with `python -m pytest -m gpu tests/` and JAX's GPU platform.
"""
import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax

if not os.environ.get("JAX_PLATFORMS"):
    jax.config.update("jax_platforms", "cpu")


import pytest


@pytest.fixture
def gpu_device():
    """The first GPU device; skips the test where JAX has none. Decided at
    run time, never at import, so every worker collects the same tests."""
    try:
        gpus = jax.devices("gpu")
    except RuntimeError:
        gpus = []
    if not gpus:
        pytest.skip("needs a GPU: run on the card with `python -m pytest -m gpu tests/`")
    return gpus[0]
