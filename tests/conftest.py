"""Test configuration: the CPU backend with an 8-device virtual mesh.

Multi-device sharding is validated on CPU through
XLA_FLAGS=--xla_force_host_platform_device_count=8.  JAX_PLATFORMS
defaults to cpu here; tests marked `gpu` run on a card when the suite is
started with JAX_PLATFORMS=cuda (README, "Tests"), and skip otherwise.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax
import numpy as np
import pytest


@pytest.fixture()
def rng():
    return np.random.default_rng(1234)


@pytest.fixture()
def gpu():
    """The GPU device, or a skip: decided when the test runs, never at
    import, so every worker collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: compiled Triton kernels run only there")
    return jax.devices()[0]
