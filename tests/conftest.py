"""Test configuration: force an 8-device virtual CPU platform.

Tests validate numerics and sharding on CPU (SURVEY.md §4 implication);
the GPU path is exercised by chip_smoke.py and bench.py on the card, and
tests marked ``gpu`` skip here. Must run before jax is imported anywhere.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()
os.environ["JAX_PLATFORMS"] = "cpu"

# jax may already be imported before this file runs; the config update
# below wins regardless, as backends initialize lazily.
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(0xA3F1)
