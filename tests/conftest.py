"""Test configuration: force an 8-virtual-device CPU platform with x64.

Multi-host/multi-chip logic is tested without a cluster by running the
same shard_map code on 8 virtual CPU devices (SURVEY.md §4d); x64 gives
the 1e-10-grade oracles the baseline demands.  The XLA_FLAGS mutation
must happen before jax initializes its backends, hence at import time.
"""

import os

_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()
os.environ["JAX_PLATFORMS"] = "cpu"

import jax

jax.config.update("jax_enable_x64", True)

CPU_DEVICES = jax.devices("cpu")
jax.config.update("jax_default_device", CPU_DEVICES[0])

import numpy as np
import pytest


@pytest.fixture
def rng():
    return np.random.default_rng(42)


@pytest.fixture
def key():
    return jax.random.PRNGKey(0)


@pytest.fixture
def cpu_devices():
    return CPU_DEVICES
