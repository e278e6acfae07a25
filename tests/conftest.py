"""Test configuration: run everything on a virtual 8-device CPU mesh.

The suite runs on the CPU backend, where the Pallas kernels run in interpret
mode, and sharding correctness is validated on host-platform virtual
devices.  Tests marked ``gpu`` need the card and skip here; on a machine
with one, ``GTA_TEST_GPU=1 python -m pytest tests -m gpu`` keeps JAX on the
GPU for them (chip_smoke.py runs them in its own process).
"""
import os

if not os.environ.get("GTA_TEST_GPU"):
    os.environ["JAX_PLATFORMS"] = "cpu"
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()

import jax  # noqa: E402

if not os.environ.get("GTA_TEST_GPU"):
    # a jax imported before this file keeps its platform choice: override
    # through the config as well
    jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402
import pytest  # noqa: E402


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def small_graph(rng, n=50, e=200, multi_edges=False):
    """A small random graph fixture (deduped unless multi_edges)."""
    senders = rng.integers(0, n, size=e).astype(np.int32)
    receivers = rng.integers(0, n, size=e).astype(np.int32)
    keep = senders != receivers
    senders, receivers = senders[keep], receivers[keep]
    if not multi_edges:
        pairs = np.unique(np.stack([senders, receivers], 1), axis=0)
        senders, receivers = pairs[:, 0], pairs[:, 1]
    return senders, receivers
