"""Test configuration.

Tests run on the CPU with 8 virtual XLA devices, so multi-device sharding
paths are exercised without accelerators — the analog of the reference's
loopback-before-accelerator bring-up strategy (NTT_PCIEComunicationv3.c/v4.c).
The environment is set before jax is first imported.

Tests that need a GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them unless JAX's default backend is a GPU.  On a
machine with a card run them with::

    JAX_PLATFORMS=cuda python -m pytest tests/ -m gpu -q
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8").strip()

import pathlib

import numpy as np
import pytest

REFERENCE = pathlib.Path("/root/reference/Multiplier_NTT_Based")


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a GPU (JAX_PLATFORMS=cuda pytest -m gpu)")


@pytest.fixture
def gpu():
    """Skips the test unless JAX's default backend is a GPU."""
    import jax
    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: JAX_PLATFORMS=cuda pytest -m gpu")


@pytest.fixture(scope="session")
def reference_dir():
    if not REFERENCE.is_dir():
        pytest.skip("reference repo not mounted")
    return REFERENCE


def read_hex_vectors(path) -> np.ndarray:
    """Read one-hex-value-per-line vector files ($readmemh format)."""
    vals = []
    for line in open(path):
        line = line.split("//")[0].strip()
        if line:
            vals.append(int(line, 16))
    return np.array(vals, dtype=np.int64)


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(0xC0FFEE)
