"""Test configuration: CPU backend with 8 virtual devices, float64 enabled.

Multi-host logic is tested on a single host exactly as SURVEY.md section 4
prescribes: XLA_FLAGS=--xla_force_host_platform_device_count=8 plus shard_map.
Must run before the first jax import.  JAX_PLATFORMS defaults to cpu; the
card-only tests (marker ``gpu``) run on the card with JAX_PLATFORMS=cuda.
"""

import os

os.environ.setdefault("JAX_PLATFORMS", "cpu")
_flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (_flags + " --xla_force_host_platform_device_count=8").strip()

import jax

jax.config.update("jax_enable_x64", True)

import pathlib

import pytest

REFERENCE = pathlib.Path("/root/reference")


@pytest.fixture(scope="session")
def reference_dir() -> pathlib.Path:
    return REFERENCE


@pytest.fixture
def gpu_device():
    """The card, for tests marked ``gpu``: skips where JAX finds no GPU.
    chip_smoke.py runs these tests on the card first."""
    devs = [d for d in jax.devices() if d.platform == "gpu"]
    if not devs:
        pytest.skip(
            "needs a GPU: JAX_PLATFORMS=cuda python -m pytest -m gpu tests/"
        )
    return devs[0]


def pytest_collection_modifyitems(config, items):
    if not REFERENCE.exists():
        skip = pytest.mark.skip(reason="reference artifacts not mounted")
        for item in items:
            if "parity" in item.keywords:
                item.add_marker(skip)
