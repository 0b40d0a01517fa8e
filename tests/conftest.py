"""Test configuration: run JAX on a virtual 8-device CPU mesh.

Mirrors the survey's test plan (SURVEY.md §4): multi-device behavior is
validated on host CPU devices via ``--xla_force_host_platform_device_count``.
Tests marked ``gpu`` need a card: they take the `gpu_device` fixture, which
skips them unless JAX_PLATFORMS names a GPU platform and one is found
(``JAX_PLATFORMS=cuda,cpu python -m pytest tests -m gpu``).
"""
import os

flags = os.environ.get("XLA_FLAGS", "")
if "host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", os.environ.get("JAX_PLATFORMS") or "cpu")
jax.config.update("jax_enable_x64", False)

import pytest  # noqa: E402


REFERENCE_DATASETS = "/root/reference/datasets/2D"


@pytest.fixture(scope="session")
def datasets_dir():
    return REFERENCE_DATASETS


@pytest.fixture
def gpu_device():
    """The first GPU; skips the test where JAX finds none."""
    if jax.default_backend() != "gpu":
        pytest.skip(f"needs a GPU; JAX backend is {jax.default_backend()!r}")
    return jax.devices()[0]
