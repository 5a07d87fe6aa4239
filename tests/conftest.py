"""Test configuration: run on a simulated 8-device CPU mesh.

The reference can only be verified on CUDA hardware (its streams variant
even hard-forces N_GPU=1, src/cudaConvFFTDataStreams.cu:271 — SURVEY.md §4
"multi-GPU is never tested"). Here the whole suite — including multi-device
sharding — runs on 8 virtual CPU devices
(--xla_force_host_platform_device_count). Run it with ``JAX_PLATFORMS=cpu``.

Tests that need the GPU carry the ``gpu`` marker and take the ``gpu``
fixture, which skips them where JAX finds no GPU; they run on the card
with ``python -m pytest tests/ -m gpu``.
"""

import os

os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "") + " --xla_force_host_platform_device_count=8"
)

import jax  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402

from cuda_fft_convolution_tpu.utils.compile_cache import (  # noqa: E402
    enable_compile_cache,
)

enable_compile_cache()


@pytest.fixture
def rng():
    return np.random.default_rng(1234)


@pytest.fixture
def gpu():
    """The first GPU device; skips the test where JAX finds none. Decided
    here, at run time, never while a test module is imported."""
    devices = jax.devices()
    if devices[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is {devices[0].platform}")
    return devices[0]
