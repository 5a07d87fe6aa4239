"""Core numerics tests (ops/conv.py) against float64 oracles.

Implements SURVEY.md §4's strategy: the demo's visual residual checks become
asserted tolerances (BASELINE.json north star: max rel err ≤1e-5)."""

import numpy as np
import jax.numpy as jnp
import pytest

from cuda_fft_convolution_tpu.ops.conv import (
    direct_conv_single,
    fft_conv_single,
    fft_conv_stack,
)
from tests.oracles import fft_conv_full_f64, fft_map_f64, rel_err

TOL = 1e-5


def _cf(x):  # channels-last (H,W,F) → channel-leading (F,H,W)
    return jnp.transpose(jnp.asarray(x), (2, 0, 1))


def test_demo_config_vs_oracles(rng):
    """The reference demo's exact configuration: 64×8×5 data, 10×4×5 kernel,
    FFT 80×16 (demoCudaConvolutionFFT.m:37-42,78-79)."""
    data = rng.standard_normal((64, 8, 5)).astype(np.float32)
    kern = rng.standard_normal((10, 4, 5)).astype(np.float32)
    out = np.array(fft_conv_single(_cf(data), _cf(kern), 80, 16))
    assert out.shape == (80, 16)
    assert rel_err(out, fft_map_f64(data, kern, 80, 16)) < TOL
    full = out[:73, :11]
    assert rel_err(full, fft_conv_full_f64(data, kern)) < TOL


@pytest.mark.parametrize(
    "h,w,f,kh,kw",
    [
        (16, 16, 1, 3, 3),
        (17, 23, 2, 5, 1),  # odd, non-16-multiple shapes
        (8, 100, 3, 8, 31),
        (33, 9, 4, 33, 9),  # kernel as big as data
        (5, 5, 1, 1, 1),  # 1×1 kernel
    ],
)
def test_shapes_property(rng, h, w, f, kh, kw):
    data = rng.standard_normal((h, w, f)).astype(np.float32)
    kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
    out = np.array(fft_conv_single(_cf(data), _cf(kern)))
    full = out[: h + kh - 1, : w + kw - 1]
    assert rel_err(full, fft_conv_full_f64(data, kern)) < TOL


def test_direct_conv_oracle_agreement(rng):
    """direct_conv_single (the spatial path) agrees with the f64 oracle."""
    data = rng.standard_normal((20, 30, 3)).astype(np.float32)
    kern = rng.standard_normal((7, 5, 3)).astype(np.float32)
    got = np.array(direct_conv_single(_cf(data), _cf(kern)))
    assert rel_err(got, fft_conv_full_f64(data, kern)) < TOL


def test_stack_amortization_matches_singles(rng):
    """fft_conv_stack (one data FFT for the whole bank) ≡ per-kernel calls."""
    data = rng.standard_normal((32, 24, 2)).astype(np.float32)
    kerns = rng.standard_normal((4, 6, 5, 2)).astype(np.float32)
    stack = np.array(
        fft_conv_stack(_cf(data), jnp.transpose(jnp.asarray(kerns), (0, 3, 1, 2)))
    )
    for i in range(4):
        single = np.array(fft_conv_single(_cf(data), _cf(kerns[i])))
        np.testing.assert_allclose(stack[i], single, atol=1e-5)


def test_planted_peak(rng):
    """Planted-signal check (demoCudaConvolutionFFT.m:58-61): correlating
    with a planted template produces its maximum response at the plant site."""
    kern = rng.standard_normal((8, 8, 1)).astype(np.float32)
    data = np.zeros((64, 64, 1), np.float32)
    r0, c0 = 20, 30
    data[r0 : r0 + 8, c0 : c0 + 8] = kern
    # correlation = convolution with flipped kernel
    out = np.array(fft_conv_single(_cf(data), _cf(kern[::-1, ::-1])))
    full = out[:71, :71]
    peak = np.unravel_index(np.argmax(full), full.shape)
    # full-correlation peak sits at plant offset + (kh-1, kw-1)
    assert peak == (r0 + 7, c0 + 7)


def test_bf16_inputs_fp32_accumulation(rng):
    """BASELINE.json config 5: bf16 inputs upcast to fp32 spectral math."""
    data = rng.standard_normal((32, 32, 4)).astype(np.float32)
    kern = rng.standard_normal((9, 9, 4)).astype(np.float32)
    d16 = jnp.asarray(data).astype(jnp.bfloat16)
    k16 = jnp.asarray(kern).astype(jnp.bfloat16)
    out = fft_conv_single(jnp.transpose(d16, (2, 0, 1)), jnp.transpose(k16, (2, 0, 1)))
    assert out.dtype == jnp.float32
    # tolerance limited by the bf16 *input* quantization, not the math
    ref = fft_conv_full_f64(
        np.array(d16.astype(jnp.float32)), np.array(k16.astype(jnp.float32))
    )
    assert rel_err(np.array(out)[:40, :40], ref) < TOL


def test_channel_mismatch_raises(rng):
    data = rng.standard_normal((3, 16, 16)).astype(np.float32)
    kern = rng.standard_normal((2, 3, 3)).astype(np.float32)
    with pytest.raises(ValueError, match="channel mismatch"):
        fft_conv_single(jnp.asarray(data), jnp.asarray(kern))
