"""FFT-size policy tests (utils/fft_size.py ≈ src/cudaConvFFTData.h:67-102)."""

import pytest

from cuda_fft_convolution_tpu.utils.fft_size import (
    FftSizePolicy,
    align_up,
    ceil_div,
    compute_fft_size,
    next_fast_len,
    next_multiple_of_16,
    next_pow2,
)


def test_grid_math():
    # iDivUp / iAlignUp parity (src/cudaConvFFTData.h:36-45)
    assert ceil_div(10, 3) == 4
    assert ceil_div(9, 3) == 3
    assert align_up(10, 16) == 16
    assert align_up(16, 16) == 16
    assert align_up(17, 16) == 32


def test_multiple16_matches_demo():
    # The demo's 64+10-1=73 → 80 and 8+4-1=11 → 16 (demoCudaConvolutionFFT.m:78-79)
    assert next_multiple_of_16(73) == 80
    assert next_multiple_of_16(11) == 16
    assert next_multiple_of_16(16) == 16
    assert compute_fft_size(64, 8, 10, 4, FftSizePolicy.MULTIPLE16) == (80, 16)


def test_pow2_policy():
    # computeFFTsize aligns to 16 first, then next pow2 (src/cudaConvFFTData.h:67-94)
    assert next_pow2(73) == 128  # 73→80→128
    assert next_pow2(16) == 16
    assert next_pow2(17) == 32
    assert next_pow2(100) == 128


@pytest.mark.parametrize("n", [1, 2, 7, 73, 100, 1000, 2111, 4097])
def test_next_fast_len_is_smooth_and_minimal(n):
    m = next_fast_len(n)
    assert m >= n
    x = m
    for p in (2, 3, 5):
        while x % p == 0:
            x //= p
    assert x == 1, f"{m} is not 5-smooth"
    # minimality: nothing 5-smooth in [n, m)
    for c in range(n, m):
        y = c
        for p in (2, 3, 5):
            while y % p == 0:
                y //= p
        assert y != 1


def test_policies_cover_linear_conv():
    for policy in FftSizePolicy:
        fh, fw = compute_fft_size(100, 37, 13, 5, policy)
        assert fh >= 112 and fw >= 41
