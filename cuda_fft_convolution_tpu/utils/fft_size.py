"""FFT-size policies.

The reference picks FFT dims as ``round_up_to_16(data + max_kernel - 1)``
(src/cudaConvFFTData.h:96 ``computeFFTsize16``; call site
src/cudaConvolutionFFT.cu:109-110) with a legacy pow-2 policy
(``computeFFTsize`` :67, commented out at call sites). Here the policy is
pluggable (SURVEY.md §7 hard-part (d)): XLA's FFT (cuFFT on the GPU) is
fastest for sizes whose factors are small primes.

When the native C++ planner extension is built (runtime/planner.cpp), its
implementations are used; this module is the always-available pure-Python
fallback and the definition of record for semantics.
"""

from __future__ import annotations

import enum
import functools


def ceil_div(a: int, b: int) -> int:
    """Ceiling division (reference ``iDivUp``, src/cudaConvFFTData.h:36)."""
    return -(-a // b)


def align_up(a: int, b: int) -> int:
    """Round ``a`` up to a multiple of ``b`` (reference ``iAlignUp`` :41)."""
    return ceil_div(a, b) * b


def next_multiple_of_16(n: int) -> int:
    """Reference-parity policy: round up to a multiple of 16.

    Mirrors ``computeFFTsize16`` (src/cudaConvFFTData.h:96): the demo's
    73→80 and 11→16 sizes come from this policy
    (demoCudaConvolutionFFT.m:78-79).
    """
    return align_up(max(int(n), 1), 16)


def next_pow2(n: int) -> int:
    """Legacy reference policy: align to 16 then round up to a power of two.

    Mirrors ``computeFFTsize`` (src/cudaConvFFTData.h:67): aligns to 16
    first, then takes the next power of two (exact power-of-two inputs map to
    themselves).
    """
    n = align_up(max(int(n), 1), 16)
    return 1 << (n - 1).bit_length()


@functools.lru_cache(maxsize=4096)
def next_fast_len(n: int, primes: tuple = (2, 3, 5)) -> int:
    """Smallest integer >= n that factors entirely into ``primes``.

    XLA's FFT (like FFTW/cuFFT) is fast for 5-smooth sizes.
    """
    n = max(int(n), 1)
    if n <= max(primes):
        return n

    def is_smooth(m: int) -> bool:
        for p in primes:
            while m % p == 0:
                m //= p
        return m == 1

    m = n
    while not is_smooth(m):
        m += 1
    return m


class FftSizePolicy(str, enum.Enum):
    """How to round ``data + max_kernel - 1`` up to the FFT size.

    MULTIPLE16  — reference parity (computeFFTsize16).
    POW2        — legacy reference policy (computeFFTsize).
    FAST        — next 5-smooth size (XLA-FFT friendly).
    """

    MULTIPLE16 = "multiple16"
    POW2 = "pow2"
    FAST = "fast"


def compute_fft_size(
    data_h: int,
    data_w: int,
    max_kernel_h: int,
    max_kernel_w: int,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> tuple[int, int]:
    """FFT dims for linear convolution of (data_h, data_w) with kernels up to
    (max_kernel_h, max_kernel_w).

    Reference: PADDING = maxK - 1; FFT = policy(DATA + PADDING)
    (src/cudaConvolutionFFT.cu:103-110).
    """
    policy = FftSizePolicy(policy)
    need_h = data_h + max_kernel_h - 1
    need_w = data_w + max_kernel_w - 1
    if policy is FftSizePolicy.MULTIPLE16:
        return next_multiple_of_16(need_h), next_multiple_of_16(need_w)
    if policy is FftSizePolicy.POW2:
        return next_pow2(need_h), next_pow2(need_w)
    return next_fast_len(need_h), next_fast_len(need_w)
