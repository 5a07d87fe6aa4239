"""Utility layer: FFT-size policies, validation errors, logging, profiling.

Replacement of the reference's host utility header
(src/cudaConvFFTData.h: error macros, iDivUp/iAlignUp grid math,
computeFFTsize/computeFFTsize16 policies).
"""

from cuda_fft_convolution_tpu.utils.checkpoint import load_spectral, save_spectral
from cuda_fft_convolution_tpu.utils.config import Config, get_config, set_config
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError, validate
from cuda_fft_convolution_tpu.utils.image_io import (
    compare_l2,
    compare_max,
    load_pgm,
    save_pgm,
)
from cuda_fft_convolution_tpu.utils.profiling import Timer, benchmark, trace
from cuda_fft_convolution_tpu.utils.selftest import selftest
from cuda_fft_convolution_tpu.utils.transfer import fetch
from cuda_fft_convolution_tpu.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
    next_fast_len,
    next_multiple_of_16,
    next_pow2,
    align_up,
    ceil_div,
)

__all__ = [
    "load_spectral",
    "save_spectral",
    "Config",
    "get_config",
    "set_config",
    "InvalidInputError",
    "validate",
    "compare_l2",
    "compare_max",
    "load_pgm",
    "save_pgm",
    "Timer",
    "benchmark",
    "trace",
    "selftest",
    "fetch",
    "FftSizePolicy",
    "compute_fft_size",
    "next_fast_len",
    "next_multiple_of_16",
    "next_pow2",
    "align_up",
    "ceil_div",
]
