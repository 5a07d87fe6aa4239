"""cuda_fft_convolution_tpu — FFT filter-bank convolution in JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
chrischoy/CUDA-FFT-Convolution: multi-channel 2-D
convolution of image data against a *bank* of filters via FFT, amortizing a
single forward FFT of the data across the whole bank.

Reference API parity (see SURVEY.md §2/§3):
  - ``fft_conv``        ≈ cudaConvolutionFFT   (src/cudaConvolutionFFT.cu:27)
  - ``fft_data``        ≈ cudaFFTData          (src/cudaFFTData.cu:18)
  - ``conv_spectral``   ≈ cudaConvFFTData      (src/cudaConvFFTData.cu:24)
  - ``conv_spectral_pipelined`` ≈ cudaConvFFTDataStreams (streams variant)

Design:
  - FFTs via ``jnp.fft.rfft2``/``irfft2`` → XLA FFT HLO (cuFFT on the GPU).
  - Channel reduction is performed *in the spectral domain*, so each kernel
    needs ONE inverse FFT instead of F (the reference does a batched C2R over
    all F channels then sums spatially — src/cudaConvFFTData.cuh:70).
  - The spectral multiply-accumulate is one XLA pass over split planes.
  - The multi-stream/multi-GPU variant becomes a chunked pipeline +
    ``shard_map`` over a device mesh (data FFT replicated, kernel bank sharded).
"""

from cuda_fft_convolution_tpu.api import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
    conv_spectral,
    conv_spectral_pipelined,
    fft_conv,
    fft_data,
    fft_data_tiled,
    fft_kernels,
)
from cuda_fft_convolution_tpu.ops.conv import (
    fft_conv_single,
    fft_conv_stack,
    direct_conv_single,
)
from cuda_fft_convolution_tpu.parallel import (
    conv_spectral_sharded,
    detect_peaks_sharded,
    make_mesh,
    shard_kernel_bank,
)
from cuda_fft_convolution_tpu.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
    next_fast_len,
    next_multiple_of_16,
    next_pow2,
)
from cuda_fft_convolution_tpu.runtime import (
    ConvFuture,
    ConvStream,
    RaggedConvFuture,
    RaggedConvStream,
    FftConvPlan,
    ShardedConvStream,
    make_plan,
)
from cuda_fft_convolution_tpu.utils.checkpoint import load_spectral, save_spectral
from cuda_fft_convolution_tpu.utils.config import get_config, set_config
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError
from cuda_fft_convolution_tpu.utils.selftest import selftest
from cuda_fft_convolution_tpu.utils.transfer import fetch

__version__ = "0.1.0"

__all__ = [
    "SpectralData",
    "SpectralKernels",
    "TiledSpectralData",
    "conv_spectral",
    "conv_spectral_pipelined",
    "fft_conv",
    "fft_data",
    "fft_data_tiled",
    "fft_kernels",
    "fft_conv_single",
    "fft_conv_stack",
    "direct_conv_single",
    "conv_spectral_sharded",
    "detect_peaks_sharded",
    "make_mesh",
    "shard_kernel_bank",
    "fetch",
    "ConvFuture",
    "ConvStream",
    "RaggedConvFuture",
    "RaggedConvStream",
    "ShardedConvStream",
    "FftConvPlan",
    "make_plan",
    "load_spectral",
    "save_spectral",
    "get_config",
    "set_config",
    "InvalidInputError",
    "selftest",
    "FftSizePolicy",
    "compute_fft_size",
    "next_fast_len",
    "next_multiple_of_16",
    "next_pow2",
    "__version__",
]
