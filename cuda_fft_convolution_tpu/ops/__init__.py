"""Device-math layer: padding, FFT wrappers, spectral MAC, convolution cores.

Replacement of the reference's device-kernel layer
(src/cudaConvFFTData.cuh: padData / elementwiseProductAndNormalize /
sumAlongFeatures) and its cuFFT plan usage.
"""

from cuda_fft_convolution_tpu.ops.padding import (
    pad_clamp_to_border,
    pad_kernel_centered,
    pad_to_fft,
)
from cuda_fft_convolution_tpu.ops.conv import (
    direct_conv_single,
    fft_conv_single,
    fft_conv_stack,
    spectral_mac,
)

__all__ = [
    "pad_to_fft",
    "pad_clamp_to_border",
    "pad_kernel_centered",
    "direct_conv_single",
    "fft_conv_single",
    "fft_conv_stack",
    "spectral_mac",
]
