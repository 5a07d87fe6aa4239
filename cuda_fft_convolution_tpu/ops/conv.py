"""Core FFT-convolution numerics (the walking skeleton, SURVEY.md §7 step 1).

Semantics preserved from the reference (SURVEY.md §7 "the contract"):
  per kernel:  out = Σ_channels IFFT( FFT(pad(data)) ⊙ FFT(pad(kernel)) ) / N
  (src/cudaConvolutionFFT.cu:245-282; scale 1/(FFT_W·FFT_H) at :270 — here
  the scale is jnp.fft.irfft2's own normalization, cuFFT is unnormalized).
  Output is the full FFT_H×FFT_W map; the linear-convolution ("full") window
  is the top-left (H+Kh−1)×(W+Kw−1) block, the rest is circular wrap
  (demoCudaConvolutionFFT.m:146-151). Kernels are used UN-flipped: this is
  convolution; callers pre-flip for correlation (demo :67-69).

Difference from the reference: the channel reduction is done in the
SPECTRAL domain (linearity of the DFT): Σ_f IFFT(D_f ⊙ K_f) =
IFFT(Σ_f D_f ⊙ K_f), so each kernel costs ONE inverse FFT instead of F
(the reference runs a batched C2R over all F channels then sums spatially,
src/cudaConvFFTData.cuh:70-92).
For an F-channel bank this removes (F−1)/F of all inverse-FFT work.

Internal canonical layout is channel-leading (F, H, W) — W is the minor
axis, FFTs batch over leading axes natively (≈ cufftPlanMany BATCH=F,
src/cudaConvolutionFFT.cu:128-142).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from cuda_fft_convolution_tpu.ops.padding import pad_to_fft
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy, compute_fft_size

# fp32 spectral math everywhere: XLA FFT requires f32/c64; bf16 inputs are
# upcast on entry (BASELINE.json config 5: "bf16 inputs with fp32 spectral
# accumulation").
_SPECTRAL_REAL = jnp.float32


_PRECISIONS = {
    "highest": jax.lax.Precision.HIGHEST,
    "high": jax.lax.Precision.HIGH,
    "default": jax.lax.Precision.DEFAULT,
}


def _use_matmul_fft() -> bool:
    """Transform engine: XLA FFT unless the matmul-DFT engine is opted
    into (``set_config(use_matmul_fft=True)``)."""
    from cuda_fft_convolution_tpu.utils.config import get_config

    return bool(get_config().use_matmul_fft)


def _matmul_precision():
    from cuda_fft_convolution_tpu.utils.config import get_config

    return _PRECISIONS[get_config().matmul_precision]


def _inverse_precision():
    """Precision for the matmul-DFT engine's inverse-synthesis dots
    (config.inverse_precision, default 'highest'; forward transforms use
    ``matmul_precision``)."""
    from cuda_fft_convolution_tpu.utils.config import get_config

    return _PRECISIONS[get_config().inverse_precision]


def rfft2_padded_planes(
    x: jnp.ndarray, fft_h: int, fft_w: int
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Zero-pad the trailing (H, W) axes to (fft_h, fft_w) and take rfft2,
    returning split (re, im) f32 planes — the library's native spectral
    representation (no complex64 ever crosses a program boundary).

    ≈ padData + cufftExecR2C batched over all leading axes
    (src/cudaConvolutionFFT.cu:155-167). Transform engine: XLA FFT HLO
    (cuFFT on the GPU; complex internally, split on return — inside one
    XLA program that split is free), or the opt-in matmul-DFT engine
    (ops/dft.py).
    """
    x = x.astype(_SPECTRAL_REAL)
    if _use_matmul_fft():
        from cuda_fft_convolution_tpu.ops.dft import rfft2_mm_planes

        return rfft2_mm_planes(x, fft_h, fft_w, precision=_matmul_precision())
    s = jnp.fft.rfft2(pad_to_fft(x, fft_h, fft_w))
    return jnp.real(s), jnp.imag(s)


def rfft2_padded(x: jnp.ndarray, fft_h: int, fft_w: int) -> jnp.ndarray:
    """Complex-output wrapper of ``rfft2_padded_planes`` (interop)."""
    sr, si = rfft2_padded_planes(x, fft_h, fft_w)
    return jax.lax.complex(sr, si)


def spectral_mac(
    data_fft: jnp.ndarray,
    kernel_fft: jnp.ndarray,
    *,
    precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Σ_f D[f,h,w] · K[...,f,h,w] — complex product + channel reduction.

    ≈ elementwiseProductAndNormalize + sumAlongFeatures fused
    (src/cudaConvFFTData.cuh:47-92), with the sum moved into the spectral
    domain. ``kernel_fft`` may have any number of leading bank axes.
    The (much larger) kernel spectra are streamed against the single data
    spectrum — this is the memory-bound hot op (split-plane form in
    ops/spectral_mac.py).
    """
    return jnp.einsum("...fhw,fhw->...hw", kernel_fft, data_fft, precision=precision)


def spectral_mac_planes(
    dr: jnp.ndarray, di: jnp.ndarray,
    kr: jnp.ndarray, ki: jnp.ndarray,
    *,
    precision=jax.lax.Precision.HIGHEST,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Split-plane form of ``spectral_mac``: 4 real einsums XLA fuses into
    one pass; the Karatsuba knob is shared with ops/spectral_mac. No
    complex dtype."""
    from cuda_fft_convolution_tpu.ops.spectral_mac import _MAC_KARATSUBA

    def e(a, b):
        return jnp.einsum("...fhw,fhw->...hw", a, b, precision=precision)

    if _MAC_KARATSUBA:
        t1 = e(kr, dr)
        t2 = e(ki, di)
        t3 = e(kr + ki, dr + di)
        return t1 - t2, t3 - t1 - t2
    return e(kr, dr) - e(ki, di), e(kr, di) + e(ki, dr)


def irfft2_norm_planes(
    sr: jnp.ndarray, si: jnp.ndarray, fft_h: int, fft_w: int
) -> jnp.ndarray:
    """Inverse real FFT of split (re, im) planes back to an (fft_h, fft_w)
    f32 map.

    The normalization 1/(fft_h·fft_w) is applied here — equivalent to the
    reference's explicit scale (src/cudaConvolutionFFT.cu:270) on top of
    unnormalized cuFFT C2R. Same engine dispatch as rfft2_padded_planes.
    """
    if _use_matmul_fft():
        from cuda_fft_convolution_tpu.ops.dft import irfft2_mm_planes

        return irfft2_mm_planes(
            sr, si, fft_h, fft_w, precision=_inverse_precision()
        )
    # XLA FFT path needs complex64 — upcast bf16-tier product planes.
    sr = sr.astype(jnp.float32)
    si = si.astype(jnp.float32)
    return jnp.fft.irfft2(jax.lax.complex(sr, si), s=(fft_h, fft_w))


def irfft2_norm(s: jnp.ndarray, fft_h: int, fft_w: int) -> jnp.ndarray:
    """Complex-input wrapper of ``irfft2_norm_planes`` (interop)."""
    return irfft2_norm_planes(jnp.real(s), jnp.imag(s), fft_h, fft_w)


def fft_conv_single(
    data: jnp.ndarray,
    kernel: jnp.ndarray,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> jnp.ndarray:
    """Convolve one (F, H, W) data array with one (F, Kh, Kw) kernel.

    Returns the full (fft_h, fft_w) map summed over channels — exactly the
    per-cell result of cudaConvolutionFFT (src/cudaConvolutionFFT.cu:284-288).
    """
    f, h, w = data.shape
    kf, kh, kw = kernel.shape
    if kf != f:
        raise ValueError(f"channel mismatch: data F={f}, kernel F={kf}")
    if fft_h is None or fft_w is None:
        fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    dr, di = rfft2_padded_planes(data, fft_h, fft_w)
    kr, ki = rfft2_padded_planes(kernel, fft_h, fft_w)
    pr, pi = spectral_mac_planes(dr, di, kr, ki)
    return irfft2_norm_planes(pr, pi, fft_h, fft_w)


def fft_conv_stack(
    data: jnp.ndarray,
    kernels: jnp.ndarray,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> jnp.ndarray:
    """Convolve (F, H, W) data with a stacked bank (N, F, Kh, Kw) of kernels.

    The data FFT is computed ONCE and reused across the whole bank — the
    reference's core amortization (src/cudaConvolutionFFT.cu:167 then the
    per-kernel loop :204-291). Returns (N, fft_h, fft_w).
    """
    f, h, w = data.shape
    n, kf, kh, kw = kernels.shape
    if kf != f:
        raise ValueError(f"channel mismatch: data F={f}, kernels F={kf}")
    if fft_h is None or fft_w is None:
        fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    dr, di = rfft2_padded_planes(data, fft_h, fft_w)
    kr, ki = rfft2_padded_planes(kernels, fft_h, fft_w)
    pr, pi = spectral_mac_planes(dr, di, kr, ki)
    return irfft2_norm_planes(pr, pi, fft_h, fft_w)


def direct_conv_single(data: jnp.ndarray, kernel: jnp.ndarray) -> jnp.ndarray:
    """Spatial-domain 'full' convolution summed over channels (test oracle and
    small-kernel crossover path).

    Matches MATLAB ``sum_i conv2(data(:,:,i), kernel(:,:,i))``
    (demoCudaConvolutionFFT.m:91-96). Runs through
    lax.conv_general_dilated (which computes correlation, so the kernel is
    flipped here to get convolution). Output (H+Kh−1, W+Kw−1).
    """
    f, h, w = data.shape
    kf, kh, kw = kernel.shape
    if kf != f:
        raise ValueError(f"channel mismatch: data F={f}, kernel F={kf}")
    lhs = data[None].astype(_SPECTRAL_REAL)  # (1, F, H, W)
    rhs = kernel[None, :, ::-1, ::-1].astype(_SPECTRAL_REAL)  # (1, F, Kh, Kw)
    out = jax.lax.conv_general_dilated(
        lhs,
        rhs,
        window_strides=(1, 1),
        padding=[(kh - 1, kh - 1), (kw - 1, kw - 1)],
        dimension_numbers=("NCHW", "OIHW", "NCHW"),
        preferred_element_type=_SPECTRAL_REAL,
        # Full fp32: XLA's default conv precision may run TF32 on the GPU
        # (about 3 digits) — unacceptable for a test oracle.
        precision=jax.lax.Precision.HIGHEST,
    )
    return out[0, 0]
