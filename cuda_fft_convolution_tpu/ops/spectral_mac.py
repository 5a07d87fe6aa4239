"""Fused spectral multiply-accumulate (the hot op).

Replacement for the reference's elementwiseProductAndNormalize +
sumAlongFeatures kernel pair (src/cudaConvFFTData.cuh:47-92), which the
reference launches back-to-back per kernel with an intermediate
FFT_H×FFT_W×F product buffer round-tripped through device memory
(src/cudaConvolutionFFT.cu:263-282). Here both are one pass:

    out[b, n, s] = Σ_f data[b, f, s] · kernel[n, f, s]      (complex)

i.e. the channel reduction happens in the SPECTRAL domain (DFT linearity), so
no per-channel product buffer ever exists and each (b, n) needs one inverse
FFT instead of F. Normalization is left to the inverse transform (cuFFT is
unnormalized so the reference scales by 1/(FFT_W·FFT_H) here,
src/cudaConvFFTData.cuh:56).

Spectra are SPLIT (re, im) planes end-to-end; the MAC is four real einsums
that XLA compiles into one pass. At F=1 XLA fuses them into an elementwise
kernel that also builds the complex input of the inverse FFT; at larger F
it hands them to cuBLAS as a batched GEMM over the spectral pixels, which
tiles the (blocks × kernels) product in shared memory. A hand-written
Triton MAC (one program per pixel tile × kernel, F reduced in registers)
measured slower at both widths on the H100 (PERF.md, Findings) and was
removed.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

# Karatsuba (3-contraction) MAC: saves one (B, N, H, Wc) product tensor of
# traffic IF XLA fuses the elementwise pre-adds into the dot operands. The
# 4-contraction form is the default; the env knob keeps the variant
# measurable per deployment (not measured on the GPU).
import os as _os

_MAC_KARATSUBA = _os.environ.get("FFTCONV_MAC_KARATSUBA", "0") not in (
    "0", "false", "False", ""
)

# bf16-tier MAC lowering: native bf16 dots want relayouted operands inside
# a chunked lax.map, and XLA may hoist that relayout to the whole bank (a
# full extra bank copy). The ``bf16_upcast`` lowering instead feeds f32 dots
# via converts fused into the operand reads: bf16 bytes off device memory,
# no layout constraint; the F-contraction's flops are negligible next to
# the traffic. Chunked callers pass bf16_upcast=True and unchunked callers
# leave the default. FFTCONV_BF16_MAC_UPCAST=1 forces it everywhere.
_BF16_MAC_UPCAST = _os.environ.get(
    "FFTCONV_BF16_MAC_UPCAST", "0"
) not in ("0", "false", "False", "")


def spectral_mac_planes(
    dr: jnp.ndarray, di: jnp.ndarray,  # (B, F, H, Wc) f32
    kr: jnp.ndarray, ki: jnp.ndarray,  # (N, F, H, Wc) f32
    *,
    precision=jax.lax.Precision.HIGHEST,
    bf16_upcast: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(B, F, H, Wc) × (N, F, H, Wc) → (B, N, H, Wc) split planes.

    4 real contractions by default (XLA fuses them into one pass);
    FFTCONV_MAC_KARATSUBA=1 selects the 3-contraction Karatsuba form —
    see the module-level knob.

    HIGHEST precision: when XLA lowers the F-contraction through a dot,
    a lower precision would run it in TF32 on the GPU (about 3 digits) —
    the spectral accumulation must stay full fp32 (≤1e-5 rel err).

    bf16 serving tier: when the spectra are STORED bf16 (fft_data /
    fft_kernels ``store_dtype='bfloat16'``), the contractions run
    single-pass on the native bf16 operands with f32 ACCUMULATION
    (``preferred_element_type``) and the outputs stay f32 — half the
    input traffic."""
    bf16 = dr.dtype == jnp.bfloat16 or kr.dtype == jnp.bfloat16
    if bf16:
        if bf16_upcast or (bf16_upcast is None and _BF16_MAC_UPCAST):
            dr, di = dr.astype(jnp.float32), di.astype(jnp.float32)
            kr, ki = kr.astype(jnp.float32), ki.astype(jnp.float32)
            if not _MAC_KARATSUBA:
                # the upcast operands are EXACTLY bf16-valued, so a
                # single-pass DEFAULT dot loses nothing against HIGHEST.
                # (Karatsuba's dr+di pre-adds are NOT bf16-exact: that
                # branch keeps the caller's precision.)
                precision = jax.lax.Precision.DEFAULT
        else:
            dr, di = dr.astype(jnp.bfloat16), di.astype(jnp.bfloat16)
            kr, ki = kr.astype(jnp.bfloat16), ki.astype(jnp.bfloat16)
            precision = jax.lax.Precision.DEFAULT

    def e(a, b):
        return jnp.einsum(
            "bfhw,nfhw->bnhw", a, b, precision=precision,
            preferred_element_type=jnp.float32,
        )

    if _MAC_KARATSUBA:
        t1 = e(dr, kr)
        t2 = e(di, ki)
        t3 = e(dr + di, kr + ki)
        return t1 - t2, t3 - t1 - t2
    return e(dr, kr) - e(di, ki), e(di, kr) + e(dr, ki)


def spectral_mac_flat_planes(
    dr: jnp.ndarray, di: jnp.ndarray,  # (B, F, S) f32 — flat spectral axis
    kr: jnp.ndarray, ki: jnp.ndarray,  # (N, F, S) f32
    *,
    precision=jax.lax.Precision.HIGHEST,
    bf16_upcast: bool | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """MAC on FLAT spectra (types.SpectralKernels ``flat``, one spectral
    pixel axis): identical math to ``spectral_mac_planes`` — the complex
    product and F-reduction are elementwise over spectral pixels, so the
    packing is free here. Same 4-contraction default / Karatsuba knob and
    bf16 serving tier as ``spectral_mac_planes``."""
    bf16 = dr.dtype == jnp.bfloat16 or kr.dtype == jnp.bfloat16
    if bf16:
        if bf16_upcast or (bf16_upcast is None and _BF16_MAC_UPCAST):
            dr, di = dr.astype(jnp.float32), di.astype(jnp.float32)
            kr, ki = kr.astype(jnp.float32), ki.astype(jnp.float32)
            if not _MAC_KARATSUBA:
                # exact on bf16-valued operands (see spectral_mac_planes)
                precision = jax.lax.Precision.DEFAULT
        else:
            dr, di = dr.astype(jnp.bfloat16), di.astype(jnp.bfloat16)
            kr, ki = kr.astype(jnp.bfloat16), ki.astype(jnp.bfloat16)
            precision = jax.lax.Precision.DEFAULT

    def e(a, b):
        return jnp.einsum(
            "bfs,nfs->bns", a, b, precision=precision,
            preferred_element_type=jnp.float32,
        )

    if _MAC_KARATSUBA:
        t1 = e(dr, kr)
        t2 = e(di, ki)
        t3 = e(dr + di, kr + ki)
        return t1 - t2, t3 - t1 - t2
    return e(dr, kr) - e(di, ki), e(di, kr) + e(dr, ki)


def spectral_mac_einsum(data_fft: jnp.ndarray, kernel_fft: jnp.ndarray) -> jnp.ndarray:
    """Complex-facing wrapper of ``spectral_mac_planes``."""
    o_r, o_i = spectral_mac_planes(
        jnp.real(data_fft), jnp.imag(data_fft),
        jnp.real(kernel_fft), jnp.imag(kernel_fft),
    )
    return jax.lax.complex(o_r, o_i)
