"""Padding ops.

Reference equivalents:
  - ``pad_to_fft``          ≈ ``padData`` (src/cudaConvFFTData.cuh:11-31):
    zero-pad an H×W×F array into FFT_H×FFT_W×F, data in the top-left corner.
  - ``pad_clamp_to_border`` ≈ the vestigial texture-based ``padData`` in
    src/convolutionFFTkernel.cu:46-76, which replicates edge pixels into the
    pad band and fills the far pad region with row/col-0 replicas (named as
    a capability to carry forward in BASELINE.json). Both regions matter:
    the band serves bottom/right edge outputs, the wrap-to-origin region
    serves top/left edge outputs through the circular FFT.

These are pure data-movement ops; XLA lowers ``jax.lax.pad`` /
dynamic-slice fusions efficiently, so no custom kernel is needed for zero
padding — it fuses into the FFT's input. Border-clamp uses clamped gathers.
"""

from __future__ import annotations

import jax.numpy as jnp


def pad_to_fft(x: jnp.ndarray, fft_h: int, fft_w: int) -> jnp.ndarray:
    """Zero-pad the last two axes (H, W) of ``x`` up to (fft_h, fft_w).

    Data lands in the top-left corner, matching the reference's padData
    (src/cudaConvFFTData.cuh:24-29). Leading axes (channels, bank, batch)
    pass through. Works for any rank >= 2.
    """
    h, w = x.shape[-2], x.shape[-1]
    if h == fft_h and w == fft_w:
        return x
    if h > fft_h or w > fft_w:
        raise ValueError(
            f"input spatial dims ({h},{w}) exceed FFT dims ({fft_h},{fft_w})"
        )
    pad_widths = [(0, 0)] * (x.ndim - 2) + [(0, fft_h - h), (0, fft_w - w)]
    return jnp.pad(x, pad_widths)


def pad_kernel_centered(
    kernel: jnp.ndarray, fft_h: int, fft_w: int
) -> jnp.ndarray:
    """Zero-pad a (..., Kh, Kw) kernel to (fft_h, fft_w) with its CENTER at
    the origin, wrapping the upper-left quadrant to the far corners.

    ≈ the vestigial ``padKernel`` (src/convolutionFFTkernel.cu:13-40), which
    centers kernels so convolution outputs are un-shifted ('same' window at
    rows/cols [0, H) directly). The library's main paths anchor kernels
    top-left like the reference's built path and trim windows instead; this
    op exists for users porting kernel-centered pipelines."""
    kh, kw = kernel.shape[-2], kernel.shape[-1]
    if kh > fft_h or kw > fft_w:
        raise ValueError(
            f"kernel ({kh},{kw}) exceeds FFT dims ({fft_h},{fft_w})"
        )
    padded = pad_to_fft(kernel, fft_h, fft_w)
    # shift so the center lands at (0, 0); circular wrap moves the
    # upper-left of the kernel into the array's far corners
    return jnp.roll(padded, (-(kh // 2), -(kw // 2)), axis=(-2, -1))


def pad_clamp_to_border(
    x: jnp.ndarray, fft_h: int, fft_w: int, border_h: int, border_w: int
) -> jnp.ndarray:
    """Pad (H, W) up to (fft_h, fft_w) with the reference's exact
    three-region rule (src/convolutionFFTkernel.cu:65-74): data in the
    top-left corner; the next (border_h, border_w) pad rows/cols replicate
    the far edge (row H−1 / col W−1); every pad row/col BEYOND the band
    replicates row/col 0.

    The far wrap-to-origin region is load-bearing for linear convolution
    through a circular FFT: output pixels near the top/left edge read taps
    at negative indices, which wrap to the END of the padded array — those
    rows must hold row/col-0 replicas for edge outputs to see replicated
    pixels (zeros there would reintroduce the implicit black border on the
    top/left edges that clamp padding exists to remove). ``border_h/w``
    should be the kernel's center offset (the 'same'-window trim offset) —
    the reference's ``kernelY``/``kernelX`` arguments.
    """
    h, w = x.shape[-2], x.shape[-1]
    if h > fft_h or w > fft_w:
        raise ValueError(
            f"input spatial dims ({h},{w}) exceed FFT dims ({fft_h},{fft_w})"
        )
    idx_h = jnp.arange(fft_h)
    idx_w = jnp.arange(fft_w)
    rows = jnp.where(
        idx_h < h, idx_h, jnp.where(idx_h < h + border_h, h - 1, 0)
    )
    cols = jnp.where(
        idx_w < w, idx_w, jnp.where(idx_w < w + border_w, w - 1, 0)
    )
    return x[..., rows, :][..., :, cols]
