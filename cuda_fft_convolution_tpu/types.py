"""First-class spectral-state types.

``SpectralData`` is the equivalent of the reference's persistent
on-device ``mxGPUArray`` returned by cudaFFTData (src/cudaFFTData.cu:97-150):
a materialized data FFT that later convolution calls resume from (SURVEY.md
§5 "checkpoint/resume" analogue). It is a JAX pytree, so it jits, vmaps,
shards and survives in device memory exactly like the reference's gpuArray.

``SpectralKernels`` is the same idea applied to a *kernel bank* — beyond the
reference (which re-FFTs kernels every call, src/cudaConvFFTData.cu:191-282),
but the natural amortization for detection workloads where the bank is fixed
across an image stream.

Storage layout — SPLIT PLANES: spectra are held as two float32 arrays
(``re``, ``im``) rather than one complex64 array. The MAC and the
matmul-DFT engine compute on planes, a bf16 tier can store each plane in
bf16 (there is no bf16 complex type), and the plane buffers are
donatable. ``fft`` remains available as a lazily-recombined complex64
property for interop.

Packing: spectra are Hermitian-packed along the LAST axis (rfft2 layout:
(..., fft_h, fft_w//2+1)). The reference packs along its column-major
innermost axis H instead (CFFT_H = FFT_H/2+1, src/cudaFFTData.cu:90-94) —
same information, row-major-native axis here. Dims are carried explicitly
rather than recovered from the packed shape; ``SpectralData.from_packed``
performs the reference's dim recovery (src/cudaConvFFTData.cu:92-98) for
users holding a raw packed spectrum.
"""

from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp


@jax.jit
def _split_planes(x):
    return (
        jnp.real(x).astype(jnp.float32),
        jnp.imag(x).astype(jnp.float32),
    )


def split_planes(x) -> tuple[jnp.ndarray, jnp.ndarray]:
    """complex array → (re, im) f32 planes. HOST (numpy) complex input is
    split on the host (migrated reference/MATLAB state loads are this
    path); device complex arrays split under jit."""
    import numpy as _np

    if isinstance(x, _np.ndarray):
        if _np.issubdtype(x.dtype, _np.complexfloating):
            return (
                jnp.asarray(_np.ascontiguousarray(x.real), jnp.float32),
                jnp.asarray(_np.ascontiguousarray(x.imag), jnp.float32),
            )
        x32 = _np.asarray(x, _np.float32)
        return jnp.asarray(x32), jnp.zeros(x32.shape, jnp.float32)
    x = jnp.asarray(x)
    if jnp.issubdtype(x.dtype, jnp.complexfloating):
        return _split_planes(x)
    return x.astype(jnp.float32), jnp.zeros_like(x, jnp.float32)


def combine_planes(re, im) -> jnp.ndarray:
    """(re, im) planes → complex64, under jit (see split_planes)."""
    return jax.jit(jax.lax.complex)(
        jnp.asarray(re, jnp.float32), jnp.asarray(im, jnp.float32)
    )


@functools.partial(jax.jit, static_argnames=("fft_h", "fft_w"))
def _unpack_h_to_w(g_re, g_im, fft_h: int, fft_w: int):
    """H-packed half-spectrum planes (F, FFT_H//2+1, FFT_W) → this
    library's W-packed layout (F, FFT_H, FFT_W//2+1) via Hermitian
    symmetry (gather + sign flip — no transform is recomputed)."""
    cfft_h = fft_h // 2 + 1
    wc = fft_w // 2 + 1
    u = jnp.arange(fft_h)
    v = jnp.arange(wc)
    mirror = u >= cfft_h  # rows recovered by conjugate symmetry
    u_src = jnp.where(mirror, fft_h - u, u)
    # (FFT_H, Wc) source column index: direct for stored rows, W-negated
    # for mirrored rows
    v_src = jnp.where(
        mirror[:, None], (fft_w - v[None, :]) % fft_w, v[None, :]
    )
    sign = jnp.where(mirror, -1.0, 1.0).astype(jnp.float32)
    re = g_re[:, u_src[:, None], v_src]  # (F, FFT_H, Wc)
    im = g_im[:, u_src[:, None], v_src] * sign[None, :, None]
    return re, im


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpectralData:
    """rfft2 of zero-padded data as split f32 planes, plus static geometry."""

    # (F, fft_h, fft_w//2+1) f32 each, or (B, F, ...) when batched.
    re: jnp.ndarray
    im: jnp.ndarray
    fft_h: int = dataclasses.field(metadata=dict(static=True))
    fft_w: int = dataclasses.field(metadata=dict(static=True))
    data_h: int = dataclasses.field(metadata=dict(static=True))
    data_w: int = dataclasses.field(metadata=dict(static=True))
    # True when the pad region holds border-clamp replicas (fft_data
    # padding='clamp') rather than zeros: 'full' windows then mix edge
    # semantics and are rejected downstream.
    clamp: bool = dataclasses.field(default=False, metadata=dict(static=True))
    # Clamp far-edge band sizes (the reference's kernelY/kernelX pad args,
    # src/convolutionFFTkernel.cu:46-76) — recorded so downstream 'same'
    # trims can verify the band actually serves the requested
    # (kernel, same_offset, kernel_layout) combination (_trim). −1 =
    # unknown (non-clamp spectra, or objects built by from_packed/
    # from_complex interop): validation is skipped.
    band_h: int = dataclasses.field(default=-1, metadata=dict(static=True))
    band_w: int = dataclasses.field(default=-1, metadata=dict(static=True))

    @property
    def fft(self) -> jnp.ndarray:
        """Complex64 view (recombined lazily; interop/debug only — the
        compute path never materializes complex)."""
        return combine_planes(self.re, self.im)

    @property
    def batched(self) -> bool:
        """True when a leading image-batch axis is present (beyond the
        reference, which is strictly one image per call)."""
        return self.re.ndim == 4

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]

    @property
    def batch_size(self) -> int:
        return self.re.shape[0] if self.batched else 1

    @property
    def cfft_w(self) -> int:
        """Hermitian-packed width (≈ CFFT_H in the reference's H-packed
        layout, src/cudaConvolutionFFT.cu:112)."""
        return self.fft_w // 2 + 1

    @classmethod
    def from_complex(
        cls, fft, fft_h: int, fft_w: int, data_h: int, data_w: int
    ) -> "SpectralData":
        re, im = split_planes(fft)
        return cls(re=re, im=im, fft_h=fft_h, fft_w=fft_w,
                   data_h=data_h, data_w=data_w)

    @classmethod
    def from_packed(
        cls, fft, data_h: int, data_w: int, *, fft_w: int | None = None
    ) -> "SpectralData":
        """Build from a RAW Hermitian-packed spectrum (e.g. a user's own
        ``jnp.fft.rfft2`` output), recovering the FFT geometry from the
        packed shape — the reference's dim recovery for a bare gpuArray
        input (src/cudaConvFFTData.cu:92-98: CFFT_H=dim0, FFT_H=(dim0−1)·2).

        ``fft`` may be complex (..., fft_h, fft_w//2+1) or a (re, im) tuple
        of f32 planes; 2-D/3-D/4-D inputs are normalized to (F, H, Wc) /
        (B, F, H, Wc). Even fft_w is assumed (like the reference); pass
        ``fft_w`` explicitly for odd sizes."""
        if isinstance(fft, (tuple, list)):
            re, im = (jnp.asarray(fft[0], jnp.float32),
                      jnp.asarray(fft[1], jnp.float32))
        else:
            re, im = split_planes(fft)
        if re.ndim == 2:  # single channel → (1, H, Wc)
            re, im = re[None], im[None]
        if re.ndim not in (3, 4):
            raise ValueError(
                f"packed spectrum must be 2-4D (got shape {re.shape})"
            )
        fft_h = int(re.shape[-2])
        wc = int(re.shape[-1])
        if fft_w is None:
            fft_w = (wc - 1) * 2  # even-size assumption, like the reference
        if fft_w // 2 + 1 != wc:
            raise ValueError(
                f"fft_w={fft_w} inconsistent with packed width {wc}"
            )
        return cls(re=re, im=im, fft_h=fft_h, fft_w=fft_w,
                   data_h=data_h, data_w=data_w)

    @classmethod
    def from_reference_packed(
        cls, fft, data_h: int, data_w: int, *, fft_h: int | None = None
    ) -> "SpectralData":
        """Build from a spectrum in the REFERENCE's packed layout — the
        actual gpuArray `cudaFFTData` returns (src/cudaFFTData.cu:90-101):
        MATLAB dims (CFFT_H, FFT_W, F) with CFFT_H = FFT_H/2+1, i.e.
        Hermitian-packed along **H** (cuFFT R2C runs over the column-major
        innermost axis). This converter lets migrated reference/MATLAB
        state — or any `fft2`-convention H-packed half-spectrum — load
        directly: it transposes the axis roles and re-derives the missing
        H rows / packs W via Hermitian symmetry,

            S[u, v] = G[u, v]                         for u < CFFT_H
            S[u, v] = conj(G[FFT_H−u, (FFT_W−v) % FFT_W])  otherwise,

        reproducing the reference's dim recovery FFT_H = (dim0−1)·2
        (src/cudaConvFFTData.cu:92-98; pass ``fft_h`` for odd sizes).

        Accepts complex or (re, im)-tuple input, shaped (CFFT_H, FFT_W, F)
        (MATLAB channel-last, like this library's API boundary) or
        (CFFT_H, FFT_W) for single-channel."""
        if isinstance(fft, (tuple, list)):
            g_re, g_im = (jnp.asarray(fft[0], jnp.float32),
                          jnp.asarray(fft[1], jnp.float32))
        else:
            g_re, g_im = split_planes(fft)
        if g_re.ndim == 2:
            g_re, g_im = g_re[..., None], g_im[..., None]
        if g_re.ndim != 3:
            raise ValueError(
                "reference-packed spectrum must be (CFFT_H, FFT_W[, F]) "
                f"(got shape {g_re.shape})"
            )
        cfft_h, fft_w, _f = (int(s) for s in g_re.shape)
        if fft_h is None:
            fft_h = (cfft_h - 1) * 2  # the reference's even-size recovery
        if fft_h // 2 + 1 != cfft_h:
            raise ValueError(
                f"fft_h={fft_h} inconsistent with packed height {cfft_h}"
            )
        # (CFFT_H, FFT_W, F) → channel-leading (F, CFFT_H, FFT_W)
        g_re = jnp.moveaxis(g_re, -1, 0)
        g_im = jnp.moveaxis(g_im, -1, 0)
        re, im = _unpack_h_to_w(g_re, g_im, fft_h, fft_w)
        return cls(re=re, im=im, fft_h=fft_h, fft_w=fft_w,
                   data_h=data_h, data_w=data_w)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class TiledSpectralData:
    """Overlap-save block spectra of the data (ops/tiled.py), split planes.

    Beyond the reference (which has no tiled engine): the per-block analogue
    of SpectralData. Valid only for kernels up to (max_kh, max_kw) because
    the block stride V = block − maxK + 1 bakes the kernel pad in."""

    # (nbh, nbw, F, block_h, block_w//2+1) f32 each, or (B, nbh, nbw, ...).
    re: jnp.ndarray
    im: jnp.ndarray
    block_h: int = dataclasses.field(metadata=dict(static=True))
    block_w: int = dataclasses.field(metadata=dict(static=True))
    max_kh: int = dataclasses.field(metadata=dict(static=True))
    max_kw: int = dataclasses.field(metadata=dict(static=True))
    data_h: int = dataclasses.field(metadata=dict(static=True))
    data_w: int = dataclasses.field(metadata=dict(static=True))
    # Baked output window (api.fft_data_tiled ``trim_mode``): the block
    # tiling origin is shifted so the engine writes EXACTLY the requested
    # window ('same'/'valid' for a known kernel size) with no trim copy —
    # origin = the 'full'-window index of output row/col 0, win = extent.
    origin_h: int = dataclasses.field(default=0, metadata=dict(static=True))
    origin_w: int = dataclasses.field(default=0, metadata=dict(static=True))
    win_h: int | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    win_w: int | None = dataclasses.field(
        default=None, metadata=dict(static=True)
    )
    # trim_mode='fftmap': the baked window IS the direct engine's FFT canvas
    # (origin 0, extent = policy(data + trim_kernel − 1)). Because the canvas
    # covers the full linear extent, the raw circular maps equal the linear
    # 'full' maps zero-extended — so these spectra serve mode='fftmap' with
    # bit-parity placement to the direct engine (the reference's raw output,
    # src/cudaConvFFTData.cu:250-282) at overlap-save speed.
    fftmap_canvas: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )

    @property
    def fft(self) -> jnp.ndarray:
        return combine_planes(self.re, self.im)

    @property
    def batched(self) -> bool:
        return self.re.ndim == 6

    @property
    def feature_dim(self) -> int:
        return self.re.shape[-3]

    @property
    def batch_size(self) -> int:
        return self.re.shape[0] if self.batched else 1

    @property
    def out_h(self) -> int:
        """Output extent the blocks synthesize (the 'full' extent unless a
        window was baked at precompute time)."""
        return (
            self.win_h if self.win_h is not None
            else self.data_h + self.max_kh - 1
        )

    @property
    def out_w(self) -> int:
        return (
            self.win_w if self.win_w is not None
            else self.data_w + self.max_kw - 1
        )


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class SpectralKernels:
    """rfft2 of a zero-padded stacked kernel bank, split planes."""

    re: jnp.ndarray  # (N, F, fft_h, fft_w//2+1) f32
    im: jnp.ndarray
    fft_h: int = dataclasses.field(metadata=dict(static=True))
    fft_w: int = dataclasses.field(metadata=dict(static=True))
    # Per-kernel true spatial sizes (pre-padding), for trimming modes.
    kernel_hs: tuple = dataclasses.field(metadata=dict(static=True))
    kernel_ws: tuple = dataclasses.field(metadata=dict(static=True))
    # Kernel anchoring baked into the spectra: False = top-left corner (the
    # reference's built path, src/cudaConvFFTData.cuh:11-31); True = kernel
    # CENTER at the origin via circular wrap (≈ the vestigial padKernel,
    # src/convolutionFFTkernel.cu:13-40) — maps come out un-shifted, so
    # 'same' needs no trim offset.
    centered: bool = dataclasses.field(
        default=False, metadata=dict(static=True)
    )
    # Storage layout: False = planar (N, F, fft_h, Wc); True = FLAT
    # (N, F, fft_h·Wc), one spectral-pixel axis (explicit
    # fft_kernels(storage='flat') only). The MAC is elementwise over
    # spectral pixels, so the layout is free there; the inverse reshapes
    # per chunk.
    flat: bool = dataclasses.field(default=False, metadata=dict(static=True))

    @property
    def fft(self) -> jnp.ndarray:
        return combine_planes(self.re, self.im)

    @property
    def num_kernels(self) -> int:
        return self.re.shape[0]

    @property
    def feature_dim(self) -> int:
        return self.re.shape[1]
