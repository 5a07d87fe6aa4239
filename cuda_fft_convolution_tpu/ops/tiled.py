"""Overlap-save tiled FFT convolution.

A capability the reference does NOT have (it always FFTs at full image +
pad size, src/cudaConvolutionFFT.cu:109-112) but that dominates its headline
regime (large image × bank of much smaller kernels, README.md:4-6): instead
of one (H+K−1)-point FFT per kernel, the image is cut into overlapping
blocks of a small FFT size L, each block is transformed ONCE for the whole
bank, and every kernel's spectrum is computed at size L — for a 2048² image
and 64² kernels that shrinks each kernel FFT by ~18× in pixels and keeps
the bank spectra small. Classic overlap-save: each block's circular
convolution is valid linear convolution in its last L−K+1 rows/cols; the
wrapped band is discarded and blocks are laid edge-to-edge.

Exactness: overlap-save computes the LINEAR convolution (the 'full'/'same'/
'valid' windows) bit-for-fp32 like the big-FFT path. It can ALSO serve
mode='fftmap': the direct canvas is sized ≥ data+K−1, so its raw circular
maps are exactly the 'full' linear maps zero-extended to the canvas —
fft_data_tiled(trim_mode='fftmap') bakes that canvas as the output window
(the extra blocks convolve the zero pad and write exact zeros) and the
assembled maps match the direct engine's placement bit-for-parity.

Everything here is jnp → differentiable and shard_map-compatible; the block
axis is just another batch axis for the spectral MAC.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from cuda_fft_convolution_tpu.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_tpu.ops.spectral_mac import spectral_mac_planes
from cuda_fft_convolution_tpu.utils.config import register_jit_consumer
from cuda_fft_convolution_tpu.utils.fft_size import next_fast_len


def choose_block_plan(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    *, min_ratio: int | None = None, max_block: int = 1024,
    matmul_engine: bool | None = None, feature_dim: int = 1,
    store_dtype: str = "float32", head: str = "conv",
) -> tuple[int, int, int, int] | None:
    """Like ``choose_block_fft`` but returns the full overlap-save plan
    (block_h, block_w, plan_kh, plan_kw) where (plan_kh, plan_kw) is the
    EFFECTIVE kernel envelope — ≥ the user's (max_kh, max_kw) when a
    tuned geometry (runtime/autotune.py) deliberately enlarges the overlap
    to pick its valid window V = block − plan_k + 1. A larger envelope
    only adds prehistory zeros; results are identical."""
    blk = choose_block_fft(
        data_h, data_w, max_kh, max_kw, min_ratio=min_ratio,
        max_block=max_block, matmul_engine=matmul_engine,
        feature_dim=feature_dim, store_dtype=store_dtype, head=head,
        _with_plan=True,
    )
    return blk


def choose_block_fft(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    *, min_ratio: int | None = None, max_block: int = 1024,
    matmul_engine: bool | None = None, feature_dim: int = 1,
    store_dtype: str = "float32", head: str = "conv",
    _with_plan: bool = False,
) -> tuple | None:
    """Pick the overlap-save block FFT size, or None when tiling won't pay.

    On the opt-in matmul-DFT engine a tuned geometry table
    (runtime/autotune.py — filled per deployment by the live tuner) is
    consulted first; the analytic rules below cover untuned shapes.

    Engine-aware rules: the matmul-DFT engine's per-output-pixel cost grows
    ~linearly with block size (dense O(L³) over (L−K+1)² outputs) and works
    for ANY size, so it wants the smallest block that keeps overlap
    redundancy sane with a lane-aligned Hermitian width. The XLA-FFT engine
    wants 5-smooth sizes and larger blocks (≈8×K) since its cost/pixel only
    grows with log L. Tiling is declined when the kernel is a large fraction
    of the image (direct engine wins — BASELINE config 3's 2048²×512²
    regime) or the image doesn't span ≥2 blocks."""
    if matmul_engine is None:
        from cuda_fft_convolution_tpu.ops.conv import _use_matmul_fft

        matmul_engine = _use_matmul_fft()
    if matmul_engine:
        from cuda_fft_convolution_tpu.runtime.autotune import (
            lookup_tuned_geometry,
        )

        tuned = lookup_tuned_geometry(
            max_kh, max_kw, feature_dim, store_dtype, head=head
        )
        if tuned is not None:
            vh, vw = tuned[0], tuned[1]
            if len(tuned) == 4:
                # explicit block dims → an enlarged effective envelope
                lh, lw = tuned[2], tuned[3]
            else:
                lh = min(vh + max_kh - 1, max_block)
                lw = min(vw + max_kw - 1, max_block)
            pkh, pkw = lh - vh + 1, lw - vw + 1
            # Measured entries skip the analytic redundancy guard (they ARE
            # the measurement); only require the image to actually span
            # multiple blocks and the enlarged envelope to stay valid.
            if pkh >= max_kh and pkw >= max_kw and not (
                data_h + pkh - 1 <= 2 * lh
                and data_w + pkw - 1 <= 2 * lw
            ):
                return (lh, lw, pkh, pkw) if _with_plan else (lh, lw)
            # tuned block doesn't fit this image/kernel ratio → fall through
        # The dense DFT works at ANY size: the VALID window
        # (V = L − K + 1) is what gets written, so V itself is rounded —
        # Vh to 8, Vw to 128. H blocks stay small (Vh ≈ K: dense-DFT
        # cost per pixel grows with L and the windowed inverse absorbs the
        # overlap redundancy), W blocks wider (Vw ≈ 6×K).
        ratio_h = 1 if min_ratio is None else min_ratio
        ratio_w = 6 if min_ratio is None else 2 * min_ratio
        vh = max(-(-(ratio_h * (max_kh - 1)) // 8) * 8, 8)
        vw = max(-(-(ratio_w * (max_kw - 1)) // 128) * 128, 128)
        lh = min(vh + max_kh - 1, max_block)
        lw = min(vw + max_kw - 1, max_block)
        # Decline when overlap redundancy gets extreme (>~2x per axis):
        # windowed inverses absorb most redundancy, so the bar is lower
        # than the FFT engine's.
        if lh < 2 * (max_kh - 1) or lw < 2 * (max_kw - 1):
            return None
    else:
        if min_ratio is None:
            min_ratio = 8
        lh = next_fast_len(min(max(min_ratio * max_kh, 128), max_block))
        lw = next_fast_len(min(max(min_ratio * max_kw, 128), max_block))
        # Decline when the block can't be ≥4× the kernel pad: the overlap
        # redundancy (L/(L−K+1))² exceeds ~1.8 and the direct engine wins.
        if lh < 4 * (max_kh - 1) or lw < 4 * (max_kw - 1):
            return None
    # decline when the image is small enough that one big FFT is comparable
    if data_h + max_kh - 1 <= 2 * lh and data_w + max_kw - 1 <= 2 * lw:
        return None
    return (lh, lw, max_kh, max_kw) if _with_plan else (lh, lw)


def fallback_block_fft(max_kh: int, max_kw: int) -> tuple[int, int]:
    """Smallest sane block when the caller forces tiling against the
    planner's advice: 4× the kernel pad, 5-smooth, ≥32."""
    return (
        next_fast_len(max(4 * (max_kh - 1), 32)),
        next_fast_len(max(4 * (max_kw - 1), 32)),
    )


@functools.partial(
    jax.jit,
    static_argnames=("block_h", "block_w", "kh", "kw", "origin_h",
                     "origin_w", "win_h", "win_w"),
)
def fft_data_blocks(
    data_cf: jnp.ndarray,  # (B, F, H, W)
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    origin_h: int = 0,
    origin_w: int = 0,
    win_h: int | None = None,
    win_w: int | None = None,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Block spectra (B, nbh, nbw, F, block_h, block_w//2+1) split (re, im)
    f32 planes.

    Blocks start every V = L−K+1 output rows/cols; block g covers padded
    input rows [g·V, g·V+L) where the input carries K−1 leading zeros (the
    overlap-save prehistory) and trailing zeros to fill the last block.

    ``origin_h/origin_w`` shift the block tiling so output row/col 0 is
    'full'-window index origin (the prehistory shrinks by the shift —
    history stays complete because origin ≤ K−1); ``win_h/win_w`` bound
    the covered extent. Together they bake a 'same'/'valid' window into
    the spectra so no trim copy is ever needed."""
    b, f, h, w = data_cf.shape
    vh, vw = block_h - kh + 1, block_w - kw + 1
    oh = (h + kh - 1 - origin_h) if win_h is None else win_h
    ow = (w + kw - 1 - origin_w) if win_w is None else win_w
    nbh, nbw = -(-oh // vh), -(-ow // vw)
    hp = (nbh - 1) * vh + block_h
    wp = (nbw - 1) * vw + block_w
    pt, pl = kh - 1 - origin_h, kw - 1 - origin_w
    x = jnp.pad(
        data_cf.astype(jnp.float32),
        ((0, 0), (0, 0), (pt, max(hp - pt - h, 0)),
         (pl, max(wp - pl - w, 0))),
    )
    x = x[:, :, :hp, :wp]
    r = jnp.arange(nbh)[:, None] * vh + jnp.arange(block_h)[None]
    c = jnp.arange(nbw)[:, None] * vw + jnp.arange(block_w)[None]
    xb = x[:, :, r, :]  # (B, F, nbh, block_h, Wp)
    xb = xb[..., c]  # (B, F, nbh, block_h, nbw, block_w)
    xb = jnp.moveaxis(xb, (2, 4), (1, 2))  # (B, nbh, nbw, F, block_h, block_w)
    # rfft2_padded_planes is a no-op pad here (blocks are already full size)
    # but routes through the transform-engine dispatch (XLA FFT or the
    # opt-in matmul-DFT engine).
    return rfft2_padded_planes(xb, block_h, block_w)


@functools.partial(
    jax.jit,
    static_argnames=(
        "block_h", "block_w", "kh", "kw", "out_h", "out_w", "out_dtype",
    ),
)
def conv_blocks(
    d_re: jnp.ndarray,  # (B, nbh, nbw, F, Lh, Lwc)
    d_im: jnp.ndarray,
    k_re: jnp.ndarray,  # (N, F, Lh, Lwc) — at the BLOCK fft size
    k_im: jnp.ndarray,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
    out_dtype: str = "float32",
) -> jnp.ndarray:
    """Spectral MAC per block + inverse FFT + overlap-save reassembly →
    (B, N, out_h, out_w) linear-convolution maps ('full' window). All
    spectra are split (re, im) planes; plain jnp end to end, so it is
    differentiable as it stands.

    ``out_dtype='bfloat16'`` casts the valid windows BEFORE the
    reassembly transpose (XLA fuses the convert into the inverse's
    epilogue): the transpose copy and the final maps write move half the
    bytes (~4e-3 rounding on the scores, the bf16-tier envelope)."""
    from cuda_fft_convolution_tpu.ops.conv import (
        _inverse_precision,
        _use_matmul_fft,
    )

    b, nbh, nbw, f, lh, lwc = d_re.shape
    n = k_re.shape[0]
    vh, vw = block_h - kh + 1, block_w - kw + 1
    # Fold (B, nbh, nbw) into one batch axis for the MAC.
    dflat_re = d_re.reshape(b * nbh * nbw, f, lh, lwc)
    dflat_im = d_im.reshape(b * nbh * nbw, f, lh, lwc)
    p_re, p_im = spectral_mac_planes(dflat_re, dflat_im, k_re, k_im)
    if d_re.dtype == jnp.bfloat16:
        # bf16 serving tier: the product SPECTRA store bf16 too (the MAC
        # accumulated f32; XLA fuses the convert into its epilogue).
        p_re, p_im = p_re.astype(jnp.bfloat16), p_im.astype(jnp.bfloat16)
    if _use_matmul_fft():
        # The matmul-DFT inverse synthesizes ONLY each block's valid
        # (non-wrapped) window — flops and intermediate bytes shrink by the
        # overlap redundancy factor (L/(L−K+1))², which an FFT cannot do.
        from cuda_fft_convolution_tpu.ops.dft import irfft2_mm_planes

        valid = irfft2_mm_planes(
            p_re, p_im, block_h, block_w,
            precision=_inverse_precision(),
            window=(kh - 1, vh, kw - 1, vw),
        )
    else:
        maps = irfft2_norm_planes(p_re, p_im, block_h, block_w)
        # Valid (non-wrapped) region of each block: rows/cols [K−1, K−1+V).
        valid = maps[:, :, kh - 1 : kh - 1 + vh, kw - 1 : kw - 1 + vw]
    if out_dtype != "float32":
        valid = valid.astype(jnp.dtype(out_dtype))
    valid = valid.reshape(b, nbh, nbw, n, vh, vw)
    out = jnp.transpose(valid, (0, 3, 1, 4, 2, 5)).reshape(
        b, n, nbh * vh, nbw * vw
    )
    return out[:, :, :out_h, :out_w]


@functools.partial(jax.jit, static_argnames=("out_w_hint",))
def peaks_from_maps(
    maps: jnp.ndarray, out_w_hint: int | None = None
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(B, N, H, W) maps → per-kernel top-1 ``(vals, ys, xs)`` each (B, N).
    Under jit the reduction can fuse into the map producer's epilogue."""
    b, n, h, w = maps.shape
    flat = maps.reshape(b, n, h * w)
    idx = jnp.argmax(flat, axis=-1)
    vals = jnp.take_along_axis(flat, idx[..., None], axis=-1)[..., 0]
    return vals, (idx // w).astype(jnp.int32), (idx % w).astype(jnp.int32)


@functools.partial(
    jax.jit,
    static_argnames=("block_h", "block_w", "kh", "kw", "out_h", "out_w"),
)
def conv_blocks_peaks(
    d_re: jnp.ndarray,  # (B, nbh, nbw, F, Lh, Lwc)
    d_im: jnp.ndarray,
    k_re: jnp.ndarray,  # (N, F, Lh, Lwc)
    k_im: jnp.ndarray,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Detection head over the overlap-save engine: per-kernel top-1
    ``(vals, ys, xs)`` each (B, N), positions in the output window's frame.
    The assembled maps are reduced in XLA."""
    maps = conv_blocks(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w
    )
    return peaks_from_maps(maps)


@functools.partial(jax.jit, static_argnames=("k",))
def top_k_from_maps(
    maps: jnp.ndarray, k: int
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(B, N, H, W) maps → EXACT per-kernel top-k ``(vals, ys, xs)`` each
    (B, N, k), values descending (ties broken by ascending flat index —
    lax.top_k's order)."""
    b, n, h, w = maps.shape
    flat = maps.reshape(b, n, h * w)
    kv, ki = jax.lax.top_k(flat, k)
    return kv, (ki // w).astype(jnp.int32), (ki % w).astype(jnp.int32)


@functools.partial(jax.jit, static_argnames=("k", "window"))
def local_peaks_from_maps(
    maps: jnp.ndarray,
    k: int,
    window: int = 3,
    threshold=None,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """(B, N, H, W) maps → per-kernel top-k LOCAL MAXIMA ``(vals, ys, xs)``
    each (B, N, k), values descending. A local maximum is a pixel equal to
    the max of its ``window``×``window`` neighborhood ('SAME' edges — edge
    pixels compare against their in-bounds neighbors) and strictly above
    ``threshold`` (a traced scalar; None keeps every local max). This is
    the DPM consumer's detection pattern: ALL candidate detections above a
    score cutoff, mutually non-adjacent (a built-in ``window``-radius
    non-max suppression), not the global top-k. Slots beyond the number of
    qualifying maxima carry ``-inf`` values and (-1, -1) positions.

    A constant plateau marks every plateau pixel as a local max (equality
    against the window dilation) — real spectral score maps are
    continuous-valued, so plateaus above threshold do not occur in
    practice. Under jit the dilation + mask fuse into the map producer's
    epilogue; only the (B, N, k) results leave the device."""
    b, n, h, w = maps.shape
    f32 = maps.astype(jnp.float32)
    dil = jax.lax.reduce_window(
        f32,
        -jnp.inf,
        jax.lax.max,
        (1, 1, window, window),
        (1, 1, 1, 1),
        "SAME",
    )
    is_peak = f32 >= dil
    if threshold is not None:
        is_peak = jnp.logical_and(is_peak, f32 > threshold)
    scores = jnp.where(is_peak, f32, -jnp.inf)
    kv, ki = jax.lax.top_k(scores.reshape(b, n, h * w), k)
    hit = jnp.isfinite(kv)
    ys = jnp.where(hit, ki // w, -1).astype(jnp.int32)
    xs = jnp.where(hit, ki % w, -1).astype(jnp.int32)
    return kv, ys, xs


@functools.partial(
    jax.jit,
    static_argnames=("block_h", "block_w", "kh", "kw", "out_h", "out_w",
                     "k"),
)
def conv_blocks_top_k(
    d_re: jnp.ndarray,  # (B, nbh, nbw, F, Lh, Lwc)
    d_im: jnp.ndarray,
    k_re: jnp.ndarray,  # (N, F, Lh, Lwc)
    k_im: jnp.ndarray,
    block_h: int,
    block_w: int,
    kh: int,
    kw: int,
    out_h: int,
    out_w: int,
    k: int,
) -> tuple[jnp.ndarray, jnp.ndarray, jnp.ndarray]:
    """Top-k detection head over the overlap-save engine: per-kernel
    ``(vals, ys, xs)`` each (B, N, k), values descending, positions in
    the output window's frame — an EXACT lax.top_k over the assembled
    maps."""
    maps = conv_blocks(
        d_re, d_im, k_re, k_im, block_h, block_w, kh, kw, out_h, out_w
    )
    return top_k_from_maps(maps, k)


# These jitted workers read the global config (transform-engine dispatch)
# at trace time; register so set_config can invalidate their caches.
register_jit_consumer(fft_data_blocks)
register_jit_consumer(conv_blocks)
register_jit_consumer(conv_blocks_peaks)
register_jit_consumer(conv_blocks_top_k)
