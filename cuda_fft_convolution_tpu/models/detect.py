"""On-device detection head: per-kernel peak extraction over score maps.

The reference library exists to serve DPM/HOG detectors (README.md:4-6
"many large kernels, large images") and its own demo validates by PEAK
LOCATION, not by map contents (demoCudaConvolutionFFT.m:58-61) — yet its
pipeline always materializes every full score map, and a consumer that
only wants peaks reads 10⁴× fewer bytes than the maps hold.

``detect_peaks`` reduces the maps on the device (XLA, fused into the map
producer where it can), so only (N,) values and (N, 2) positions leave it.
Results are exact per-kernel top-1, bit-comparable to argmaxing the
trimmed maps.
"""

from __future__ import annotations

import jax.numpy as jnp

from cuda_fft_convolution_tpu import api as _api
from cuda_fft_convolution_tpu.ops.tiled import (
    choose_block_plan,
    conv_blocks_peaks,
    conv_blocks_top_k,
    peaks_from_maps,
    top_k_from_maps,
)
from cuda_fft_convolution_tpu.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_tpu.utils.errors import validate


def detect_peaks(
    data,
    kernels,
    *,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
):
    """Per-kernel top-1 detection: ``(values, positions)`` where ``values``
    is (N,) (or (B, N) batched) peak responses and ``positions`` is
    (N, 2) / (B, N, 2) int32 (row, col) in the ``mode`` window's frame
    ('same' → data coordinates, like the reference demo's peak check).

    ``data`` may be a channel-last array ((H, W, F) or (B, H, W, F)), or a
    precomputed :class:`TiledSpectralData` (serving: pass the same spectra
    a `conv_spectral` call would take — the peaks head reuses them).
    ``kernels`` is a stacked uniform bank (N, Kh, Kw, F) or a
    :class:`SpectralKernels` at the matching block geometry (planar).
    A RAGGED cell list (mixed kernel sizes — the reference's cell-array
    scenario, demoCudaConvolutionFFT.m:41-43) is accepted for
    mode='same' only: every 'same' map is data-sized, so the bucketed
    per-cell maps stack and the reduction runs once across the whole
    cell array.

    ``correlation=True`` by default: detection scores are correlations
    (the MOSSE/DPM convention — template matching, models/filter_bank.py
    uses the same default).

    ``algorithm='auto'|'tiled'`` routes through the overlap-save engine
    when the planner tiles; 'direct' computes the maps with the big-FFT
    engine. Both reduce in XLA."""
    validate(
        mode in ("same", "valid", "full"),
        "detect_peaks modes: 'same', 'valid', 'full' (fftmap's circular "
        "frame has no meaningful global peak position)",
    )
    if _ragged_sizes(kernels):
        validate(mode == "same", _RAGGED_MODE_MSG)
        maps = _ragged_same_maps(
            data, kernels, correlation=correlation, algorithm=algorithm,
            same_offset=same_offset, store_dtype=store_dtype,
        )
        if maps.ndim == 3:
            vals, ys, xs = peaks_from_maps(maps[None])
            return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
        vals, ys, xs = peaks_from_maps(maps)
        return vals, jnp.stack([ys, xs], axis=-1)
    if isinstance(data, SpectralData):
        # Direct-engine spectra (e.g. pyramid levels, models/pyramid.py):
        # score with conv_spectral, reduce with the XLA head — the maps
        # stay device-resident, only (N,)+(N,2) ever cross the link.
        _kernel_hw(kernels)  # reject ragged banks up front
        maps = jnp.asarray(
            _api.conv_spectral(
                data, kernels, mode=mode, correlation=correlation
            )
        )
        if maps.ndim == 3:
            vals, ys, xs = peaks_from_maps(maps[None])
            return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
        vals, ys, xs = peaks_from_maps(maps)
        return vals, jnp.stack([ys, xs], axis=-1)
    if isinstance(data, TiledSpectralData):
        sd = data
        kh, kw = _kernel_hw(kernels)
        validate(
            sd.win_h is not None or mode == "full",
            "TiledSpectralData without a baked window serves mode='full' "
            "peaks; bake trim_mode='same'/'valid' at fft_data_tiled for "
            "windowed peaks",
        )
        return _peaks_tiled(sd, kernels, kh, kw, correlation, store_dtype)

    arr = _api._as_array(data)
    batched = arr.ndim == 4
    h, w = (arr.shape[1], arr.shape[2]) if batched else (
        arr.shape[0], arr.shape[1]
    )
    kh, kw = _kernel_hw(kernels)
    if algorithm != "direct":
        plan = choose_block_plan(
            h, w, kh, kw, feature_dim=int(arr.shape[-1]),
            store_dtype=store_dtype, head="peaks",
        )
        if algorithm == "tiled" or plan is not None:
            if plan is None:
                sd = _api.fft_data_tiled(
                    arr, kh, kw, trim_mode=mode, trim_kernel_h=kh,
                    trim_kernel_w=kw, same_offset=same_offset,
                    store_dtype=store_dtype,
                )
            else:
                lh, lw, pkh, pkw = plan
                sd = _api.fft_data_tiled(
                    arr, pkh, pkw, block_h=lh, block_w=lw, trim_mode=mode,
                    trim_kernel_h=kh, trim_kernel_w=kw,
                    same_offset=same_offset, store_dtype=store_dtype,
                )
            return _peaks_tiled(
                sd, kernels, kh, kw, correlation, store_dtype
            )
    maps = _api.fft_conv(
        arr, kernels=kernels, mode=mode, correlation=correlation,
        algorithm="direct", same_offset=same_offset,
        store_dtype=store_dtype,
    )
    maps = jnp.asarray(maps)
    if maps.ndim == 3:  # (N, H, W) unbatched
        vals, ys, xs = peaks_from_maps(maps[None])
        return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
    vals, ys, xs = peaks_from_maps(maps)
    return vals, jnp.stack([ys, xs], axis=-1)


def _kernel_hw(kernels) -> tuple[int, int]:
    if isinstance(kernels, SpectralKernels):
        hs, ws = set(kernels.kernel_hs), set(kernels.kernel_ws)
        validate(
            len(hs) == 1 and len(ws) == 1,
            "detect_peaks takes a uniform bank (bucket ragged cells first)",
        )
        return next(iter(hs)), next(iter(ws))
    if isinstance(kernels, (list, tuple)):
        shapes = {tuple(jnp.asarray(k).shape) for k in kernels}
        validate(
            len(shapes) == 1,
            "detect_peaks takes a uniform bank (bucket ragged cells "
            "first, e.g. via RaggedConvStream groups)",
        )
        kh, kw, _ = next(iter(shapes))
        return int(kh), int(kw)
    karr = jnp.asarray(kernels)
    validate(
        karr.ndim == 4,
        "detect_peaks takes a stacked uniform bank (N, Kh, Kw, F)",
    )
    return int(karr.shape[1]), int(karr.shape[2])


def _ragged_sizes(kernels) -> bool:
    """True when ``kernels`` is a mixed-size cell array (the reference's
    cell-array scenario, demoCudaConvolutionFFT.m:41-43)."""
    if isinstance(kernels, SpectralKernels):
        return (
            len(set(kernels.kernel_hs)) > 1
            or len(set(kernels.kernel_ws)) > 1
        )
    if isinstance(kernels, (list, tuple)):
        return len({tuple(jnp.asarray(kk).shape) for kk in kernels}) > 1
    return False


def _ragged_same_maps(
    data,
    kernels,
    *,
    correlation,
    algorithm,
    same_offset,
    store_dtype,
    out_dtype=None,
):
    """Stacked 'same' score maps for a mixed-size cell array. Every 'same'
    map is data-sized regardless of kernel size, so the per-cell maps
    (``fft_conv``'s pow-2 bucketing — one data FFT per bucket envelope)
    stack into one (…, N, H, W) tensor and the detection reduction runs
    ONCE across the whole cell array. 'valid'/'full' windows differ per
    size, so the heads reject ragged cells there. The reduction fuses
    into the map producers under jit like the uniform XLA head."""
    if isinstance(data, (SpectralData, TiledSpectralData)):
        # precomputed banks carry their flip already (fft_kernels
        # correlation=...), matching the uniform heads' contract
        corr = correlation and not isinstance(kernels, SpectralKernels)
        maps = _api.conv_spectral(
            data, kernels, mode="same", correlation=corr,
            out_dtype=out_dtype,
        )
    else:
        validate(
            not isinstance(kernels, SpectralKernels),
            "ragged SpectralKernels need the precomputed spectra they "
            "were built against (pass the SpectralData, not raw arrays)",
        )
        maps = _api.fft_conv(
            data, kernels=kernels, mode="same", correlation=correlation,
            algorithm=algorithm, same_offset=same_offset,
            store_dtype=store_dtype, out_dtype=out_dtype,
        )
    return jnp.stack([jnp.asarray(m) for m in maps], axis=-3)


_RAGGED_MODE_MSG = (
    "ragged cell arrays serve mode='same' detection only (the "
    "'valid'/'full' windows differ per kernel size, so their maps "
    "cannot share one reduction frame)"
)


def _tiled_head_operands(
    sd: TiledSpectralData, kernels, kh: int, kw: int, correlation: bool,
    store_dtype: str,
):
    """Shared tiled-engine setup for the detection heads: validated bank
    spectra, batched data planes, and the output window frame."""
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            not sk.flat and (sk.fft_h, sk.fft_w) == (sd.block_h, sd.block_w),
            "SpectralKernels geometry/layout does not match the tiled "
            "spectra (planar at the block FFT size required)",
        )
    else:
        sk = _api.fft_kernels(
            kernels, spectral=sd, correlation=correlation,
            storage="planar", store_dtype=store_dtype,
        )
    validate(
        kh <= sd.max_kh and kw <= sd.max_kw,
        f"kernel ({kh},{kw}) exceeds the tiled spectra's planned envelope "
        f"({sd.max_kh},{sd.max_kw})",
    )
    d_re = sd.re if sd.batched else sd.re[None]
    d_im = sd.im if sd.batched else sd.im[None]
    # The engine synthesizes the baked window (origin shift already in the
    # block tiling): peaks come back in that window's frame directly. With
    # no baked window the frame is the KERNEL's 'full' extent — the planned
    # envelope may be larger (aligned-window plans), and those extra
    # rows/cols are zeros that must not win the argmax.
    if sd.win_h is not None:
        out_h, out_w = sd.out_h, sd.out_w
    else:
        out_h, out_w = sd.data_h + kh - 1, sd.data_w + kw - 1
    return d_re, d_im, sk, out_h, out_w


def _peaks_tiled(
    sd: TiledSpectralData, kernels, kh: int, kw: int, correlation: bool,
    store_dtype: str,
):
    d_re, d_im, sk, out_h, out_w = _tiled_head_operands(
        sd, kernels, kh, kw, correlation, store_dtype
    )
    vals, ys, xs = conv_blocks_peaks(
        d_re, d_im, sk.re, sk.im, sd.block_h, sd.block_w,
        sd.max_kh, sd.max_kw, out_h, out_w,
    )
    pos = jnp.stack([ys, xs], axis=-1).astype(jnp.int32)
    if sd.batched:
        return vals, pos
    return vals[0], pos[0]


def _top_k_tiled(
    sd: TiledSpectralData, kernels, kh: int, kw: int, correlation: bool,
    store_dtype: str, k: int,
):
    d_re, d_im, sk, out_h, out_w = _tiled_head_operands(
        sd, kernels, kh, kw, correlation, store_dtype
    )
    vals, ys, xs = conv_blocks_top_k(
        d_re, d_im, sk.re, sk.im, sd.block_h, sd.block_w,
        sd.max_kh, sd.max_kw, out_h, out_w, k,
    )
    pos = jnp.stack([ys, xs], axis=-1).astype(jnp.int32)
    if sd.batched:
        return vals, pos
    return vals[0], pos[0]


def detect_top_k(
    data,
    kernels,
    k: int = 5,
    *,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
):
    """Per-kernel top-k detection: ``(values, positions)`` with ``values``
    (N, k) descending (or (B, N, k) batched) and ``positions`` (N, k, 2) /
    (B, N, k, 2) int32 (row, col) in the ``mode`` window's frame.

    Same routing and input contract as :func:`detect_peaks`: an EXACT
    ``lax.top_k`` over the score maps (ties broken by ascending flat
    index). For spatially distinct detections use
    :func:`detect_local_peaks`."""
    validate(int(k) >= 1, f"k must be >= 1; got {k}")
    k = int(k)
    validate(
        mode in ("same", "valid", "full"),
        "detect_top_k modes: 'same', 'valid', 'full' (fftmap's circular "
        "frame has no meaningful global peak positions)",
    )
    if _ragged_sizes(kernels):
        validate(mode == "same", _RAGGED_MODE_MSG)
        maps = _ragged_same_maps(
            data, kernels, correlation=correlation, algorithm=algorithm,
            same_offset=same_offset, store_dtype=store_dtype,
        )
        if maps.ndim == 3:
            vals, ys, xs = top_k_from_maps(maps[None], k)
            return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
        vals, ys, xs = top_k_from_maps(maps, k)
        return vals, jnp.stack([ys, xs], axis=-1)
    if isinstance(data, SpectralData):
        _kernel_hw(kernels)  # reject ragged banks up front
        maps = jnp.asarray(
            _api.conv_spectral(
                data, kernels, mode=mode, correlation=correlation
            )
        )
        if maps.ndim == 3:
            vals, ys, xs = top_k_from_maps(maps[None], k)
            return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
        vals, ys, xs = top_k_from_maps(maps, k)
        return vals, jnp.stack([ys, xs], axis=-1)
    if isinstance(data, TiledSpectralData):
        sd = data
        kh, kw = _kernel_hw(kernels)
        validate(
            sd.win_h is not None or mode == "full",
            "TiledSpectralData without a baked window serves mode='full' "
            "detections; bake trim_mode='same'/'valid' at fft_data_tiled "
            "for windowed detections",
        )
        return _top_k_tiled(sd, kernels, kh, kw, correlation, store_dtype, k)

    arr = _api._as_array(data)
    batched = arr.ndim == 4
    h, w = (arr.shape[1], arr.shape[2]) if batched else (
        arr.shape[0], arr.shape[1]
    )
    kh, kw = _kernel_hw(kernels)
    if algorithm != "direct":
        plan = choose_block_plan(
            h, w, kh, kw, feature_dim=int(arr.shape[-1]),
            store_dtype=store_dtype, head="peaks",
        )
        if algorithm == "tiled" or plan is not None:
            if plan is None:
                sd = _api.fft_data_tiled(
                    arr, kh, kw, trim_mode=mode, trim_kernel_h=kh,
                    trim_kernel_w=kw, same_offset=same_offset,
                    store_dtype=store_dtype,
                )
            else:
                lh, lw, pkh, pkw = plan
                sd = _api.fft_data_tiled(
                    arr, pkh, pkw, block_h=lh, block_w=lw, trim_mode=mode,
                    trim_kernel_h=kh, trim_kernel_w=kw,
                    same_offset=same_offset, store_dtype=store_dtype,
                )
            return _top_k_tiled(
                sd, kernels, kh, kw, correlation, store_dtype, k
            )
    maps = _api.fft_conv(
        arr, kernels=kernels, mode=mode, correlation=correlation,
        algorithm="direct", same_offset=same_offset,
        store_dtype=store_dtype,
    )
    maps = jnp.asarray(maps)
    if maps.ndim == 3:  # (N, H, W) unbatched
        vals, ys, xs = top_k_from_maps(maps[None], k)
        return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
    vals, ys, xs = top_k_from_maps(maps, k)
    return vals, jnp.stack([ys, xs], axis=-1)


def detect_local_peaks(
    data,
    kernels,
    k: int = 16,
    *,
    threshold=None,
    window: int = 3,
    mode: str = "same",
    correlation: bool = True,
    algorithm: str = "auto",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    out_dtype: str | None = None,
):
    """Per-kernel thresholded LOCAL-MAXIMA detection — the DPM/HOG
    consumer's actual pattern (every candidate detection above a score
    cutoff, mutually non-adjacent), where :func:`detect_peaks` /
    :func:`detect_top_k` return only the globally strongest responses.

    Returns ``(values, positions)``: ``values`` (N, k) descending (or
    (B, N, k) batched), ``positions`` (N, k, 2) / (B, N, k, 2) int32
    (row, col) in the ``mode`` window's frame. A hit is a pixel equal to
    the max of its ``window``×``window`` neighborhood (a built-in
    window-radius non-max suppression) and strictly above ``threshold``
    (a traced scalar; None keeps every local max). Slots beyond the
    number of qualifying maxima carry ``-inf`` / (-1, -1) — a static
    (N, k) result shape, so the host fetch stays tiny and jit-stable
    regardless of how many detections fire.

    The maps are produced by the regular engine (``algorithm`` as in
    ``fft_conv``) and the dilation+mask+top-k reduce them in XLA, fused
    into the producer under jit. ``out_dtype='bfloat16'`` halves the maps
    traffic between producer and reducer where they do materialize
    (scores compare in f32 after upcast; returned values are the upcast
    scores). Ragged cell lists are accepted for mode='same' (see
    :func:`detect_peaks`)."""
    validate(int(k) >= 1, f"k must be >= 1; got {k}")
    validate(int(window) >= 2, f"window must be >= 2; got {window}")
    validate(
        mode in ("same", "valid", "full"),
        "detect_local_peaks modes: 'same', 'valid', 'full' (fftmap's "
        "circular frame has no meaningful peak positions)",
    )
    from cuda_fft_convolution_tpu.ops.tiled import local_peaks_from_maps

    if _ragged_sizes(kernels):
        validate(mode == "same", _RAGGED_MODE_MSG)
        maps = _ragged_same_maps(
            data, kernels, correlation=correlation, algorithm=algorithm,
            same_offset=same_offset, store_dtype=store_dtype,
            out_dtype=out_dtype,
        )
    elif isinstance(data, (SpectralData, TiledSpectralData)):
        # precomputed banks carry their flip already (fft_kernels
        # correlation=...), matching the other heads' contract
        _kernel_hw(kernels)
        corr = correlation and not isinstance(kernels, SpectralKernels)
        maps = jnp.asarray(_api.conv_spectral(
            data, kernels, mode=mode, correlation=corr,
            out_dtype=out_dtype,
        ))
    else:
        _kernel_hw(kernels)
        maps = jnp.asarray(_api.fft_conv(
            data, kernels=kernels, mode=mode, correlation=correlation,
            algorithm=algorithm, same_offset=same_offset,
            store_dtype=store_dtype, out_dtype=out_dtype,
        ))
    if maps.ndim == 3:  # (N, H, W) unbatched
        vals, ys, xs = local_peaks_from_maps(
            maps[None], int(k), int(window), threshold
        )
        return vals[0], jnp.stack([ys[0], xs[0]], axis=-1)
    vals, ys, xs = local_peaks_from_maps(
        maps, int(k), int(window), threshold
    )
    return vals, jnp.stack([ys, xs], axis=-1)
