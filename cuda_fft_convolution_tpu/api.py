"""Public API layer — the equivalent of the reference's MEX entry points.

Reference parity map (SURVEY.md §2/§3):
  - ``fft_conv``                ≈ cudaConvolutionFFT  (src/cudaConvolutionFFT.cu:27)
  - ``fft_data``                ≈ cudaFFTData         (src/cudaFFTData.cu:18)
  - ``conv_spectral``           ≈ cudaConvFFTData     (src/cudaConvFFTData.cu:24)
  - ``conv_spectral_pipelined`` ≈ cudaConvFFTDataStreams (src/cudaConvFFTDataStreams.cu:121)
  - ``fft_kernels``             — new: persistent kernel-bank spectra (the
    reference re-FFTs kernels on every call; detection workloads with a fixed
    bank amortize this too).

API layout contract: like the reference, data is ``(H, W, F)`` channels-last
fp32 (``src/cudaConvolutionFFT.cu:51-54`` enforces 3-D single) and kernels are
``(Kh, Kw, F)`` — given either as a Python list (ragged sizes allowed, the
"cell array") or as a stacked ``(N, Kh, Kw, F)`` array. A leading batch axis
``(B, H, W, F)`` is also accepted (beyond the reference; BASELINE.json
config 4). Internally everything is channel-leading ``(F, H, W)`` so that W
is the minor axis and FFTs batch over leading axes.

Kernels may live on host (numpy) or device (jax.Array) interchangeably —
the reference accepts both host cells and gpuArray cells
(src/cudaConvFFTData.cu:195-225); in JAX this is free.

Outputs: ``mode='fftmap'`` returns the raw (fft_h, fft_w) circular maps —
exact reference-parity output (src/cudaConvolutionFFT.cu:284-288); 'full' /
'same' / 'valid' trim to the standard linear-convolution windows
(demoCudaConvolutionFFT.m:146-151 extracts 'full' by hand).
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
from cuda_fft_convolution_tpu.ops.tiled import (
    choose_block_plan,
    conv_blocks,
    fallback_block_fft,
    fft_data_blocks,
)
from cuda_fft_convolution_tpu.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_tpu.utils.config import get_config
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError, validate
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy, compute_fft_size

_MODES = ("fftmap", "full", "same", "valid")


# ---------------------------------------------------------------------------
# layout helpers
# ---------------------------------------------------------------------------


def _as_array(x) -> jnp.ndarray:
    return x if isinstance(x, jnp.ndarray) else jnp.asarray(x)


def _data_to_cfirst(data) -> tuple[jnp.ndarray, bool]:
    """(H, W, F) → (1, F, H, W); (B, H, W, F) → (B, F, H, W). Returns
    (array, batched)."""
    data = _as_array(data)
    validate(
        all(d > 0 for d in data.shape),
        f"data has zero-size dimension: shape {data.shape}",
    )
    if data.ndim == 3:
        return jnp.transpose(data, (2, 0, 1))[None], False
    if data.ndim == 4:
        return jnp.transpose(data, (0, 3, 1, 2)), True
    raise InvalidInputError(
        f"data must be (H, W, F) or (B, H, W, F); got shape {data.shape}"
    )


def _kernels_to_stack(
    kernels, feature_dim: int | None
) -> tuple[jnp.ndarray, tuple[int, ...], tuple[int, ...]]:
    """Normalize a kernel bank to a stacked (N, F, maxKh, maxKw) array.

    Accepts: a list/tuple of (Kh_i, Kw_i, F) arrays (the reference's cell
    array — ragged sizes allowed), a single (Kh, Kw, F) array, or a stacked
    (N, Kh, Kw, F) array. Ragged kernels are zero-padded to the max size —
    exact for linear convolution (padding a kernel with zeros does not change
    FFT(pad_to_fft(k))). Returns (stack, kernel_hs, kernel_ws).
    """
    if isinstance(kernels, (list, tuple)):
        ks = [_as_array(k) for k in kernels]
        validate(len(ks) > 0, "kernel list is empty")
        for k in ks:
            validate(
                k.ndim == 3,
                f"each kernel must be (Kh, Kw, F); got shape {k.shape}",
            )
            if feature_dim is not None:
                validate(
                    k.shape[2] == feature_dim,
                    f"kernel feature dim {k.shape[2]} != data feature dim "
                    f"{feature_dim} (reference check src/cudaConvolutionFFT.cu:242)",
                )
        khs = tuple(int(k.shape[0]) for k in ks)
        kws = tuple(int(k.shape[1]) for k in ks)
        max_kh, max_kw = max(khs), max(kws)
        stack = jnp.stack(
            [
                jnp.pad(
                    jnp.transpose(k, (2, 0, 1)),
                    ((0, 0), (0, max_kh - k.shape[0]), (0, max_kw - k.shape[1])),
                )
                for k in ks
            ]
        )
        return stack, khs, kws

    k = _as_array(kernels)
    if k.ndim == 3:  # single kernel (Kh, Kw, F)
        k = k[None]
    validate(
        k.ndim == 4, f"kernels must be (N, Kh, Kw, F) or a list; got {k.shape}"
    )
    if feature_dim is not None:
        validate(
            k.shape[3] == feature_dim,
            f"kernel feature dim {k.shape[3]} != data feature dim {feature_dim}",
        )
    n, kh, kw = k.shape[0], int(k.shape[1]), int(k.shape[2])
    return jnp.transpose(k, (0, 3, 1, 2)), (kh,) * n, (kw,) * n


# ---------------------------------------------------------------------------
# jitted workers (static geometry, traced tensors)
# ---------------------------------------------------------------------------


@functools.partial(
    jax.jit, static_argnames=("fft_h", "fft_w", "clamp", "clamp_h", "clamp_w")
)
def _fft_data_worker(
    data_cf: jnp.ndarray, fft_h: int, fft_w: int,
    clamp: bool = False, clamp_h: int = 0, clamp_w: int = 0,
):
    """(B, F, H, W) → (re, im) f32 planes (B, F, fft_h, fft_w//2+1).

    ≈ padData + batched cufftExecR2C (src/cudaFFTData.cu:115-146); the batch
    over B·F leading axes is XLA FFT HLO's native batching (the reference's
    cufftPlanMany BATCH=F, src/cudaFFTData.cu:137-143). Split-plane output:
    no complex64 at the program boundary (see types.py).

    ``clamp=True`` selects border-clamp padding with a (clamp_h, clamp_w)
    far-edge band (≈ padDataClampToBorder,
    src/convolutionFFTkernel.cu:46-76) instead of zero padding. The flag is
    separate from the band sizes: a (0, 0) band is a VALID clamp pad (the
    whole pad wraps to row/col 0 — exactly right for kernels ≤ 2 wide,
    whose 'same' offset is 0).
    """
    if clamp:
        from cuda_fft_convolution_tpu.ops.padding import pad_clamp_to_border

        data_cf = pad_clamp_to_border(
            data_cf.astype(jnp.float32), fft_h, fft_w, clamp_h, clamp_w
        )
    return rfft2_padded_planes(data_cf, fft_h, fft_w)


@functools.partial(jax.jit, static_argnames=("fft_h", "fft_w", "correlation"))
def _fft_kernels_worker(
    kstack: jnp.ndarray, fft_h: int, fft_w: int, correlation: bool
):
    """(N, F, Kh, Kw) → (re, im) f32 planes (N, F, fft_h, fft_w//2+1).

    ``correlation=True`` flips kernels spatially before the FFT — the demo
    does this flip by hand to turn convolution into template correlation
    (demoCudaConvolutionFFT.m:63-69); here it is a flag.
    """
    if correlation:
        kstack = kstack[..., ::-1, ::-1]
    return rfft2_padded_planes(kstack, fft_h, fft_w)


@functools.partial(jax.jit, static_argnames=("fft_h", "fft_w"))
def _fft_kernels_centered_worker(
    kstack: jnp.ndarray, fft_h: int, fft_w: int, shifts: jnp.ndarray
):
    """(N, F, Kh, Kw) → (re, im) planes with each kernel's CENTER wrapped to
    the origin (≈ padKernel, src/convolutionFFTkernel.cu:13-40): maps come
    out un-shifted, so 'same' needs no trim offset. ``shifts`` is the
    per-kernel (N, 2) array of negated center offsets — TRACED, not static,
    so a chunked ragged bank shares one executable across chunks (each
    kernel rolls by its OWN center; ragged banks center correctly)."""
    from cuda_fft_convolution_tpu.ops.padding import pad_to_fft

    padded = pad_to_fft(kstack.astype(jnp.float32), fft_h, fft_w)
    rolled = jax.vmap(
        lambda x, s: jnp.roll(x, (s[0], s[1]), axis=(-2, -1))
    )(padded, shifts)
    return rfft2_padded_planes(rolled, fft_h, fft_w)


@jax.jit
def _flip_stack_ragged(kstack: jnp.ndarray, shifts: jnp.ndarray):
    """Correlation flip for a RAGGED zero-padded stack: flipping the padded
    (maxKh, maxKw) extent moves kernel i's content to the bottom-right
    corner (offset (maxKh−kh_i, maxKw−kw_i)); rolling it back to the origin
    makes the result exactly flip-within-own-extent — the demo's hand flip
    (demoCudaConvolutionFFT.m:67-69) per kernel. ``shifts[i] = (kh_i −
    maxKh, kw_i − maxKw)``. (A uniform stack needs no roll: shift 0.)"""
    flipped = kstack[..., ::-1, ::-1]
    return jax.vmap(
        lambda x, s: jnp.roll(x, (s[0], s[1]), axis=(-2, -1))
    )(flipped, shifts)


def _apply_correlation_flip(kstack, khs, kws, correlation):
    """Resolve the correlation flip on a stacked bank, returning
    (kstack, correlation_remaining). Uniform banks keep the cheap in-worker
    padded flip; ragged banks flip per-kernel here (see
    _flip_stack_ragged)."""
    if not correlation or (len(set(khs)) == 1 and len(set(kws)) == 1):
        return kstack, correlation
    max_kh, max_kw = kstack.shape[-2], kstack.shape[-1]
    shifts = jnp.asarray(
        [(kh - max_kh, kw - max_kw) for kh, kw in zip(khs, kws)]
    )
    return _flip_stack_ragged(kstack, shifts), False


@jax.jit
def _flatten_bank_chunk(x):
    """(N, F, H, Wc) → (N, F, H·Wc): the flat lane-packed bank layout."""
    n, f, h, wc = x.shape
    return x.reshape(n, f, h * wc)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _write_bank_chunk(acc_re, acc_im, chunk_re, chunk_im, start):
    """Write a bank-spectra chunk into the donated plane accumulators
    (in-place buffer reuse: peak memory = bank + one chunk, not 2× bank —
    and f32 planes actually alias under donation, unlike emulated complex)."""
    return (
        jax.lax.dynamic_update_slice_in_dim(acc_re, chunk_re, start, axis=0),
        jax.lax.dynamic_update_slice_in_dim(acc_im, chunk_im, start, axis=0),
    )


@functools.partial(
    jax.jit, static_argnames=("fft_h", "fft_w", "flat")
)
def _conv_from_spectra(
    d_re: jnp.ndarray,  # (B, F, H, Wc) f32
    d_im: jnp.ndarray,
    k_re: jnp.ndarray,  # (N, F, H, Wc) f32; flat: (N, F, H*Wc)
    k_im: jnp.ndarray,
    fft_h: int,
    fft_w: int,
    flat: bool = False,
) -> jnp.ndarray:
    """Spectral MAC + single inverse FFT per (batch, kernel) → (B, N, fft_h, fft_w).

    ≈ elementwiseProductAndNormalize + cufftExecC2R + sumAlongFeatures
    (src/cudaConvolutionFFT.cu:263-282), with the channel sum moved into the
    spectral domain so each kernel needs ONE C2R instead of F (SURVEY.md §7
    step 1 note); normalization 1/(fft_h·fft_w) (:270) folded into the
    inverse transform. Pure f32 planes in, f32 maps out.
    """
    if flat:
        p_re, p_im = _flat_mac_then_reshape(d_re, d_im, k_re, k_im, fft_h, fft_w)
    else:
        p_re, p_im = spectral_mac_planes(d_re, d_im, k_re, k_im)
    p_re, p_im = _products_like(d_re, p_re, p_im)
    return irfft2_norm_planes(p_re, p_im, fft_h, fft_w)


def _products_like(d_re, p_re, p_im):
    """bf16 serving tier: when the spectra are stored bf16 the product
    spectra store bf16 too (the MAC accumulated f32; the convert fuses into
    its epilogue) — the product round trip and the inverse dots halve their
    bytes. f32 spectra keep f32 products."""
    if d_re.dtype == jnp.bfloat16:
        return p_re.astype(jnp.bfloat16), p_im.astype(jnp.bfloat16)
    return p_re, p_im


def _flat_mac_then_reshape(d_re, d_im, k_re, k_im, fft_h, fft_w,
                           bf16_upcast=None):
    """MAC against a FLAT bank (lane-packed spectra): flatten the data
    planes, run the flat einsum, reshape the product back to planar for
    the inverse transform (one relayout of the much-smaller product)."""
    from cuda_fft_convolution_tpu.ops.spectral_mac import (
        spectral_mac_flat_planes,
    )

    b, f = d_re.shape[0], d_re.shape[1]
    wc = fft_w // 2 + 1
    dfl_re = d_re.reshape(b, f, fft_h * wc)
    dfl_im = d_im.reshape(b, f, fft_h * wc)
    p_re, p_im = spectral_mac_flat_planes(
        dfl_re, dfl_im, k_re, k_im, bf16_upcast=bf16_upcast
    )
    n = k_re.shape[0]
    return (
        p_re.reshape(b, n, fft_h, wc),
        p_im.reshape(b, n, fft_h, wc),
    )


@functools.partial(
    jax.jit,
    static_argnames=("fft_h", "fft_w", "chunk_size", "flat"),
)
def _conv_from_spectra_chunked(
    d_re: jnp.ndarray,
    d_im: jnp.ndarray,
    k_re: jnp.ndarray,
    k_im: jnp.ndarray,
    fft_h: int,
    fft_w: int,
    chunk_size: int,
    flat: bool = False,
) -> jnp.ndarray:
    """Bank-chunked pipeline ≈ the streams variant's round-robin
    (src/cudaConvFFTDataStreams.cu:338-469): process the bank in chunks of
    ``chunk_size`` kernels via lax.map so peak memory is bounded by one chunk
    of product/output buffers while XLA's async dispatch overlaps chunk k+1's
    spectra fetch with chunk k's inverse FFT (the role CUDA streams play in
    the reference).

    Chunks are taken with dynamic slices — NOT a padded copy of the whole
    bank, which would double the bank's multi-GB footprint (it OOM'd the
    F=31 direct config). dynamic_slice clamps the last chunk's start, so
    reassembly takes the clamped tail explicitly."""
    n = k_re.shape[0]
    num_chunks = -(-n // chunk_size)
    starts = jnp.arange(num_chunks) * chunk_size

    def one_chunk(start):
        kc_re = jax.lax.dynamic_slice_in_dim(k_re, start, chunk_size, axis=0)
        kc_im = jax.lax.dynamic_slice_in_dim(k_im, start, chunk_size, axis=0)
        # bf16_upcast=True: inside a chunked lax.map, native bf16 dots make
        # XLA hoist a whole-bank operand relayout out of the loop (2 full
        # bank copies — measured compile OOM at N=576); the f32-dot
        # lowering with converts fused into the reads has no layout
        # constraint and measured identical chunked throughput.
        if flat:
            p_re, p_im = _flat_mac_then_reshape(
                d_re, d_im, kc_re, kc_im, fft_h, fft_w, bf16_upcast=True
            )
        else:
            p_re, p_im = spectral_mac_planes(
                d_re, d_im, kc_re, kc_im,
                bf16_upcast=True,
            )
        p_re, p_im = _products_like(d_re, p_re, p_im)
        return irfft2_norm_planes(p_re, p_im, fft_h, fft_w)

    out = jax.lax.map(one_chunk, starts)  # (num_chunks, B, C, fft_h, fft_w)
    out = jnp.moveaxis(out, 2, 1).reshape(-1, d_re.shape[0], fft_h, fft_w)
    if n % chunk_size:
        # last chunk was clamped to [n - chunk_size, n): keep the full
        # chunks then the clamped tail's last n - (num_chunks-1)*chunk_size
        head = out[: (num_chunks - 1) * chunk_size]
        tail = out[-(n - (num_chunks - 1) * chunk_size) :]
        out = jnp.concatenate([head, tail])
    return jnp.moveaxis(out, 0, 1)  # (B, N, fft_h, fft_w)


@functools.partial(
    jax.jit,
    static_argnames=("fft_h", "fft_w", "chunk_size",
                     "correlation"),
)
def _conv_from_spatial_chunked(
    d_re: jnp.ndarray,
    d_im: jnp.ndarray,
    kstack: jnp.ndarray,  # (N, F, Kh, Kw) SPATIAL kernels
    fft_h: int,
    fft_w: int,
    chunk_size: int,
    correlation: bool,
) -> jnp.ndarray:
    """Memory-light giant-bank pipeline: kernel spectra are never resident —
    each chunk is transformed on the fly, MAC'd, and inverted, so peak HBM
    is data spectra + output maps + ONE chunk. This is the reference's own
    regime (it pads+FFTs each kernel inside the loop,
    src/cudaConvFFTData.cu:191-282); the resident-spectra path is the
    amortization upgrade, used whenever the bank actually fits."""
    n = kstack.shape[0]
    num_chunks = -(-n // chunk_size)
    starts = jnp.arange(num_chunks) * chunk_size

    def one_chunk(start):
        kc = jax.lax.dynamic_slice_in_dim(kstack, start, chunk_size, axis=0)
        kc_re, kc_im = _fft_kernels_worker(kc, fft_h, fft_w, correlation)
        p_re, p_im = spectral_mac_planes(d_re, d_im, kc_re, kc_im)
        return irfft2_norm_planes(p_re, p_im, fft_h, fft_w)

    out = jax.lax.map(one_chunk, starts)
    out = jnp.moveaxis(out, 2, 1).reshape(-1, d_re.shape[0], fft_h, fft_w)
    if n % chunk_size:
        head = out[: (num_chunks - 1) * chunk_size]
        tail = out[-(n - (num_chunks - 1) * chunk_size) :]
        out = jnp.concatenate([head, tail])
    return jnp.moveaxis(out, 0, 1)  # (B, N, fft_h, fft_w)


def _resolve_store_dtype(store_dtype: str):
    """'float32' | 'bfloat16' → jnp dtype for stored spectra (the bf16
    serving tier — see fft_data's docstring)."""
    validate(
        store_dtype in ("float32", "bfloat16"),
        "store_dtype must be 'float32' or 'bfloat16'",
    )
    return jnp.float32 if store_dtype == "float32" else jnp.bfloat16


def _resolve_policy(policy):
    return get_config().policy if policy is None else FftSizePolicy(policy)


def _bank_spectra_bytes(
    n: int, f: int, fft_h: int, fft_w: int, store_bytes: int = 4
) -> int:
    """Resident device bytes of a bank's (re, im) spectra — THE byte model
    every residency/streaming decision uses (keep single-sourced; it must
    mirror fft_kernels' actual storage). ``store_bytes``: per-element
    width (2 = bf16 serving tier)."""
    return 2 * store_bytes * n * f * fft_h * (fft_w // 2 + 1)


# The CPU reports no memory limit: the planners budget this much host RAM.
_CPU_BUDGET_BYTES = 8 << 30


def _device_memory_budget() -> int:
    """Usable device bytes on the default device: ``Config.hbm_budget_bytes``
    when set (tests, fleets); on the CPU an explicit 8 GiB; on an
    accelerator ``hbm_fraction`` × ``memory_stats()["bytes_limit"]``. An
    accelerator that reports no limit is an error, not a guess."""
    cfg = get_config()
    if cfg.hbm_budget_bytes is not None:
        return int(cfg.hbm_budget_bytes)
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        return _CPU_BUDGET_BYTES
    stats = dev.memory_stats() or {}
    if "bytes_limit" not in stats:
        raise RuntimeError(
            f"device {dev.device_kind!r} ({dev.platform}) reports no "
            "memory_stats()['bytes_limit'] — set the planning budget with "
            "set_config(hbm_budget_bytes=...) or FFTCONV_HBM_BUDGET_BYTES"
        )
    return int(cfg.hbm_fraction * stats["bytes_limit"])


# ---------------------------------------------------------------------------
# public API
# ---------------------------------------------------------------------------


def fft_data(
    data,
    max_kernel_h: int,
    max_kernel_w: int,
    *,
    policy: FftSizePolicy | str | None = None,
    device=None,
    padding: str = "zero",
    same_offset: str = "scipy",
    kernel_layout: str = "corner",
    store_dtype: str = "float32",
) -> SpectralData:
    """Precompute the reusable data spectrum — ≈ ``cudaFFTData(data, Kh, Kw)``
    (src/cudaFFTData.cu:18-150).

    The result is a first-class on-device object (a JAX pytree) that later
    ``conv_spectral`` calls resume from, like the reference's persistent
    ``mxGPUArray`` return (src/cudaFFTData.cu:150). FFT dims follow
    ``policy(data + max_kernel − 1)`` (src/cudaConvolutionFFT.cu:103-110,
    policy pluggable per SURVEY.md §7).

    ``padding``: 'zero' pads with zeros (padData,
    src/cudaConvFFTData.cuh:11-31); 'clamp' pads with the reference's
    three-region border-replicate rule (padDataClampToBorder,
    src/convolutionFFTkernel.cu:46-76) — boundary-friendly filtering where
    'same'-window edge outputs see replicated pixels instead of an implicit
    black border on EVERY edge (bottom/right via the clamp band, top/left
    via the wrap-to-origin replicas the circular FFT reads at negative tap
    indices). The band is sized to the kernels' 'same'-window anchor:
    ``same_offset`` picks the corner-layout convention ('scipy' (K−1)//2
    or 'matlab' K//2 — match the trim you will request; they differ only
    for even kernels), and ``kernel_layout='centered'`` sizes it K//2 (a
    centered kernel's anchor is its roll shift, independent of the trim
    convention) — pass it when the bank will be centered. The band is
    recorded on the result and the 'same' trim validates it against the
    actual kernels. Pair with mode 'same' or 'fftmap'.

    ``store_dtype='bfloat16'`` stores the spectra bf16 — the serving tier
    for BASELINE configs[4]'s "bf16 inputs, fp32 spectral accumulation":
    the downstream MAC consumes the bf16 operands single-pass with f32
    accumulation (half the spectral traffic; rel err ~1e-3 vs the fp32
    tier's ≤1e-5 — tests/test_bf16_tier.py pins it). Pair with
    ``fft_kernels(..., store_dtype='bfloat16')``.
    """
    validate(max_kernel_h >= 1 and max_kernel_w >= 1, "kernel dims must be >= 1")
    validate(padding in ("zero", "clamp"), "padding must be 'zero' or 'clamp'")
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    validate(
        kernel_layout in ("corner", "centered"),
        "kernel_layout must be 'corner' or 'centered'",
    )
    store_t = _resolve_store_dtype(store_dtype)
    policy = _resolve_policy(policy)
    if device is not None:
        # ≈ the reference's optional 0-based GPU id argument
        # (src/cudaConvolutionFFT.cu:84-89 cudaSetDevice): place the input on
        # an explicit device; all downstream compute follows the data.
        data = jax.device_put(_as_array(data), device)
    data_cf, batched = _data_to_cfirst(data)
    b, f, h, w = data_cf.shape
    fft_h, fft_w = compute_fft_size(h, w, max_kernel_h, max_kernel_w, policy)
    if padding == "clamp":
        # The band is the kernels' 'same'-window ANCHOR — the reference's
        # kernelY/kernelX pad arguments; the rest of the pad wraps to
        # row/col 0 inside pad_clamp_to_border. A centered kernel's anchor
        # is its roll shift K//2 regardless of same_offset (the trim
        # convention only moves corner-anchored windows).
        if kernel_layout == "centered" or same_offset == "matlab":
            clamp = (max_kernel_h // 2, max_kernel_w // 2)
        else:
            clamp = ((max_kernel_h - 1) // 2, (max_kernel_w - 1) // 2)
    else:
        clamp = (0, 0)
    re, im = _fft_data_worker(
        data_cf, fft_h, fft_w, padding == "clamp", *clamp
    )
    re, im = re.astype(store_t), im.astype(store_t)
    if not batched:
        re, im = re[0], im[0]
    is_clamp = padding == "clamp"
    return SpectralData(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, data_h=h, data_w=w,
        clamp=is_clamp,
        band_h=clamp[0] if is_clamp else -1,
        band_w=clamp[1] if is_clamp else -1,
    )


def fft_data_tiled(
    data,
    max_kernel_h: int,
    max_kernel_w: int,
    *,
    block_h: int | None = None,
    block_w: int | None = None,
    device=None,
    trim_mode: str = "full",
    trim_kernel_h: int | None = None,
    trim_kernel_w: int | None = None,
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    policy: FftSizePolicy | str | None = None,
) -> TiledSpectralData:
    """Precompute overlap-save BLOCK spectra of the data (ops/tiled.py).

    The tiled analogue of ``fft_data``: one small-FFT pass over the image,
    reusable across the whole bank and across calls. Beyond the reference —
    its engine always transforms at full image+pad size. Block size defaults
    to the planner's choice (``choose_block_fft``).

    ``trim_mode='same'``/``'valid'`` BAKES that output window into the
    block tiling (for kernels of exactly ``trim_kernel_h/w``, default the
    max): the engine then writes the windowed maps directly — no trim copy
    (1.7 GB of device-memory traffic on the 2048²×100 headline).
    'full'-window requests against such spectra still work whenever the
    requested rows/cols lie inside the baked window; wider requests raise.

    ``trim_mode='fftmap'`` bakes the DIRECT engine's FFT canvas
    (``policy(data + trim_kernel − 1)``, origin 0): blocks beyond the
    linear extent convolve the zero pad and write exact zeros, so the
    assembled maps equal the direct engine's raw circular fftmaps
    (src/cudaConvFFTData.cu:250-282) — same shape, same placement — at
    overlap-save speed. Such spectra also serve every linear mode (the
    canvas contains the 'full' window). ``policy`` sizes the canvas
    (default the same policy ``fft_data`` uses); zero-padding only
    (the clamp band is a direct-engine concept).

    ``store_dtype='bfloat16'``: the bf16 serving tier (see ``fft_data``) —
    block spectra stored bf16, all downstream dots single-pass bf16 with
    f32 accumulation."""
    validate(max_kernel_h >= 1 and max_kernel_w >= 1, "kernel dims must be >= 1")
    store_t = _resolve_store_dtype(store_dtype)
    validate(
        trim_mode in ("full", "same", "valid", "fftmap"),
        "trim_mode must be 'full', 'same', 'valid', or 'fftmap'",
    )
    validate(
        policy is None or trim_mode == "fftmap",
        "policy only sizes the trim_mode='fftmap' canvas — block dims are "
        "chosen by the overlap-save planner, not an FFT-size policy",
    )
    # window offsets follow the USER's kernel size — captured before a
    # measured block plan possibly enlarges the planned envelope below
    tkh = max_kernel_h if trim_kernel_h is None else int(trim_kernel_h)
    tkw = max_kernel_w if trim_kernel_w is None else int(trim_kernel_w)
    if device is not None:
        # gpuId parity (src/cudaConvolutionFFT.cu:84-89): explicit placement.
        data = jax.device_put(_as_array(data), device)
    data_cf, batched = _data_to_cfirst(data)
    b, f, h, w = data_cf.shape
    if block_h is None or block_w is None:
        plan = choose_block_plan(
            h, w, max_kernel_h, max_kernel_w, feature_dim=f,
            store_dtype=store_dtype,
        )
        if plan is None:
            # Caller forced tiling where the planner declines — still honor
            # it with the smallest sane block.
            block_h, block_w = fallback_block_fft(
                max_kernel_h, max_kernel_w
            )
        else:
            # Measured plans may enlarge the effective kernel envelope so
            # the valid window is tile-aligned (extra prehistory zeros —
            # results identical, kernels up to the enlarged max accepted).
            block_h, block_w, max_kernel_h, max_kernel_w = plan
    validate(
        block_h >= max_kernel_h and block_w >= max_kernel_w,
        f"block ({block_h},{block_w}) smaller than kernel "
        f"({max_kernel_h},{max_kernel_w})",
    )
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    if trim_mode == "same":
        if same_offset == "matlab":
            origin_h, origin_w = tkh // 2, tkw // 2
        else:
            origin_h, origin_w = (tkh - 1) // 2, (tkw - 1) // 2
        win_h, win_w = h, w
    elif trim_mode == "valid":
        validate(
            h >= tkh and w >= tkw,
            f"trim_mode='valid' needs data >= kernel; got data ({h},{w}), "
            f"kernel ({tkh},{tkw})",
        )
        origin_h, origin_w = tkh - 1, tkw - 1
        win_h, win_w = h - tkh + 1, w - tkw + 1
    elif trim_mode == "fftmap":
        # The direct engine's canvas for these data/kernel dims — the maps'
        # shape is user-visible (reference raw-output parity), so it must
        # match what fft_data would pick exactly.
        origin_h = origin_w = 0
        win_h, win_w = compute_fft_size(
            h, w, tkh, tkw, _resolve_policy(policy)
        )
        validate(
            win_h >= h + tkh - 1 and win_w >= w + tkw - 1,
            f"fftmap canvas ({win_h},{win_w}) does not cover the linear "
            f"extent ({h + tkh - 1},{w + tkw - 1}) — the circular maps "
            "would alias; use an FFT-size policy that pads to at least "
            "data + kernel − 1",
        )
    else:
        origin_h = origin_w = 0
        win_h = win_w = None
    re, im = fft_data_blocks(
        data_cf, block_h, block_w, max_kernel_h, max_kernel_w,
        origin_h, origin_w, win_h, win_w,
    )
    re, im = re.astype(store_t), im.astype(store_t)
    if not batched:
        re, im = re[0], im[0]
    return TiledSpectralData(
        re=re, im=im, block_h=block_h, block_w=block_w,
        max_kh=max_kernel_h, max_kw=max_kernel_w, data_h=h, data_w=w,
        origin_h=origin_h, origin_w=origin_w, win_h=win_h, win_w=win_w,
        fftmap_canvas=trim_mode == "fftmap",
    )


def fft_kernels(
    kernels,
    fft_h: int | None = None,
    fft_w: int | None = None,
    *,
    spectral: SpectralData | TiledSpectralData | None = None,
    feature_dim: int | None = None,
    correlation: bool = False,
    device=None,
    kernel_layout: str = "corner",
    storage: str = "auto",
    store_dtype: str = "float32",
) -> SpectralKernels:
    """Precompute a kernel bank's spectra at a fixed FFT size.

    Beyond the reference (which re-runs kernel FFTs every call,
    src/cudaConvFFTData.cu:191-282) — amortizes the bank FFT across an image
    stream. Pass either explicit (fft_h, fft_w) or the ``SpectralData`` the
    bank will be used against.

    ``storage``: 'planar' keeps (N, F, fft_h, Wc) planes; 'flat' packs the
    spectral pixels into one axis (N, F, fft_h·Wc). 'auto' is planar.
    Flat banks serve the direct engine on a single device (sharding and
    the tiled engine take planar).

    ``kernel_layout``: 'corner' anchors kernels top-left (padData — the
    reference's built path); 'centered' wraps each kernel's center to the
    origin (padKernel, src/convolutionFFTkernel.cu:13-40) so conv maps come
    out un-shifted — mode='same' then needs no trim offset. Centered banks
    support mode 'fftmap'/'same' on the direct engine only, and require
    pre-flipped kernels for correlation (correlation=True is rejected).

    ``store_dtype='bfloat16'``: the bf16 serving tier (see ``fft_data``) —
    bank spectra stored bf16 (HALF the resident footprint: ~2× more kernels
    fit), MAC dots single-pass bf16 with f32 accumulation. Pair with
    bf16-stored data spectra."""
    store_t = _resolve_store_dtype(store_dtype)
    validate(
        kernel_layout in ("corner", "centered"),
        "kernel_layout must be 'corner' or 'centered'",
    )
    validate(
        storage in ("auto", "planar", "flat"),
        "storage must be 'auto', 'planar', or 'flat'",
    )
    centered = kernel_layout == "centered"
    validate(
        not (centered and storage == "flat"),
        "storage='flat' serves corner-anchored banks only",
    )
    validate(
        not (centered and correlation),
        "kernel_layout='centered' requires pre-flipped kernels "
        "(correlation=True is ambiguous for centered anchors — flip by "
        "hand like the reference demo, demoCudaConvolutionFFT.m:67-69)",
    )
    if isinstance(spectral, TiledSpectralData):
        fft_h, fft_w = spectral.block_h, spectral.block_w
        feature_dim = spectral.feature_dim
    elif spectral is not None:
        fft_h, fft_w = spectral.fft_h, spectral.fft_w
        feature_dim = spectral.feature_dim
    validate(
        fft_h is not None and fft_w is not None,
        "pass fft_h/fft_w or spectral=SpectralData",
    )
    kstack, khs, kws = _kernels_to_stack(kernels, feature_dim)
    # Ragged banks flip per-kernel here (the padded-stack flip displaces
    # smaller kernels); uniform banks keep the in-worker flip.
    kstack, correlation = _apply_correlation_flip(
        kstack, khs, kws, correlation
    )
    if device is not None:
        # gpuId parity (src/cudaConvolutionFFT.cu:84-89): explicit placement.
        kstack = jax.device_put(kstack, device)
    validate(
        max(khs) <= fft_h and max(kws) <= fft_w,
        f"kernel ({max(khs)},{max(kws)}) exceeds FFT dims ({fft_h},{fft_w}) "
        "(reference check src/cudaConvolutionFFT.cu:242-243)",
    )
    n, f = kstack.shape[0], kstack.shape[1]
    tiled_target = isinstance(spectral, TiledSpectralData)
    validate(
        not (tiled_target and storage == "flat"),
        "storage='flat' serves the direct engine; tiled block spectra "
        "take planar banks",
    )
    wc = fft_w // 2 + 1
    flat = storage == "flat"
    def _transform_chunk(chunk, s):
        # centered banks roll each kernel's own center to the origin —
        # they chunk through the same bounded loop below as corner banks
        # (shifts ride as a traced operand: ragged chunks share one
        # executable instead of recompiling per static-khs slice)
        if centered:
            e = s + chunk.shape[0]
            shifts = jnp.asarray(
                [(-(kh // 2), -(kw // 2))
                 for kh, kw in zip(khs[s:e], kws[s:e])]
            )
            return _fft_kernels_centered_worker(chunk, fft_h, fft_w, shifts)
        return _fft_kernels_worker(chunk, fft_h, fft_w, correlation)

    spectra_bytes = _bank_spectra_bytes(
        n, f, fft_h, fft_w, jnp.dtype(store_t).itemsize
    )
    total = _device_memory_budget()
    if spectra_bytes > total // 4 and n > 1:
        # Chunk the forward transform so its temporaries stay bounded (big
        # DPM banks at large FFT sizes OOM otherwise). Chunks land in
        # DONATED plane accumulators — a concatenate would hold all chunks
        # plus the result live at once (2× the multi-GB bank, measured OOM).
        # Chunk size comes from what's LEFT after the resident accumulator:
        # each in-flight chunk holds its output planes plus ~3× that in
        # transform temporaries (Karatsuba + layout copies). No floor —
        # when residents leave less than total//8 free, a floored chunk
        # would oversubscribe memory (step>=1 below is the only minimum).
        avail = total - spectra_bytes - 2 * kstack.size * 4
        per_kernel = 8 * f * fft_h * wc  # transform temporaries are f32
        step = int(max(1, min(n, avail // (4 * per_kernel))))
        acc_shape = (n, f, fft_h * wc) if flat else (n, f, fft_h, wc)
        re = jnp.zeros(acc_shape, store_t)
        im = jnp.zeros(acc_shape, store_t)
        for s in range(0, n, step):
            c_re, c_im = _transform_chunk(
                kstack[s : s + min(step, n - s)], s
            )
            c_re, c_im = c_re.astype(store_t), c_im.astype(store_t)
            if flat:
                c_re = _flatten_bank_chunk(c_re)
                c_im = _flatten_bank_chunk(c_im)
            re, im = _write_bank_chunk(re, im, c_re, c_im, s)
            # Wait per chunk: queued chunk programs would all hold their
            # output buffers at once — the pile-up re-creates the 2×-bank
            # peak the donation avoids.
            if not isinstance(re, jax.core.Tracer):
                jax.block_until_ready(re)
    else:
        re, im = _transform_chunk(kstack, 0)
        re, im = re.astype(store_t), im.astype(store_t)
        if flat:
            re = _flatten_bank_chunk(re)
            im = _flatten_bank_chunk(im)
    return SpectralKernels(
        re=re, im=im, fft_h=fft_h, fft_w=fft_w, kernel_hs=khs,
        kernel_ws=kws, flat=flat, centered=centered,
    )


def _trim(
    maps: jnp.ndarray,  # (B, N, fft_h, fft_w)
    spectral: SpectralData,
    khs: tuple[int, ...],
    kws: tuple[int, ...],
    mode: str,
    batched: bool,
    same_offset: str = "scipy",
    centered: bool = False,
):
    """Slice the circular FFT maps down to the requested window.

    'fftmap' → raw maps (reference-parity). 'full' → top-left
    (H+Kh−1)×(W+Kw−1) (demoCudaConvolutionFFT.m:149); 'same' → centered H×W
    with offset ``same_offset``: 'scipy' = (Kh−1)//2 (scipy/numpy
    convention) or 'matlab' = Kh//2 (MATLAB conv2 — one pixel lower/right
    for even kernels); 'valid' → (H−Kh+1)×(W−Kw+1) starting at (Kh−1, Kw−1).
    Ragged banks return a list for modes whose window depends on kernel
    size. ``centered`` (kernel_layout='centered' spectra) → maps are
    un-shifted; 'same' is the plain top-left H×W block."""
    h, w = spectral.data_h, spectral.data_w
    if mode == "fftmap":
        out = maps
        return out if batched else out[0]
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    validate(
        not centered or mode == "same",
        "kernel_layout='centered' spectra support mode 'fftmap' or 'same' "
        "only (the 'full'/'valid' windows wrap circularly for centered "
        "anchors — use the default corner layout)",
    )
    if (
        mode == "same"
        and getattr(spectral, "clamp", False)
        and getattr(spectral, "band_h", -1) >= 0
    ):
        # The clamp band only serves 'same' edge outputs whose window
        # anchor matches the band it was sized for: bottom/right outputs
        # tap rows up to D−1+anchor (must be far-edge replicas, positions
        # [D, D+band)), and top/left outputs' negative taps wrap to the
        # last (K−1−anchor) rows (must be row-0 replicas, positions
        # >= D+band). A kernel/convention whose anchor falls outside
        # [band OK-range] silently reads the WRONG replica class — reject
        # it instead (reference rule: src/convolutionFFTkernel.cu:65-74).
        for kh, kw in zip(khs, kws):
            for kk, band, fft_l, d_l, ax in (
                (kh, spectral.band_h, spectral.fft_h, h, "H"),
                (kw, spectral.band_w, spectral.fft_w, w, "W"),
            ):
                anchor = (
                    kk // 2
                    if (centered or same_offset == "matlab")
                    else (kk - 1) // 2
                )
                validate(
                    anchor <= band <= fft_l - d_l - (kk - 1 - anchor),
                    f"padding='clamp' band mismatch on the {ax} axis: the "
                    f"spectra's far-edge band ({band}) does not serve a "
                    f"'same' window anchored at {anchor} (kernel {kk}, "
                    f"{'centered' if centered else same_offset} anchor). "
                    "Recompute fft_data(padding='clamp') with the same "
                    "same_offset/kernel_layout and max_kernel dims as "
                    "this call",
                )
    ragged = len(set(khs)) > 1 or len(set(kws)) > 1
    # Spectra with a baked output window (fft_data_tiled trim_mode) carry
    # the block-tiling origin: window coordinates below are 'full'-window
    # indices, shifted here into the maps' frame. A request matching the
    # baked window slices [0:rh] — a no-op XLA elides (zero trim copies).
    org_h = getattr(spectral, "origin_h", 0)
    org_w = getattr(spectral, "origin_w", 0)
    avail_h, avail_w = maps.shape[-2], maps.shape[-1]

    def window(kh, kw):
        if centered:  # un-shifted maps: 'same' = top-left H×W
            r = (0, 0, h, w)
        elif mode == "full":
            r = (0, 0, h + kh - 1, w + kw - 1)
        elif mode == "same":
            if same_offset == "matlab":
                r = (kh // 2, kw // 2, h, w)
            else:
                r = ((kh - 1) // 2, (kw - 1) // 2, h, w)
        else:  # valid
            validate(
                h >= kh and w >= kw, f"mode='valid' needs data >= kernel; "
                f"got data ({h},{w}), kernel ({kh},{kw})"
            )
            r = (kh - 1, kw - 1, h - kh + 1, w - kw + 1)
        r0, c0, rh, rw = r[0] - org_h, r[1] - org_w, r[2], r[3]
        validate(
            0 <= r0 and r0 + rh <= avail_h
            and 0 <= c0 and c0 + rw <= avail_w,
            f"mode='{mode}' window for kernel ({kh},{kw}) falls outside "
            "the window baked into these tiled spectra — recompute "
            "fft_data_tiled with trim_mode='full' (or the matching mode "
            "and kernel size)",
        )
        return r0, c0, rh, rw

    if not ragged:
        r0, c0, rh, rw = window(khs[0], kws[0])
        out = maps[:, :, r0 : r0 + rh, c0 : c0 + rw]
        return out if batched else out[0]
    outs = []
    for i, (kh, kw) in enumerate(zip(khs, kws)):
        r0, c0, rh, rw = window(kh, kw)
        m = maps[:, i, r0 : r0 + rh, c0 : c0 + rw]
        outs.append(m if batched else m[0])
    return outs


def _resolve_out_dtype(out_dtype):
    """Normalize the maps-output dtype option: None/'float32' → None
    (f32 maps, the default), 'bfloat16' → jnp.bfloat16 (half the output
    write traffic and in-flight serving bytes; ~4e-3 rounding on the
    scores — the same envelope as the bf16 spectra tier)."""
    validate(
        out_dtype in (None, "float32", "bfloat16"),
        f"out_dtype must be None, 'float32' or 'bfloat16', got {out_dtype!r}",
    )
    return None if out_dtype in (None, "float32") else jnp.bfloat16


def conv_spectral(
    spectral: SpectralData | TiledSpectralData,
    kernels,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    same_offset: str = "scipy",
    kernel_layout: str = "corner",
    out_dtype: str | None = None,
):
    """Convolve a kernel bank against a precomputed data spectrum —
    ≈ ``cudaConvFFTData(fftData, {kernels})`` (src/cudaConvFFTData.cu:24-282).

    ``kernels`` may be a list of (Kh, Kw, F) arrays (ragged ok), a stacked
    (N, Kh, Kw, F) array, or a precomputed ``SpectralKernels``. Returns
    per-kernel maps stacked (N, fft_h, fft_w) (batched: (B, N, ...)) for
    'fftmap', trimmed windows for 'full'/'same'/'valid' (list if ragged).

    A ``TiledSpectralData`` routes through the overlap-save engine
    (ops/tiled.py; linear-conv modes — plus 'fftmap' when the spectra
    baked the FFT canvas, ``fft_data_tiled(trim_mode='fftmap')``).

    ``same_offset``: 'scipy' = (Kh−1)//2 or 'matlab' = Kh//2 ('same' window
    offset — MATLAB conv2 parity for even kernels). ``kernel_layout``:
    see ``fft_kernels`` (centered banks → un-shifted maps; 'fftmap'/'same',
    direct engine only).

    ``out_dtype='bfloat16'``: store the output MAPS bf16 — the serving
    lever for score-map consumers (detection tolerates the ~4e-3
    rounding): half the output write traffic and half the in-flight bytes
    per frame, so a pipelined server holds twice the depth. Default
    None/'float32' keeps f32 maps."""
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    out_dt = _resolve_out_dtype(out_dtype)
    validate(
        not (getattr(spectral, "clamp", False) and mode == "full"),
        "padding='clamp' spectra pair with mode 'same', 'fftmap', or "
        "'valid' — a 'full' window mixes the far-edge band with the "
        "wrap-to-origin replicas",
    )
    if isinstance(spectral, TiledSpectralData):
        validate(
            kernel_layout == "corner"
            and not (
                isinstance(kernels, SpectralKernels) and kernels.centered
            ),
            "kernel_layout='centered' requires the direct engine "
            "(SpectralData) — tiled block decomposition assumes "
            "corner-anchored kernels",
        )
        return _conv_spectral_tiled(
            spectral, kernels, mode=mode, correlation=correlation,
            same_offset=same_offset,
            out_dtype=out_dtype,
        )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            sk.fft_h == spectral.fft_h and sk.fft_w == spectral.fft_w,
            f"SpectralKernels FFT dims ({sk.fft_h},{sk.fft_w}) != "
            f"SpectralData dims ({spectral.fft_h},{spectral.fft_w})",
        )
        validate(
            sk.feature_dim == spectral.feature_dim,
            f"feature dim mismatch: kernels {sk.feature_dim}, "
            f"data {spectral.feature_dim}",
        )
        validate(not correlation, "correlation must be baked into fft_kernels "
                 "when passing SpectralKernels")
        validate(
            sk.re.dtype == spectral.re.dtype,
            f"spectra store-dtype mismatch: kernels {sk.re.dtype}, data "
            f"{spectral.re.dtype} — precompute both sides with the same "
            "store_dtype ('bfloat16' tier pairs with a bf16 bank)",
        )
    else:
        # Giant banks: when the bank's RESIDENT spectra would take over
        # half the device budget, never materialize them — stream SPATIAL
        # kernels (tiny) and transform each chunk on the fly inside the
        # conv. This is the reference's own regime (per-kernel pad+FFT in
        # the loop, src/cudaConvFFTData.cu:191-282); resident spectra are
        # the amortization upgrade, used whenever they actually fit.
        kstack, khs, kws = _kernels_to_stack(
            kernels, spectral.feature_dim
        )
        validate(
            max(khs) <= spectral.fft_h and max(kws) <= spectral.fft_w,
            f"kernel ({max(khs)},{max(kws)}) exceeds FFT dims "
            f"({spectral.fft_h},{spectral.fft_w}) "
            "(reference check src/cudaConvolutionFFT.cu:242-243)",
        )
        n, f = int(kstack.shape[0]), int(kstack.shape[1])
        # Mirror fft_kernels' ACTUAL storage: the data spectra's store
        # dtype (the bf16 tier halves residency).
        resident_bytes = _bank_spectra_bytes(
            n, f, spectral.fft_h, spectral.fft_w,
            int(spectral.re.dtype.itemsize),
        )
        if (
            n > 1
            and kernel_layout == "corner"
            and resident_bytes > _device_memory_budget() // 2
        ):
            skc, corr = _apply_correlation_flip(
                kstack, khs, kws, correlation
            )
            return _conv_spectral_streaming_spatial(
                spectral, skc, khs, kws, mode=mode,
                correlation=corr,
                same_offset=same_offset, out_dtype=out_dtype,
            )
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            kernel_layout=kernel_layout,
            store_dtype=(
                "bfloat16"
                if spectral.re.dtype == jnp.bfloat16 else "float32"
            ),
        )
    if mode != "fftmap":
        # Linear-conv windows are only valid when the FFT dims cover
        # data + kernel − 1: a kernel larger than the maxK used to size
        # fft_data (but still ≤ FFT dims) would silently return circularly
        # aliased maps (the reference's FFT sizing guarantees this by
        # construction, src/cudaConvolutionFFT.cu:103-110).
        validate(
            spectral.data_h + max(sk.kernel_hs) - 1 <= spectral.fft_h
            and spectral.data_w + max(sk.kernel_ws) - 1 <= spectral.fft_w,
            f"kernel ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) too large for "
            f"linear convolution at FFT dims ({spectral.fft_h},"
            f"{spectral.fft_w}) with data ({spectral.data_h},"
            f"{spectral.data_w}): output would be circularly aliased. "
            "Recompute fft_data with larger max_kernel dims, or use "
            "mode='fftmap' for raw circular maps",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    # Memory safety: when the whole bank's products + maps don't fit the
    # device budget, transparently run the chunked pipeline (identical
    # results; the reference would simply OOM — its buffers are sized for
    # one kernel at a time, src/cudaConvolutionFFT.cu:116-127, at the cost
    # of no intra-bank batching at all).
    from cuda_fft_convolution_tpu.runtime.planner import plan_bank

    budget = _device_memory_budget()
    store_bytes = int(sk.re.dtype.itemsize)
    plan = plan_bank(
        sk.num_kernels, spectral.feature_dim, spectral.fft_h, spectral.fft_w,
        batch=spectral.batch_size, hbm_budget_bytes=budget,
        store_bytes=store_bytes,
    )
    try:
        if plan.chunk_size < sk.num_kernels:
            maps = _conv_from_spectra_chunked(
                d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w,
                plan.chunk_size, sk.flat,
            )
        else:
            maps = _conv_from_spectra(
                d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w,
                sk.flat,
            )
    except Exception as exc:  # noqa: BLE001 — annotate allocator failures
        if "RESOURCE_EXHAUSTED" in str(exc) or "Out of memory" in str(exc):
            raise MemoryError(
                f"{exc}\n[cuda_fft_convolution_tpu] the bank plan "
                f"(chunk_size={plan.chunk_size}, est. peak "
                f"{plan.peak_bytes >> 20} MiB) exceeded device memory — "
                "lower FFTCONV_HBM_FRACTION (e.g. 0.8) to force smaller "
                "chunks, or pass conv_spectral_pipelined(chunk_size=...)"
            ) from exc
        raise
    if out_dt is not None:
        # Cast the circular maps BEFORE the trim windows are sliced: under
        # jit the convert fuses into the inverse synthesis epilogue and the
        # trim copies move half the bytes.
        maps = maps.astype(out_dt)
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset, centered=sk.centered,
    )


def _conv_spectral_streaming_spatial(
    spectral: SpectralData,
    kstack: jnp.ndarray,  # (N, F, Kh, Kw) spatial
    khs: tuple,
    kws: tuple,
    *,
    mode: str,
    correlation: bool,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """conv_spectral tail for banks too large to hold as resident spectra:
    chunked on-the-fly transform + MAC + inverse (see
    _conv_from_spatial_chunked)."""
    if mode != "fftmap":
        validate(
            spectral.data_h + max(khs) - 1 <= spectral.fft_h
            and spectral.data_w + max(kws) - 1 <= spectral.fft_w,
            f"kernel ({max(khs)},{max(kws)}) too large for linear "
            f"convolution at FFT dims ({spectral.fft_h},{spectral.fft_w}) "
            f"with data ({spectral.data_h},{spectral.data_w}): output "
            "would be circularly aliased. Recompute fft_data with larger "
            "max_kernel dims, or use mode='fftmap' for raw circular maps",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    n, f = int(kstack.shape[0]), int(kstack.shape[1])
    b = d_re.shape[0]
    spec = spectral.fft_h * (spectral.fft_w // 2 + 1)  # spectral pixels
    pix = spectral.fft_h * spectral.fft_w
    # fixed residents: data spectra + full output maps + spatial bank
    fixed = 8 * b * f * spec + 4 * b * n * pix + kstack.size * 4
    # per streamed kernel (double-buffered): chunk spectra + products + map
    per_k = 2 * (8 * f * spec + 8 * b * spec + 8 * b * pix)
    budget = max(_device_memory_budget() - fixed, per_k)
    chunk = int(max(1, min(n, budget // per_k)))
    maps = _conv_from_spatial_chunked(
        d_re, d_im, kstack, spectral.fft_h, spectral.fft_w,
        chunk, correlation,
    )
    out_dt = _resolve_out_dtype(out_dtype)
    if out_dt is not None:
        maps = maps.astype(out_dt)
    return _trim(
        maps, spectral, khs, kws, mode, batched, same_offset=same_offset
    )


def _conv_spectral_tiled(
    spectral: TiledSpectralData,
    kernels,
    *,
    mode: str,
    correlation: bool,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """Overlap-save bank convolution against precomputed block spectra."""
    validate(
        mode != "fftmap" or spectral.fftmap_canvas,
        "mode='fftmap' (raw circular maps) needs spectra with the FFT "
        "canvas baked in — precompute with fft_data_tiled("
        "trim_mode='fftmap') or use the direct engine",
    )
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            not sk.flat,
            "flat-layout banks serve the direct engine; precompute with "
            "storage='planar' for tiled spectra",
        )
        validate(
            sk.fft_h == spectral.block_h and sk.fft_w == spectral.block_w,
            f"SpectralKernels FFT dims ({sk.fft_h},{sk.fft_w}) != block dims "
            f"({spectral.block_h},{spectral.block_w})",
        )
        validate(not correlation, "correlation must be baked into fft_kernels "
                 "when passing SpectralKernels")
        validate(
            sk.re.dtype == spectral.re.dtype,
            f"spectra store-dtype mismatch: kernels {sk.re.dtype}, data "
            f"{spectral.re.dtype} — precompute both sides with the same "
            "store_dtype ('bfloat16' tier pairs with a bf16 bank)",
        )
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=(
                "bfloat16"
                if spectral.re.dtype == jnp.bfloat16 else "float32"
            ),
        )
    validate(
        max(sk.kernel_hs) <= spectral.max_kh
        and max(sk.kernel_ws) <= spectral.max_kw,
        f"bank kernels up to ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) exceed "
        f"the tiled spectra's planned max ({spectral.max_kh},{spectral.max_kw})",
    )
    if mode == "fftmap":
        # Raw-map parity holds only while the linear extent fits the baked
        # canvas — a larger kernel's true circular map would wrap where
        # these maps stay zero (direct-engine check mirrored from
        # conv_spectral's linear-window validation).
        validate(
            spectral.data_h + max(sk.kernel_hs) - 1 <= spectral.win_h
            and spectral.data_w + max(sk.kernel_ws) - 1 <= spectral.win_w,
            f"kernel ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) exceeds the "
            f"fftmap canvas ({spectral.win_h},{spectral.win_w}) baked for "
            f"data ({spectral.data_h},{spectral.data_w}): the circular map "
            "would wrap. Recompute fft_data_tiled(trim_mode='fftmap') with "
            "larger trim_kernel dims",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    # Memory safety: when the whole bank's per-block products exceed the
    # device budget, run the bank in chunks (same transparency as the
    # direct engine's auto-chunking).
    chunk = _tiled_chunk_size(spectral, d_re, sk.num_kernels)
    maps = _tiled_chunked_maps(
        spectral, d_re, d_im, sk, chunk,
        out_dtype=out_dtype or "float32",
    )
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset,
    )


def _tiled_chunk_size(
    spectral: TiledSpectralData, d_re: jnp.ndarray, n: int
) -> int:
    """Bank chunk size for the tiled engine from an explicit memory model:
    per-kernel cost = MAC products + inverse temps over every block, plus
    its slice of the output maps; fixed cost = block + bank spectra + the
    full output allocation."""
    b, nbh, nbw = d_re.shape[0], d_re.shape[1], d_re.shape[2]
    f = spectral.feature_dim
    lh, wc = spectral.block_h, spectral.block_w // 2 + 1
    nb = b * nbh * nbw
    # Stored spectra scale with the serving tier (bf16 = 2-byte planes);
    # MAC products and inverse temps stay f32 — the chunked bf16 path runs
    # the upcast lowering, whose dot outputs are f32 (ops/spectral_mac.py).
    pair = 2 * d_re.dtype.itemsize
    per_kernel = 2 * nb * lh * wc * 8 + b * spectral.out_h * spectral.out_w * 4
    fixed = (
        nb * f * lh * wc * pair  # block spectra
        + n * f * lh * wc * pair  # bank spectra
        + b * n * spectral.out_h * spectral.out_w * 4  # output maps
    )
    budget = max(_device_memory_budget() - fixed, per_kernel)
    return max(1, min(n, budget // per_kernel))


def _tiled_chunked_maps(
    spectral: TiledSpectralData,
    d_re: jnp.ndarray,
    d_im: jnp.ndarray,
    sk: SpectralKernels,
    chunk_size: int,
    out_dtype: str = "float32",
) -> jnp.ndarray:
    """Run the bank through conv_blocks in ``chunk_size`` slices (one call
    when the whole bank fits). XLA's async dispatch overlaps consecutive
    chunks — the streams variant's role."""
    n = sk.num_kernels
    if chunk_size >= n:
        return conv_blocks(
            d_re, d_im, sk.re, sk.im, spectral.block_h, spectral.block_w,
            spectral.max_kh, spectral.max_kw,
            spectral.out_h, spectral.out_w,
            out_dtype=out_dtype,
        )
    outs = []
    for s in range(0, n, chunk_size):
        e = min(s + chunk_size, n)
        outs.append(
            conv_blocks(
                d_re, d_im, sk.re[s:e], sk.im[s:e],
                spectral.block_h, spectral.block_w,
                spectral.max_kh, spectral.max_kw,
                spectral.out_h, spectral.out_w,
                out_dtype=out_dtype,
            )
        )
    return jnp.concatenate(outs, axis=1)


def conv_spectral_pipelined(
    spectral: SpectralData | TiledSpectralData,
    kernels,
    *,
    chunk_size: int | None = None,
    mode: str = "fftmap",
    correlation: bool = False,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """Memory-bounded bank convolution — ≈ ``cudaConvFFTDataStreams``
    (src/cudaConvFFTDataStreams.cu): the bank is processed ``chunk_size``
    kernels at a time so product/output buffers stay bounded while XLA
    overlaps chunks (the reference's 2-streams-per-GPU double buffering,
    :292-327). Use for 1000+-filter banks on big images. Works on direct
    (SpectralData) and overlap-save (TiledSpectralData) spectra.

    ``chunk_size=None`` → the runtime planner sizes chunks from the device's
    memory budget (runtime/planner.py plan_bank — the decision the reference
    hard-codes as 2 slots)."""
    validate(mode in _MODES, f"mode must be one of {_MODES}")
    _resolve_out_dtype(out_dtype)  # validate early; threaded as a string
    validate(
        not (getattr(spectral, "clamp", False) and mode == "full"),
        "padding='clamp' spectra pair with mode 'same', 'fftmap', or "
        "'valid' — a 'full' window mixes the far-edge band with the "
        "wrap-to-origin replicas",
    )
    tiled = isinstance(spectral, TiledSpectralData)
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(not correlation, "correlation must be baked into fft_kernels "
                 "when passing SpectralKernels")
        validate(
            sk.re.dtype == spectral.re.dtype,
            f"spectra store-dtype mismatch: kernels {sk.re.dtype}, data "
            f"{spectral.re.dtype} — precompute both sides with the same "
            "store_dtype ('bfloat16' tier pairs with a bf16 bank)",
        )
    else:
        sk = fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            store_dtype=(
                "bfloat16"
                if spectral.re.dtype == jnp.bfloat16 else "float32"
            ),
        )
    if chunk_size is None:
        chunk_size = get_config().chunk_size
    if chunk_size is None:
        from cuda_fft_convolution_tpu.runtime.planner import plan_bank

        fft_h = spectral.block_h if tiled else spectral.fft_h
        fft_w = spectral.block_w if tiled else spectral.fft_w
        n_blocks = 1
        if tiled:
            n_blocks = int(np_prod_blocks(spectral))
        chunk_size = plan_bank(
            sk.num_kernels,
            spectral.feature_dim,
            fft_h,
            fft_w,
            batch=spectral.batch_size * n_blocks,
            store_bytes=int(sk.re.dtype.itemsize),
            hbm_budget_bytes=_device_memory_budget(),
        ).chunk_size
    validate(chunk_size >= 1, "chunk_size must be >= 1")
    chunk_size = min(chunk_size, sk.num_kernels)
    if tiled:
        validate(
            not sk.flat,
            "flat-layout banks serve the direct engine; precompute with "
            "storage='planar' for tiled spectra",
        )
        validate(
            not sk.centered,
            "kernel_layout='centered' requires the direct engine "
            "(SpectralData) — tiled block decomposition assumes "
            "corner-anchored kernels",
        )
        validate(
            mode != "fftmap" or spectral.fftmap_canvas,
            "mode='fftmap' (raw circular maps) needs spectra with the FFT "
            "canvas baked in — precompute with fft_data_tiled("
            "trim_mode='fftmap') or use the direct engine",
        )
        validate(
            max(sk.kernel_hs) <= spectral.max_kh
            and max(sk.kernel_ws) <= spectral.max_kw,
            f"bank kernels up to ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) "
            f"exceed the tiled spectra's planned max "
            f"({spectral.max_kh},{spectral.max_kw})",
        )
        validate(
            mode != "fftmap"
            or (
                spectral.data_h + max(sk.kernel_hs) - 1 <= spectral.win_h
                and spectral.data_w + max(sk.kernel_ws) - 1 <= spectral.win_w
            ),
            f"kernel ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) exceeds the "
            f"fftmap canvas ({spectral.win_h},{spectral.win_w}): the "
            "circular map would wrap — recompute fft_data_tiled("
            "trim_mode='fftmap') with larger trim_kernel dims",
        )
        batched = spectral.batched
        d_re = spectral.re if batched else spectral.re[None]
        d_im = spectral.im if batched else spectral.im[None]
        maps = _tiled_chunked_maps(
            spectral, d_re, d_im, sk, min(chunk_size, sk.num_kernels),
            out_dtype=out_dtype or "float32",
        )
        return _trim(
            maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
            same_offset=same_offset,
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    maps = _conv_from_spectra_chunked(
        d_re, d_im, sk.re, sk.im, spectral.fft_h, spectral.fft_w,
        chunk_size, sk.flat,
    )
    out_dt = _resolve_out_dtype(out_dtype)
    if out_dt is not None:
        maps = maps.astype(out_dt)
    return _trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset, centered=sk.centered,
    )


def np_prod_blocks(spectral: TiledSpectralData) -> int:
    shape = spectral.re.shape
    return int(shape[-5] * shape[-4])


def _bucket_ragged(kernels) -> list[list[int]] | None:
    """Group a ragged kernel list into size buckets (pow-2 envelope per
    axis). Returns per-bucket index lists in a stable order, or None when
    bucketing won't pay (≤1 bucket, or all buckets share one envelope).

    SURVEY.md §7 step 2: a cell array mixing 8² and 256² kernels should NOT
    pay 256²-sized FFTs for every kernel (the reference does exactly that —
    it only enforces kernels ≤ maxK, src/cudaConvolutionFFT.cu:242)."""
    def env(n):  # pow-2 envelope, floor 8 (tiny kernels share a bucket)
        return max(1 << (int(n) - 1).bit_length(), 8)

    keys = [(env(k.shape[0]), env(k.shape[1])) for k in kernels]
    if len(set(keys)) <= 1:
        return None
    buckets: dict = {}
    for i, key in enumerate(keys):
        buckets.setdefault(key, []).append(i)
    # Only split when it pays: at least one bucket's envelope is ≤ half the
    # global envelope on some axis (otherwise one FFT size serves all).
    gh = max(k[0] for k in keys)
    gw = max(k[1] for k in keys)
    if not any(k[0] * 2 <= gh or k[1] * 2 <= gw for k in buckets):
        return None
    return [idx for _, idx in sorted(buckets.items())]


def fft_conv(
    data,
    max_kernel_h: int | None = None,
    max_kernel_w: int | None = None,
    kernels=None,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    policy: FftSizePolicy | str | None = None,
    algorithm: str = "auto",
    device=None,
    bucket_ragged: bool = True,
    padding: str = "zero",
    kernel_layout: str = "corner",
    same_offset: str = "scipy",
    store_dtype: str = "float32",
    out_dtype: str | None = None,
):
    """One-shot bank convolution — ≈ ``cudaConvolutionFFT(data, maxKh, maxKw,
    kernelCell)`` (src/cudaConvolutionFFT.cu:27-310): one forward data FFT
    amortized across the whole bank, per-kernel spectral MAC + inverse FFT.
    ``device=`` mirrors the reference's optional gpuId argument
    (src/cudaConvolutionFFT.cu:84-89).

    ``max_kernel_h/w`` may be omitted (inferred from the bank; the reference
    requires them because it sizes buffers before reading the cell array).

    ``algorithm``: 'direct' = one image-sized FFT (the reference's engine);
    'tiled' = overlap-save block FFTs (ops/tiled.py — linear modes, plus
    'fftmap' via a baked FFT-size canvas whose raw maps match the direct
    engine's exactly); 'auto' = tiled when the planner says it pays.

    ``padding='clamp'`` replicates edge pixels through the pad band
    (padDataClampToBorder, src/convolutionFFTkernel.cu:46-76);
    ``kernel_layout='centered'`` wraps kernel centers to the origin
    (padKernel, :13-40) for un-shifted maps; ``same_offset='matlab'``
    selects MATLAB conv2's Kh//2 'same' offset (scipy's is (Kh-1)//2 — the
    conventions differ by one pixel for even kernels). The first two force
    the direct engine.

    ``store_dtype='bfloat16'``: the bf16 serving tier (see ``fft_data``) —
    all intermediate spectra run bf16 with f32 accumulation (half the
    spectral traffic; rel err ~1e-3 vs the fp32 tier's ≤1e-5).
    ``out_dtype='bfloat16'``: bf16 output MAPS (see ``conv_spectral``) —
    half the output write traffic; composable with either spectra tier."""
    validate(kernels is not None, "kernels is required")
    _resolve_out_dtype(out_dtype)  # validate early; threaded as a string
    validate(
        algorithm in ("auto", "direct", "tiled"),
        "algorithm must be 'auto', 'direct', or 'tiled'",
    )
    validate(padding in ("zero", "clamp"), "padding must be 'zero' or 'clamp'")
    validate(
        kernel_layout in ("corner", "centered"),
        "kernel_layout must be 'corner' or 'centered'",
    )
    if padding == "clamp" or kernel_layout == "centered":
        validate(
            algorithm != "tiled",
            "padding='clamp' / kernel_layout='centered' require the direct "
            "engine (algorithm='direct' or 'auto')",
        )
        algorithm = "direct"
    validate(
        padding != "clamp" or mode in ("same", "fftmap", "valid"),
        "padding='clamp' pairs with mode 'same', 'fftmap', or 'valid' — a "
        "'full' window mixes the far-edge band with the wrap-to-origin "
        "replicas (the pad regions exist to serve 'same' edge outputs, "
        "src/convolutionFFTkernel.cu:65-74)",
    )
    if (
        bucket_ragged
        and mode != "fftmap"  # fftmap's raw-map shape is FFT-size-defined
        and isinstance(kernels, (list, tuple))
        and len(kernels) > 1
    ):
        ks = [_as_array(k) for k in kernels]
        buckets = _bucket_ragged(ks)
        if buckets is not None:
            # Each bucket runs at its own FFT/block size (one extra data
            # FFT per bucket — cheap next to running every small kernel at
            # the giant bucket's FFT size); outputs merge in input order.
            results: list = [None] * len(ks)
            for idx in buckets:
                sub = [ks[i] for i in idx]
                out = fft_conv(
                    data, None, None, sub, mode=mode,
                    correlation=correlation, policy=policy,
                    algorithm=algorithm,
                    device=device, bucket_ragged=False,
                    padding=padding, kernel_layout=kernel_layout,
                    same_offset=same_offset, store_dtype=store_dtype,
                    out_dtype=out_dtype,
                )
                if not isinstance(out, list):  # uniform bucket → stacked
                    out = [out[..., i, :, :] for i in range(len(sub))]
                for i, o in zip(idx, out):
                    results[i] = o
            return results
    if max_kernel_h is None or max_kernel_w is None:
        if isinstance(kernels, (list, tuple)):
            max_kernel_h = max(int(k.shape[0]) for k in kernels)
            max_kernel_w = max(int(k.shape[1]) for k in kernels)
        else:
            karr = _as_array(kernels)
            kh_ax, kw_ax = (1, 2) if karr.ndim == 4 else (0, 1)
            max_kernel_h = int(karr.shape[kh_ax])
            max_kernel_w = int(karr.shape[kw_ax])

    if algorithm == "auto" and policy is not None and mode != "fftmap":
        # An explicitly pinned FFT-size policy (e.g. 'multiple16' for
        # reference parity) only applies to the direct engine for LINEAR
        # windows — the tiled engine's block geometry supersedes it, so
        # honor the pin rather than silently ignoring it. mode='fftmap'
        # stays on auto: there the policy sizes the output CANVAS, which
        # the tiled engine honors exactly (trim_kwargs below).
        algorithm = "direct"
    if algorithm != "direct":
        data_arr = _as_array(data)
        h, w = (
            (data_arr.shape[0], data_arr.shape[1])
            if data_arr.ndim == 3
            else (data_arr.shape[1], data_arr.shape[2])
        )
        plan = choose_block_plan(
            h, w, max_kernel_h, max_kernel_w,
            feature_dim=int(data_arr.shape[-1]),
            store_dtype=store_dtype,
        )
        if algorithm == "tiled" or plan is not None:
            # Uniform banks with a windowed mode: bake the window into the
            # block tiling so the engine writes 'same'/'valid' maps
            # directly — the trim slice becomes a no-op (saves a
            # full-output copy: 1.7 GB on the 2048²×100 headline).
            # mode='fftmap' bakes the direct engine's FFT canvas instead:
            # the raw circular maps ARE the 'full' maps zero-extended
            # (padding='zero'/'corner' guaranteed here — 'clamp'/'centered'
            # forced the direct engine above), so overlap-save serves
            # reference raw-output parity too.
            trim_kwargs = {}
            if mode == "fftmap":
                trim_kwargs = dict(
                    trim_mode="fftmap",
                    trim_kernel_h=max_kernel_h,
                    trim_kernel_w=max_kernel_w,
                    policy=policy,
                )
            elif mode in ("same", "valid"):
                # Bake the window at the ACTUAL uniform kernel shape — not
                # max_kernel_h/w, which callers may pass larger than the
                # kernels (the reference's buffer-sizing pattern,
                # src/cudaConvolutionFFT.cu:103-110): _trim requests the
                # window at the actual kernel size, and a max-sized baked
                # window would put that request out of range.
                if isinstance(kernels, (list, tuple)):
                    kshapes = {
                        (int(k.shape[0]), int(k.shape[1])) for k in kernels
                    }
                    uniform = len(kshapes) == 1
                    ukh, ukw = next(iter(kshapes))
                else:
                    karr = _as_array(kernels)
                    kh_ax, kw_ax = (1, 2) if karr.ndim == 4 else (0, 1)
                    uniform = True
                    ukh, ukw = int(karr.shape[kh_ax]), int(karr.shape[kw_ax])
                if uniform:
                    trim_kwargs = dict(
                        trim_mode=mode,
                        trim_kernel_h=ukh,
                        trim_kernel_w=ukw,
                        same_offset=same_offset,
                    )
            if plan is None:
                spectral = fft_data_tiled(
                    data, max_kernel_h, max_kernel_w, device=device,
                    store_dtype=store_dtype, **trim_kwargs,
                )
            else:
                # plan may enlarge the effective kernel envelope (aligned
                # valid window — see choose_block_plan); fft_data_tiled
                # stores the enlarged envelope as its planned max.
                lh, lw, pkh, pkw = plan
                spectral = fft_data_tiled(
                    data, pkh, pkw, block_h=lh, block_w=lw, device=device,
                    store_dtype=store_dtype, **trim_kwargs,
                )
            return conv_spectral(
                spectral, kernels, mode=mode, correlation=correlation,
                same_offset=same_offset,
                out_dtype=out_dtype,
            )
    # Reaching here: algorithm == 'direct', or 'auto' with the planner
    # declining to tile ('tiled' always returned above).
    spectral = fft_data(
        data, max_kernel_h, max_kernel_w, policy=policy, device=device,
        padding=padding, same_offset=same_offset,
        kernel_layout=kernel_layout, store_dtype=store_dtype,
    )
    return conv_spectral(
        spectral, kernels, mode=mode, correlation=correlation,
        same_offset=same_offset,
        kernel_layout=kernel_layout, out_dtype=out_dtype,
    )


# Jitted workers whose traced bodies read the global config (transform
# engine dispatch): registered so set_config invalidates their caches.
from cuda_fft_convolution_tpu.utils.config import register_jit_consumer  # noqa: E402

for _fn in (
    _fft_data_worker,
    _fft_kernels_worker,
    _conv_from_spectra,
    _conv_from_spectra_chunked,
):
    register_jit_consumer(_fn)
del _fn
