"""Ahead-of-time compiled convolution plans — the cufftPlanMany analogue.

The reference builds cuFFT plans once per call and reuses them across the
kernel loop (src/cudaConvolutionFFT.cu:128-142); a serving system would want
them cached across calls. ``FftConvPlan`` is that object for XLA: geometry
is fixed at construction, the three stages (data FFT, kernel-bank FFT,
MAC+inverse) are ``jax.jit(...).lower(...).compile()``d up front, and
``execute`` is pure dispatch — no tracing, no compilation, stable latency.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from cuda_fft_convolution_tpu.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_tpu.ops.spectral_mac import spectral_mac_planes
from cuda_fft_convolution_tpu.utils.errors import validate
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy, compute_fft_size


@dataclasses.dataclass(frozen=True)
class FftConvPlan:
    """Compiled executables for a fixed (data, bank) geometry.

    Produced by ``make_plan``. ``execute(data, kernels)`` takes channel-last
    host/device arrays of exactly the planned shapes and returns the stacked
    (N, fft_h, fft_w) conv maps ((B, N, ...) if batched).
    """

    data_shape: tuple  # (H, W, F) or (B, H, W, F), API layout
    kernel_shape: tuple  # (N, Kh, Kw, F)
    fft_h: int
    fft_w: int
    kfft_aval: object  # ShapeDtypeStruct of each kernel-spectra plane
    # Stage executables, compiled lazily from ``_builders`` (3 zero-arg
    # ``lower().compile()`` thunks). ``make_plan`` forces all three up
    # front by default (the AOT contract: ``execute`` is pure dispatch);
    # ``lazy=True`` defers each to first use — the serving streams embed
    # ``trace_frame`` in their own fused jitted dispatch and never call
    # the data-FFT/conv executables, so eager builds would pay 2 wasted
    # compiles per plan.
    _builders: tuple = None
    _data_fft_exec: object = None
    _kernel_fft_exec: object = None
    _conv_exec: object = None
    head: str | None = None  # None (maps) | 'peaks' | 'top_k' | 'local_peaks'
    # The TRACEABLE stage functions behind the compiled executables, for
    # embedding this plan's pipeline inside a larger jitted program (the
    # fused ragged dispatch, runtime/stream.RaggedConvStream): _trace_fn
    # is data → spectra planes → _conv_trace_fn(d_re, d_im, k_re, k_im)
    # → maps (batched internal layout) / head tuple.
    _data_fft_fn: object = None
    _conv_fn: object = None

    def _exec(self, field: str):
        e = getattr(self, field)
        if e is None:
            e = self._builders[
                ("_data_fft_exec", "_kernel_fft_exec", "_conv_exec").index(
                    field
                )
            ]()
            object.__setattr__(self, field, e)  # frozen-dataclass cache
        return e

    def compile_now(self) -> "FftConvPlan":
        """Force all three stage executables (no-op when already built);
        returns self. ``make_plan`` calls this unless ``lazy=True``."""
        self._exec("_data_fft_exec")
        self._exec("_kernel_fft_exec")
        self._exec("_conv_exec")
        return self

    def trace_frame(self, frame, kfft):
        """Traceable full per-frame pipeline at this plan's geometry —
        compose into a caller's own ``jax.jit`` (the compiled executables
        cannot be re-traced). Returns what ``execute_spectral`` returns."""
        dfft = self._data_fft_fn(frame)
        out = self._conv_fn(*dfft, *kfft)
        if len(self.data_shape) == 4:
            return out
        if self.head is None:
            return out[0]
        return jax.tree.map(lambda x: x[0], out)

    def data_fft(self, data):
        """Compiled ≈ cudaFFTData: (re, im) f32 plane pair
        (B, F, fft_h, wc) — split-plane spectra, like the whole library."""
        return self._exec("_data_fft_exec")(jnp.asarray(data, jnp.float32))

    def kernel_fft(self, kernels):
        return self._exec("_kernel_fft_exec")(
            jnp.asarray(kernels, jnp.float32)
        )

    def execute(self, data, kernels):
        """Compiled ≈ cudaConvolutionFFT for the planned geometry."""
        validate(
            tuple(data.shape) == self.data_shape,
            f"data shape {data.shape} != planned {self.data_shape}",
        )
        validate(
            tuple(kernels.shape) == self.kernel_shape,
            f"kernel shape {kernels.shape} != planned {self.kernel_shape}",
        )
        dfft = self.data_fft(data)
        kfft = self.kernel_fft(kernels)
        return self.execute_spectral(dfft, kfft)

    def execute_spectral(self, dfft, kfft):
        """Compiled ≈ cudaConvFFTData: MAC + inverse only (amortized path).
        ``dfft``/``kfft`` are the (re, im) plane pairs from data_fft /
        kernel_fft. With a baked ``head`` the compiled program returns
        ``(values, positions)`` instead of maps (see ``make_plan``)."""
        out = self._exec("_conv_exec")(*dfft, *kfft)
        if len(self.data_shape) == 4:
            return out
        if self.head is None:
            return out[0]
        return jax.tree.map(lambda x: x[0], out)


def _head_wrap(conv_fn, head, head_k, head_window, head_threshold):
    """Wrap a maps-producing ``_conv`` with the selected detection head
    BEFORE lowering, so the reduction compiles into the same program
    (maps stay an XLA intermediate). ``conv_fn`` yields (B, N, h, w) on
    both engines; the wrapped program yields ``(values, positions)``."""
    if head is None:
        return conv_fn
    from cuda_fft_convolution_tpu.ops.tiled import (
        local_peaks_from_maps,
        peaks_from_maps,
        top_k_from_maps,
    )

    def _conv_head(d_re, d_im, k_re, k_im):
        maps = conv_fn(d_re, d_im, k_re, k_im)
        if head == "peaks":
            vals, ys, xs = peaks_from_maps(maps)
        elif head == "top_k":
            vals, ys, xs = top_k_from_maps(maps, int(head_k))
        else:
            vals, ys, xs = local_peaks_from_maps(
                maps, int(head_k), int(head_window), head_threshold
            )
        return vals, jnp.stack([ys, xs], axis=-1)

    return _conv_head


def make_plan(
    data_shape: tuple,
    kernel_shape: tuple,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
    correlation: bool = False,
    algorithm: str = "direct",
    mode: str = "fftmap",
    store_dtype: str = "float32",
    same_offset: str = "scipy",
    out_dtype: str | None = None,
    head: str | None = None,
    head_k: int = 1,
    head_window: int = 3,
    head_threshold: float | None = None,
    lazy: bool = False,
) -> FftConvPlan:
    """AOT-compile a plan for channel-last ``data_shape`` ((H, W, F) or
    (B, H, W, F)) against a uniform bank ``kernel_shape`` (N, Kh, Kw, F).

    ``algorithm='tiled'`` compiles the overlap-save engine instead (block
    spectra); ``mode`` picks the output window baked into the compiled
    program — 'fftmap' bakes the direct engine's FFT canvas so the tiled
    program emits reference-parity raw circular maps; the linear windows
    ('full'/'same'/'valid', with ``same_offset`` convention) compile their
    static trim slice into the program on both engines.

    ``store_dtype='bfloat16'``: the bf16 serving tier (see api.fft_data) —
    plan spectra stored/exchanged bf16 with f32 accumulation; the plan's
    spectral ABI (data_fft/kernel_fft outputs, execute_spectral inputs)
    becomes bf16 plane pairs.

    ``out_dtype='bfloat16'``: bf16 output MAPS baked into the compiled
    program (see api.conv_spectral) — half the output write traffic and
    half the in-flight bytes per frame for a depth-bounded server.

    ``head``: bake a DETECTION head into the compiled program — the plan
    then returns ``(values, positions)`` instead of maps ('peaks' top-1:
    (N,)/(N, 2); 'top_k': (N, head_k)/(N, head_k, 2); 'local_peaks':
    thresholded window-local maxima, ``head_window``/``head_threshold``
    STATIC at plan build — serving cutoffs are plan config; use
    models.detect_local_peaks for a per-call traced threshold). The
    reduction fuses into the compiled program's epilogue: maps never
    leave the device, a served frame's in-flight working set drops from
    the full maps to (N, k) scalars (deeper pipelines for the same device
    memory, and a ~10⁴× smaller host fetch — the reference demo's consumer
    reads exactly these peak locations, demoCudaConvolutionFFT.m:58-61).

    ``lazy=True`` defers each stage's ``lower().compile()`` to its first
    use (``compile_now()`` forces them) — for callers like the serving
    streams that retrace the plan via ``trace_frame`` into their own
    fused dispatch and only ever invoke ``kernel_fft``."""
    validate(algorithm in ("direct", "tiled"), "algorithm: 'direct'|'tiled'")
    from cuda_fft_convolution_tpu.api import _resolve_out_dtype

    validate(
        head in (None, "peaks", "top_k", "local_peaks"),
        f"head must be None, 'peaks', 'top_k' or 'local_peaks'; got {head!r}",
    )
    if head is not None:
        validate(
            mode != "fftmap",
            "detection heads need a linear output window ('full'/'same'/"
            "'valid') — fftmap's circular frame has no meaningful peak "
            "positions",
        )
        validate(int(head_k) >= 1, f"head_k must be >= 1; got {head_k}")
        validate(
            int(head_window) >= 2,
            f"head_window must be >= 2; got {head_window}",
        )

    out_t = _resolve_out_dtype(out_dtype)
    validate(
        store_dtype in ("float32", "bfloat16"),
        "store_dtype must be 'float32' or 'bfloat16'",
    )
    store_t = jnp.float32 if store_dtype == "float32" else jnp.bfloat16
    if len(data_shape) == 3:
        h, w, f = data_shape
        b = 1
        batched = False
    else:
        b, h, w, f = data_shape
        batched = True
    n, kh, kw, kf = kernel_shape
    validate(kf == f, f"feature dim mismatch: data {f}, kernels {kf}")

    if algorithm == "tiled":
        from cuda_fft_convolution_tpu import api as _api
        from cuda_fft_convolution_tpu.ops.tiled import (
            choose_block_plan,
            fallback_block_fft,
        )
        from cuda_fft_convolution_tpu.types import SpectralKernels, TiledSpectralData

        # static block geometry, resolved once on host (the plan may
        # enlarge the effective kernel envelope — aligned valid window)
        plan = choose_block_plan(h, w, kh, kw, feature_dim=f,
                                 store_dtype=store_dtype)
        if plan is None:
            block_h, block_w = fallback_block_fft(kh, kw)
            pkh, pkw = kh, kw
        else:
            block_h, block_w, pkh, pkw = plan
        # mode='fftmap' bakes the direct engine's FFT canvas into the block
        # tiling (fft_data_tiled trim_mode='fftmap'): the compiled program
        # emits reference-parity raw circular maps at overlap-save speed.
        trim_kwargs = (
            dict(
                trim_mode="fftmap", trim_kernel_h=kh, trim_kernel_w=kw,
                policy=policy,
            )
            if mode == "fftmap"
            else {}
        )

        def _data_fft_t(data):
            sd = _api.fft_data_tiled(
                data, pkh, pkw, block_h=block_h, block_w=block_w,
                store_dtype=store_dtype, **trim_kwargs,
            )
            return sd.re, sd.im

        def _kernel_fft_t(kernels):
            sk = _api.fft_kernels(
                kernels, fft_h=block_h, fft_w=block_w,
                correlation=correlation, store_dtype=store_dtype,
                storage="planar",  # 'auto' may pick flat (rank-3) on big
                # banks; _conv_exec is lowered against 4-D planar avals
            )
            return sk.re, sk.im

        if mode == "fftmap":
            from cuda_fft_convolution_tpu.api import _resolve_policy

            canvas = compute_fft_size(h, w, kh, kw, _resolve_policy(policy))
        else:
            canvas = (None, None)

        def _conv(d_re, d_im, k_re, k_im):
            # always batched internally; execute_spectral unwraps
            sd = TiledSpectralData(
                re=d_re if d_re.ndim == 6 else d_re[None],
                im=d_im if d_im.ndim == 6 else d_im[None],
                block_h=block_h, block_w=block_w,
                max_kh=pkh, max_kw=pkw, data_h=h, data_w=w,
                win_h=canvas[0], win_w=canvas[1],
                fftmap_canvas=mode == "fftmap",
            )
            sk = SpectralKernels(
                re=k_re, im=k_im, fft_h=block_h, fft_w=block_w,
                kernel_hs=(kh,) * n, kernel_ws=(kw,) * n,
            )
            return _api.conv_spectral(
                sd, sk, mode=mode,
                same_offset=same_offset, out_dtype=out_dtype,
            )

        data_aval = jax.ShapeDtypeStruct(data_shape, jnp.float32)
        kern_aval = jax.ShapeDtypeStruct(kernel_shape, jnp.float32)
        dfft_avals = jax.eval_shape(_data_fft_t, data_aval)
        kfft_aval = jax.ShapeDtypeStruct(
            (n, f, block_h, block_w // 2 + 1), store_t
        )
        conv_fn = _head_wrap(_conv, head, head_k, head_window,
                             head_threshold)
        p = FftConvPlan(
            data_shape=tuple(data_shape),
            kernel_shape=tuple(kernel_shape),
            fft_h=block_h,
            fft_w=block_w,
            kfft_aval=kfft_aval,
            _builders=(
                lambda: jax.jit(_data_fft_t).lower(data_aval).compile(),
                lambda: jax.jit(_kernel_fft_t).lower(kern_aval).compile(),
                lambda: jax.jit(conv_fn)
                .lower(*dfft_avals, kfft_aval, kfft_aval)
                .compile(),
            ),
            head=head,
            _data_fft_fn=_data_fft_t,
            _conv_fn=conv_fn,
        )
        return p if lazy else p.compile_now()

    fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    wc = fft_w // 2 + 1
    validate(
        mode in ("fftmap", "full", "same", "valid"),
        "mode must be 'fftmap', 'full', 'same', or 'valid'",
    )
    validate(
        same_offset in ("scipy", "matlab"),
        "same_offset must be 'scipy' or 'matlab'",
    )
    # Linear windows are static for a uniform bank — bake the trim slice
    # into the compiled program (offsets follow api._trim exactly).
    if mode == "full":
        win = (0, 0, h + kh - 1, w + kw - 1)
    elif mode == "same":
        off = (kh // 2, kw // 2) if same_offset == "matlab" else (
            (kh - 1) // 2, (kw - 1) // 2
        )
        win = (off[0], off[1], h, w)
    elif mode == "valid":
        validate(
            h >= kh and w >= kw,
            f"mode='valid' needs data >= kernel; got data ({h},{w}), "
            f"kernel ({kh},{kw})",
        )
        win = (kh - 1, kw - 1, h - kh + 1, w - kw + 1)
    else:
        win = None

    def _data_fft(data):
        x = (
            jnp.transpose(data, (0, 3, 1, 2))
            if batched
            else jnp.transpose(data, (2, 0, 1))[None]
        )
        re, im = rfft2_padded_planes(x, fft_h, fft_w)
        return re.astype(store_t), im.astype(store_t)

    def _kernel_fft(kernels):
        ks = jnp.transpose(kernels, (0, 3, 1, 2))
        if correlation:
            ks = ks[..., ::-1, ::-1]
        re, im = rfft2_padded_planes(ks, fft_h, fft_w)
        return re.astype(store_t), im.astype(store_t)

    def _conv(d_re, d_im, k_re, k_im):
        # AOT plans are single whole-bank dots (unchunked) — the native
        # bf16 MAC lowering applies at the tier; products store bf16 so
        # the inverse dots halve their bytes (api._products_like).
        p_re, p_im = spectral_mac_planes(d_re, d_im, k_re, k_im)
        p_re, p_im = p_re.astype(store_t), p_im.astype(store_t)
        maps = irfft2_norm_planes(p_re, p_im, fft_h, fft_w)
        if out_t is not None:
            maps = maps.astype(out_t)
        if win is not None:
            r0, c0, rh, rw = win
            maps = maps[:, :, r0 : r0 + rh, c0 : c0 + rw]
        return maps

    f32 = jnp.float32
    data_aval = jax.ShapeDtypeStruct(data_shape, f32)
    kern_aval = jax.ShapeDtypeStruct(kernel_shape, f32)
    dfft_aval = jax.ShapeDtypeStruct((b, f, fft_h, wc), store_t)
    kfft_aval = jax.ShapeDtypeStruct((n, f, fft_h, wc), store_t)

    conv_fn = _head_wrap(_conv, head, head_k, head_window, head_threshold)
    p = FftConvPlan(
        data_shape=tuple(data_shape),
        kernel_shape=tuple(kernel_shape),
        fft_h=fft_h,
        fft_w=fft_w,
        kfft_aval=kfft_aval,
        _builders=(
            lambda: jax.jit(_data_fft).lower(data_aval).compile(),
            lambda: jax.jit(_kernel_fft).lower(kern_aval).compile(),
            lambda: jax.jit(conv_fn)
            .lower(dfft_aval, dfft_aval, kfft_aval, kfft_aval)
            .compile(),
        ),
        head=head,
        _data_fft_fn=_data_fft,
        _conv_fn=conv_fn,
    )
    return p if lazy else p.compile_now()
