"""Sharded filter-bank convolution over a device mesh.

Strategy (the reference's multi-GPU intent, done declaratively — SURVEY.md §2
parallelism table + §5 "distributed communication backend"):

  - **kernel axis**: the filter bank (N axis) is sharded across devices —
    the declarative form of the reference's round-robin of kernels over
    GPUs (src/cudaConvFFTDataStreams.cu:341-349).
  - **data axis**: the image batch (B axis) is sharded across devices —
    classic data parallelism (no reference analogue; it is single-image).
  - The data spectrum is *replicated* along the kernel axis — what the
    reference does imperatively with cudaMemcpyPeerAsync (:279-289), XLA
    expresses as a broadcast inserted automatically from the sharding
    specs and hands to NCCL (NVLink between the cards of one host).

Each device then runs the identical single-device program (spectral MAC +
inverse FFT) on its bank shard; results come back sharded over
(data, kernels) with zero cross-device math — bank convolution is
embarrassingly parallel over kernels, so scaling is linear in devices as
long as the replicated data FFT fits device memory.

Serving-grade dispatch: the jitted shard_map executable is CACHED, keyed on
(mesh, engine, static geometry) — repeat calls with same-shaped inputs are
pure dispatch, no retracing (the reference's streams variant likewise
builds its plans once and loops, src/cudaConvFFTDataStreams.cu:279-347).
Inputs already carrying the right sharding (e.g. a bank placed once via
``shard_kernel_bank``) are NOT re-placed.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from cuda_fft_convolution_tpu import api as _api
from cuda_fft_convolution_tpu.ops.conv import irfft2_norm_planes
from cuda_fft_convolution_tpu.ops.spectral_mac import spectral_mac_planes
from cuda_fft_convolution_tpu.ops.tiled import conv_blocks
from cuda_fft_convolution_tpu.types import (
    SpectralData,
    SpectralKernels,
    TiledSpectralData,
)
from cuda_fft_convolution_tpu.utils.errors import validate

DATA_AXIS = "data"
KERNEL_AXIS = "kernels"

# Incremented each time a sharded executable is BUILT (traced); tests assert
# repeat calls hit the cache (zero new traces).
TRACE_COUNT = 0


def make_mesh(
    data: int = 1,
    kernels: int | None = None,
    *,
    devices=None,
) -> Mesh:
    """Build a (data, kernels) mesh. ``kernels=None`` → use all remaining
    devices on the kernel axis (bank sharding is the primary scaling axis
    for this workload, as in the reference's kernel round-robin). Devices
    are laid out in the given order: the cards of one GPU host reach each
    other all to all over NVLink, so the order carries no topology."""
    if devices is None:
        devices = jax.devices()
    n = len(devices)
    if kernels is None:
        validate(n % data == 0, f"{n} devices not divisible by data={data}")
        kernels = n // data
    validate(
        data * kernels == n,
        f"mesh {data}x{kernels} != {n} available devices",
    )
    dev_mesh = np.asarray(devices, dtype=object).reshape(data, kernels)
    return Mesh(dev_mesh, (DATA_AXIS, KERNEL_AXIS))


def _pad_bank(re: jnp.ndarray, im: jnp.ndarray, shards: int):
    """Zero-pad the bank axis to a multiple of the kernel-axis size.

    Zero kernels convolve to zero maps — results are trimmed after. (The
    reference's round-robin simply leaves trailing slots idle,
    src/cudaConvFFTDataStreams.cu:353-360.)"""
    n = re.shape[0]
    n_pad = -(-n // shards) * shards
    if n_pad != n:
        pad = ((0, n_pad - n),) + ((0, 0),) * (re.ndim - 1)
        re, im = jnp.pad(re, pad), jnp.pad(im, pad)
    return re, im, n


def _placed(x: jnp.ndarray, sharding: NamedSharding) -> jnp.ndarray:
    """device_put unless ``x`` already carries exactly this sharding (a
    pre-sharded bank from shard_kernel_bank skips re-placement)."""
    cur = getattr(x, "sharding", None)
    if cur is not None and cur == sharding:
        return x
    return jax.device_put(x, sharding)


def shard_kernel_bank(sk: SpectralKernels, mesh: Mesh) -> SpectralKernels:
    """Place a kernel bank's spectra sharded over the mesh's kernel axis
    (pad-to-divisible included). Amortizes bank placement across calls —
    ``conv_spectral_sharded`` detects the sharding and skips re-placement.
    NOTE: the padded bank keeps its padded ``num_kernels``; kernel_hs/ws
    keep the true per-kernel sizes for trimming."""
    kshards = mesh.shape[KERNEL_AXIS]
    re, im, _ = _pad_bank(sk.re, sk.im, kshards)
    sharding = NamedSharding(mesh, P(KERNEL_AXIS, None, None, None))
    return SpectralKernels(
        re=jax.device_put(re, sharding),
        im=jax.device_put(im, sharding),
        fft_h=sk.fft_h,
        fft_w=sk.fft_w,
        kernel_hs=sk.kernel_hs,
        kernel_ws=sk.kernel_ws,
        centered=sk.centered,
    )


@functools.lru_cache(maxsize=64)
def _sharded_conv_exec(
    mesh: Mesh,
    ndim_d: int,
    tiled: bool,
    geom: tuple,
    chunk: int | None = None,
    out_dtype: str = "float32",
):
    """Build (once per key) the jitted shard_map executable for a bank
    convolution. The jit cache inside handles per-shape compilation; this
    cache removes the per-call closure rebuild that would defeat it.

    ``chunk`` (kernels per pipelined slice, from the per-device plan) bounds
    each device's product/output working set — the single-device path's
    auto-chunking (api.py plan_bank), applied to the LOCAL shard. None =
    whole shard in one pass."""
    global TRACE_COUNT
    TRACE_COUNT += 1
    dspec = P(*([DATA_AXIS] + [None] * (ndim_d - 1)))
    kspec = P(KERNEL_AXIS, None, None, None)

    if tiled:
        bh, bw, mkh, mkw, oh, ow = geom

        def _local_conv(d_re, d_im, k_re, k_im):
            # Per-device overlap-save on this device's bank shard; the block
            # spectra are replicated along the kernel axis via their
            # PartitionSpec (≈ the reference's peer-copy of the data FFT,
            # src/cudaConvFFTDataStreams.cu:279-289, as a sharding).
            ln = k_re.shape[0]
            step = ln if chunk is None else max(1, min(chunk, ln))
            outs = [
                conv_blocks(
                    d_re, d_im, k_re[s : s + step], k_im[s : s + step],
                    bh, bw, mkh, mkw, oh, ow,
                    out_dtype=out_dtype,
                )
                for s in range(0, ln, step)
            ]
            return outs[0] if len(outs) == 1 else jnp.concatenate(outs, axis=1)
    else:
        fft_h, fft_w = geom

        def _local_conv(d_re, d_im, k_re, k_im):
            # Per-device body: the exact single-device program on this
            # device's (batch-shard × bank-shard) block. No collectives —
            # bank convolution is embarrassingly parallel once the data
            # spectrum is in place; the replication of the data planes along
            # the kernel axis is expressed by their PartitionSpec.
            ln = k_re.shape[0]
            if chunk is not None and chunk < ln:
                maps = _api._conv_from_spectra_chunked(
                    d_re, d_im, k_re, k_im, fft_h, fft_w,
                    max(1, chunk),
                )
            else:
                p_re, p_im = spectral_mac_planes(d_re, d_im, k_re, k_im)
                maps = irfft2_norm_planes(p_re, p_im, fft_h, fft_w)
            if out_dtype != "float32":
                maps = maps.astype(jnp.dtype(out_dtype))
            return maps

    return jax.jit(
        jax.shard_map(
            _local_conv,
            mesh=mesh,
            in_specs=(dspec, dspec, kspec, kspec),
            out_specs=P(DATA_AXIS, KERNEL_AXIS, None, None),
        )
    )


@functools.lru_cache(maxsize=64)
def _sharded_stream_exec(
    mesh: Mesh,
    ndim_d: int,
    fft_h: int,
    fft_w: int,
    chunk: int,
    correlation: bool,
):
    """Streaming-spatial sharded executable: each device holds its SPATIAL
    kernel shard (tiny) and transforms/MACs/inverts it in ``chunk``-kernel
    slices — per-device peak memory = data spectra + output maps + one
    chunk.
    The sharded analogue of api._conv_spectral_streaming_spatial, for banks
    whose resident spectra exceed even a per-device budget (the regime the
    reference's per-kernel loop lives in, src/cudaConvFFTData.cu:191-282)."""
    global TRACE_COUNT
    TRACE_COUNT += 1
    dspec = P(*([DATA_AXIS] + [None] * (ndim_d - 1)))
    kspec = P(KERNEL_AXIS, None, None, None)

    def _local_conv(d_re, d_im, kstack):
        return _api._conv_from_spatial_chunked(
            d_re, d_im, kstack, fft_h, fft_w, chunk, correlation
        )

    return jax.jit(
        jax.shard_map(
            _local_conv,
            mesh=mesh,
            in_specs=(dspec, dspec, kspec),
            out_specs=P(DATA_AXIS, KERNEL_AXIS, None, None),
        )
    )


def conv_spectral_sharded(
    spectral: SpectralData,
    kernels,
    mesh: Mesh,
    *,
    mode: str = "fftmap",
    correlation: bool = False,
    same_offset: str = "scipy",
    out_dtype: str | None = None,
):
    """Bank convolution sharded over ``mesh`` — the multi-device
    ``conv_spectral``.

    Data spectrum: replicated along the kernel axis, sharded over the data
    axis when batched. Kernel bank: sharded over the kernel axis. Output maps
    come back sharded over (data, kernels) — downstream sharded consumers
    (e.g. detection NMS per filter) never gather them.

    Accepts a ``TiledSpectralData`` too: the overlap-save engine runs
    per-device on the bank shard (block spectra replicated like the direct
    spectrum).

    Memory planning mirrors the single-device path, per device: each
    device's shard is planned against the memory budget (runtime/planner.py)
    and runs chunked when the whole shard wouldn't fit; raw giant banks
    whose resident spectra exceed half the per-device budget never
    materialize spectra at all — the spatial kernels are sharded and each
    device streams its shard (transform + MAC + inverse per chunk)."""
    tiled = isinstance(spectral, TiledSpectralData)
    _api._resolve_out_dtype(out_dtype)  # validate; threaded as a string
    validate(
        not (getattr(spectral, "clamp", False) and mode == "full"),
        "padding='clamp' spectra pair with mode 'same', 'fftmap', or "
        "'valid' — a 'full' window mixes the far-edge band with the "
        "wrap-to-origin replicas",
    )
    kshards = mesh.shape[KERNEL_AXIS]
    budget = _api._device_memory_budget()
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(not correlation, "correlation must be baked into fft_kernels "
                 "when passing SpectralKernels")
        validate(
            not sk.flat,
            "flat-layout banks are a single-device direct-engine "
            "optimization; precompute with storage='planar' for sharding",
        )
        validate(
            sk.re.dtype == spectral.re.dtype,
            f"spectra store-dtype mismatch: kernels {sk.re.dtype}, data "
            f"{spectral.re.dtype} — precompute both sides with the same "
            "store_dtype ('bfloat16' tier pairs with a bf16 bank)",
        )
    else:
        if not tiled:
            # Giant raw banks: size the RESIDENT per-device spectra before
            # transforming anything; stream spatial shards when they exceed
            # half the per-device budget (same rule as api.conv_spectral).
            kstack, khs, kws = _api._kernels_to_stack(
                kernels, spectral.feature_dim
            )
            n, f = int(kstack.shape[0]), int(kstack.shape[1])
            per_dev_resident = _api._bank_spectra_bytes(
                -(-n // kshards), f, spectral.fft_h, spectral.fft_w,
                int(spectral.re.dtype.itemsize),  # tier-matched bank
            )
            if n > kshards and per_dev_resident > budget // 2:
                kstack, correlation = _api._apply_correlation_flip(
                    kstack, khs, kws, correlation
                )
                return _conv_sharded_streaming(
                    spectral, kstack, khs, kws, mesh,
                    mode=mode, correlation=correlation,
                    same_offset=same_offset,
                    budget=budget,
                )
        sk = _api.fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            storage="planar",  # 'auto' may pick flat: rank-3 spectra
            # can't take the 4-axis kernel PartitionSpec below
            store_dtype=(
                "bfloat16"
                if spectral.re.dtype == jnp.bfloat16 else "float32"
            ),
        )
    if tiled:
        validate(
            mode != "fftmap" or spectral.fftmap_canvas,
            "mode='fftmap' (raw circular maps) needs spectra with the FFT "
            "canvas baked in — precompute with fft_data_tiled("
            "trim_mode='fftmap') or use the direct engine",
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
        validate(
            sk.fft_h == spectral.block_h and sk.fft_w == spectral.block_w,
            "SpectralKernels FFT dims do not match the tiled block dims",
        )
        validate(
            not sk.centered,
            "kernel_layout='centered' requires the direct engine "
            "(SpectralData) — tiled block decomposition assumes "
            "corner-anchored kernels",
        )
        validate(
            max(sk.kernel_hs) <= spectral.max_kh
            and max(sk.kernel_ws) <= spectral.max_kw,
            f"bank kernels up to ({max(sk.kernel_hs)},{max(sk.kernel_ws)}) "
            f"exceed the tiled spectra's planned max "
            f"({spectral.max_kh},{spectral.max_kw})",
        )
        geom = (
            spectral.block_h, spectral.block_w,
            spectral.max_kh, spectral.max_kw,
            spectral.out_h, spectral.out_w,
        )
    else:
        validate(
            sk.fft_h == spectral.fft_h and sk.fft_w == spectral.fft_w,
            "SpectralKernels FFT dims do not match SpectralData",
        )
        geom = (spectral.fft_h, spectral.fft_w)

    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    b = d_re.shape[0]
    dshards = mesh.shape[DATA_AXIS]
    validate(
        b % dshards == 0,
        f"batch {b} not divisible by data-axis size {dshards}",
    )

    k_re, k_im, _ = _pad_bank(sk.re, sk.im, kshards)
    # True bank size: kernel_hs is never padded (shard_kernel_bank pads only
    # the spectra), so it recovers N even for a pre-padded bank.
    n = len(sk.kernel_hs)

    # Per-device execution plan (the single-device auto-chunking applied to
    # the local shard): chunk when one device's products + maps exceed its
    # budget share.
    from cuda_fft_convolution_tpu.runtime.planner import plan_bank

    local_n = k_re.shape[0] // kshards
    local_b = b // dshards
    if tiled:
        shape = d_re.shape
        n_blocks = int(shape[-5] * shape[-4])
        plan_fh, plan_fw = spectral.block_h, spectral.block_w
        plan_batch = local_b * n_blocks
    else:
        plan_fh, plan_fw = spectral.fft_h, spectral.fft_w
        plan_batch = local_b
    plan = plan_bank(
        local_n, spectral.feature_dim, plan_fh, plan_fw,
        batch=plan_batch, hbm_budget_bytes=budget,
        store_bytes=int(k_re.dtype.itemsize),
    )
    chunk = plan.chunk_size if plan.chunk_size < local_n else None

    dspec = P(*([DATA_AXIS] + [None] * (d_re.ndim - 1)))
    kspec = P(KERNEL_AXIS, None, None, None)
    dsh = NamedSharding(mesh, dspec)
    ksh = NamedSharding(mesh, kspec)
    d_re, d_im = _placed(d_re, dsh), _placed(d_im, dsh)
    k_re, k_im = _placed(k_re, ksh), _placed(k_im, ksh)

    exec_fn = _sharded_conv_exec(
        mesh, d_re.ndim, tiled, geom, chunk,
        out_dtype=out_dtype or "float32",
    )
    maps = exec_fn(d_re, d_im, k_re, k_im)[:, :n]
    return _api._trim(
        maps, spectral, sk.kernel_hs, sk.kernel_ws, mode, batched,
        same_offset=same_offset, centered=sk.centered,
    )


@functools.lru_cache(maxsize=64)
def _sharded_peaks_exec(
    mesh: Mesh, ndim_d: int, geom: tuple, k: int | None = None
):
    """Jitted shard_map executable for the sharded detection head: each
    device runs the peaks pipeline (ops/tiled.conv_blocks_peaks,
    or conv_blocks_top_k when ``k``) on its LOCAL bank shard — per-kernel
    detections are independent per kernel, so the head needs ZERO
    cross-device math; results come back sharded over (data, kernels)
    and are ~10⁴× smaller than maps, so even gathering them is free."""
    from cuda_fft_convolution_tpu.ops.tiled import (
        conv_blocks_peaks,
        conv_blocks_top_k,
    )

    global TRACE_COUNT
    TRACE_COUNT += 1
    bh, bw, mkh, mkw, oh, ow = geom
    dspec = P(*([DATA_AXIS] + [None] * (ndim_d - 1)))
    kspec = P(KERNEL_AXIS, None, None, None)

    def _local_peaks(d_re, d_im, k_re, k_im):
        if k is None:
            vals, ys, xs = conv_blocks_peaks(
                d_re, d_im, k_re, k_im, bh, bw, mkh, mkw, oh, ow
            )
        else:
            vals, ys, xs = conv_blocks_top_k(
                d_re, d_im, k_re, k_im, bh, bw, mkh, mkw, oh, ow, k
            )
        return vals, ys.astype(jnp.int32), xs.astype(jnp.int32)

    ospec = (
        P(DATA_AXIS, KERNEL_AXIS)
        if k is None
        else P(DATA_AXIS, KERNEL_AXIS, None)
    )
    return jax.jit(
        jax.shard_map(
            _local_peaks,
            mesh=mesh,
            in_specs=(dspec, dspec, kspec, kspec),
            out_specs=(ospec, ospec, ospec),
        )
    )


def detect_peaks_sharded(
    spectral: TiledSpectralData,
    kernels,
    mesh: Mesh,
    *,
    correlation: bool = True,
    k: int | None = None,
):
    """Multi-device detection head: per-kernel top-1 ``(values,
    positions)`` with the bank sharded over ``mesh``'s kernel axis and the
    block spectra replicated along it (batch sharded over the data axis) —
    ``detect_peaks`` × ``conv_spectral_sharded`` composed.

    Each device reduces its bank shard's score maps on the device and
    contributes only a (B_local, N_local) peak tuple — there is no
    cross-device collective at all, and the gathered result is ~4 orders
    of magnitude smaller than the sharded maps ``conv_spectral_sharded``
    would return.

    ``spectral`` must be a :class:`TiledSpectralData` with a baked
    'same'/'valid' window (the peaks frame; fft_data_tiled
    ``trim_mode=``) or none (→ the kernel-'full' frame). ``kernels`` is a
    stacked uniform bank (N, Kh, Kw, F) or planar
    :class:`SpectralKernels` at the block geometry (pre-shard with
    ``shard_kernel_bank`` to amortize placement). Returns ``values``
    (B, N) | (N,) and ``positions`` (..., N, 2) int32 in the window
    frame, identical to single-device ``detect_peaks``.

    ``k`` (optional) switches the head to top-k per kernel — same
    semantics as :func:`models.detect_top_k` (exact), each device reducing
    its own bank shard: ``values`` (..., N, k), ``positions``
    (..., N, k, 2)."""
    validate(
        isinstance(spectral, TiledSpectralData),
        "detect_peaks_sharded takes TiledSpectralData (the peaks head is "
        "an overlap-save consumer; for direct spectra run "
        "conv_spectral_sharded and argmax the sharded maps)",
    )
    validate(k is None or int(k) >= 1, f"k must be >= 1; got {k}")
    if k is not None:
        k = int(k)
    validate(
        not spectral.fftmap_canvas,
        "fftmap's circular frame has no meaningful global peak position",
    )
    kshards = mesh.shape[KERNEL_AXIS]
    if isinstance(kernels, SpectralKernels):
        sk = kernels
        validate(
            not sk.flat and sk.fft_h == spectral.block_h
            and sk.fft_w == spectral.block_w,
            "SpectralKernels geometry/layout does not match the tiled "
            "spectra (planar at the block FFT size required)",
        )
        validate(
            sk.re.dtype == spectral.re.dtype,
            "spectra store-dtype mismatch between data and kernel bank",
        )
    else:
        sk = _api.fft_kernels(
            kernels, spectral=spectral, correlation=correlation,
            storage="planar",
            store_dtype=(
                "bfloat16"
                if spectral.re.dtype == jnp.bfloat16 else "float32"
            ),
        )
    validate(
        max(sk.kernel_hs) <= spectral.max_kh
        and max(sk.kernel_ws) <= spectral.max_kw,
        "bank kernels exceed the tiled spectra's planned envelope",
    )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    b = d_re.shape[0]
    dshards = mesh.shape[DATA_AXIS]
    validate(
        b % dshards == 0,
        f"batch {b} not divisible by data-axis size {dshards}",
    )
    k_re, k_im, _ = _pad_bank(sk.re, sk.im, kshards)
    n = len(sk.kernel_hs)
    if spectral.win_h is not None:
        out_h, out_w = spectral.out_h, spectral.out_w
    else:
        out_h = spectral.data_h + max(sk.kernel_hs) - 1
        out_w = spectral.data_w + max(sk.kernel_ws) - 1
    geom = (
        spectral.block_h, spectral.block_w,
        spectral.max_kh, spectral.max_kw, out_h, out_w,
    )
    dspec = P(*([DATA_AXIS] + [None] * (d_re.ndim - 1)))
    dsh = NamedSharding(mesh, dspec)
    ksh = NamedSharding(mesh, P(KERNEL_AXIS, None, None, None))
    d_re, d_im = _placed(d_re, dsh), _placed(d_im, dsh)
    k_re, k_im = _placed(k_re, ksh), _placed(k_im, ksh)
    exec_fn = _sharded_peaks_exec(mesh, d_re.ndim, geom, k)
    vals, ys, xs = exec_fn(d_re, d_im, k_re, k_im)
    vals, ys, xs = vals[:, :n], ys[:, :n], xs[:, :n]
    pos = jnp.stack([ys, xs], axis=-1)
    if batched:
        return vals, pos
    return vals[0], pos[0]


def _conv_sharded_streaming(
    spectral: SpectralData,
    kstack: jnp.ndarray,  # (N, F, Kh, Kw) spatial
    khs: tuple,
    kws: tuple,
    mesh: Mesh,
    *,
    mode: str,
    correlation: bool,
    same_offset: str,
    budget: int,
):
    """conv_spectral_sharded tail for giant raw banks: spatial kernels are
    sharded over the kernel axis and each device streams its shard through
    transform + MAC + inverse in planner-sized chunks — resident bank
    spectra never exist on any device."""
    if mode != "fftmap":
        validate(
            spectral.data_h + max(khs) - 1 <= spectral.fft_h
            and spectral.data_w + max(kws) - 1 <= spectral.fft_w,
            f"kernel ({max(khs)},{max(kws)}) too large for linear "
            f"convolution at FFT dims ({spectral.fft_h},{spectral.fft_w})",
        )
    batched = spectral.batched
    d_re = spectral.re if batched else spectral.re[None]
    d_im = spectral.im if batched else spectral.im[None]
    b = d_re.shape[0]
    dshards = mesh.shape[DATA_AXIS]
    kshards = mesh.shape[KERNEL_AXIS]
    validate(
        b % dshards == 0,
        f"batch {b} not divisible by data-axis size {dshards}",
    )
    n, f = int(kstack.shape[0]), int(kstack.shape[1])
    # pad the spatial bank axis to the shard count (zero kernels → zero maps)
    n_pad = -(-n // kshards) * kshards
    if n_pad != n:
        kstack = jnp.pad(
            kstack, ((0, n_pad - n), (0, 0), (0, 0), (0, 0))
        )
    local_n = n_pad // kshards
    local_b = b // dshards
    # per-device chunk size: same memory model as the single-device
    # streaming path (api._conv_spectral_streaming_spatial), on the shard
    spec = spectral.fft_h * (spectral.fft_w // 2 + 1)  # spectral pixels
    pix = spectral.fft_h * spectral.fft_w
    fixed = (
        8 * local_b * f * spec
        + 4 * local_b * local_n * pix
        + kstack.size * 4 // kshards
    )
    per_k = 2 * (8 * f * spec + 8 * local_b * spec + 8 * local_b * pix)
    chunk = int(max(1, min(local_n, max(budget - fixed, per_k) // per_k)))

    dspec = P(*([DATA_AXIS] + [None] * (d_re.ndim - 1)))
    dsh = NamedSharding(mesh, dspec)
    ksh = NamedSharding(mesh, P(KERNEL_AXIS, None, None, None))
    d_re, d_im = _placed(d_re, dsh), _placed(d_im, dsh)
    kstack = _placed(kstack, ksh)

    exec_fn = _sharded_stream_exec(
        mesh, d_re.ndim, spectral.fft_h, spectral.fft_w, chunk,
        correlation,
    )
    maps = exec_fn(d_re, d_im, kstack)[:, :n]
    return _api._trim(
        maps, spectral, khs, kws, mode, batched, same_offset=same_offset
    )
