#!/usr/bin/env python
"""Benchmark harness. Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": ..., "vs_baseline": N, "card": ..., ...}

Headline config (BASELINE.json): 2048×2048 image × 100 kernels of 64×64,
fp32 — the library's recommended one-shot path (`fft_conv` with
algorithm='auto', 'same' maps), jit-wrapped end-to-end (the public API is
jit-transparent) so one call is one XLA program. Kernel FFTs are INCLUDED —
this is the cudaConvolutionFFT-equivalent workload.

``vs_baseline`` = measured throughput / the algorithm-independent memory
floor (read image + read bank + write output maps at the card's published
bandwidth, ``_PEAKS``). The reference publishes no numbers (SURVEY.md §6),
so this floor is the stable yardstick.

Every timing ends in ``jax.block_until_ready``. The JSON line names the
device as JAX reports it and the card's name and power limit as
``nvidia-smi`` reports them.

Rows (BASELINE.json configs):
  - configs[0/1] correctness: the accuracy check vs a float64 CPU FFT oracle
  - configs[2]: 2048² × 512² kernels (large-kernel/crossover regime)
  - configs[3]: batch of 8 × 100 kernels, pipelined/tiled
  - configs[4]: bf16 DPM/HOG — 4K image → HOG features (512²×31) → 1000+
    filter bank, fp32 spectral accumulation; plus the F=31 giant-bank
    DIRECT config.

Set BENCH_QUICK=1 to run only the headline + tiled + accuracy. BENCH_SMOKE=1
shrinks every row so the whole script runs on the CPU as a plumbing check
(tests/test_aux.py); it reports no roofline share.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np

# Published peaks of the cards this benchmark divides by, keyed by JAX's
# device_kind. Source: NVIDIA H100 Tensor Core GPU data sheet (SXM5, dense
# rates at the 700 W limit): 3.35 TB/s HBM3, 989 TFLOP/s bf16, 67 TFLOP/s
# fp32 outside the tensor cores.
_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_gbps": 3350.0, "bf16_tflops": 989.0, "fp32_tflops": 67.0,
    },
}


def device_peaks(device_kind: str) -> dict:
    """The published peaks of ``device_kind``; an unknown device is an
    error, never a default."""
    try:
        return _PEAKS[device_kind]
    except KeyError:
        raise KeyError(
            f"no published peaks for device_kind {device_kind!r}: add the "
            "card to bench._PEAKS with its data-sheet source"
        ) from None


def _time_fn(fn, *args, warmup=2, iters=5, sync_every=1) -> float:
    """Seconds per call of jitted ``fn``. ``sync_every`` > 1 dispatches
    that many calls before waiting (a streaming server's steady state) at
    the cost of holding that many working sets at once."""
    import jax

    for _ in range(warmup):
        jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    out = None
    for i in range(iters):
        out = fn(*args)
        if (i + 1) % sync_every == 0:
            jax.block_until_ready(out)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / iters


def _time_stream(stream, frame, iters=18, sync_every=9) -> float:
    """Steady-state serving through a stream runtime (RaggedConvStream):
    pipelined submits, a wait every ``sync_every`` frames.
    ``stream.depth`` must be >= sync_every."""
    stream.submit(frame).result()  # warmup
    stream.flush()
    t0 = time.perf_counter()
    fut = None
    done = 0
    while done < iters:
        for _ in range(min(sync_every, iters - done)):
            fut = stream.submit(frame)
            done += 1
        fut.result()
    return (time.perf_counter() - t0) / iters


def _r(v, nd=3):
    return None if v is None else round(v, nd)


def main() -> None:
    from cuda_fft_convolution_tpu.utils.compile_cache import (
        enable_compile_cache,
    )

    enable_compile_cache()
    import jax
    import jax.numpy as jnp

    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.utils.fft_size import compute_fft_size
    from cuda_fft_convolution_tpu.utils.profiling import card_description

    quick = os.environ.get("BENCH_QUICK", "0") == "1"
    smoke = os.environ.get("BENCH_SMOKE", "0") == "1"
    dev = jax.devices()[0]
    # a measurement needs a card this table knows; smoke runs only plumb
    peaks = None if smoke else device_peaks(dev.device_kind)
    jit = jax.jit

    rng = np.random.default_rng(0)
    if smoke:
        H = W = 256
        N, KH, KW, F = 10, 16, 16, 1
        ACC = 128           # accuracy-check image size
        BIGK, NB = 48, 2    # large-kernel regime
        BATCH_B, BATCH_HW = 2, 128
        IMG4K, NK, KD, NKD = 256, 16, 12, 8
    else:
        H = W = 2048
        N, KH, KW, F = 100, 64, 64, 1
        ACC = 512
        BIGK, NB = 512, 16
        BATCH_B, BATCH_HW = 8, 1024
        IMG4K, NK, KD, NKD = 4096, 1024, 12, 576
    data = jnp.asarray(rng.standard_normal((H, W, F)).astype(np.float32))
    kernels = jnp.asarray(rng.standard_normal((N, KH, KW, F)).astype(np.float32))
    jax.block_until_ready((data, kernels))
    gpix_filters = H * W * N / 1e9

    # --- accuracy vs a float64 CPU FFT oracle first, while memory is empty
    # (512²×8 kernels shares every code path incl. the tiled engine)
    dh = np.asarray(data[:ACC, :ACC, :])
    ks = np.asarray(kernels[:8, :, :, :])
    got = np.array(fc.fft_conv(dh, KH, KW, ks, mode="full"))
    oh, ow = ACC + KH - 1, ACC + KW - 1
    err = 0.0
    for i in range(ks.shape[0]):
        ref = np.zeros((oh, ow))
        for c in range(F):
            ref += np.real(
                np.fft.ifft2(
                    np.fft.fft2(dh[:, :, c].astype(np.float64), (oh, ow))
                    * np.fft.fft2(ks[i, :, :, c].astype(np.float64), (oh, ow))
                )
            )
        err = max(err, np.max(np.abs(got[i] - ref)) / np.max(np.abs(ref)))
    del got

    # --- headline: recommended one-shot, jit-fused end-to-end
    one_shot = jit(
        lambda d, k: fc.fft_conv(d, KH, KW, k, mode="same", algorithm="auto")
    )
    t_head = _time_fn(one_shot, data, kernels)
    v_head = gpix_filters / t_head

    # --- tiled amortized (block spectra + bank spectra precomputed; the
    # 'same' window is baked into the tiling — no trim copy)
    sdt = fc.fft_data_tiled(data, KH, KW, trim_mode="same")
    skt = fc.fft_kernels(kernels, spectral=sdt)
    jax.block_until_ready((sdt.re, skt.re))
    conv_t = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
    t_tiled = _time_fn(conv_t, sdt, skt)
    v_tiled = gpix_filters / t_tiled
    # steady-state serving: dispatches pipelined, a wait every 9th call
    t_stream = _time_fn(conv_t, sdt, skt, iters=18, sync_every=9)
    v_stream = gpix_filters / t_stream
    del sdt, skt

    v_fftmap = v_amort = v_bf16 = v_bf16_stream = v_batch = None
    v_bf16out_stream = None
    v_bigk = v_bigk_stream = v_dpm_direct = v_dpm = None
    v_dpm_direct_stream = None
    v_dpm_stream = None
    v_peaks = v_peaks_stream = peaks_stream_ms = None
    v_peaks_f32_stream = peaks_f32_stream_ms = None
    peaks_fetch_ms = maps_fetch_est_ms = None
    v_ragged = v_ragged_stream = v_dpmf8_stream = None
    v_dpm_bf16out = None
    if not quick:
        import gc

        # reference-parity one-shot: raw circular fftmaps ('auto' routes
        # these through the tiled engine with the FFT canvas baked in)
        fftmap_shot = jit(lambda d, k: fc.fft_conv(d, KH, KW, k, mode="fftmap"))
        v_fftmap = gpix_filters / _time_fn(fftmap_shot, data, kernels, iters=3)

        # amortized direct: precomputed data + kernel spectra (split API)
        sd = fc.fft_data(data, KH, KW)
        sk = fc.fft_kernels(kernels, spectral=sd)
        jax.block_until_ready((sd.re, sk.re))
        conv_d = jit(lambda s, k: fc.conv_spectral(s, k))
        v_amort = gpix_filters / _time_fn(conv_d, sd, sk, iters=3)
        del sd, sk

        # bf16 inputs, fp32 spectral accumulation: the bf16 serving tier
        # end-to-end (spectra stored bf16, f32 accumulation)
        bf16_shot = jit(
            lambda d, k: fc.fft_conv(
                d, KH, KW, k, mode="same", store_dtype="bfloat16"
            )
        )
        v_bf16 = gpix_filters / _time_fn(
            bf16_shot, data.astype(jnp.bfloat16),
            kernels.astype(jnp.bfloat16), iters=3,
        )
        # tier serving steady state: amortized bf16 spectra + deep pipeline
        sdt16 = fc.fft_data_tiled(
            data, KH, KW, trim_mode="same", store_dtype="bfloat16"
        )
        skt16 = fc.fft_kernels(
            kernels, spectral=sdt16, store_dtype="bfloat16"
        )
        jax.block_until_ready((sdt16.re, skt16.re))
        conv_16 = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
        t_bf16s = _time_fn(conv_16, sdt16, skt16, iters=18, sync_every=9)
        v_bf16_stream = gpix_filters / t_bf16s
        # composed serving tier: bf16 spectra + bf16 output maps
        conv_16b = jit(
            lambda s, k: fc.conv_spectral(
                s, k, mode="same", out_dtype="bfloat16"
            )
        )
        t_bf16sb = _time_fn(conv_16b, sdt16, skt16, iters=18, sync_every=9)
        v_bf16out_stream = gpix_filters / t_bf16sb
        del sdt16, skt16

        # batch of 8 images (BASELINE configs[3])
        bdata = jnp.asarray(
            rng.standard_normal(
                (BATCH_B, BATCH_HW, BATCH_HW, F)
            ).astype(np.float32)
        )
        sdb = fc.fft_data_tiled(bdata, KH, KW, trim_mode="same")
        skb = fc.fft_kernels(kernels, spectral=sdb)
        jax.block_until_ready((sdb.re, skb.re))
        conv_b = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
        t_batch = _time_fn(conv_b, sdb, skb, iters=3)
        v_batch = BATCH_B * BATCH_HW * BATCH_HW * N / 1e9 / t_batch
        del sdb, skb, bdata

        # BASELINE configs[4]: DPM/HOG detection — 4K image → HOG features
        # (512²×31, bf16) → 1000+ filter bank, fp32 spectral accumulation.
        from cuda_fft_convolution_tpu.models import hog_features

        img4k = jnp.asarray(
            rng.standard_normal((IMG4K, IMG4K)).astype(np.float32)
        )
        feats = jit(
            lambda im: hog_features(im, cell=8, bins=31).astype(jnp.bfloat16)
        )(img4k)
        jax.block_until_ready(feats)
        del img4k
        FD = 31
        dpm_bank = jnp.asarray(
            rng.standard_normal((NK, KD, KD, FD)).astype(np.float32)
        )
        dpm_gpixf = feats.shape[0] * feats.shape[1] * NK / 1e9

        # giant-bank DIRECT engine (F=31 bank spectra at the full 540² FFT
        # size), reference-parity fftmap output, bf16 serving tier; the
        # planner chunks the call when the bank does not fit.
        gc.collect()
        sdf = fc.fft_data(
            feats.astype(jnp.float32), KD, KD, store_dtype="bfloat16"
        )
        skf = fc.fft_kernels(
            dpm_bank[:NKD], spectral=sdf, store_dtype="bfloat16"
        )
        jax.block_until_ready(skf.re)
        conv_gd = jit(lambda s, k: fc.conv_spectral(s, k, mode="fftmap"))
        t_gd = _time_fn(conv_gd, sdf, skf, iters=2)
        v_dpm_direct = feats.shape[0] * feats.shape[1] * NKD / 1e9 / t_gd
        gc.collect()
        t_gds = _time_fn(conv_gd, sdf, skf, iters=12, sync_every=6)
        v_dpm_direct_stream = (
            feats.shape[0] * feats.shape[1] * NKD / 1e9 / t_gds
        )
        del sdf, skf

        # tiled amortized serving path (the production detector loop) at
        # the bf16 serving tier
        gc.collect()
        sdd = fc.fft_data_tiled(
            feats, KD, KD, trim_mode="same", store_dtype="bfloat16"
        )
        skd = fc.fft_kernels(
            dpm_bank, spectral=sdd, store_dtype="bfloat16"
        )
        jax.block_until_ready((sdd.re, skd.re))
        conv_dpm = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
        t_dpm = _time_fn(conv_dpm, sdd, skd, iters=3)
        v_dpm = dpm_gpixf / t_dpm
        t_dpms = _time_fn(conv_dpm, sdd, skd, iters=18, sync_every=9)
        v_dpm_stream = dpm_gpixf / t_dpms
        # bf16 OUTPUT maps: half the final write and the in-flight set
        conv_dpmb = jit(
            lambda s, k: fc.conv_spectral(
                s, k, mode="same", out_dtype="bfloat16"
            )
        )
        t_dpmb = _time_fn(conv_dpmb, sdd, skd, iters=24, sync_every=12)
        v_dpm_bf16out = dpm_gpixf / t_dpmb
        del sdd, skd, feats, dpm_bank

        # Detection head: per-kernel top-1 peaks over the headline config
        # at the bf16 serving tier, reported as equivalent GPix·F/s
        # against the same work the maps rows do.
        from cuda_fft_convolution_tpu.models import detect_peaks as _dp

        gc.collect()
        sdp = fc.fft_data_tiled(
            data, KH, KW, trim_mode="same", store_dtype="bfloat16"
        )
        skp = fc.fft_kernels(
            kernels, spectral=sdp, store_dtype="bfloat16",
            storage="planar", correlation=True,
        )
        jax.block_until_ready((sdp.re, skp.re))
        peaks_fn = jit(lambda s, k: _dp(s, k, mode="same"))
        t_pk = _time_fn(peaks_fn, sdp, skp, iters=3)
        v_peaks = gpix_filters / t_pk
        t_pks = _time_fn(peaks_fn, sdp, skp, iters=18, sync_every=9)
        v_peaks_stream = gpix_filters / t_pks
        peaks_stream_ms = t_pks * 1e3
        # End-to-end CONSUMPTION: a detection consumer fetches results to
        # host. Peaks fetch the full (vals, pos) tuples; the maps
        # equivalent is estimated from ONE kernel's map × N (labeled an
        # estimate).
        pvv, ppv = jax.block_until_ready(peaks_fn(sdp, skp))
        t0f = time.perf_counter()
        np.asarray(pvv), np.asarray(ppv)
        peaks_fetch_ms = (time.perf_counter() - t0f) * 1e3
        maps_out = jax.block_until_ready(conv_dpm(sdp, skp))
        t0f = time.perf_counter()
        np.asarray(maps_out[0])
        maps_fetch_est_ms = (time.perf_counter() - t0f) * 1e3 * N
        del maps_out, pvv, ppv, sdp, skp

        # fp32 peaks head
        sdp32 = fc.fft_data_tiled(data, KH, KW, trim_mode="same")
        skp32 = fc.fft_kernels(
            kernels, spectral=sdp32, storage="planar", correlation=True,
        )
        jax.block_until_ready((sdp32.re, skp32.re))
        t_pk32 = _time_fn(peaks_fn, sdp32, skp32, iters=18, sync_every=9)
        v_peaks_f32_stream = gpix_filters / t_pk32
        peaks_f32_stream_ms = t_pk32 * 1e3
        del sdp32, skp32

        # BASELINE configs[1]: small mixed-size filter bank sharing ONE
        # data FFT (the reference's cell-array scenario,
        # demoCudaConvolutionFFT.m:41-43) — 512² image × 16 kernels of 4
        # sizes; fft_conv buckets by shape, one data FFT per bucket size.
        rag_data = jnp.asarray(
            rng.standard_normal((512, 512, F)).astype(np.float32)
        )
        rag_cells = [
            jnp.asarray(
                rng.standard_normal((k, k, F)).astype(np.float32)
            )
            for k in (9, 17, 33, 64) for _ in range(4)
        ]
        jax.block_until_ready(rag_data)
        rag_fn = jit(
            lambda d: jnp.concatenate([
                jnp.ravel(o) for o in fc.fft_conv(
                    d, kernels=rag_cells, mode="same"
                )
            ])
        )
        t_rag = _time_fn(rag_fn, rag_data, iters=3)
        v_ragged = (512 * 512 * len(rag_cells) / 1e9) / t_rag
        # steady-state counterpart: the serving RUNTIME — RaggedConvStream
        # holds per-shape-group plans with the bank spectra resident and
        # compiles every group's pipeline into ONE dispatch per frame.
        rag_stream = fc.RaggedConvStream(
            (512, 512, F), rag_cells, depth=12, algorithm="direct",
            mode="same",
        )
        t_rags = _time_stream(
            rag_stream, rag_data, iters=24, sync_every=12
        )
        v_ragged_stream = (512 * 512 * len(rag_cells) / 1e9) / t_rags
        rag_stream.flush()
        del rag_data, rag_cells, rag_stream

        # F=8 serving row: 1024² × 64 kernels of 32², F=8, bf16 tier.
        f8_data = jnp.asarray(
            rng.standard_normal((1024, 1024, 8)).astype(np.float32)
        )
        f8_bank = jnp.asarray(
            rng.standard_normal((64, 32, 32, 8)).astype(np.float32)
        )
        sd8 = fc.fft_data_tiled(
            f8_data, 32, 32, trim_mode="same", store_dtype="bfloat16"
        )
        sk8 = fc.fft_kernels(
            f8_bank, spectral=sd8, store_dtype="bfloat16",
            storage="planar",
        )
        jax.block_until_ready((sd8.re, sk8.re))
        f8_fn = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
        t_f8 = _time_fn(f8_fn, sd8, sk8, iters=18, sync_every=9)
        v_dpmf8_stream = (1024 * 1024 * 64 / 1e9) / t_f8
        del sd8, sk8, f8_data, f8_bank

        # BASELINE configs[2]: large-kernel regime, 2048² × a bank of 16
        # 512² kernels (FFT-vs-direct crossover), one-shot and amortized.
        gc.collect()
        kbig = jnp.asarray(
            rng.standard_normal((NB, BIGK, BIGK, F)).astype(np.float32)
        )
        bigk_shot = jit(
            lambda d, k: fc.fft_conv(d, BIGK, BIGK, k, mode="same")
        )
        t_bigk = _time_fn(bigk_shot, data, kbig, iters=3)
        v_bigk = H * W * NB / 1e9 / t_bigk
        sdbk = fc.fft_data_tiled(data, BIGK, BIGK, trim_mode="same")
        skbk = fc.fft_kernels(kbig, spectral=sdbk)
        jax.block_until_ready((sdbk.re, skbk.re))
        conv_bk = jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
        t_bigks = _time_fn(conv_bk, sdbk, skbk, iters=16, sync_every=8)
        v_bigk_stream = H * W * NB / 1e9 / t_bigks
        del kbig, sdbk, skbk

    # --- algorithm-independent memory floor: any implementation must at
    # least read the image, read the bank, and write N 'same' maps.
    floor_bytes = (
        H * W * F * 4 + N * KH * KW * F * 4 + N * H * W * 4
    )
    if peaks is None:
        roofline = None
    else:
        roofline = gpix_filters / (floor_bytes / (peaks["hbm_gbps"] * 1e9))

    fft_h, fft_w = compute_fft_size(H, W, KH, KW, "fast")
    result = {
        "metric": "GPix*filters/s, one-shot fft_conv (jit-fused, auto engine), "
                  "2048^2 image x 100 64x64 kernels, fp32, 'same' maps",
        "value": round(v_head, 3),
        "unit": "GPix*filters/s",
        "vs_baseline": None if roofline is None else round(v_head / roofline, 4),
        "card": card_description(),
        "device": {
            "platform": dev.platform, "kind": dev.device_kind,
            "count": len(jax.devices()),
        },
        "smoke": smoke,
        "detail": {
            "headline_ms": round(t_head * 1e3, 3),
            "amortized_tiled_GPixF_s": round(v_tiled, 3),
            "amortized_tiled_ms": round(t_tiled * 1e3, 3),
            "streaming_tiled_GPixF_s": round(v_stream, 3),
            "hbm_floor_GPixF_s": _r(roofline),
            "direct_fft_size": [fft_h, fft_w],
            "max_rel_err_vs_f64_fft": float(f"{err:.3e}"),
            # full-run rows (BENCH_QUICK=1 skips → null):
            "fftmap_parity_GPixF_s": _r(v_fftmap),
            "amortized_direct_GPixF_s": _r(v_amort),
            "bf16_GPixF_s": _r(v_bf16),
            "bf16_streaming_GPixF_s": _r(v_bf16_stream),
            "bf16_bf16out_streaming_GPixF_s": _r(v_bf16out_stream),
            "batch8_1024_GPixF_s": _r(v_batch),
            "bigkernel_512_GPixF_s": _r(v_bigk),
            "bigkernel_streaming_GPixF_s": _r(v_bigk_stream),
            "dpm_hog_bf16_1024f_GPixF_s": _r(v_dpm),
            "dpm_hog_streaming_GPixF_s": _r(v_dpm_stream),
            "dpm_hog_bf16out_stream_GPixF_s": _r(v_dpm_bf16out),
            "detect_peaks_bf16_GPixF_s": _r(v_peaks),
            "detect_peaks_bf16_stream_GPixF_s": _r(v_peaks_stream),
            "detect_peaks_bf16_stream_ms_frame": _r(peaks_stream_ms, 2),
            "detect_peaks_f32_stream_GPixF_s": _r(v_peaks_f32_stream),
            "detect_peaks_f32_stream_ms_frame": _r(peaks_f32_stream_ms, 2),
            # end-to-end consumption: fetching results to host (the maps
            # figure is ONE map's fetch × N — labeled estimate)
            "peaks_result_fetch_ms": _r(peaks_fetch_ms, 2),
            "maps_result_fetch_est_ms": _r(maps_fetch_est_ms, 1),
            "ragged_bank16_GPixF_s": _r(v_ragged),
            "ragged_bank16_stream_GPixF_s": _r(v_ragged_stream),
            "dpm_f8_bf16_stream_GPixF_s": _r(v_dpmf8_stream),
            "dpm_direct_giantbank_GPixF_s": _r(v_dpm_direct),
            "dpm_direct_streaming_GPixF_s": _r(v_dpm_direct_stream),
        },
    }
    print(json.dumps(result))


if __name__ == "__main__":
    main()
