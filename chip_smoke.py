#!/usr/bin/env python
"""Smoke run of the library's main path on one NVIDIA GPU, at full size.

    python chip_smoke.py          # phases b-e on one card
    python chip_smoke.py --four   # the mesh phase only, on four cards

Every phase drives the public entry points a user calls and compares the
result with the float64 numpy reference (``tests/oracles.py``):

  a. device check: the first JAX device must be a GPU; the card's name and
     power limit (nvidia-smi) are printed before any number.
  b. headline one-shot: ``fft_conv`` of a 2048x2048x1 fp32 image with 100
     kernels of 64x64, mode 'same'; plus mode 'fftmap' on the direct engine.
  c. amortized + serving: ``fft_data_tiled`` + ``fft_kernels`` +
     ``conv_spectral``, then a depth-3 ``ConvStream`` over 5 frames.
  d. DPM/HOG bf16 tier: a 4096^2 image -> ``hog_features`` (512^2 x 31) ->
     a bank of 1024 filters of 12x12x31 stored bfloat16, through
     ``conv_spectral`` and ``detect_peaks``.
  e. ragged cell array + gradient: ``RaggedConvStream`` (16 cells of
     9/17/33/64 on a 512^2 image), three ``train_step`` SGD steps of a
     ``FilterBankDetector``, and the tiled engine's gradient against the
     direct engine's.

``--four``: ``conv_spectral_sharded``, ``ShardedConvStream`` and
``detect_peaks_sharded`` with the phase-d bank sharded over a (data,
kernels) = (1, 4) mesh, and a sharded training step on a (2, 2) mesh, each
against the single-card result.

Each phase prints its compile seconds, one timed call (host clock around
``block_until_ready``), its error against the reference with the tolerance
and precision used, and ``peak_bytes_in_use``. The last line of standard
output is one JSON object, printed only when every phase passed. With no
GPU the script exits non-zero before any phase runs.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

_ROOT = os.path.dirname(os.path.abspath(__file__))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


def _load_oracles():
    """tests/oracles.py by path: an installed package named ``tests`` must
    not shadow the repository's reference."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(
        "fftconv_oracles", os.path.join(_ROOT, "tests", "oracles.py")
    )
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


oracles = _load_oracles()

# Tolerances: max |got - want| / max |want| against the float64 reference.
# fp32 tier: cuFFT in fp32 and the spectral MAC at Precision.HIGHEST keep
# ~1e-7; 1e-5 is the library's fp32 accuracy bar.
FP32_TOL = 1e-5
# bf16 tier: spectra stored bfloat16 (8 mantissa bits, ~4e-3 per value) with
# f32 accumulation; the bar of tests/test_bf16_tier.py.
BF16_TOL = 2e-2
# Two fp32 results of the same math on different engines or device counts
# (tiled vs direct gradient; sharded vs one card): only the order of the f32
# sums differs, so they agree far inside the fp32 bar.
SAME_MATH_TOL = 1e-5
# bf16-tier results on different device counts: the per-shard MAC may sum in
# another order, and a product spectrum then rounds to bfloat16 one ulp
# (~4e-3 of that value) apart; spread over a block's inverse FFT that stays
# far below 1e-3 of the map's peak.
BF16_SAME_MATH_TOL = 1e-3


class PhaseError(AssertionError):
    """A phase's result is wrong or a check failed."""


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise PhaseError(msg)


def _peak_bytes(device=None):
    import jax

    dev = device if device is not None else jax.devices()[0]
    stats = dev.memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def _rel(got, want) -> float:
    return oracles.rel_err(got, want)


def _jrel(got, want) -> float:
    """Relative error of two device arrays, reduced on the device."""
    import jax.numpy as jnp

    got = jnp.asarray(got, jnp.float32)
    want = jnp.asarray(want, jnp.float32)
    return float(jnp.max(jnp.abs(got - want)) / jnp.max(jnp.abs(want)))


def _compile_and_time(fn, *args):
    """(result, compile seconds, one timed call in seconds) for a jitted
    ``fn``: compile ahead of time, run once to warm, time one call."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn).lower(*args).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*args))
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*args))
    return out, compile_s, time.perf_counter() - t0


def _report(card: str, phase: str, **fields) -> dict:
    fields = {"phase": phase, "card": card, **fields}
    print(json.dumps(fields, default=float), flush=True)
    return fields


def _same_window(full: np.ndarray, kh: int, kw: int, h: int, w: int):
    """The library's 'same' window (scipy offset (K-1)//2) of a full map."""
    r0, c0 = (kh - 1) // 2, (kw - 1) // 2
    return full[r0 : r0 + h, c0 : c0 + w]


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------


def phase_headline(card: str, *, size=2048, n=100, k=64, n_check=4, seed=0):
    """(b) fft_conv 'same' on the headline shape, and 'fftmap' on the
    direct engine, each against the float64 reference on ``n_check``
    kernels. Returns the inputs and the 'same' maps for phase (c)."""
    import jax.numpy as jnp

    import cuda_fft_convolution_tpu as fc
    fft_conv_full_f64, fft_map_f64 = (
        oracles.fft_conv_full_f64, oracles.fft_map_f64
    )

    rng = np.random.default_rng(seed)
    data_np = rng.standard_normal((size, size, 1)).astype(np.float32)
    bank_np = rng.standard_normal((n, k, k, 1)).astype(np.float32)
    data, bank = jnp.asarray(data_np), jnp.asarray(bank_np)
    check = np.linspace(0, n - 1, n_check).astype(int)

    maps, compile_s, call_s = _compile_and_time(
        lambda d, b: fc.fft_conv(d, k, k, b, mode="same"), data, bank
    )
    _check(maps.shape == (n, size, size), f"same maps shape {maps.shape}")
    got = np.asarray(maps[check])
    err = max(
        _rel(got[j], _same_window(
            fft_conv_full_f64(data_np, bank_np[i]), k, k, size, size))
        for j, i in enumerate(check)
    )
    _check(err <= FP32_TOL, f"fft_conv same: rel err {err:.3e} > {FP32_TOL}")
    _report(card, "b_fft_conv_same", shape=list(maps.shape),
            compile_s=compile_s, call_s=call_s, max_rel_err=err,
            tol=FP32_TOL, precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            kernels_checked=check.tolist(), peak_bytes_in_use=_peak_bytes())

    fmap, compile_s, call_s = _compile_and_time(
        lambda d, b: fc.fft_conv(d, k, k, b, mode="fftmap",
                                 algorithm="direct"),
        data, bank,
    )
    fh, fw = fmap.shape[1:]
    got = np.asarray(fmap[check])
    err_m = max(
        _rel(got[j], fft_map_f64(data_np, bank_np[i], fh, fw))
        for j, i in enumerate(check)
    )
    del fmap
    _check(err_m <= FP32_TOL,
           f"fft_conv fftmap direct: rel err {err_m:.3e} > {FP32_TOL}")
    _report(card, "b_fft_conv_fftmap_direct", shape=[n, fh, fw],
            compile_s=compile_s, call_s=call_s, max_rel_err=err_m,
            tol=FP32_TOL, precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            kernels_checked=check.tolist(), peak_bytes_in_use=_peak_bytes())
    return data, bank, maps


def phase_amortized(card: str, data, bank, maps_b, *, frames=5):
    """(c) split API (tiled data spectra + bank spectra + conv_spectral)
    and a depth-3 ConvStream, each against phase (b)'s maps. Frame i is
    the image scaled by 2^(i-1), so each frame's maps must equal 2^(i-1)
    times (b)'s (a power of two scales exactly in floating point)."""
    import jax
    import jax.numpy as jnp

    import cuda_fft_convolution_tpu as fc

    k = bank.shape[1]
    t0 = time.perf_counter()
    sd = fc.fft_data_tiled(data, k, k, trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=sd)
    jax.block_until_ready((sd.re, sk.re))
    spectra_s = time.perf_counter() - t0
    maps, compile_s, call_s = _compile_and_time(
        lambda s, kk: fc.conv_spectral(s, kk, mode="same"), sd, sk
    )
    err = _jrel(maps, maps_b)
    _check(maps.shape == maps_b.shape, f"conv_spectral shape {maps.shape}")
    _check(err <= SAME_MATH_TOL,
           f"conv_spectral vs fft_conv: rel diff {err:.3e}")
    _report(card, "c_conv_spectral", shape=list(maps.shape),
            block=[sd.block_h, sd.block_w], spectra_s=spectra_s,
            compile_s=compile_s, call_s=call_s, max_rel_diff_vs_b=err,
            tol=SAME_MATH_TOL, precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            peak_bytes_in_use=_peak_bytes())
    del maps, sd, sk

    t0 = time.perf_counter()
    stream = fc.ConvStream.create(
        tuple(data.shape), bank, depth=3, algorithm="tiled", mode="same"
    )
    scales = [2.0 ** (i - 1) for i in range(frames)]
    futs = [stream.submit(data * s) for s in scales[:1]]
    first = jax.block_until_ready(futs[0].result())
    compile_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    futs += [stream.submit(data * s) for s in scales[1:]]
    outs = [first] + [f.result() for f in futs[1:]]
    jax.block_until_ready(outs)
    per_frame_s = (time.perf_counter() - t0) / (frames - 1)
    stream.flush()
    errs = [_jrel(o, maps_b * s) for o, s in zip(outs, scales)]
    _check(max(errs) <= SAME_MATH_TOL,
           f"ConvStream frames vs fft_conv: rel diffs {errs}")
    _report(card, "c_conv_stream", frames=frames, depth=3,
            first_frame_s=compile_s, per_frame_s=per_frame_s,
            max_rel_diff_vs_b=max(errs), tol=SAME_MATH_TOL,
            precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            peak_bytes_in_use=_peak_bytes())


def dpm_inputs(*, image=4096, n=1024, kd=12, seed=1, planted=None):
    """HOG features of a random ``image``^2 picture and a bank of ``n``
    filters of kd x kd x 31. The kernels listed in ``planted`` are HOG
    templates cut from the features (the DPM use: each has a clear
    correlation peak); the others are random."""
    import jax
    import jax.numpy as jnp

    from cuda_fft_convolution_tpu.models import hog_features

    rng = np.random.default_rng(seed)
    img = jnp.asarray(rng.standard_normal((image, image)).astype(np.float32))
    feats = jax.jit(lambda im: hog_features(im, cell=8, bins=31))(img)
    feats_np = np.asarray(feats)
    fh, fw, fd = feats_np.shape
    bank_np = (rng.standard_normal((n, kd, kd, fd)) / kd).astype(np.float32)
    planted = [] if planted is None else list(planted)
    for j, i in enumerate(planted):
        y = (j * 97 + 31) % (fh - kd)
        x = (j * 61 + 17) % (fw - kd)
        bank_np[i] = feats_np[y : y + kd, x : x + kd, :]
    return feats, feats_np, jnp.asarray(bank_np), bank_np


def _corr_same_f64(feats_np, kern_np):
    kh, kw = kern_np.shape[:2]
    full = oracles.fft_conv_full_f64(feats_np, kern_np[::-1, ::-1, :])
    return _same_window(full, kh, kw, feats_np.shape[0], feats_np.shape[1])


def _check_peak(oracle: np.ndarray, pos, value, tol: float) -> None:
    """The detected peak must be the oracle's argmax. Where the oracle's
    two best values are closer than the tier's error can separate, any
    position whose oracle value is within that error of the max is a
    correct answer; the value must match within the tier either way."""
    scale = np.max(np.abs(oracle))
    flat = oracle.ravel()
    top2 = np.partition(flat, -2)[-2:]
    want = np.unravel_index(int(np.argmax(flat)), oracle.shape)
    got_val = oracle[int(pos[0]), int(pos[1])]
    _check(abs(float(value) - top2[1]) <= tol * scale,
           f"peak value {float(value):.6g} vs oracle max {top2[1]:.6g}")
    if top2[1] - top2[0] > 2 * tol * scale:
        _check(tuple(int(p) for p in pos) == tuple(int(w) for w in want),
               f"peak at {tuple(pos)} != oracle argmax {want}")
    else:
        _check(top2[1] - got_val <= 2 * tol * scale,
               f"peak at {tuple(pos)} is not within the tier of the max")


def phase_dpm(card: str, *, image=4096, n=1024, kd=12, n_check=4, seed=1):
    """(d) HOG features -> bf16 bank spectra -> conv_spectral 'same'
    correlation maps and the detect_peaks head, against the float64
    reference on ``n_check`` planted-template kernels."""
    import jax

    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.models import detect_peaks

    check = np.linspace(0, n - 1, n_check).astype(int).tolist()
    feats, feats_np, bank, bank_np = dpm_inputs(
        image=image, n=n, kd=kd, seed=seed, planted=check
    )
    fh, fw, fd = feats_np.shape
    t0 = time.perf_counter()
    sd = fc.fft_data_tiled(feats, kd, kd, trim_mode="same",
                           store_dtype="bfloat16")
    sk = fc.fft_kernels(bank, spectral=sd, correlation=True,
                        store_dtype="bfloat16")
    jax.block_until_ready((sd.re, sk.re))
    spectra_s = time.perf_counter() - t0
    maps, compile_s, call_s = _compile_and_time(
        lambda s, kk: fc.conv_spectral(s, kk, mode="same"), sd, sk
    )
    _check(maps.shape == (n, fh, fw), f"DPM maps shape {maps.shape}")
    got = np.asarray(maps[np.asarray(check)])
    oracles = [_corr_same_f64(feats_np, bank_np[i]) for i in check]
    err = max(_rel(g, o) for g, o in zip(got, oracles))
    _check(err <= BF16_TOL, f"DPM bf16 maps: rel err {err:.3e} > {BF16_TOL}")
    _report(card, "d_dpm_conv_spectral", shape=list(maps.shape),
            features=[fh, fw, fd], block=[sd.block_h, sd.block_w],
            spectra_s=spectra_s, compile_s=compile_s, call_s=call_s,
            max_rel_err=err, tol=BF16_TOL,
            precision="bf16 spectra, f32 accumulation",
            kernels_checked=check, peak_bytes_in_use=_peak_bytes())
    del maps

    (vals, pos), compile_s, call_s = _compile_and_time(
        lambda s, kk: detect_peaks(s, kk, mode="same"), sd, sk
    )
    _check(vals.shape == (n,) and pos.shape == (n, 2),
           f"peaks shapes {vals.shape} {pos.shape}")
    vals_np, pos_np = np.asarray(vals), np.asarray(pos)
    for j, i in enumerate(check):
        _check_peak(oracles[j], pos_np[i], vals_np[i], BF16_TOL)
    _report(card, "d_dpm_detect_peaks", compile_s=compile_s, call_s=call_s,
            peaks_checked=check, tol=BF16_TOL,
            precision="bf16 spectra, f32 accumulation",
            peak_bytes_in_use=_peak_bytes())


def phase_ragged_and_grad(card: str, *, size=512, sizes=(9, 17, 33, 64),
                          per_size=4, frames=3, train_hw=256, train_f=31,
                          train_n=32, train_k=12, seed=2):
    """(e) RaggedConvStream over a mixed-size cell array, three SGD steps
    of a FilterBankDetector, and the tiled engine's gradient against the
    direct engine's."""
    import jax
    import jax.numpy as jnp
    import optax

    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.models import (
        init_detector,
        loss_fn,
        train_step,
    )

    rng = np.random.default_rng(seed)
    img_np = rng.standard_normal((size, size, 1)).astype(np.float32)
    cells_np = [
        rng.standard_normal((s, s, 1)).astype(np.float32)
        for s in sizes for _ in range(per_size)
    ]
    img = jnp.asarray(img_np)
    t0 = time.perf_counter()
    stream = fc.RaggedConvStream(
        (size, size, 1), [jnp.asarray(c) for c in cells_np], depth=3,
        mode="same",
    )
    first = stream.submit(img).result()
    jax.block_until_ready(first)
    compile_s = time.perf_counter() - t0
    scales = [2.0 ** (i + 1) for i in range(frames - 1)]
    t0 = time.perf_counter()
    futs = [stream.submit(img * s) for s in scales]
    outs = [f.result() for f in futs]
    jax.block_until_ready(outs)
    per_frame_s = (time.perf_counter() - t0) / max(len(futs), 1)
    stream.flush()
    _check(len(first) == len(cells_np), f"{len(first)} ragged outputs")
    err = max(
        _rel(np.asarray(m), _same_window(
            oracles.fft_conv_full_f64(img_np, c), c.shape[0], c.shape[1], size, size))
        for m, c in zip(first, cells_np)
    )
    _check(err <= FP32_TOL, f"ragged stream: rel err {err:.3e} > {FP32_TOL}")
    diff = max(
        _jrel(o, m * s) for out, s in zip(outs, scales)
        for o, m in zip(out, first)
    )
    _check(diff <= SAME_MATH_TOL, f"ragged frames: rel diff {diff:.3e}")
    _report(card, "e_ragged_stream", cells=len(cells_np),
            groups=stream.num_groups, frames=frames,
            first_frame_s=compile_s, per_frame_s=per_frame_s,
            max_rel_err=err, tol=FP32_TOL, frame_rel_diff=diff,
            precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            peak_bytes_in_use=_peak_bytes())

    # Training: 3 SGD steps of the detector (direct engine inside).
    model = init_detector(jax.random.key(seed), train_n, train_f,
                          train_k, train_k)
    images = jnp.asarray(rng.standard_normal(
        (2, train_f, train_hw, train_hw)).astype(np.float32))
    targets = jnp.asarray(rng.standard_normal(
        (2, train_n, train_hw, train_hw)).astype(np.float32))
    tx = optax.sgd(0.5)
    opt_state = tx.init(model)
    step = jax.jit(lambda m, o, x, y: train_step(m, o, x, y, tx))
    t0 = time.perf_counter()
    compiled = step.lower(model, opt_state, images, targets).compile()
    compile_s = time.perf_counter() - t0
    losses, step_s = [], []
    m, o = model, opt_state
    for _ in range(3):
        t0 = time.perf_counter()
        m, o, loss = jax.block_until_ready(compiled(m, o, images, targets))
        step_s.append(time.perf_counter() - t0)
        losses.append(float(loss))
    _check(all(np.isfinite(losses)), f"non-finite losses {losses}")
    _check(losses[0] > losses[1] > losses[2],
           f"loss does not decrease: {losses}")

    # Gradient: the same loss through the tiled engine (fft_conv
    # algorithm='tiled', its VJP) against the detector's direct engine.
    def tiled_loss(mdl, x, y):
        maps = fc.fft_conv(
            jnp.transpose(x, (0, 2, 3, 1)), train_k, train_k,
            jnp.transpose(mdl.kernels, (0, 2, 3, 1)), mode="same",
            correlation=True, algorithm="tiled",
        )
        scores = maps + mdl.bias[None, :, None, None]
        return jnp.mean((scores - y) ** 2)

    g_direct = jax.jit(jax.grad(loss_fn))(model, images, targets)
    g_tiled = jax.jit(jax.grad(tiled_loss))(model, images, targets)
    gerr = max(
        _jrel(g_tiled.kernels, g_direct.kernels),
        _jrel(g_tiled.bias, g_direct.bias),
    )
    _check(gerr <= SAME_MATH_TOL,
           f"tiled vs direct gradient: rel diff {gerr:.3e}")
    _report(card, "e_train_step", batch=2, features=train_f,
            filters=train_n, kernel=train_k, image=train_hw,
            compile_s=compile_s, step_s=step_s, losses=losses,
            grad_rel_diff_tiled_vs_direct=gerr, tol=SAME_MATH_TOL,
            precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST",
            peak_bytes_in_use=_peak_bytes())


def phase_four(card: str, devices, *, image=4096, n=1024, kd=12,
               frames=3, train_hw=128, train_f=31, train_n=32, seed=3):
    """--four: the phase-d bank sharded over the kernel axis of a (1, 4)
    mesh through conv_spectral_sharded, ShardedConvStream and
    detect_peaks_sharded, and the sharded training step on a (2, 2) mesh,
    each against the same work on one card."""
    import jax
    import jax.numpy as jnp
    import optax
    from jax.sharding import NamedSharding, PartitionSpec as P

    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.models import (
        FilterBankDetector,
        detect_peaks,
        init_detector,
        train_step,
    )

    _check(len(devices) == 4, f"--four needs 4 devices, got {len(devices)}")
    check = np.linspace(0, n - 1, 4).astype(int).tolist()
    feats, feats_np, bank, bank_np = dpm_inputs(
        image=image, n=n, kd=kd, seed=seed, planted=check
    )
    mesh = fc.make_mesh(data=1, kernels=4, devices=devices)
    sd = fc.fft_data_tiled(feats, kd, kd, trim_mode="same",
                           store_dtype="bfloat16")
    want = fc.conv_spectral(sd, bank, mode="same", correlation=True)

    t0 = time.perf_counter()
    got = jax.block_until_ready(fc.conv_spectral_sharded(
        sd, bank, mesh, mode="same", correlation=True))
    first_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    got = jax.block_until_ready(fc.conv_spectral_sharded(
        sd, bank, mesh, mode="same", correlation=True))
    call_s = time.perf_counter() - t0
    diff = _jrel(got, want)
    _check(diff <= BF16_SAME_MATH_TOL,
           f"sharded conv vs one card: rel diff {diff:.3e}")
    sub = np.asarray(got[np.asarray(check)])
    oracles = [_corr_same_f64(feats_np, bank_np[i]) for i in check]
    err = max(_rel(g, o) for g, o in zip(sub, oracles))
    _check(err <= BF16_TOL, f"sharded conv: rel err {err:.3e}")
    _report(card, "four_conv_spectral_sharded", mesh=[1, 4],
            shape=list(got.shape), first_call_s=first_s, call_s=call_s,
            rel_diff_vs_one_card=diff, tol_vs_one_card=BF16_SAME_MATH_TOL,
            max_rel_err=err, tol=BF16_TOL,
            precision="bf16 spectra, f32 accumulation",
            peak_bytes_in_use=[_peak_bytes(d) for d in devices])
    del got

    t0 = time.perf_counter()
    with fc.ShardedConvStream(
        mesh, bank, tuple(feats.shape), depth=2, mode="same",
        correlation=True, store_dtype="bfloat16",
    ) as stream:
        scales = [2.0 ** (i - 1) for i in range(frames)]
        maps = stream.map([feats * s for s in scales])
        jax.block_until_ready(maps)
    stream_s = time.perf_counter() - t0
    sdiff = max(_jrel(m, want * s) for m, s in zip(maps, scales))
    _check(sdiff <= BF16_SAME_MATH_TOL,
           f"sharded stream vs one card: rel diff {sdiff:.3e}")
    _report(card, "four_sharded_stream", frames=frames, depth=2,
            total_s_incl_compile=stream_s, rel_diff_vs_one_card=sdiff,
            tol=BF16_SAME_MATH_TOL,
            precision="bf16 spectra, f32 accumulation")
    del maps

    pv, pp = fc.detect_peaks_sharded(sd, bank, mesh, correlation=True)
    wv, wp = detect_peaks(sd, bank, mode="same", correlation=True)
    want_np = np.asarray(want)
    pv, pp = np.asarray(pv), np.asarray(pp)
    scale = float(np.max(np.abs(want_np)))
    vdiff = float(np.max(np.abs(pv - np.asarray(wv)))) / scale
    _check(vdiff <= BF16_SAME_MATH_TOL,
           f"sharded peaks values vs one card: rel diff {vdiff:.3e}")
    # each sharded peak must sit on a maximum of the one-card map
    at = want_np[np.arange(n), pp[:, 0], pp[:, 1]]
    gap = float(np.max(want_np.reshape(n, -1).max(-1) - at)) / scale
    _check(gap <= BF16_SAME_MATH_TOL,
           f"sharded peaks off the one-card maxima by {gap:.3e}")
    same_pos = int(np.sum(np.all(pp == np.asarray(wp), axis=-1)))
    _report(card, "four_detect_peaks_sharded", kernels=n,
            positions_equal=same_pos, value_rel_diff=vdiff, max_gap=gap,
            tol=BF16_SAME_MATH_TOL)
    del want, want_np

    # Sharded training step: batch over 'data', bank over 'kernels'.
    tmesh = fc.make_mesh(data=2, kernels=2, devices=devices)
    rng = np.random.default_rng(seed)
    model = init_detector(jax.random.key(seed), train_n, train_f, kd, kd)
    images = jnp.asarray(rng.standard_normal(
        (4, train_f, train_hw, train_hw)).astype(np.float32))
    targets = jnp.asarray(rng.standard_normal(
        (4, train_n, train_hw, train_hw)).astype(np.float32))
    tx = optax.sgd(1e-2)
    opt_state = tx.init(model)
    step = jax.jit(lambda m, o, x, y: train_step(m, o, x, y, tx))
    want_model, _, want_loss = step(model, opt_state, images, targets)
    shard_model = FilterBankDetector(
        kernels=NamedSharding(tmesh, P("kernels", None, None, None)),
        bias=NamedSharding(tmesh, P("kernels")),
    )
    m = jax.device_put(model, shard_model)
    x = jax.device_put(images, NamedSharding(tmesh, P("data")))
    y = jax.device_put(targets, NamedSharding(tmesh, P("data", "kernels")))
    t0 = time.perf_counter()
    new_model, _, loss = jax.block_until_ready(step(m, opt_state, x, y))
    first_s = time.perf_counter() - t0
    kdiff = _jrel(new_model.kernels, want_model.kernels)
    ldiff = abs(float(loss) - float(want_loss)) / abs(float(want_loss))
    _check(np.isfinite(float(loss)), f"non-finite sharded loss {loss}")
    _check(max(kdiff, ldiff) <= SAME_MATH_TOL,
           f"sharded train step vs one card: {kdiff:.3e}, {ldiff:.3e}")
    _report(card, "four_train_step", mesh=[2, 2],
            first_call_s=first_s, loss=float(loss),
            kernels_rel_diff_vs_one_card=kdiff,
            loss_rel_diff_vs_one_card=ldiff, tol=SAME_MATH_TOL,
            precision="fp32 FFT (cuFFT on GPU), MAC HIGHEST")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument(
        "--four", action="store_true",
        help="run only the four-card mesh phase (needs 4 GPUs)",
    )
    args = parser.parse_args(argv)

    from cuda_fft_convolution_tpu.utils.compile_cache import (
        enable_compile_cache,
    )
    from cuda_fft_convolution_tpu.utils.profiling import card_description

    enable_compile_cache()
    import jax

    devices = jax.devices()
    dev = devices[0]
    if dev.platform != "gpu":
        print(f"chip_smoke: no GPU (first JAX device is {dev.platform!r})",
              file=sys.stderr)
        return 2
    card = card_description()
    print(f"card: {card}", flush=True)
    print(f"jax: {jax.__version__}, device_kind: {dev.device_kind}, "
          f"devices: {len(devices)}", flush=True)
    if args.four:
        if len(devices) < 4:
            print(f"chip_smoke --four: {len(devices)} GPU(s), need 4",
                  file=sys.stderr)
            return 2
        phase_four(card, devices[:4])
    else:
        data, bank, maps = phase_headline(card)
        phase_amortized(card, data, bank, maps)
        del data, bank, maps
        phase_dpm(card)
        phase_ragged_and_grad(card)
    print(f"card: {card}", flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
