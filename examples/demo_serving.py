#!/usr/bin/env python
"""Serving patterns — how to run the bank-convolution loop in production.

The reference's serving story is `cudaFFTData` → repeated `cudaConvFFTData`
calls (src/cudaFFTData.cu:97-150 keeps the data FFT on the GPU between
calls). This demo shows the serving patterns the library adds to it:

  1. amortized spectra on BOTH sides (data blocks + kernel bank)
  2. a BAKED output window (trim_mode='same'): the engine writes 'same'
     maps directly — no trim copy per call
  3. AOT plans (zero retracing at call time)
  4. pipelined dispatch: keep a few calls in flight and sync every k-th —
     host work for call k+1 overlaps device work for call k
  5. frame batching: B frames per call, linear device cost per frame

CPU-safe (small shapes).
"""

import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cuda_fft_convolution_tpu as fc  # noqa: E402

rng = np.random.default_rng(7)
H, W, F = 256, 256, 1
N, K = 16, 16

frames = rng.standard_normal((8, H, W, F)).astype(np.float32)
bank = rng.standard_normal((N, K, K, F)).astype(np.float32)

# 1+2. amortize spectra; bake the 'same' window into the block tiling
sd = fc.fft_data_tiled(frames[0], K, K, trim_mode="same")
sk = fc.fft_kernels(bank, spectral=sd)

# the serving call: precomputed spectra in, 'same' maps out — jit the loop
serve = jax.jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))
maps = serve(sd, sk)
assert maps.shape == (N, H, W), maps.shape

# 3. AOT plan (the cufftPlanMany analogue): fixed geometry, compiled once
plan = fc.make_plan(frames[0].shape, bank.shape, algorithm="tiled",
                    mode="same")
maps_plan = plan.execute(frames[0], bank)
_mp, _m = np.asarray(maps_plan), np.asarray(maps)
assert np.max(np.abs(_mp - _m)) / np.max(np.abs(_m)) < 1e-5

# 4. pipelined dispatch: sync every k-th call
t0 = time.perf_counter()
out = None
for i, frame in enumerate(frames):
    sd_i = fc.fft_data_tiled(frame, K, K, trim_mode="same")
    out = serve(sd_i, sk)
    if (i + 1) % 4 == 0:  # sync point — bound queued work
        jax.block_until_ready(out)
jax.block_until_ready(out)
print(f"pipelined 8 frames: {(time.perf_counter() - t0) * 1e3:.1f} ms")

# 5. frame batching: B frames per call
sd_b = fc.fft_data_tiled(frames, K, K, trim_mode="same")
maps_b = serve(sd_b, sk)
assert maps_b.shape == (8, N, H, W)
_mb, _m = np.asarray(maps_b[0]), np.asarray(maps)
assert np.max(np.abs(_mb - _m)) / np.max(np.abs(_m)) < 1e-5

# 6. FLAT bank spectra (storage='flat', one spectral-pixel axis): the same
# maps from the direct engine.
sd_d = fc.fft_data(frames[0], K, K)
sk_flat = fc.fft_kernels(bank, spectral=sd_d, storage="flat")
maps_flat = fc.conv_spectral(sd_d, sk_flat, mode="same")
maps_plan = fc.conv_spectral(
    sd_d, fc.fft_kernels(bank, spectral=sd_d, storage="planar"), mode="same"
)
assert np.array_equal(np.asarray(maps_flat), np.asarray(maps_plan))

# 8. the bounded-depth serving stream: the patterns above packaged as a
# runtime object — AOT plan + resident bank spectra + pipelined dispatch
# with at most `depth` calls in flight (the reference's stream pool,
# src/cudaConvFFTDataStreams.cu:279-349, as an async-future API).
with fc.ConvStream.create(frames[0].shape, bank, algorithm="tiled",
                          mode="same", depth=3) as stream:
    futures = [stream.submit(f) for f in frames]   # returns immediately
    assert stream.inflight <= 3                    # bounded device memory
    results = [fut.result() for fut in futures]    # sync as consumed
_ms, _m = np.asarray(results[0]), np.asarray(maps)
assert np.max(np.abs(_ms - _m)) / np.max(np.abs(_m)) < 1e-5
# model update without recompiling: swap the resident bank spectra
stream.update_kernels(bank[::-1])

# 9. the bf16 serving tier: spectra stored bfloat16, every contraction
# accumulating fp32 — half the resident bank footprint (2x more kernels
# fit) and half the spectral bytes (~5e-3 rel err vs the fp32 tier's
# <=1e-5). Both sides opt in together:
sd16 = fc.fft_data(frames[0], K, K, store_dtype="bfloat16")
sk16 = fc.fft_kernels(bank, spectral=sd16, store_dtype="bfloat16")
maps16 = fc.conv_spectral(sd16, sk16, mode="same")
_m16 = np.asarray(maps16.astype(jnp.float32))
assert np.max(np.abs(_m16 - _m)) / np.max(np.abs(_m)) < 2e-2

# 9b. reference-parity raw circular maps (mode='fftmap') WITHOUT the
# direct-engine tax: trim_mode='fftmap' bakes the direct FFT canvas into
# the block tiling, so overlap-save emits the same maps (shape and
# placement) at tiled cost. fft_conv(mode='fftmap') auto-routes this.
sd_map = fc.fft_data_tiled(frames[0], K, K, trim_mode="fftmap")
raw = fc.conv_spectral(sd_map, bank, mode="fftmap")
raw_direct = fc.fft_conv(frames[0], K, K, bank, mode="fftmap",
                         algorithm="direct")
_r, _rd = np.asarray(raw), np.asarray(raw_direct)
assert _r.shape == _rd.shape
assert np.max(np.abs(_r - _rd)) / np.max(np.abs(_rd)) < 1e-5

# 10. multi-device serving: ShardedConvStream composes the stream pool
# with the mesh path (bank pre-sharded over the kernel axis, data spectra
# replicated to every card) — the reference's full streams design
# (src/cudaConvFFTDataStreams.cu:273-349: per-GPU stream pairs x kernel
# round-robin) as two orthogonal primitives. Skipped on single-device
# backends (run under tests/conftest.py's 8-virtual-CPU mesh to see it).
import jax as _jax

if len(_jax.devices()) >= 2:
    mesh = fc.make_mesh(data=1, kernels=len(_jax.devices()))
    with fc.ShardedConvStream(mesh, bank, frames[0].shape, depth=3,
                              mode="same", algorithm="tiled") as sstream:
        sharded = [fut.result() for fut in
                   [sstream.submit(f) for f in frames]]
    _ss = np.asarray(sharded[0])
    assert np.max(np.abs(_ss - _m)) / np.max(np.abs(_m)) < 1e-5

print("serving demo OK")
