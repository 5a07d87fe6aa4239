#!/usr/bin/env python
"""Detection-head demo: planted templates recovered by ``detect_peaks``
WITHOUT materializing score maps, plus heterogeneous serving through
``RaggedConvStream``.

The reference library's own demo validates by PEAK LOCATION
(the reference's demoCudaConvolutionFFT.m:58-61) yet its pipeline always
writes every full score map; this demo exercises the detection consumers:

  1. plant K templates at known positions in a noisy image;
  2. ``detect_peaks`` (per-kernel top-1 over the correlation scores,
     reduced on the device — only (N,) values and positions leave it)
     must recover every planted position exactly;
  3. the same bank served as a heterogeneous CELL LIST through
     ``RaggedConvStream`` (per-shape AOT plans under one facade) matches
     the one-shot ``fft_conv`` maps;
  4. peaks are cross-checked against argmaxing the full maps.

CPU-safe (runs in seconds).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cuda_fft_convolution_tpu as fc  # noqa: E402
from cuda_fft_convolution_tpu.models import detect_peaks  # noqa: E402

rng = np.random.default_rng(7)
H, W, F = 240, 320, 2
K, N = 24, 4

# templates + noisy scene with each template planted once
bank = rng.standard_normal((N, K, K, F)).astype(np.float32)
scene = 0.05 * rng.standard_normal((H, W, F)).astype(np.float32)
planted = [(40, 60), (120, 250), (200, 30), (170, 150)]  # top-left corners
for i, (y, x) in enumerate(planted):
    scene[y:y + K, x:x + K] += 3.0 * bank[i]
# 'same' correlation peaks sit at the template CENTER
centers = [(y + K // 2, x + K // 2) for (y, x) in planted]

vals, pos = detect_peaks(scene, jnp.asarray(bank), mode="same",
                         correlation=True)
pos = np.asarray(pos)
print("peaks:", pos.tolist(), " planted centers:", centers)
for i, (cy, cx) in enumerate(centers):
    assert tuple(pos[i]) == (cy, cx), (i, tuple(pos[i]), (cy, cx))

# cross-check vs argmax over full maps
maps = fc.fft_conv(scene, kernels=jnp.asarray(bank), mode="same",
                   correlation=True)
maps = np.asarray(maps)
flat = maps.reshape(N, -1).argmax(-1)
assert np.array_equal(pos, np.stack([flat // W, flat % W], -1)), "peak parity"
print("peak parity vs full maps OK; max score %.3f" % float(np.max(vals)))

# heterogeneous serving: mixed-size cells under one stream facade
cells = [jnp.asarray(bank[0]),
         jnp.asarray(rng.standard_normal((9, 9, F)).astype(np.float32)),
         jnp.asarray(bank[1])]
with fc.RaggedConvStream(scene.shape, cells, depth=2, mode="same",
                         correlation=True) as stream:
    futures = [stream.submit(scene) for _ in range(3)]
    outs = [f.result() for f in futures]
want = fc.fft_conv(scene, kernels=cells, mode="same", correlation=True)
for got, ref in zip(outs[-1], want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(ref), atol=2e-4)
print("ragged serving matches one-shot fft_conv (3 frames, 2 shapes)")

# multi-scale: a 2x-scaled template found at the right pyramid level and
# base position by the peaks head alone — per-level spectra precomputed
# once (build_pyramid ≈ one cudaFFTData per level), and only (L, N)
# values + positions ever leave the device (no per-level map fetch)
from cuda_fft_convolution_tpu.models import (  # noqa: E402
    build_pyramid,
    detect_pyramid_peaks,
)

template = bank[0]
big_scene = 0.05 * rng.standard_normal((2 * H, 2 * W, F)).astype(np.float32)
up = np.asarray(
    jax.image.resize(jnp.asarray(template), (2 * K, 2 * K, F), "bilinear")
)
py0, px0 = 150, 400
big_scene[py0:py0 + 2 * K, px0:px0 + 2 * K] += 3.0 * up
pyr = build_pyramid(big_scene, K, K, num_levels=3, scale=0.5)
det = detect_pyramid_peaks(pyr, jnp.asarray(bank))
lvl = int(det.best_level[0])
by, bx = (int(c) for c in np.asarray(det.best_position[0]))
want_c = (py0 + K, px0 + K)  # plant center in base coords
print(f"pyramid: template 0 found at level {lvl}, base pos ({by},{bx}), "
      f"planted center {want_c}")
assert lvl == 1, "2x-scaled template should win at the half-res level"
assert abs(by - want_c[0]) <= 4 and abs(bx - want_c[1]) <= 4

# multi-detection: ONE template planted at several places — the top-1 head
# can only see the strongest instance; detect_local_peaks (thresholded
# window-local maxima = DPM's consumer pattern) recovers all of them in a
# single static-(N, k) result.
from cuda_fft_convolution_tpu.models import detect_local_peaks  # noqa: E402

multi = 0.02 * rng.standard_normal((H, W, F)).astype(np.float32)
spots = [(30, 40), (30, 240), (180, 40), (180, 240), (100, 140)]
for (y, x) in spots:
    multi[y:y + K, x:x + K] += 3.0 * bank[0]
lvals, lpos = detect_local_peaks(
    multi, jnp.asarray(bank[:1]), k=8, window=5,
    mode="same", correlation=True,  # no threshold: every local max ranked
)
lvals, lpos = np.asarray(lvals)[0], np.asarray(lpos)[0]
thr = 0.5 * lvals[0]  # half the best score separates hits from noise
keep = lvals > thr
got = {tuple(p) for p in lpos[keep]}
want = {(y + K // 2, x + K // 2) for (y, x) in spots}
assert want <= got, (sorted(got), sorted(want))
lv2, lp2 = detect_local_peaks(
    multi, jnp.asarray(bank[:1]), k=8, window=5, threshold=float(thr),
    mode="same", correlation=True,
)
lv2, lp2 = np.asarray(lv2)[0], np.asarray(lp2)[0]
n2 = int(np.isfinite(lv2).sum())
assert {tuple(p) for p in lp2[:n2]} == want, (lp2[:n2], want)
print(f"local-peaks: all {len(spots)} planted instances of template 0 "
      f"recovered (thresholded slots: {n2}/8, rest padded -inf)")

print("demo_detect OK")

# ragged cell array straight through the head (round 4: mode='same' maps
# are data-sized regardless of kernel size, so mixed-size cells share one
# stacked reduction — the reference's cell-array scenario,
# demoCudaConvolutionFFT.m:41-43, served by detect_peaks directly)
rag_sizes = (9, 17, 33)
rag_cells = [
    rng.standard_normal((k, k, F)).astype(np.float32) for k in rag_sizes
]
scene = 0.02 * rng.standard_normal((H, W, F)).astype(np.float32)
rag_at = [(40, 50), (120, 200), (170, 60)]
for c, (y, x) in zip(rag_cells, rag_at):
    scene[y:y + c.shape[0], x:x + c.shape[1]] += 2.0 * c
rv, rp = detect_peaks(scene, rag_cells, mode="same", correlation=True)
rp = np.asarray(rp)
for i, (c, (y, x)) in enumerate(zip(rag_cells, rag_at)):
    want = (y + (c.shape[0] - 1) // 2, x + (c.shape[1] - 1) // 2)
    assert tuple(rp[i]) == want, (i, tuple(rp[i]), want)
print(f"ragged cells: {len(rag_cells)} mixed sizes {rag_sizes} each found "
      "at its planted center through one detect_peaks call")

print("demo_detect ragged OK")
