#!/usr/bin/env python
"""DPM-style detection at production scale (BASELINE.json config 5: bf16
inputs, fp32 spectral accumulation, large HOG filter bank on big imagery).

Pipeline: image → HOG features → planner-chunked correlation of a large
filter bank against one precomputed feature spectrum → top detections.
Defaults are smoke-test sized; pass full-size dims on a GPU, e.g.:

    python examples/demo_dpm.py --height 4096 --width 4096 --filters 1000
"""

import argparse
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import cuda_fft_convolution_tpu as fc  # noqa: E402
from cuda_fft_convolution_tpu.models.hog import hog_features  # noqa: E402

p = argparse.ArgumentParser()
p.add_argument("--height", type=int, default=512)
p.add_argument("--width", type=int, default=512)
p.add_argument("--filters", type=int, default=64)
p.add_argument("--kh", type=int, default=8)  # filter size in HOG cells
p.add_argument("--kw", type=int, default=8)
p.add_argument("--cell", type=int, default=8)
p.add_argument("--bins", type=int, default=9)
args = p.parse_args()

rng = np.random.default_rng(3)

# bf16 imagery (config 5) — upcast happens inside the library
image = jnp.asarray(
    rng.standard_normal((args.height, args.width)).astype(np.float32)
).astype(jnp.bfloat16)

t0 = time.perf_counter()
feats = hog_features(image.astype(jnp.float32), cell=args.cell, bins=args.bins)
jax.block_until_ready(feats)
fh, fw, F = feats.shape
print(f"HOG features: {feats.shape} from {image.shape} image "
      f"({(time.perf_counter()-t0)*1e3:.0f} ms incl. compile)")

# filter bank (normally learned or clustered from examples)
bank = rng.standard_normal(
    (args.filters, args.kh, args.kw, F)
).astype(np.float32)
# plant filter 7 into the features so something fires
f7 = np.array(bank[7]) / (np.linalg.norm(bank[7]) + 1e-6) * 5.0
feats_np = np.array(feats)
r0, c0 = fh // 3, fw // 4
feats_np[r0 : r0 + args.kh, c0 : c0 + args.kw, :] += f7
feats = jnp.asarray(feats_np)

# one data FFT, planner-chunked bank correlation (the streams-variant path)
sd = fc.fft_data(feats, args.kh, args.kw)
sk = fc.fft_kernels(bank, spectral=sd, correlation=True)
scores = fc.conv_spectral_pipelined(sd, sk, mode="same")
jax.block_until_ready(scores)

t0 = time.perf_counter()
scores = fc.conv_spectral_pipelined(sd, sk, mode="same")
jax.block_until_ready(scores)
dt = time.perf_counter() - t0
thr = fh * fw * args.filters / dt / 1e9
print(f"bank scoring: {scores.shape} in {dt*1e3:.1f} ms "
      f"({thr:.2f} GPix*filters/s over the feature map)")

best = np.unravel_index(int(jnp.argmax(scores)), scores.shape)
print(f"top detection: filter {best[0]} at cell ({best[1]}, {best[2]}); "
      f"planted filter 7 at ({r0 + args.kh//2}, {c0 + args.kw//2})")
assert best[0] == 7
assert abs(best[1] - (r0 + (args.kh - 1) // 2)) <= 1
assert abs(best[2] - (c0 + (args.kw - 1) // 2)) <= 1
print("demo_dpm OK")
