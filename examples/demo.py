#!/usr/bin/env python
"""End-to-end demo — the port of demoCudaConvolutionFFT.m
(the reference's demoCudaConvolutionFFT.m), with its visual checks turned
into printed assertions.

Walks the exact reference scenario:
  1. random 64×8×5 data and 10×4×5 kernels (:37-55)
  2. kernel patterns planted into the data at known offsets (:58-61)
  3. kernels flipped for correlation (:67-69) — here via correlation=True
  4. a 3-kernel cell with one perturbed kernel (:110-113)
  5. one-shot convolution at FFT size 80×16 (multiple16 policy, :78-79)
  6. validation against the conv2 and fft2 oracles (:91-102)
  7. the split API (cudaFFTData → cudaConvFFTData) for amortized reuse
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
import cuda_fft_convolution_tpu as fc  # noqa: E402

rng = np.random.default_rng(42)

# 1. demo geometry (demoCudaConvolutionFFT.m:37-42)
H, W, F = 64, 8, 5
KH, KW = 10, 4
data = rng.standard_normal((H, W, F)).astype(np.float32)
kernel = rng.standard_normal((KH, KW, F)).astype(np.float32)

# 2. plant the kernel into the data at a known offset (:58-61)
r0, c0 = 30, 2
data[r0 : r0 + KH, c0 : c0 + KW, :] += 3.0 * kernel

# 4. three-kernel cell, one perturbed (:110-113)
kernel2 = kernel + 0.1 * rng.standard_normal((KH, KW, F)).astype(np.float32)
bank = [kernel, kernel2, kernel]

# 5. one-shot convolution, reference policy → FFT 80×16
maps = fc.fft_conv(data, KH, KW, bank, policy="multiple16", correlation=True)
print(f"conv maps: {maps.shape}  (expect (3, 80, 16))")
assert maps.shape == (3, 80, 16)

# 3+2. correlation peak at the plant site
full = np.array(maps[0][: H + KH - 1, : W + KW - 1])
peak = np.unravel_index(np.argmax(full), full.shape)
print(f"planted at ({r0},{c0}) + (KH-1,KW-1) = ({r0+KH-1},{c0+KW-1}); "
      f"correlation peak at {peak}")
assert peak == (r0 + KH - 1, c0 + KW - 1), "peak not at plant site!"

# 6. numeric oracle: CPU float64 fft2/ifft2 at the same FFT size (:78-102)
worst = 0.0
for i, k in enumerate(bank):
    ref = np.zeros((80, 16))
    kf = k[::-1, ::-1, :]  # correlation = conv with flipped kernel (:67-69)
    for c in range(F):
        ref += np.real(
            np.fft.ifft2(
                np.fft.fft2(data[:, :, c].astype(np.float64), (80, 16))
                * np.fft.fft2(kf[:, :, c].astype(np.float64), (80, 16))
            )
        )
    err = np.max(np.abs(np.array(maps[i]) - ref)) / np.max(np.abs(ref))
    worst = max(worst, err)
print(f"max rel err vs float64 fft2 oracle: {worst:.3e}  (tolerance 1e-5)")
assert worst < 1e-5

# 7. split API: precompute the data spectrum once, reuse across calls
spectral = fc.fft_data(data, KH, KW, policy="multiple16")
sk = fc.fft_kernels(bank, spectral=spectral, correlation=True)
maps2 = fc.conv_spectral(spectral, sk)
drift = np.max(np.abs(np.array(maps2) - np.array(maps)))
print(f"split API == one-shot: max abs diff {drift:.3e}")
assert drift < 1e-6

print("demo OK")
