"""Differentiable filter-bank detector (the flagship model).

The reference's target workload: score an image's feature map against a bank
of templates by correlation (demoCudaConvolutionFFT.m flips kernels at
:63-69 precisely to turn the convolution MEX into template correlation).
Here that detector is a trainable model:

    scores[b, n] = correlate(features[b], bank[n]) + bias[n]      ('same')

computed through the library's FFT path — one data FFT per image amortized
over the whole bank (src/cudaConvolutionFFT.cu:167's trick), and fully
differentiable (jnp.fft has exact VJPs), so the bank can be *learned* from
(image, target-response) pairs instead of hand-built from HOG clustering.

All functions are pure and jit/vmap/shard-friendly; parameters are a plain
pytree dataclass.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import optax

from cuda_fft_convolution_tpu.ops.conv import (
    irfft2_norm_planes,
    rfft2_padded_planes,
)
from cuda_fft_convolution_tpu.ops.spectral_mac import spectral_mac_planes
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy, compute_fft_size


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class FilterBankDetector:
    """Learnable correlation filter bank.

    kernels: (N, F, Kh, Kw) fp32 — the bank (channel-leading, the library's
             internal layout).
    bias:    (N,) fp32 — per-filter score offset (DPM's per-component bias).
    """

    kernels: jnp.ndarray
    bias: jnp.ndarray

    @property
    def num_filters(self) -> int:
        return self.kernels.shape[0]


def init_detector(
    rng: jax.Array, num_filters: int, feature_dim: int, kh: int, kw: int
) -> FilterBankDetector:
    k_rng, _ = jax.random.split(rng)
    scale = 1.0 / jnp.sqrt(jnp.float32(feature_dim * kh * kw))
    return FilterBankDetector(
        kernels=scale
        * jax.random.normal(k_rng, (num_filters, feature_dim, kh, kw), jnp.float32),
        bias=jnp.zeros((num_filters,), jnp.float32),
    )


def detect(
    model: FilterBankDetector,
    images: jnp.ndarray,  # (B, F, H, W) fp32/bf16, channel-leading
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> jnp.ndarray:
    """Score maps (B, N, H, W) — 'same'-window correlation responses + bias.

    Differentiable end-to-end (jnp.fft has exact VJPs)."""
    b, f, h, w = images.shape
    n, kf, kh, kw = model.kernels.shape
    assert kf == f, f"feature dim mismatch: images {f}, bank {kf}"
    fft_h, fft_w = compute_fft_size(h, w, kh, kw, policy)
    d_re, d_im = rfft2_padded_planes(images, fft_h, fft_w)
    # Correlation = convolution with the spatially flipped kernel
    # (demoCudaConvolutionFFT.m:67-69).
    k_re, k_im = rfft2_padded_planes(
        model.kernels[..., ::-1, ::-1], fft_h, fft_w
    )
    p_re, p_im = spectral_mac_planes(d_re, d_im, k_re, k_im)
    maps = irfft2_norm_planes(p_re, p_im, fft_h, fft_w)
    r0, c0 = (kh - 1) // 2, (kw - 1) // 2
    same = maps[:, :, r0 : r0 + h, c0 : c0 + w]
    return same + model.bias[None, :, None, None]


def loss_fn(
    model: FilterBankDetector,
    images: jnp.ndarray,  # (B, F, H, W)
    targets: jnp.ndarray,  # (B, N, H, W) desired response maps
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> jnp.ndarray:
    """MSE between predicted and target response maps (correlation-filter
    regression — the MOSSE/KCF training objective, solved here by SGD
    through the FFT instead of a closed form)."""
    scores = detect(model, images, policy=policy)
    return jnp.mean((scores - targets) ** 2)


def train_step(
    model: FilterBankDetector,
    opt_state,
    images: jnp.ndarray,
    targets: jnp.ndarray,
    tx: optax.GradientTransformation,
    *,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
):
    """One SGD step through the FFT-convolution path. Pure; jit/pjit it with
    whatever shardings the caller's mesh dictates (see parallel/ and the
    sharded training step in chip_smoke.py's four-card phase)."""
    loss, grads = jax.value_and_grad(loss_fn)(model, images, targets, policy=policy)
    updates, opt_state = tx.update(grads, opt_state, model)
    model = optax.apply_updates(model, updates)
    return model, opt_state, loss
