"""Differentiability tests: the whole FFT-conv path has exact VJPs.
A capability the reference's MEX pipeline cannot offer at all."""

import jax
import numpy as np
import jax.numpy as jnp

import cuda_fft_convolution_tpu as fc


def test_grad_through_fft_conv_finite_difference(rng):
    """End-to-end VJP through fft_data→MAC→irfft2 checked against a central
    finite difference."""
    data = jnp.asarray(rng.standard_normal((12, 10, 2)).astype(np.float32))
    kern = jnp.asarray(rng.standard_normal((3, 3, 2)).astype(np.float32))

    def loss(k):
        out = fc.fft_conv(data, kernels=k[None], mode="valid")
        return jnp.sum(out**2)

    g = np.array(jax.grad(loss)(kern))
    eps = 1e-2
    i, j, c = 1, 2, 0
    e = np.zeros_like(np.array(kern))
    e[i, j, c] = eps
    f_plus = float(loss(kern + e))
    f_minus = float(loss(kern - e))
    fd = (f_plus - f_minus) / (2 * eps)
    assert abs(g[i, j, c] - fd) / max(abs(fd), 1e-6) < 5e-3


def test_grad_through_tiled_engine(rng):
    """The overlap-save engine is plain jnp → differentiable; its gradient
    must match the direct engine's."""
    data = jnp.asarray(rng.standard_normal((40, 40, 1)).astype(np.float32))
    kern = jnp.asarray(rng.standard_normal((5, 5, 1)).astype(np.float32))

    def loss(k, algorithm):
        out = fc.fft_conv(data, kernels=k[None], mode="same", algorithm=algorithm)
        return jnp.sum(out**2)

    g_direct = np.array(jax.grad(lambda k: loss(k, "direct"))(kern))
    g_tiled = np.array(jax.grad(lambda k: loss(k, "tiled"))(kern))
    np.testing.assert_allclose(g_tiled, g_direct, rtol=1e-3, atol=1e-2)


def test_grad_through_tiled_engine_fused_dispatch(rng):
    """jax.grad through the tiled engine at an explicit, non-5-smooth block
    geometry with a wide non-square kernel must match the direct engine."""
    data = jnp.asarray(rng.standard_normal((64, 300, 1)).astype(np.float32))
    kern = jnp.asarray(rng.standard_normal((5, 129, 1)).astype(np.float32))

    def loss_tiled(k):
        spectral = fc.fft_data_tiled(
            data, 5, 129, block_h=36, block_w=256,
            trim_mode="same", trim_kernel_h=5, trim_kernel_w=129,
        )
        out = fc.conv_spectral(spectral, k[None], mode="same")
        return jnp.sum(out**2)

    g_fused = np.array(jax.grad(loss_tiled)(kern))
    g_direct = np.array(
        jax.grad(
            lambda k: jnp.sum(
                fc.fft_conv(data, kernels=k[None], mode="same",
                            algorithm="direct") ** 2
            )
        )(kern)
    )
    scale = np.max(np.abs(g_direct))
    assert np.max(np.abs(g_fused - g_direct)) / scale < 1e-4


def test_grad_through_fftmap_canvas(rng):
    """mode='fftmap' on the tiled engine (baked FFT canvas) stays
    differentiable and matches the direct engine's gradient."""
    data = jnp.asarray(rng.standard_normal((40, 40, 1)).astype(np.float32))
    bank = jnp.asarray(rng.standard_normal((2, 5, 5, 1)).astype(np.float32))

    def loss(d, algorithm):
        out = fc.fft_conv(d, 5, 5, bank, mode="fftmap", algorithm=algorithm)
        return jnp.sum(out**2)

    g_direct = np.array(jax.grad(lambda d: loss(d, "direct"))(data))
    g_tiled = np.array(jax.grad(lambda d: loss(d, "tiled"))(data))
    scale = np.max(np.abs(g_direct))
    assert np.max(np.abs(g_tiled - g_direct)) / scale < 1e-5
