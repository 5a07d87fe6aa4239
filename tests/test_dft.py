"""Matmul-DFT transform tests (ops/dft.py): must be fp32-exact against
jnp.fft on every geometry, and the engine flip must be invisible through the
public API (set_config invalidates cached executables)."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.ops.dft import irfft2_mm, rfft2_mm
from tests.oracles import fft_conv_full_f64, rel_err


@pytest.mark.parametrize(
    "h,w,fh,fw",
    [
        (13, 9, 16, 16),
        (64, 64, 80, 90),
        (100, 50, 128, 135),
        (7, 7, 8, 9),  # odd fft_w (Wc covers Nyquist-less case)
        (1, 1, 8, 8),
    ],
)
def test_matmul_transforms_match_fft(rng, h, w, fh, fw):
    x = jnp.asarray(rng.standard_normal((3, h, w)).astype(np.float32))
    s_mm = rfft2_mm(x, fh, fw)
    s_ref = jnp.fft.rfft2(jnp.pad(x, ((0, 0), (0, fh - h), (0, fw - w))))
    scale = float(jnp.max(jnp.abs(jnp.real(s_ref))))
    assert float(jnp.max(jnp.abs(jnp.real(s_mm) - jnp.real(s_ref)))) / scale < 1e-5
    assert float(jnp.max(jnp.abs(jnp.imag(s_mm) - jnp.imag(s_ref)))) / max(
        float(jnp.max(jnp.abs(jnp.imag(s_ref)))), 1e-9
    ) < 1e-5

    y_mm = irfft2_mm(s_ref, fh, fw)
    y_ref = jnp.fft.irfft2(s_ref, s=(fh, fw))
    assert (
        float(jnp.max(jnp.abs(y_mm - y_ref))) / float(jnp.max(jnp.abs(y_ref)))
        < 1e-5
    )


def test_engine_flip_through_public_api(rng):
    """conv results must be identical (fp32 tolerance) under both transform
    engines, and set_config must actually take effect on cached workers."""
    data = rng.standard_normal((48, 40, 2)).astype(np.float32)
    kern = rng.standard_normal((7, 5, 2)).astype(np.float32)
    ref = fft_conv_full_f64(data, kern)
    try:
        fc.set_config(use_matmul_fft=False)
        a = np.array(fc.fft_conv(data, kernels=[kern], mode="full")[0]
                     if isinstance(fc.fft_conv(data, kernels=[kern], mode="full"), list)
                     else fc.fft_conv(data, kernels=[kern], mode="full")[0])
        fc.set_config(use_matmul_fft=True)
        b = np.array(fc.fft_conv(data, kernels=[kern], mode="full")[0]
                     if isinstance(fc.fft_conv(data, kernels=[kern], mode="full"), list)
                     else fc.fft_conv(data, kernels=[kern], mode="full")[0])
    finally:
        fc.set_config(use_matmul_fft=None)
    assert rel_err(a, ref) < 1e-5
    assert rel_err(b, ref) < 1e-5


def test_matmul_engine_tiled_path(rng):
    data = rng.standard_normal((100, 90, 1)).astype(np.float32)
    kern = rng.standard_normal((6, 6, 1)).astype(np.float32)
    ref = fft_conv_full_f64(data, kern)
    try:
        fc.set_config(use_matmul_fft=True)
        sd = fc.fft_data_tiled(data, 6, 6, block_h=32, block_w=32)
        out = np.array(fc.conv_spectral(sd, [kern], mode="full")[0])
    finally:
        fc.set_config(use_matmul_fft=None)
    assert rel_err(out, ref) < 1e-5


def test_inverse_precision_tiers_hold_the_bar(rng):
    """The inverse-synthesis precision tier (config.inverse_precision;
    default 'highest', 'high' an opt-in speed tier) must stay within the
    library's ≤1e-5 bar against the f64 oracle on the DEFAULT tier; the
    opt-in 'high' tier is held to an envelope of ≤5e-5 here. On the CPU
    all tiers run exact f32 — the test then pins the plumbing (set_config
    must invalidate cached executables). On the GPU 'high' runs TF32
    (about 3 digits) and cannot hold either bar."""
    data = rng.standard_normal((96, 80, 2)).astype(np.float32)
    kern = rng.standard_normal((9, 7, 2)).astype(np.float32)
    ref = fft_conv_full_f64(data, kern)
    try:
        for tier in ("highest", "high"):
            fc.set_config(inverse_precision=tier)
            direct = np.array(
                fc.fft_conv(data, kernels=[kern], mode="full",
                            algorithm="direct")[0]
            )
            sd = fc.fft_data_tiled(data, 9, 7, block_h=40, block_w=32)
            tiled = np.array(fc.conv_spectral(sd, [kern], mode="full")[0])
            bar = 1e-5 if tier == "highest" else 5e-5
            assert rel_err(direct, ref) < bar, tier
            assert rel_err(tiled, ref) < bar, tier
    finally:
        fc.set_config(inverse_precision="highest")


def test_matmul_gradients(rng):
    """The matmul transforms are einsum → differentiable; grads must match
    the FFT engine's."""
    import jax

    data = jnp.asarray(rng.standard_normal((24, 24, 1)).astype(np.float32))
    kern = jnp.asarray(rng.standard_normal((5, 5, 1)).astype(np.float32))

    def loss(k):
        out = fc.fft_conv(data, kernels=k[None], mode="same")
        return jnp.sum(out**2)

    try:
        fc.set_config(use_matmul_fft=False)
        g_fft = np.array(jax.grad(loss)(kern))
        fc.set_config(use_matmul_fft=True)
        g_mm = np.array(jax.grad(loss)(kern))
    finally:
        fc.set_config(use_matmul_fft=None)
    np.testing.assert_allclose(g_mm, g_fft, rtol=1e-3, atol=1e-2)


def test_irfft2_mm_partial_window(rng):
    """window=(r0,nr,c0,nc) equals the full inverse sliced."""
    # device-side complex input
    s = jax.jit(jax.lax.complex)(
        jnp.asarray(rng.standard_normal((2, 32, 17)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((2, 32, 17)).astype(np.float32)),
    )
    full = irfft2_mm(s, 32, 32)
    part = irfft2_mm(s, 32, 32, window=(5, 12, 7, 20))
    np.testing.assert_allclose(
        np.array(part), np.array(full[:, 5:17, 7:27]), atol=1e-5
    )


# ---------------------------------------------------------------------------
# Two-stage Cooley–Tukey transforms (axes above the dense cap)
# ---------------------------------------------------------------------------


def test_ct_factor_properties():
    from cuda_fft_convolution_tpu.ops.dft import (
        MATMUL_FFT_MAX_AXIS,
        ct_factor,
    )

    # lane-friendly factor preferred when one exists
    a, b = ct_factor(2560)
    assert a * b == 2560 and b % 128 == 0
    for l in (2560, 2688, 4096, 3000, 2816, 5400):
        a, b = ct_factor(l)
        assert a * b == l
        assert a <= MATMUL_FFT_MAX_AXIS and b <= MATMUL_FFT_MAX_AXIS
    assert ct_factor(2551) is None  # prime > cap: no factorization
    assert ct_factor(9000) is None  # beyond the CT cap


@pytest.mark.parametrize(
    "h,w,fh,fw",
    [
        (40, 50, 2560, 2560),   # both axes CT (the BASELINE config-3 size)
        (30, 30, 2560, 128),    # H-axis CT only
        (30, 30, 128, 2560),    # W-axis CT only
        (20, 20, 2688, 3000),   # mixed awkward factorizations
        (16, 16, 3125, 128),    # 5^5: no 8-friendly factor on H
    ],
)
def test_ct_transforms_match_fft(rng, h, w, fh, fw):
    """CT forward/inverse vs the f64 numpy oracle at sizes beyond the dense
    cap — the regime the reference's cuFFT plans handle natively
    (src/cudaConvolutionFFT.cu:128-142) and round 2 punted to the VPU FFT."""
    from cuda_fft_convolution_tpu.ops.dft import (
        irfft2_mm_planes,
        rfft2_mm_planes,
    )

    x = rng.standard_normal((2, h, w)).astype(np.float32)
    sr, si = rfft2_mm_planes(jnp.asarray(x), fh, fw)
    ref = np.fft.rfft2(x.astype(np.float64), s=(fh, fw))
    scale = np.max(np.abs(ref))
    assert np.max(np.abs(np.array(sr) - ref.real)) / scale < 1e-5
    assert np.max(np.abs(np.array(si) - ref.imag)) / scale < 1e-5

    # inverse round-trip: irfft2(rfft2(x)) == padded x
    y = irfft2_mm_planes(sr, si, fh, fw)
    pad = np.zeros((2, fh, fw), np.float32)
    pad[:, :h, :w] = x
    assert np.max(np.abs(np.array(y) - pad)) / np.max(np.abs(x)) < 1e-5


def test_ct_through_public_api(rng):
    """fft_conv with an FFT axis beyond the dense cap (forced matmul
    engine) runs the CT transform end-to-end and matches the f64 oracle —
    the BASELINE config-3 regime on the direct engine."""
    data = rng.standard_normal((2300, 40, 1)).astype(np.float32)
    kern = rng.standard_normal((230, 20, 1)).astype(np.float32)
    try:
        fc.set_config(use_matmul_fft=True)
        sd = fc.fft_data(data, 230, 20, policy="fast")
        assert sd.fft_h > 2304  # really lands in CT territory
        out = np.array(fc.conv_spectral(sd, [kern], mode="valid")[0])
    finally:
        fc.set_config(use_matmul_fft=None)
    oh, ow = 2300 + 230 - 1, 40 + 20 - 1
    ref = np.real(
        np.fft.ifft2(
            np.fft.fft2(data[:, :, 0].astype(np.float64), (oh, ow))
            * np.fft.fft2(kern[:, :, 0].astype(np.float64), (oh, ow))
        )
    )[229:2300, 19:40]
    assert rel_err(out, ref) < 1e-5
