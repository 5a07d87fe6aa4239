"""Seeded property fuzz: random shapes/modes/engines against the float64
oracle. A compact committed version of the wider sweeps run during
development — seeds fixed so failures reproduce."""

import numpy as np

import cuda_fft_convolution_tpu as fc
from tests.oracles import conv_same_nearest_f64, fft_conv_full_f64, rel_err

TOL = 1e-5


def test_fuzz_api_vs_oracle():
    rng = np.random.default_rng(99)
    for trial in range(12):
        h = int(rng.integers(20, 160))
        w = int(rng.integers(20, 160))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(1, min(h, 14)))
        kw = int(rng.integers(1, min(w, 14)))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
        mode = ["full", "same", "valid"][trial % 3]
        algo = (
            ["auto", "direct", "tiled"][trial % 3]
            if min(h, w) > 4 * max(kh, kw)
            else "direct"
        )
        out = fc.fft_conv(data, kernels=[kern], mode=mode, algorithm=algo)
        got = np.asarray(out[0] if isinstance(out, list) else out[0])
        ref = fft_conv_full_f64(data, kern)
        if mode == "same":
            r0, c0 = (kh - 1) // 2, (kw - 1) // 2
            ref = ref[r0 : r0 + h, c0 : c0 + w]
        elif mode == "valid":
            ref = ref[kh - 1 : h, kw - 1 : w]
        assert rel_err(got, ref) < TOL, (h, w, f, kh, kw, mode, algo)


def test_fuzz_bf16_tier_vs_fp32():
    """Random shapes/modes/engines at store_dtype='bfloat16': the tier
    tracks the fp32 result within bf16 rounding (~5e-3 measured; 2e-2
    bar) on every path the fp32 fuzz exercises."""
    rng = np.random.default_rng(31)
    import jax.numpy as jnp

    for trial in range(8):
        h = int(rng.integers(24, 140))
        w = int(rng.integers(24, 140))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(2, min(h, 12)))
        kw = int(rng.integers(2, min(w, 12)))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
        mode = ["full", "same", "valid"][trial % 3]
        algo = (
            ["auto", "direct", "tiled"][trial % 3]
            if min(h, w) > 4 * max(kh, kw)
            else "direct"
        )
        want = fc.fft_conv(data, kernels=[kern], mode=mode, algorithm=algo)
        got = fc.fft_conv(
            data, kernels=[kern], mode=mode, algorithm=algo,
            store_dtype="bfloat16",
        )
        want = np.asarray(want[0] if isinstance(want, list) else want[0])
        g = got[0] if isinstance(got, list) else got[0]
        got = np.asarray(jnp.asarray(g, jnp.float32))
        assert got.shape == want.shape
        assert rel_err(got, want) < 2e-2, (h, w, f, kh, kw, mode, algo)


def test_fuzz_clamp_same_vs_nearest_oracle():
    """Random shapes/kernels at padding='clamp', mode='same': equals direct
    convolution with 'nearest' (edge-replicate) boundary handling on every
    edge — both same-offset conventions, kernels even and odd, including
    exact-fit FFT sizes where the pad is exactly kernel−1 wide."""
    rng = np.random.default_rng(404)
    # pinned first: kh=kw=2 at scipy offset has a (0,0) clamp band — the
    # ENTIRE pad is wrap-to-origin replicas (regression: a truthiness gate
    # on the band once degraded this case to zero padding, rel err 0.77)
    cases = [(20, 22, 2, 2, "scipy")]
    for trial in range(6):
        cases.append((
            int(rng.integers(16, 48)), int(rng.integers(16, 48)),
            int(rng.integers(2, 9)), int(rng.integers(2, 9)),
            ["scipy", "matlab"][trial % 2],
        ))
    for h, w, kh, kw, off in cases:
        data = rng.standard_normal((h, w)).astype(np.float32)
        kern = rng.standard_normal((kh, kw)).astype(np.float32)
        out = np.array(
            fc.fft_conv(data[:, :, None], kh, kw, [kern[:, :, None]],
                        mode="same", padding="clamp", policy="fast",
                        same_offset=off)
        )[0]
        dh = kh // 2 if off == "matlab" else (kh - 1) // 2
        dw = kw // 2 if off == "matlab" else (kw - 1) // 2
        ref = conv_same_nearest_f64(data, kern, dh, dw)
        assert rel_err(out, ref) < TOL, (h, w, kh, kw, off)


def test_fuzz_bank_entry_points_agree():
    """conv_spectral / conv_spectral_pipelined (forced chunking) /
    one-shot fft_conv agree bit-for-bit-ish on random uniform banks, both
    storage layouts."""
    rng = np.random.default_rng(1234)
    for trial in range(4):
        h = int(rng.integers(24, 80))
        w = int(rng.integers(24, 80))
        f = int(rng.integers(1, 3))
        kh = int(rng.integers(2, 8))
        kw = int(rng.integers(2, 8))
        n = int(rng.integers(3, 7))
        data = rng.standard_normal((h, w, f)).astype(np.float32)
        bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
        sd = fc.fft_data(data, kh, kw)
        storage = ["planar", "flat"][trial % 2]
        sk = fc.fft_kernels(bank, spectral=sd, storage=storage)
        a = np.array(fc.conv_spectral(sd, sk, mode="same"))
        b = np.array(
            fc.conv_spectral_pipelined(sd, sk, mode="same", chunk_size=2)
        )
        c = np.array(
            fc.fft_conv(data, kh, kw, bank, mode="same", algorithm="direct")
        )
        np.testing.assert_allclose(b, a, atol=1e-5)
        np.testing.assert_allclose(c, a, atol=1e-5)


def test_fuzz_fftmap_tiled_vs_direct():
    """Random shapes through mode='fftmap' on both engines: the tiled
    canvas must reproduce the direct engine's raw circular maps (shape AND
    placement) at every geometry, batched or not, with correlation."""
    rng = np.random.default_rng(41)
    for trial in range(8):
        h = int(rng.integers(40, 180))
        w = int(rng.integers(40, 180))
        f = int(rng.integers(1, 4))
        kh = int(rng.integers(1, 13))
        kw = int(rng.integers(1, 13))
        n = int(rng.integers(1, 4))
        batched = trial % 3 == 2
        shape = (2, h, w, f) if batched else (h, w, f)
        data = rng.standard_normal(shape).astype(np.float32)
        bank = rng.standard_normal((n, kh, kw, f)).astype(np.float32)
        corr = trial % 2 == 1
        direct = np.asarray(
            fc.fft_conv(data, kernels=bank, mode="fftmap",
                        algorithm="direct", correlation=corr)
        )
        tiled = np.asarray(
            fc.fft_conv(data, kernels=bank, mode="fftmap",
                        algorithm="tiled", correlation=corr)
        )
        assert tiled.shape == direct.shape, (trial, tiled.shape, direct.shape)
        assert rel_err(tiled, direct) < TOL, (h, w, f, kh, kw, n, corr)
