"""Overlap-save tiled engine tests (ops/tiled.py): exactness against the
direct engine and the float64 oracle — tiling is a pure performance
transform and must be bit-level fp32-equivalent on linear windows."""

import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.ops.tiled import choose_block_fft
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError
from tests.oracles import fft_conv_full_f64, rel_err

TOL = 1e-5


def test_choose_block_policy():
    # big image, small kernel → tile (engine pinned per-branch)
    blk = choose_block_fft(2048, 2048, 64, 64, matmul_engine=False)
    assert blk is not None
    lh, lw = blk
    # XLA-FFT engine wants large (≈8×K) 5-smooth blocks
    assert lh >= 8 * 64 and lw >= 8 * 64
    blk_mm = choose_block_fft(2048, 2048, 64, 64, matmul_engine=True)
    assert blk_mm is not None
    lh, lw = blk_mm
    # matmul-DFT engine wants small blocks with a rounded valid window
    assert lh >= 64 + 8 - 1 and lw >= 64 + 128 - 1
    # FFT engine: kernel comparable to image → decline (direct engine wins);
    # small image → decline. The matmul-DFT engine's windowed inverses absorb
    # overlap redundancy, so it keeps tiling these shapes (its per-pixel
    # cost grows with block size, not kernel/image ratio).
    assert choose_block_fft(2048, 2048, 512, 512, matmul_engine=False) is None
    assert choose_block_fft(64, 64, 8, 8, matmul_engine=False) is None
    assert choose_block_fft(2048, 2048, 512, 512, matmul_engine=True) is not None


def test_tiled_matches_oracle_full(rng):
    data = rng.standard_normal((300, 257, 2)).astype(np.float32)
    kerns = [
        rng.standard_normal((9, 7, 2)).astype(np.float32),
        rng.standard_normal((5, 11, 2)).astype(np.float32),
    ]
    sd = fc.fft_data_tiled(data, 9, 11, block_h=64, block_w=64)
    outs = fc.conv_spectral(sd, kerns, mode="full")
    for k, o in zip(kerns, outs):
        assert o.shape == (300 + k.shape[0] - 1, 257 + k.shape[1] - 1)
        assert rel_err(np.array(o), fft_conv_full_f64(data, k)) < TOL


def test_tiled_equals_direct_all_modes(rng):
    data = rng.standard_normal((200, 150, 3)).astype(np.float32)
    kern = rng.standard_normal((12, 8, 3)).astype(np.float32)
    for mode in ("full", "same", "valid"):
        direct = np.array(
            fc.fft_conv(data, kernels=[kern], mode=mode, algorithm="direct")
        )
        tiled = np.array(
            fc.fft_conv(data, kernels=[kern], mode=mode, algorithm="tiled")
        )
        assert direct.shape == tiled.shape
        # Both engines independently meet 1e-5 vs the f64 oracle, so they
        # must agree to the same bar (relative to the output scale).
        scale = np.max(np.abs(direct))
        assert np.max(np.abs(tiled - direct)) / scale < 1e-5, mode


def test_tiled_block_edge_cases(rng):
    """Output extents that don't divide the block valid size, blocks larger
    than the image, single-block degenerate case."""
    for h, w, kh, kw, bh, bw in [
        (50, 50, 5, 5, 16, 16),   # many partial blocks
        (20, 20, 3, 3, 32, 32),   # one block covers everything
        (33, 17, 8, 2, 16, 8),    # valid size 9×7, ragged coverage
    ]:
        data = rng.standard_normal((h, w, 1)).astype(np.float32)
        kern = rng.standard_normal((kh, kw, 1)).astype(np.float32)
        sd = fc.fft_data_tiled(data, kh, kw, block_h=bh, block_w=bw)
        out = np.array(fc.conv_spectral(sd, [kern], mode="full")[0])
        assert rel_err(out, fft_conv_full_f64(data, kern)) < TOL, (h, w, kh, kw)


def test_tiled_batched(rng):
    data = rng.standard_normal((2, 60, 40, 2)).astype(np.float32)
    kern = rng.standard_normal((4, 6, 2)).astype(np.float32)
    sd = fc.fft_data_tiled(data, 4, 6, block_h=32, block_w=32)
    out = np.array(fc.conv_spectral(sd, [kern], mode="full"))
    assert out.shape == (2, 1, 63, 45)
    for b in range(2):
        assert rel_err(out[b, 0], fft_conv_full_f64(data[b], kern)) < TOL


def test_tiled_spectral_kernels_reuse(rng):
    data = rng.standard_normal((100, 100, 1)).astype(np.float32)
    kerns = [rng.standard_normal((7, 7, 1)).astype(np.float32) for _ in range(3)]
    sd = fc.fft_data_tiled(data, 7, 7, block_h=64, block_w=64)
    sk = fc.fft_kernels(kerns, spectral=sd)
    a = np.array(fc.conv_spectral(sd, sk, mode="full"))
    b = np.array(fc.conv_spectral(sd, kerns, mode="full"))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_tiled_rejects_fftmap_and_oversize(rng):
    data = rng.standard_normal((100, 100, 1)).astype(np.float32)
    kern = rng.standard_normal((7, 7, 1)).astype(np.float32)
    sd = fc.fft_data_tiled(data, 7, 7, block_h=64, block_w=64)
    with pytest.raises(InvalidInputError):
        fc.conv_spectral(sd, [kern], mode="fftmap")
    with pytest.raises(InvalidInputError):  # kernel beyond planned max
        fc.conv_spectral(sd, [np.zeros((9, 9, 1), np.float32)], mode="full")
    # tiled + fftmap one-shot is SUPPORTED (fft_conv bakes the FFT canvas
    # itself) — placement parity is pinned by test_fftmap_tiled_* below.


def test_auto_algorithm_dispatch(rng):
    """'auto' must agree with 'direct' wherever it chooses to tile — to the
    same relative bar both engines meet against the f64 oracle."""
    data = rng.standard_normal((400, 300, 1)).astype(np.float32)
    kern = rng.standard_normal((8, 8, 1)).astype(np.float32)
    auto = np.array(fc.fft_conv(data, kernels=[kern], mode="same"))
    direct = np.array(
        fc.fft_conv(data, kernels=[kern], mode="same", algorithm="direct")
    )
    scale = np.max(np.abs(direct))
    assert np.max(np.abs(auto - direct)) / scale < 1e-5


def test_tiled_correlation(rng):
    data = rng.standard_normal((80, 80, 1)).astype(np.float32)
    kern = rng.standard_normal((6, 6, 1)).astype(np.float32)
    a = np.array(
        fc.fft_conv(data, kernels=[kern], mode="full", algorithm="tiled",
                    correlation=True)
    )
    b = np.array(
        fc.fft_conv(data, kernels=[kern[::-1, ::-1]], mode="full",
                    algorithm="tiled")
    )
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_enlarged_envelope_plan_equivalence(rng):
    """A plan whose effective kernel envelope exceeds the bank's true max
    (extra prehistory zeros — e.g. the v4 headline plan (65, 128) for 64²
    kernels) must produce identical linear-conv windows."""
    data = rng.standard_normal((200, 180, 1)).astype(np.float32)
    kern = rng.standard_normal((9, 6, 1)).astype(np.float32)
    base = fc.fft_data_tiled(data, 9, 6, block_h=32, block_w=37)
    # enlarged: plan envelope (12, 10) though kernels are only (9, 6)
    big = fc.fft_data_tiled(data, 12, 10, block_h=40, block_w=48)
    for mode in ("full", "same", "valid"):
        a = np.array(fc.conv_spectral(base, [kern], mode=mode))
        b = np.array(fc.conv_spectral(big, [kern], mode=mode))
        assert a.shape == b.shape, mode
        scale = np.max(np.abs(a))
        assert np.max(np.abs(a - b)) / scale < 1e-5, mode
    full = np.array(fc.conv_spectral(big, [kern], mode="full"))
    assert rel_err(full[0], fft_conv_full_f64(data, kern)) < 1e-5


def test_baked_trim_window_matches_full_path(rng):
    """fft_data_tiled(trim_mode='same'/'valid') bakes the output window
    into the block tiling (no trim copy); results must equal the
    full-spectra path exactly, for odd and even kernels."""
    data = rng.standard_normal((100, 90, 2)).astype(np.float32)
    for kh, kw in [(9, 6), (8, 8), (5, 5)]:
        kerns = [rng.standard_normal((kh, kw, 2)).astype(np.float32)
                 for _ in range(2)]
        full_sd = fc.fft_data_tiled(data, kh, kw, block_h=32, block_w=40)
        for mode in ("same", "valid"):
            want = np.array(fc.conv_spectral(full_sd, kerns, mode=mode))
            baked = fc.fft_data_tiled(
                data, kh, kw, block_h=32, block_w=40, trim_mode=mode
            )
            assert baked.out_h == want.shape[-2]
            assert baked.out_w == want.shape[-1]
            got = np.array(fc.conv_spectral(baked, kerns, mode=mode))
            assert got.shape == want.shape, (kh, kw, mode)
            scale = np.max(np.abs(want))
            assert np.max(np.abs(got - want)) / scale < 1e-6, (kh, kw, mode)
    # a window the baked spectra can't serve raises
    baked = fc.fft_data_tiled(data, 9, 6, block_h=32, block_w=40,
                              trim_mode="valid")
    with pytest.raises(InvalidInputError):
        fc.conv_spectral(
            baked, [rng.standard_normal((9, 6, 2)).astype(np.float32)],
            mode="full",
        )


def test_baked_trim_offsets_under_enlarged_plan(rng, monkeypatch):
    """When a measured block plan enlarges the planned kernel envelope,
    the baked 'same' offsets must still follow the USER's kernel size."""
    import cuda_fft_convolution_tpu.api as api

    monkeypatch.setattr(
        api, "choose_block_plan", lambda *a, **k: (32, 40, 12, 10)
    )
    data = rng.standard_normal((100, 90, 1)).astype(np.float32)
    sd = api.fft_data_tiled(data, 9, 6, trim_mode="same")
    assert sd.max_kh == 12 and sd.max_kw == 10  # plan envelope stored
    assert (sd.origin_h, sd.origin_w) == (4, 2)  # offsets from (9, 6)
    kern = rng.standard_normal((9, 6, 1)).astype(np.float32)
    got = np.array(fc.conv_spectral(sd, [kern], mode="same"))
    want = np.array(
        fc.fft_conv(data, kernels=[kern], mode="same", algorithm="direct")
    )
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_baked_trim_oneshot_dispatch(rng):
    """fft_conv with a uniform bank and mode='same' routes through baked
    spectra and still matches the direct engine and the f64 oracle."""
    data = rng.standard_normal((300, 280, 1)).astype(np.float32)
    kerns = [rng.standard_normal((8, 8, 1)).astype(np.float32)
             for _ in range(3)]
    got = np.array(
        fc.fft_conv(data, kernels=kerns, mode="same", algorithm="tiled")
    )
    want = np.array(
        fc.fft_conv(data, kernels=kerns, mode="same", algorithm="direct")
    )
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_pipelined_tiled_matches_plain(rng):
    """conv_spectral_pipelined on TiledSpectralData: chunked tiled path
    equals the unchunked result for dividing and non-dividing chunks."""
    data = rng.standard_normal((60, 50, 1)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 1)).astype(np.float32) for _ in range(7)]
    sd = fc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32)
    want = np.array(fc.conv_spectral(sd, kerns, mode="same"))
    for chunk in (2, 3, 7, 16):
        got = np.array(
            fc.conv_spectral_pipelined(sd, kerns, chunk_size=chunk, mode="same")
        )
        np.testing.assert_allclose(got, want, atol=1e-6)
    with pytest.raises(InvalidInputError):
        fc.conv_spectral_pipelined(sd, kerns, chunk_size=2, mode="fftmap")


def test_matmul_tiled_property_sweep(rng):
    """Property sweep of the matmul-engine tiled path (forced on CPU) over
    auto-chosen geometry for varied kernel sizes."""
    try:
        fc.set_config(use_matmul_fft=True)
        for (h, w, kh, kw, f) in [
            (140, 130, 9, 9, 1),
            (200, 90, 17, 5, 2),
            (96, 300, 4, 32, 1),
        ]:
            data = rng.standard_normal((h, w, f)).astype(np.float32)
            kern = rng.standard_normal((kh, kw, f)).astype(np.float32)
            got = fc.fft_conv(data, kernels=[kern], mode="full",
                              algorithm="tiled")
            assert rel_err(np.array(got[0]), fft_conv_full_f64(data, kern)) < TOL, (
                h, w, kh, kw, f,
            )
    finally:
        fc.set_config(use_matmul_fft=None)


# ---------------------------------------------------------------------------
# mode='fftmap' through the tiled engine: the baked FFT-size canvas makes
# the raw circular maps reproducible by overlap-save (direct canvas is
# sized >= data+K-1, so circular == linear 'full' zero-extended). Every
# case pins shape AND placement against the direct engine.
# ---------------------------------------------------------------------------


def test_fftmap_tiled_matches_direct(rng):
    data = rng.standard_normal((200, 150, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 12, 8, 2)).astype(np.float32)
    direct = np.array(
        fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct")
    )
    tiled = np.array(
        fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="tiled")
    )
    assert tiled.shape == direct.shape
    assert rel_err(tiled, direct) < TOL


def test_fftmap_tiled_ragged_and_correlation(rng):
    data = rng.standard_normal((180, 170, 3)).astype(np.float32)
    kerns = [
        rng.standard_normal((9, 7, 3)).astype(np.float32),
        rng.standard_normal((5, 11, 3)).astype(np.float32),
        rng.standard_normal((11, 11, 3)).astype(np.float32),
    ]
    for corr in (False, True):
        direct = np.array(
            fc.fft_conv(
                data, kernels=kerns, mode="fftmap", algorithm="direct",
                correlation=corr,
            )
        )
        tiled = np.array(
            fc.fft_conv(
                data, kernels=kerns, mode="fftmap", algorithm="tiled",
                correlation=corr,
            )
        )
        assert tiled.shape == direct.shape
        assert rel_err(tiled, direct) < TOL


def test_fftmap_tiled_batched_and_oversized_max(rng):
    data = rng.standard_normal((2, 160, 140, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 8, 8, 2)).astype(np.float32)
    # max_kernel passed LARGER than the actual kernels (the reference's
    # buffer-sizing pattern) — the canvas must follow the max dims.
    direct = np.array(
        fc.fft_conv(data, 16, 16, bank, mode="fftmap", algorithm="direct")
    )
    tiled = np.array(
        fc.fft_conv(data, 16, 16, bank, mode="fftmap", algorithm="tiled")
    )
    assert tiled.shape == direct.shape
    assert rel_err(tiled, direct) < TOL


def test_fftmap_tiled_pinned_policy_shape(rng):
    data = rng.standard_normal((150, 150, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 9, 9, 1)).astype(np.float32)
    direct = np.array(
        fc.fft_conv(
            data, kernels=bank, mode="fftmap", algorithm="direct",
            policy="multiple16",
        )
    )
    tiled = np.array(
        fc.fft_conv(
            data, kernels=bank, mode="fftmap", algorithm="tiled",
            policy="multiple16",
        )
    )
    assert tiled.shape == direct.shape
    assert rel_err(tiled, direct) < TOL


def test_fftmap_canvas_spectra_serve_linear_modes(rng):
    data = rng.standard_normal((120, 130, 2)).astype(np.float32)
    kern = rng.standard_normal((7, 9, 2)).astype(np.float32)
    sd = fc.fft_data_tiled(data, 7, 9, trim_mode="fftmap")
    assert sd.fftmap_canvas
    for mode in ("full", "same", "valid"):
        got = np.array(fc.conv_spectral(sd, [kern], mode=mode))[0]
        want = np.array(
            fc.fft_conv(data, kernels=[kern], mode=mode, algorithm="direct")
        )[0]
        assert got.shape == want.shape
        assert rel_err(got, want) < TOL


def test_fftmap_tiled_pipelined_matches_direct(rng):
    data = rng.standard_normal((140, 140, 1)).astype(np.float32)
    bank = rng.standard_normal((5, 8, 8, 1)).astype(np.float32)
    sd = fc.fft_data_tiled(data, 8, 8, trim_mode="fftmap")
    direct = np.array(
        fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct")
    )
    got = np.array(
        fc.conv_spectral_pipelined(sd, bank, mode="fftmap", chunk_size=2)
    )
    assert got.shape == direct.shape
    assert rel_err(got, direct) < TOL


def test_fftmap_tiled_validation():
    rng = np.random.default_rng(0)
    data = rng.standard_normal((64, 64, 1)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    # spectra without the baked canvas reject raw-map requests
    sd_full = fc.fft_data_tiled(data, 5, 5)
    with pytest.raises(InvalidInputError):
        fc.conv_spectral(sd_full, [kern], mode="fftmap")
    with pytest.raises(InvalidInputError):
        fc.conv_spectral_pipelined(sd_full, [kern], mode="fftmap")
    # a kernel whose linear extent exceeds the baked canvas would wrap:
    # plan the blocks for 40x40 kernels but bake the canvas for 5x5 —
    # a 33x33 kernel passes the planned-max check yet must be rejected
    # at the canvas (64+33-1 > policy(64+5-1)).
    sd = fc.fft_data_tiled(
        data, 40, 40, trim_mode="fftmap", trim_kernel_h=5, trim_kernel_w=5
    )
    assert sd.data_h + 33 - 1 > sd.win_h
    big = rng.standard_normal((33, 33, 1)).astype(np.float32)
    with pytest.raises(InvalidInputError):
        fc.conv_spectral(sd, [big], mode="fftmap")
    with pytest.raises(InvalidInputError):
        fc.conv_spectral_pipelined(sd, [big], mode="fftmap")
    # policy only applies to the fftmap canvas
    with pytest.raises(InvalidInputError):
        fc.fft_data_tiled(data, 5, 5, trim_mode="same", policy="pow2")


def test_fftmap_auto_honors_pinned_policy(rng):
    """algorithm='auto' + an explicit FFT-size policy + mode='fftmap':
    auto may tile (the canvas honors the policy exactly) — output must
    match the direct engine at that policy, shape included."""
    data = rng.standard_normal((300, 280, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 8, 8, 1)).astype(np.float32)
    want = np.asarray(
        fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct",
                    policy="multiple16")
    )
    got = np.asarray(
        fc.fft_conv(data, kernels=bank, mode="fftmap", policy="multiple16")
    )
    assert got.shape == want.shape
    assert rel_err(got, want) < TOL
