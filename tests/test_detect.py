"""Detection-head tests: models.detect_peaks must be peak-parity with
argmaxing the trimmed maps on every engine/dispatch path (the reference
demo's validation is exactly a peak-location check,
demoCudaConvolutionFFT.m:58-61)."""

import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.models import detect_peaks, detect_top_k


def _oracle_peaks(maps):
    """argmax over trimmed maps: (N, H, W) → (vals, (N,2) positions)."""
    m = np.asarray(maps)
    n = m.shape[0]
    flat = m.reshape(n, -1)
    idx = flat.argmax(axis=1)
    vals = flat[np.arange(n), idx]
    ys, xs = np.unravel_index(idx, m.shape[1:])
    return vals, np.stack([ys, xs], axis=-1)


@pytest.mark.parametrize("mode", ["same", "valid", "full"])
@pytest.mark.parametrize("algorithm", ["direct", "tiled"])
def test_detect_peaks_parity(rng, mode, algorithm):
    data = rng.standard_normal((60, 70, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    maps = fc.fft_conv(
        data, kernels=bank, mode=mode, correlation=True, algorithm="direct"
    )
    want_v, want_p = _oracle_peaks(maps)
    vals, pos = detect_peaks(
        data, bank, mode=mode, correlation=True, algorithm=algorithm
    )
    np.testing.assert_array_equal(np.asarray(pos), want_p)
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-4)


def test_detect_peaks_planted_template(rng):
    """A template planted in noise must be found at the planted location
    (the demo's acceptance check, demoCudaConvolutionFFT.m:58-61)."""
    templ = rng.standard_normal((9, 9, 1)).astype(np.float32)
    data = 0.05 * rng.standard_normal((64, 64, 1)).astype(np.float32)
    y0, x0 = 23, 41
    data[y0 : y0 + 9, x0 : x0 + 9] += templ
    vals, pos = detect_peaks(
        data, templ[None], mode="same", correlation=True
    )
    # 'same' scipy offset: peak at planted center
    assert tuple(np.asarray(pos)[0]) == (y0 + 4, x0 + 4)


def test_detect_peaks_batched_and_bf16(rng):
    data = rng.standard_normal((2, 40, 40, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    vals, pos = detect_peaks(data, bank, mode="same", correlation=True)
    assert vals.shape == (2, 2) and pos.shape == (2, 2, 2)
    for b in range(2):
        maps = fc.fft_conv(
            data[b], kernels=bank, mode="same", correlation=True,
            algorithm="direct",
        )
        want_v, want_p = _oracle_peaks(maps)
        np.testing.assert_array_equal(np.asarray(pos)[b], want_p)
    # bf16 serving tier: same peak locations at tier accuracy
    vals16, pos16 = detect_peaks(
        data, bank, mode="same", correlation=True, store_dtype="bfloat16"
    )
    np.testing.assert_array_equal(np.asarray(pos16), np.asarray(pos))
    np.testing.assert_allclose(
        np.asarray(vals16), np.asarray(vals), rtol=2e-2
    )


def _oracle_top_k(maps, k):
    """Exact top-k oracle: (N, H, W) → (vals (N, k) desc, pos (N, k, 2))."""
    m = np.asarray(maps)
    n = m.shape[0]
    flat = m.reshape(n, -1)
    idx = np.argsort(-flat, axis=1, kind="stable")[:, :k]
    vals = np.take_along_axis(flat, idx, axis=1)
    ys, xs = idx // m.shape[2], idx % m.shape[2]
    return vals, np.stack([ys, xs], axis=-1)


@pytest.mark.parametrize("mode", ["same", "full"])
def test_detect_top_k_exact_paths(rng, mode):
    """detect_top_k is EXACT on the direct engine and the tiled engine
    (lax.top_k over the maps): values/positions match a numpy argsort
    oracle; k=1 agrees with detect_peaks."""
    data = rng.standard_normal((60, 70, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    maps = fc.fft_conv(
        data, kernels=bank, mode=mode, correlation=True, algorithm="direct"
    )
    want_v, want_p = _oracle_top_k(maps, 4)
    for algorithm in ("direct", "tiled"):
        vals, pos = detect_top_k(
            data, bank, k=4, mode=mode, correlation=True,
            algorithm=algorithm,
        )
        assert vals.shape == (3, 4) and pos.shape == (3, 4, 2)
        np.testing.assert_array_equal(np.asarray(pos), want_p)
        np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-4)
    v1, p1 = detect_top_k(data, bank, k=1, mode=mode, correlation=True)
    pv, pp = detect_peaks(data, bank, mode=mode, correlation=True)
    np.testing.assert_array_equal(np.asarray(p1[:, 0]), np.asarray(pp))
    np.testing.assert_allclose(
        np.asarray(v1[:, 0]), np.asarray(pv), rtol=1e-5
    )
    with pytest.raises(fc.InvalidInputError):
        detect_top_k(data, bank, k=0)
    with pytest.raises(fc.InvalidInputError):
        detect_top_k(data, bank, k=2, mode="fftmap")


def test_detect_peaks_direct_spectral_data(rng):
    """detect_peaks on precomputed DIRECT-engine spectra (fft_data — the
    pyramid-level serving pattern): conv_spectral + the XLA head, maps
    device-resident; batched and unbatched, positions exact vs oracle."""
    data = rng.standard_normal((48, 56, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 7, 5, 2)).astype(np.float32)
    sd = fc.fft_data(data, 7, 5)
    maps = fc.conv_spectral(sd, bank, mode="same", correlation=True)
    want_v, want_p = _oracle_peaks(maps)
    vals, pos = detect_peaks(sd, bank, mode="same", correlation=True)
    np.testing.assert_array_equal(np.asarray(pos), want_p)
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-5)
    # batched spectra → (B, N) / (B, N, 2)
    bdata = rng.standard_normal((2, 48, 56, 2)).astype(np.float32)
    sdb = fc.fft_data(bdata, 7, 5)
    bv, bp = detect_peaks(sdb, bank, mode="full", correlation=True)
    assert bv.shape == (2, 3) and bp.shape == (2, 3, 2)
    for b in range(2):
        m = fc.fft_conv(
            bdata[b], kernels=bank, mode="full", correlation=True,
            algorithm="direct",
        )
        _, wp = _oracle_peaks(m)
        np.testing.assert_array_equal(np.asarray(bp)[b], wp)
    # ragged cells serve mode='same' only — 'valid' windows differ per
    # size and stay rejected (test_detect_heads_ragged_* cover the
    # supported route)
    with pytest.raises(fc.InvalidInputError):
        detect_peaks(
            sd,
            [np.ones((5, 5, 2), np.float32), np.ones((3, 3, 2), np.float32)],
            mode="valid",
        )


def test_detect_peaks_spectral_kernels_and_validation(rng):
    data = rng.standard_normal((50, 50, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    sd = fc.fft_data_tiled(
        data, 5, 5, trim_mode="same", trim_kernel_h=5, trim_kernel_w=5
    )
    sk = fc.fft_kernels(bank, spectral=sd, correlation=True, storage="planar")
    vals, pos = detect_peaks(sd, sk, mode="same")
    maps = fc.conv_spectral(sd, sk, mode="same")
    want_v, want_p = _oracle_peaks(maps)
    np.testing.assert_array_equal(np.asarray(pos), want_p)
    with pytest.raises(fc.InvalidInputError):
        detect_peaks(data, bank, mode="fftmap")
    # ragged cells serve mode='same' only (see test_detect_heads_ragged)
    with pytest.raises(fc.InvalidInputError):
        detect_peaks(data, [bank[0], bank[1][:3]], mode="valid")


def _oracle_local_peaks(maps, k, window=3, threshold=None):
    """Brute-force local-maxima + top-k over (N, H, W) maps."""
    m = np.asarray(maps, np.float32)
    n, h, w = m.shape
    r = window // 2
    rl = window - 1 - r  # asymmetric split for even windows ('SAME')
    vals = np.full((n, k), -np.inf, np.float32)
    pos = np.full((n, k, 2), -1, np.int32)
    for i in range(n):
        hits = []
        for y in range(h):
            for x in range(w):
                y0, y1 = max(0, y - rl), min(h, y + r + 1)
                x0, x1 = max(0, x - rl), min(w, x + r + 1)
                v = m[i, y, x]
                if v >= m[i, y0:y1, x0:x1].max() and (
                    threshold is None or v > threshold
                ):
                    hits.append((v, y, x))
        hits.sort(key=lambda t: (-t[0], t[1] * w + t[2]))
        for j, (v, y, x) in enumerate(hits[:k]):
            vals[i, j] = v
            pos[i, j] = (y, x)
    return vals, pos


@pytest.mark.parametrize("window", [3, 5])
def test_detect_local_peaks_oracle(rng, window):
    """detect_local_peaks ≡ brute-force local-maxima + top-k over the
    trimmed maps (values and positions; padded slots -inf/(-1,-1))."""
    from cuda_fft_convolution_tpu.models import detect_local_peaks

    data = rng.standard_normal((30, 34, 2)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 2)).astype(np.float32)
    maps = fc.fft_conv(
        data, kernels=bank, mode="same", correlation=True,
        algorithm="direct",
    )
    want_v, want_p = _oracle_local_peaks(maps, k=8, window=window)
    vals, pos = detect_local_peaks(
        data, bank, k=8, window=window, mode="same", correlation=True
    )
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(pos), want_p)


def test_detect_local_peaks_threshold_and_padding(rng):
    """threshold drops sub-cutoff maxima; empty slots carry -inf/(-1,-1);
    a high cutoff empties every slot."""
    from cuda_fft_convolution_tpu.models import detect_local_peaks

    data = rng.standard_normal((24, 24, 1)).astype(np.float32)
    bank = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    maps = np.asarray(fc.fft_conv(
        data, kernels=bank, mode="same", correlation=True,
        algorithm="direct",
    ))
    thr = float(np.quantile(maps, 0.99))
    want_v, want_p = _oracle_local_peaks(maps, k=12, threshold=thr)
    vals, pos = detect_local_peaks(
        data, bank, k=12, threshold=thr, mode="same", correlation=True
    )
    np.testing.assert_allclose(
        np.asarray(vals), want_v, rtol=1e-4, atol=1e-6
    )
    np.testing.assert_array_equal(np.asarray(pos), want_p)
    n_hits = int(np.isfinite(want_v[0]).sum())
    assert 0 < n_hits < 12  # the padding path is actually exercised
    assert (np.asarray(pos)[0, n_hits:] == -1).all()
    # a cutoff above the global max finds nothing
    v2, p2 = detect_local_peaks(
        data, bank, k=4, threshold=float(maps.max()) + 1.0, mode="same"
    )
    assert not np.isfinite(np.asarray(v2)).any()
    assert (np.asarray(p2) == -1).all()


def test_detect_local_peaks_planted_templates(rng):
    """Two templates planted far apart both surface (top-1 heads only see
    the stronger one) — the DPM multi-detection scenario."""
    from cuda_fft_convolution_tpu.models import detect_local_peaks

    templ = rng.standard_normal((7, 7, 1)).astype(np.float32)
    data = 0.02 * rng.standard_normal((64, 64, 1)).astype(np.float32)
    spots = [(12, 15), (44, 40)]
    for (y0, x0) in spots:
        data[y0 : y0 + 7, x0 : x0 + 7] += templ
    vals, pos = detect_local_peaks(
        data, templ[None], k=2, mode="same", correlation=True
    )
    got = {tuple(p) for p in np.asarray(pos)[0]}
    want = {(y0 + 3, x0 + 3) for (y0, x0) in spots}
    assert got == want, (got, want)


def test_detect_local_peaks_spectral_inputs_and_out_dtype(rng):
    """Precomputed tiled spectra route + bf16 maps between producer and
    reducer (positions must match the f32 path)."""
    from cuda_fft_convolution_tpu.models import detect_local_peaks

    data = rng.standard_normal((48, 48, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    want_v, want_p = detect_local_peaks(
        data, bank, k=4, mode="same", correlation=True
    )
    sd = fc.fft_data_tiled(data, 5, 5, trim_mode="same")
    sk = fc.fft_kernels(bank, spectral=sd, correlation=True,
                        storage="planar")
    v2, p2 = detect_local_peaks(sd, sk, k=4, mode="same")
    np.testing.assert_allclose(np.asarray(v2), np.asarray(want_v),
                               rtol=1e-5)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(want_p))
    v3, p3 = detect_local_peaks(
        data, bank, k=4, mode="same", correlation=True,
        out_dtype="bfloat16",
    )
    np.testing.assert_array_equal(np.asarray(p3), np.asarray(want_p))


def test_detect_heads_ragged_cells(rng):
    """Ragged cell arrays (mixed kernel sizes — the reference's cell-array
    scenario, demoCudaConvolutionFFT.m:41-43) through all three heads at
    mode='same': every 'same' map is data-sized, so parity is stacking the
    per-cell maps and reducing once."""
    from cuda_fft_convolution_tpu.models import (
        detect_local_peaks, detect_peaks, detect_top_k,
    )

    data = rng.standard_normal((48, 56, 2)).astype(np.float32)
    cells = [
        rng.standard_normal((k, k, 2)).astype(np.float32)
        for k in (5, 9, 17)
    ]
    stacked = np.stack([
        np.asarray(m) for m in fc.fft_conv(
            data, kernels=cells, mode="same", correlation=True,
            algorithm="direct",
        )
    ])
    want_v, want_p = _oracle_peaks(stacked)
    vals, pos = detect_peaks(data, cells, mode="same", correlation=True)
    np.testing.assert_array_equal(np.asarray(pos), want_p)
    np.testing.assert_allclose(np.asarray(vals), want_v, rtol=1e-4)
    # top-k: returned hits must score exactly what the maps say, and the
    # k=1 column must be the global peak
    tv, tp = detect_top_k(data, cells, k=3, mode="same", correlation=True)
    tv, tp = np.asarray(tv), np.asarray(tp)
    np.testing.assert_allclose(tv[:, 0], want_v, rtol=1e-4)
    for i in range(len(cells)):
        for j in range(3):
            y, x = tp[i, j]
            np.testing.assert_allclose(
                tv[i, j], stacked[i, y, x], rtol=1e-4
            )
        assert (tv[i, :-1] >= tv[i, 1:]).all()
    # thresholded local maxima vs the brute-force oracle on stacked maps
    want_lv, want_lp = _oracle_local_peaks(stacked, k=6, window=3)
    lv, lp = detect_local_peaks(
        data, cells, k=6, window=3, mode="same", correlation=True
    )
    np.testing.assert_allclose(np.asarray(lv), want_lv, rtol=1e-4)
    np.testing.assert_array_equal(np.asarray(lp), want_lp)


def test_detect_heads_ragged_spectral_and_batched(rng):
    """Ragged cells against precomputed direct spectra (one data FFT at
    the largest envelope serves every cell), and batched ragged local
    peaks; 'valid' stays rejected."""
    from cuda_fft_convolution_tpu.models import (
        detect_local_peaks, detect_peaks,
    )

    data = rng.standard_normal((40, 44, 1)).astype(np.float32)
    cells = [
        rng.standard_normal((k, k, 1)).astype(np.float32)
        for k in (5, 11)
    ]
    want_v, want_p = detect_peaks(
        data, cells, mode="same", correlation=True
    )
    sd = fc.fft_data(data, 11, 11)
    v2, p2 = detect_peaks(sd, cells, mode="same", correlation=True)
    np.testing.assert_array_equal(np.asarray(p2), np.asarray(want_p))
    np.testing.assert_allclose(
        np.asarray(v2), np.asarray(want_v), rtol=1e-4
    )
    batch = rng.standard_normal((2, 40, 44, 1)).astype(np.float32)
    bv, bp = detect_local_peaks(
        batch, cells, k=4, mode="same", correlation=True
    )
    for b in range(2):
        sv, sp = detect_local_peaks(
            batch[b], cells, k=4, mode="same", correlation=True
        )
        np.testing.assert_allclose(
            np.asarray(bv)[b], np.asarray(sv), rtol=1e-4
        )
        np.testing.assert_array_equal(np.asarray(bp)[b], np.asarray(sp))
    with pytest.raises(fc.InvalidInputError):
        detect_peaks(data, cells, mode="valid", correlation=True)
    with pytest.raises(fc.InvalidInputError):
        detect_local_peaks(data, cells, k=4, mode="full")
