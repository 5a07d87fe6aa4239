"""API layer tests (api.py ≈ the three MEX entry points, SURVEY.md §3)."""

import numpy as np
import jax.numpy as jnp
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError
from tests.oracles import fft_conv_full_f64, fft_map_f64, rel_err

TOL = 1e-5


def test_fft_conv_one_shot_demo_parity(rng):
    """≈ cudaConvolutionFFT demo call: 3-kernel cell with one perturbed
    kernel (demoCudaConvolutionFFT.m:110-131), multiple16 policy → 80×16."""
    data = rng.standard_normal((64, 8, 5)).astype(np.float32)
    k1 = rng.standard_normal((10, 4, 5)).astype(np.float32)
    k2 = (k1 + 0.1 * rng.standard_normal((10, 4, 5))).astype(np.float32)
    out = fc.fft_conv(data, 10, 4, [k1, k2, k1], policy="multiple16")
    assert out.shape == (3, 80, 16)
    for i, k in enumerate([k1, k2, k1]):
        assert rel_err(np.array(out[i]), fft_map_f64(data, k, 80, 16)) < TOL


def test_split_api_equivalence(rng):
    """fft_data → conv_spectral ≡ one-shot fft_conv (the reference's
    cudaFFTData/cudaConvFFTData split, SURVEY.md §3.2/3.3)."""
    data = rng.standard_normal((40, 30, 3)).astype(np.float32)
    kerns = [rng.standard_normal((7, 9, 3)).astype(np.float32) for _ in range(4)]
    one_shot = fc.fft_conv(data, 7, 9, kerns)
    sd = fc.fft_data(data, 7, 9)
    split = fc.conv_spectral(sd, kerns)
    a, b = np.array(one_shot), np.array(split)
    # scale-relative: on an accelerator the two paths may schedule sums
    # differently (fp32 reassociation noise, ~1e-6 rel, on near-zero entries)
    assert np.max(np.abs(a - b)) / np.max(np.abs(b)) < 1e-5


def test_spectral_kernels_reuse(rng):
    """Precomputed SpectralKernels give identical results."""
    data = rng.standard_normal((32, 32, 2)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 2)).astype(np.float32) for _ in range(3)]
    sd = fc.fft_data(data, 5, 5)
    sk = fc.fft_kernels(kerns, spectral=sd)
    np.testing.assert_allclose(
        np.array(fc.conv_spectral(sd, sk)),
        np.array(fc.conv_spectral(sd, kerns)),
        atol=1e-6,
    )


def test_ragged_kernel_bank_full_mode(rng):
    """Ragged cell arrays (different kernel sizes, same F — the reference
    allows this, src/cudaConvolutionFFT.cu:242) trim per-kernel in 'full'."""
    data = rng.standard_normal((24, 20, 2)).astype(np.float32)
    kerns = [
        rng.standard_normal((5, 7, 2)).astype(np.float32),
        rng.standard_normal((3, 2, 2)).astype(np.float32),
        rng.standard_normal((9, 9, 2)).astype(np.float32),
    ]
    outs = fc.fft_conv(data, kernels=kerns, mode="full")
    assert isinstance(outs, list)
    for k, o in zip(kerns, outs):
        assert o.shape == (24 + k.shape[0] - 1, 20 + k.shape[1] - 1)
        assert rel_err(np.array(o), fft_conv_full_f64(data, k)) < TOL


def test_modes_same_valid(rng):
    data = rng.standard_normal((20, 20, 1)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    ref = fft_conv_full_f64(data, kern)  # (24, 24)
    same = np.array(fc.fft_conv(data, kernels=[kern], mode="same")[0])
    valid = np.array(fc.fft_conv(data, kernels=[kern], mode="valid")[0])
    assert same.shape == (20, 20)
    assert valid.shape == (16, 16)
    assert rel_err(same, ref[2:22, 2:22]) < TOL
    assert rel_err(valid, ref[4:20, 4:20]) < TOL


def test_batched_data(rng):
    """(B, H, W, F) batch axis (BASELINE.json config 4)."""
    data = rng.standard_normal((3, 16, 16, 2)).astype(np.float32)
    kern = rng.standard_normal((4, 4, 2)).astype(np.float32)
    out = fc.fft_conv(data, kernels=[kern], mode="full")
    # uniform bank → stacked (B, N, h, w)
    assert out.shape == (3, 1, 19, 19)
    for b in range(3):
        assert rel_err(np.array(out[b, 0]), fft_conv_full_f64(data[b], kern)) < TOL


def test_pipelined_equals_plain(rng):
    """conv_spectral_pipelined (≈ the streams variant) is numerically
    identical to conv_spectral for every chunk size, including non-dividing
    ones (the reference round-robins whatever remains,
    src/cudaConvFFTDataStreams.cu:353-360)."""
    data = rng.standard_normal((24, 24, 2)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 2)).astype(np.float32) for _ in range(7)]
    sd = fc.fft_data(data, 5, 5)
    want = np.array(fc.conv_spectral(sd, kerns))
    for chunk in (1, 2, 3, 7, 16):
        got = np.array(fc.conv_spectral_pipelined(sd, kerns, chunk_size=chunk))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_correlation_flag(rng):
    """correlation=True ≡ caller flipping kernels by hand
    (demoCudaConvolutionFFT.m:63-69)."""
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kern = rng.standard_normal((4, 6, 1)).astype(np.float32)
    a = np.array(fc.fft_conv(data, kernels=[kern], correlation=True))
    b = np.array(fc.fft_conv(data, kernels=[kern[::-1, ::-1]]))
    np.testing.assert_allclose(a, b, atol=1e-6)


def test_host_and_device_kernels(rng):
    """Kernels accepted from host (numpy) or device (jax.Array)
    (≈ src/cudaConvFFTData.cu:195-225)."""
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kern = rng.standard_normal((3, 3, 1)).astype(np.float32)
    a = np.array(fc.fft_conv(data, kernels=[kern]))
    b = np.array(fc.fft_conv(data, kernels=[jnp.asarray(kern)]))
    np.testing.assert_allclose(a, b)


def test_input_validation():
    """Negative tests ≈ the reference's mexErrMsgIdAndTxt checks
    (src/cudaConvolutionFFT.cu:45-54,64-65,242-243)."""
    data = np.zeros((8, 8, 2), np.float32)
    with pytest.raises(InvalidInputError):  # wrong rank
        fc.fft_data(np.zeros((8, 8)), 3, 3)
    with pytest.raises(InvalidInputError):  # feature-dim mismatch
        fc.fft_conv(data, kernels=[np.zeros((3, 3, 5), np.float32)])
    with pytest.raises(InvalidInputError):  # kernel bigger than FFT dims
        sd = fc.fft_data(data, 3, 3)
        fc.conv_spectral(sd, [np.zeros((30, 30, 2), np.float32)])
    with pytest.raises(InvalidInputError):  # empty cell
        fc.fft_conv(data, 3, 3, [])
    with pytest.raises(InvalidInputError):  # bad mode
        fc.fft_conv(data, kernels=[np.zeros((3, 3, 2), np.float32)], mode="nope")


def test_spectral_data_fetch_roundtrip(rng):
    """SpectralData is a real pytree; fetch() pulls its complex spectrum to
    host."""
    data = rng.standard_normal((16, 8, 2)).astype(np.float32)
    sd = fc.fft_data(data, 3, 3, policy="multiple16")
    spec = fc.fetch(sd.fft)
    assert spec.shape == (2, sd.fft_h, sd.fft_w // 2 + 1)
    ref = np.fft.rfft2(data[:, :, 0].astype(np.float64), (sd.fft_h, sd.fft_w))
    assert rel_err(np.abs(spec[0]), np.abs(ref)) < 1e-4


def test_api_is_jit_transparent(rng):
    """The whole public API is traceable: users wrap hot loops in jax.jit
    and every stage (pad, FFT, MAC, inverse, trim) fuses into ONE program —
    the serving-latency answer to the reference's per-call MEX dispatch."""
    import jax

    data = rng.standard_normal((40, 30, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    want = np.array(fc.fft_conv(data, 5, 5, kerns, mode="same"))
    got = np.array(
        jax.jit(lambda d, k: fc.fft_conv(d, 5, 5, k, mode="same"))(
            jnp.asarray(data), jnp.asarray(kerns)
        )
    )
    # Different fusion inside vs outside the user jit may reorder fp32
    # reductions — compare at the accuracy bar (1e-5 on O(10) outputs),
    # not bitwise.
    np.testing.assert_allclose(got, want, atol=1e-5)
    sd = fc.fft_data(data, 5, 5)
    got2 = np.array(
        jax.jit(lambda s, k: fc.conv_spectral(s, k, mode="same"))(
            sd, jnp.asarray(kerns)
        )
    )
    np.testing.assert_allclose(got2, want, atol=1e-5)


def test_streaming_spatial_giant_bank_path(rng):
    """Banks whose resident spectra exceed half the budget stream SPATIAL
    kernels with on-the-fly chunk transforms (_conv_from_spatial_chunked)
    and must match the resident-spectra path exactly."""
    from unittest import mock

    import cuda_fft_convolution_tpu.api as api

    data = rng.standard_normal((40, 40, 2)).astype(np.float32)
    kerns = rng.standard_normal((5, 7, 7, 2)).astype(np.float32)
    sd = fc.fft_data(data, 7, 7)
    want = np.array(fc.conv_spectral(sd, kerns, mode="same"))
    # Shrink the budget so this small bank counts as "giant" and takes the
    # streaming path (chunked, chunk < N).
    with mock.patch.object(api, "_device_memory_budget", lambda: 1 << 20):
        got = np.array(fc.conv_spectral(sd, kerns, mode="same"))
    np.testing.assert_allclose(got, want, atol=1e-6)
    # correlation flag flows through the on-the-fly transform
    want_c = np.array(
        fc.conv_spectral(sd, kerns[:, ::-1, ::-1], mode="same")
    )
    with mock.patch.object(api, "_device_memory_budget", lambda: 1 << 20):
        got_c = np.array(
            fc.conv_spectral(sd, kerns, mode="same", correlation=True)
        )
    np.testing.assert_allclose(got_c, want_c, atol=1e-6)


def test_ragged_same_mode_uses_each_kernels_window(rng):
    """'same' with a ragged bank must center per kernel size, not reuse the
    first kernel's offset. Centering uses the scipy/numpy convention
    ((K-1)//2); note MATLAB conv2 'same' uses K//2 — one pixel lower for
    even kernels (documented in api._trim)."""
    data = rng.standard_normal((20, 20, 1)).astype(np.float32)
    k1 = rng.standard_normal((3, 3, 1)).astype(np.float32)
    k2 = rng.standard_normal((7, 5, 1)).astype(np.float32)
    outs = fc.fft_conv(data, kernels=[k1, k2], mode="same", algorithm="direct")
    assert isinstance(outs, list)
    for k, o in zip([k1, k2], outs):
        assert o.shape == (20, 20)
        full = fft_conv_full_f64(data, k)
        r0, c0 = (k.shape[0] - 1) // 2, (k.shape[1] - 1) // 2
        assert rel_err(np.array(o), full[r0 : r0 + 20, c0 : c0 + 20]) < TOL


def test_device_argument(rng):
    """fft_data(device=...) pins placement — ≈ the reference's gpuId arg
    (src/cudaConvolutionFFT.cu:84-89)."""
    import jax

    dev = jax.devices()[0]
    data = rng.standard_normal((8, 8, 1)).astype(np.float32)
    sd = fc.fft_data(data, 3, 3, device=dev)
    assert list(sd.fft.devices())[0] == dev


def test_from_packed_dim_recovery(rng):
    """SpectralData.from_packed recovers FFT geometry from a raw packed
    rfft2 spectrum — the reference's bare-gpuArray dim recovery
    (src/cudaConvFFTData.cu:92-98)."""
    data = rng.standard_normal((20, 24, 2)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 2)).astype(np.float32)
    sd_ref = fc.fft_data(data, 5, 5)
    # A user holding a raw rfft2 of the zero-padded data:
    import jax

    padded = np.zeros((2, sd_ref.fft_h, sd_ref.fft_w), np.float32)
    padded[:, :20, :24] = np.transpose(data, (2, 0, 1))
    raw = jax.jit(jnp.fft.rfft2)(jnp.asarray(padded))
    sd = fc.SpectralData.from_packed(raw, data_h=20, data_w=24)
    assert (sd.fft_h, sd.fft_w) == (sd_ref.fft_h, sd_ref.fft_w)
    got = np.array(fc.conv_spectral(sd, [kern], mode="full")[0])
    want = np.array(fc.conv_spectral(sd_ref, [kern], mode="full")[0])
    np.testing.assert_allclose(got, want, atol=1e-5)
    # plane-pair input works too
    sd2 = fc.SpectralData.from_packed((sd_ref.re, sd_ref.im), 20, 24)
    got2 = np.array(fc.conv_spectral(sd2, [kern], mode="full")[0])
    np.testing.assert_allclose(got2, want, atol=1e-6)
    # inconsistent explicit fft_w is rejected
    with pytest.raises(ValueError):
        fc.SpectralData.from_packed(raw, 20, 24, fft_w=sd_ref.fft_w + 2)


def test_from_reference_packed_roundtrip(rng):
    """SpectralData.from_reference_packed loads spectra in the reference's
    ACTUAL gpuArray layout — Hermitian-packed along H in MATLAB column-major
    dims (CFFT_H, FFT_W, F), src/cudaFFTData.cu:90-101 — and convolving
    from the converted state matches convolving from fft_data natively."""
    data = rng.standard_normal((20, 24, 3)).astype(np.float32)
    kern = rng.standard_normal((5, 7, 3)).astype(np.float32)
    sd_ref = fc.fft_data(data, 5, 7, policy="multiple16")
    fft_h, fft_w = sd_ref.fft_h, sd_ref.fft_w
    # numpy emulation of the reference's packing: full fft2 of the padded
    # data, keep rows 0..FFT_H/2, logical dims (CFFT_H, FFT_W, F)
    padded = np.zeros((fft_h, fft_w, 3), np.float64)
    padded[:20, :24] = data
    full = np.fft.fft2(padded, axes=(0, 1))
    ref_packed = full[: fft_h // 2 + 1].astype(np.complex64)
    # host numpy complex input: split on host (the realistic migration
    # path is host state)
    sd = fc.SpectralData.from_reference_packed(
        ref_packed, data_h=20, data_w=24
    )
    assert (sd.fft_h, sd.fft_w) == (fft_h, fft_w)
    got = np.array(fc.conv_spectral(sd, [kern], mode="full")[0])
    want = np.array(fc.conv_spectral(sd_ref, [kern], mode="full")[0])
    np.testing.assert_allclose(got, want, atol=1e-4)
    # plane-pair input and single-channel 2-D input work too
    sd2 = fc.SpectralData.from_reference_packed(
        (ref_packed.real, ref_packed.imag), 20, 24
    )
    np.testing.assert_allclose(
        np.array(fc.conv_spectral(sd2, [kern], mode="full")[0]), want,
        atol=1e-4,
    )
    sd1 = fc.SpectralData.from_reference_packed(ref_packed[..., 0], 20, 24)
    assert sd1.feature_dim == 1 and sd1.fft_h == fft_h
    # inconsistent explicit fft_h is rejected
    with pytest.raises(ValueError):
        fc.SpectralData.from_reference_packed(
            ref_packed, 20, 24, fft_h=fft_h + 2
        )


def test_linear_mode_rejects_aliasing_kernel(rng):
    """ADVICE round-1: a kernel larger than the maxK used to size fft_data
    (but still <= FFT dims) must raise for linear modes instead of silently
    returning circularly aliased maps."""
    data = rng.standard_normal((8, 8, 1)).astype(np.float32)
    sd = fc.fft_data(data, 3, 3)  # FFT dims cover 8+3-1=10
    big = rng.standard_normal((5, 5, 1)).astype(np.float32)  # 5 <= 10 but aliases
    with pytest.raises(ValueError):
        fc.conv_spectral(sd, [big], mode="full")
    # fftmap mode still allowed (raw circular maps are well-defined)
    out = fc.conv_spectral(sd, [big], mode="fftmap")
    assert np.isfinite(np.array(out)).all()


def test_device_argument_all_entry_points(rng):
    """gpuId parity (src/cudaConvolutionFFT.cu:84-89) on every entry point."""
    import jax

    dev = jax.devices()[-1]
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kerns = [rng.standard_normal((3, 3, 1)).astype(np.float32)]
    out = fc.fft_conv(data, 3, 3, kerns, mode="full", device=dev)
    assert list(out[0].devices())[0] == dev
    sdt = fc.fft_data_tiled(data, 3, 3, device=dev)
    assert list(sdt.re.devices())[0] == dev
    sk = fc.fft_kernels(kerns, fft_h=32, fft_w=32, device=dev)
    assert list(sk.re.devices())[0] == dev


def test_explicit_policy_pins_direct_engine(rng):
    """ADVICE round-1: an explicitly passed FFT-size policy must not be
    silently ignored by auto-routing to the tiled engine."""
    data = rng.standard_normal((200, 200, 1)).astype(np.float32)
    kern = rng.standard_normal((4, 4, 1)).astype(np.float32)
    # multiple16: 200+4-1=203 → 208. The direct engine honors this; the
    # tiled engine would use block geometry instead.
    out = np.array(
        fc.fft_conv(data, kernels=[kern], mode="fftmap", policy="multiple16")
    )
    assert out.shape[-2:] == (208, 208)
    # 'same' + explicit policy → still direct (auto would have tiled 200²/4²)
    out2 = np.array(
        fc.fft_conv(data, kernels=[kern], mode="same", policy="multiple16")
    )
    assert out2.shape[-2:] == (200, 200)
    want = np.array(
        fc.fft_conv(data, kernels=[kern], mode="same", algorithm="direct")
    )
    np.testing.assert_allclose(out2, want, atol=1e-5)


def test_ragged_bucketing_uses_per_bucket_fft_sizes(rng, monkeypatch):
    """SURVEY §7 step 2: a bank mixing tiny and huge kernels runs each size
    bucket at its own FFT/block geometry (the reference pads everything to
    maxK) and stays oracle-exact in input order."""
    import cuda_fft_convolution_tpu.api as api

    data = rng.standard_normal((300, 300, 1)).astype(np.float32)
    small = rng.standard_normal((8, 8, 1)).astype(np.float32)
    big = rng.standard_normal((200, 200, 1)).astype(np.float32)
    small2 = rng.standard_normal((6, 8, 1)).astype(np.float32)

    seen_maxk = []
    orig_direct, orig_tiled = api.fft_data, api.fft_data_tiled

    def spy_direct(d, mh, mw, **kw):
        seen_maxk.append((mh, mw))
        return orig_direct(d, mh, mw, **kw)

    def spy_tiled(d, mh, mw, **kw):
        seen_maxk.append((mh, mw))
        return orig_tiled(d, mh, mw, **kw)

    monkeypatch.setattr(api, "fft_data", spy_direct)
    monkeypatch.setattr(api, "fft_data_tiled", spy_tiled)

    outs = api.fft_conv(data, kernels=[small, big, small2], mode="full")
    assert isinstance(outs, list) and len(outs) == 3
    # two distinct buckets ran, each at its own (much smaller vs max) size
    assert len(seen_maxk) == 2
    assert max(m[0] for m in seen_maxk) >= 200
    assert min(m[0] for m in seen_maxk) <= 8
    from tests.oracles import fft_conv_full_f64, rel_err

    for kk, o in zip([small, big, small2], outs):
        assert o.shape == (300 + kk.shape[0] - 1, 300 + kk.shape[1] - 1)
        assert rel_err(np.array(o), fft_conv_full_f64(data, kk)) < TOL

    # bucketing off → single padded-to-max pass, same numbers
    seen_maxk.clear()
    outs2 = api.fft_conv(
        data, kernels=[small, big, small2], mode="full", bucket_ragged=False
    )
    assert len(seen_maxk) == 1
    for a, b in zip(outs, outs2):
        np.testing.assert_allclose(np.array(a), np.array(b), atol=2e-4)


def test_bucketing_not_applied_to_similar_sizes(rng):
    """Kernels in one pow-2 envelope share one FFT size (no bucket split)."""
    from cuda_fft_convolution_tpu.api import _bucket_ragged

    ks = [np.zeros((60, 60, 1)), np.zeros((64, 64, 1)), np.zeros((33, 50, 1))]
    assert _bucket_ragged([jnp.asarray(k) for k in ks]) is None
    ks2 = [np.zeros((8, 8, 1)), np.zeros((256, 256, 1))]
    buckets = _bucket_ragged([jnp.asarray(k) for k in ks2])
    assert buckets is not None and len(buckets) == 2


def test_same_mode_oversized_max_kernel_tiled(rng):
    """Explicit max_kernel_h/w LARGER than the actual uniform kernels (the
    reference's buffer-sizing pattern, src/cudaConvolutionFFT.cu:103-110)
    must not break windowed modes on the tiled engine: the baked trim
    window follows the ACTUAL kernel shape (round-2 advisor regression)."""
    data = rng.standard_normal((96, 96, 1)).astype(np.float32)
    kerns = rng.standard_normal((3, 8, 8, 1)).astype(np.float32)
    got = fc.fft_conv(data, 16, 16, kerns, mode="same", algorithm="tiled")
    ref = fc.fft_conv(data, 8, 8, kerns, mode="same", algorithm="direct")
    assert rel_err(np.array(got), np.array(ref)) < TOL
    # list-of-kernels route
    got2 = fc.fft_conv(
        data, 16, 16, [np.asarray(k) for k in kerns], mode="same",
        algorithm="tiled",
    )
    assert rel_err(np.array(got2), np.array(ref)) < TOL


def test_flat_bank_storage_matches_planar(rng):
    """storage='flat' (lane-packed resident spectra — the giant-bank HBM
    layout) must be numerically identical to planar through conv_spectral,
    including the chunked path and pipelined calls."""
    data = rng.standard_normal((40, 36, 3)).astype(np.float32)
    kerns = rng.standard_normal((6, 7, 5, 3)).astype(np.float32)
    sd = fc.fft_data(data, 7, 5)
    sk_p = fc.fft_kernels(kerns, spectral=sd, storage="planar")
    sk_f = fc.fft_kernels(kerns, spectral=sd, storage="flat")
    assert sk_f.flat and not sk_p.flat
    assert sk_f.re.ndim == 3
    want = np.array(fc.conv_spectral(sd, sk_p, mode="same"))
    got = np.array(fc.conv_spectral(sd, sk_f, mode="same"))
    # identical math; on an accelerator the flat vs planar einsums may
    # schedule accumulation differently (not bit-equal) — fp32-noise
    # tolerance
    assert rel_err(got, want) < 1e-5
    # chunked (tight budget) and pipelined paths
    try:
        fc.set_config(hbm_budget_bytes=1 << 20)
        got_c = np.array(fc.conv_spectral(sd, sk_f, mode="same"))
    finally:
        fc.set_config(hbm_budget_bytes=None)
    # chunked vs unchunked reorders fp32 accumulation (~5e-6 abs, same as
    # the planar chunked path)
    np.testing.assert_allclose(got_c, want, atol=1e-4)
    got_p = np.array(
        fc.conv_spectral_pipelined(sd, sk_f, chunk_size=2, mode="same")
    )
    np.testing.assert_allclose(got_p, want, atol=1e-4)


def test_flat_bank_rejected_where_unsupported(rng):
    data = rng.standard_normal((32, 32, 1)).astype(np.float32)
    kerns = rng.standard_normal((4, 5, 5, 1)).astype(np.float32)
    sdt = fc.fft_data_tiled(data, 5, 5, block_h=16, block_w=16)
    sk_f = fc.fft_kernels(kerns, fft_h=16, fft_w=16, storage="flat")
    with pytest.raises(InvalidInputError):
        fc.conv_spectral(sdt, sk_f, mode="same")
    import jax

    if len(jax.devices()) >= 2:
        sd = fc.fft_data(data, 5, 5)
        sk2 = fc.fft_kernels(kerns, spectral=sd, storage="flat")
        with pytest.raises(InvalidInputError):
            fc.conv_spectral_sharded(sd, sk2, fc.make_mesh(data=1))


def test_flat_bank_checkpoint_roundtrip(rng, tmp_path):
    from cuda_fft_convolution_tpu.utils.checkpoint import (
        load_spectral,
        save_spectral,
    )

    kerns = rng.standard_normal((3, 4, 4, 2)).astype(np.float32)
    sk = fc.fft_kernels(kerns, fft_h=12, fft_w=12, storage="flat")
    p = str(tmp_path / "skf.npz")
    save_spectral(p, sk)
    back = load_spectral(p)
    assert back.flat is True
    np.testing.assert_array_equal(np.array(back.re), np.array(sk.re))


def test_ragged_bank_correlation_per_kernel_flip(rng):
    """correlation=True on a RAGGED bank must flip each kernel within its
    own extent (the padded-stack flip displaced smaller kernels — round-3
    regression test). Covers the resident, streaming, and one-shot paths."""
    data = rng.standard_normal((24, 24, 1)).astype(np.float32)
    k_small = rng.standard_normal((3, 3, 1)).astype(np.float32)
    k_big = rng.standard_normal((7, 7, 1)).astype(np.float32)
    outs = fc.fft_conv(
        data, kernels=[k_small, k_big], mode="full", correlation=True,
        bucket_ragged=False,
    )
    for k, o in zip([k_small, k_big], outs):
        ref = fc.fft_conv(
            data, kernels=[np.ascontiguousarray(k[::-1, ::-1])], mode="full"
        )[0]
        np.testing.assert_allclose(np.array(o), np.array(ref), atol=1e-5)
    # streaming-spatial giant-bank path (forced by a tiny budget)
    sd = fc.fft_data(data, 7, 7)
    try:
        fc.set_config(hbm_budget_bytes=64 << 10)
        outs_s = fc.conv_spectral(
            sd, [k_small, k_big, k_big], mode="full", correlation=True
        )
    finally:
        fc.set_config(hbm_budget_bytes=None)
    ref_s = fc.conv_spectral(
        sd, [np.ascontiguousarray(k_small[::-1, ::-1])], mode="full"
    )[0]
    np.testing.assert_allclose(
        np.array(outs_s[0]), np.array(ref_s), atol=1e-4
    )


def test_tiled_bank_never_auto_flat(rng):
    """fft_kernels(spectral=TiledSpectralData) stays planar: storage='auto'
    is planar, and the tiled engine takes planar banks only."""
    data = rng.standard_normal((512, 512, 31)).astype(np.float32)
    kerns = rng.standard_normal((64, 12, 12, 31)).astype(np.float32)
    sdd = fc.fft_data_tiled(data, 12, 12, trim_mode="same")
    sk = fc.fft_kernels(kerns, spectral=sdd)
    assert not sk.flat
    out = fc.conv_spectral(sdd, sk, mode="same")  # must not raise
    assert out.shape == (64, 512, 512)
    with pytest.raises(InvalidInputError):
        fc.fft_kernels(kerns, spectral=sdd, storage="flat")
