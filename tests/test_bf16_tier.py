"""bf16 serving tier: spectra stored bfloat16, fp32 spectral accumulation.

BASELINE configs[4] ("bf16 inputs, fp32 spectral accumulation") is the
reference workload this tier serves: DPM/HOG banks where the resident
spectra dominate HBM and every MAC is traffic-bound.  Storing the spectra
bf16 halves the resident footprint and the MAC read bytes; every
contraction still ACCUMULATES f32 (``preferred_element_type`` on the
einsums, f32 accumulators in the matmul-DFT inverse).  The tier's accuracy
is ~bf16 mantissa (~4e-3 rel), far from the fp32 tier's ≤1e-5 — these
tests pin it at 2e-2 against the float64 oracles.
"""

import numpy as np
import jax.numpy as jnp
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError
from tests.oracles import fft_map_f64, rel_err

BF16_TOL = 2e-2


def _mk(rng, shape):
    return rng.standard_normal(shape).astype(np.float32)


def test_direct_engine_bf16_tier_accuracy(rng):
    """fft_data/fft_kernels store_dtype='bfloat16' → conv_spectral fftmap
    stays within bf16 mantissa of the f64 oracle (both engines)."""
    data = _mk(rng, (48, 40, 3))
    kerns = [_mk(rng, (7, 9, 3)) for _ in range(4)]
    for engine in (True, False):  # matmul-DFT / XLA-FFT inverse
        try:
            fc.set_config(use_matmul_fft=engine)
            sd = fc.fft_data(data, 7, 9, store_dtype="bfloat16")
            assert sd.re.dtype == jnp.bfloat16
            sk = fc.fft_kernels(kerns, spectral=sd, store_dtype="bfloat16")
            assert sk.re.dtype == jnp.bfloat16
            out = np.array(fc.conv_spectral(sd, sk).astype(jnp.float32))
            fh, fw = sd.fft_h, sd.fft_w
            for i, k in enumerate(kerns):
                assert rel_err(out[i], fft_map_f64(data, k, fh, fw)) < BF16_TOL
        finally:
            fc.set_config(use_matmul_fft=None)


def test_tiled_engine_bf16_tier_accuracy(rng):
    """fft_data_tiled store_dtype='bfloat16' → 'same' maps within tier
    tolerance (block spectra + per-block MAC + windowed inverse all bf16
    operands, f32 accumulation)."""
    data = _mk(rng, (96, 80, 2))
    kerns = [_mk(rng, (5, 5, 2)) for _ in range(3)]
    sd = fc.fft_data_tiled(data, 5, 5, trim_mode="same",
                           store_dtype="bfloat16")
    assert sd.re.dtype == jnp.bfloat16
    out = np.array(fc.conv_spectral(sd, kerns, mode="same")
                   .astype(jnp.float32))
    # fp32-tier result stands in for the oracle (itself ≤1e-5 vs f64)
    want = np.array(fc.fft_conv(data, 5, 5, kerns, mode="same"))
    assert out.shape == want.shape
    for i in range(len(kerns)):
        assert rel_err(out[i], want[i]) < BF16_TOL


def test_raw_kernels_inherit_tier(rng):
    """conv_spectral(bf16 data spectra, raw kernels) transforms the bank
    at the matching store dtype — no mismatch error, tier accuracy."""
    data = _mk(rng, (32, 32, 2))
    kerns = [_mk(rng, (5, 5, 2)) for _ in range(2)]
    sd = fc.fft_data(data, 5, 5, store_dtype="bfloat16")
    out = np.array(fc.conv_spectral(sd, kerns).astype(jnp.float32))
    for i, k in enumerate(kerns):
        assert rel_err(
            out[i], fft_map_f64(data, k, sd.fft_h, sd.fft_w)
        ) < BF16_TOL


def test_one_shot_bf16_tier(rng):
    """fft_conv(store_dtype='bfloat16') runs the whole one-shot pipeline
    at the tier on both engines (direct / tiled)."""
    data = _mk(rng, (80, 64, 3))
    kerns = [_mk(rng, (9, 9, 3)) for _ in range(3)]
    want = np.array(fc.fft_conv(data, 9, 9, kerns, mode="same"))
    for algorithm in ("direct", "tiled"):
        got = np.array(
            fc.fft_conv(data, 9, 9, kerns, mode="same",
                        algorithm=algorithm, store_dtype="bfloat16")
            .astype(jnp.float32)
        )
        assert got.shape == want.shape
        for i in range(len(kerns)):
            assert rel_err(got[i], want[i]) < BF16_TOL, algorithm


def test_store_dtype_mismatch_rejected(rng):
    """Pairing f32 data spectra with a bf16 bank (or vice versa) is a
    validation error, not silent upcasting."""
    data = _mk(rng, (32, 32, 2))
    kerns = [_mk(rng, (5, 5, 2)) for _ in range(2)]
    sd32 = fc.fft_data(data, 5, 5)
    sk16 = fc.fft_kernels(kerns, spectral=sd32, store_dtype="bfloat16")
    with pytest.raises(InvalidInputError, match="store-dtype mismatch"):
        fc.conv_spectral(sd32, sk16)
    with pytest.raises(InvalidInputError, match="store_dtype"):
        fc.fft_data(data, 5, 5, store_dtype="float16")


def test_flat_bank_bf16(rng):
    """storage='flat' composes with the tier (lane-packed bf16 bank,
    flat MAC with f32 accumulation)."""
    data = _mk(rng, (40, 36, 2))
    kerns = [_mk(rng, (6, 6, 2)) for _ in range(3)]
    sd = fc.fft_data(data, 6, 6, store_dtype="bfloat16")
    sk = fc.fft_kernels(kerns, spectral=sd, storage="flat",
                        store_dtype="bfloat16")
    assert sk.re.dtype == jnp.bfloat16 and sk.re.ndim == 3
    out = np.array(fc.conv_spectral(sd, sk).astype(jnp.float32))
    for i, k in enumerate(kerns):
        assert rel_err(
            out[i], fft_map_f64(data, k, sd.fft_h, sd.fft_w)
        ) < BF16_TOL


def test_chunked_bf16_path(rng):
    """The chunked bank pipeline at the tier (conv_spectral_pipelined with
    a forced small chunk) exercises the upcast MAC lowering inside
    lax.map — results stay at tier accuracy and match the unchunked run.
    Raw kernels inherit the tier here too."""
    data = _mk(rng, (40, 36, 3))
    kerns = [_mk(rng, (6, 6, 3)) for _ in range(5)]
    sd = fc.fft_data(data, 6, 6, store_dtype="bfloat16")
    sk = fc.fft_kernels(kerns, spectral=sd, store_dtype="bfloat16")
    whole = np.array(fc.conv_spectral(sd, sk).astype(jnp.float32))
    chunked = np.array(
        fc.conv_spectral_pipelined(sd, kerns, chunk_size=2)
        .astype(jnp.float32)
    )
    assert chunked.shape == whole.shape
    for i, k in enumerate(kerns):
        assert rel_err(
            chunked[i], fft_map_f64(data, k, sd.fft_h, sd.fft_w)
        ) < BF16_TOL
    # flat bank through the chunked path as well
    skf = fc.fft_kernels(kerns, spectral=sd, storage="flat",
                         store_dtype="bfloat16")
    chunked_flat = np.array(
        fc.conv_spectral_pipelined(sd, skf, chunk_size=2)
        .astype(jnp.float32)
    )
    np.testing.assert_allclose(chunked_flat, chunked, atol=1e-2)


def test_sharded_bf16_tier(rng):
    """conv_spectral_sharded at the tier: bf16 spectra shard over the mesh
    (the sharded planner's store_bytes-aware chunk sizing included) and
    match the single-device tier result."""
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs a multi-device mesh")
    mesh = fc.make_mesh(data=1)
    data = _mk(rng, (32, 24, 3))
    kerns = [_mk(rng, (5, 5, 3)) for _ in range(8)]
    sd = fc.fft_data(data, 5, 5, store_dtype="bfloat16")
    sk = fc.fft_kernels(kerns, spectral=sd, store_dtype="bfloat16")
    want = np.array(fc.conv_spectral(sd, sk).astype(jnp.float32))
    got = np.array(
        fc.conv_spectral_sharded(sd, sk, mesh).astype(jnp.float32)
    )
    # sharded vs single-device agree to tier noise (bf16 rounding orders
    # differ between the per-shard and whole-bank einsum lowerings)
    assert rel_err(got, want) < BF16_TOL
    for i, k in enumerate(kerns):
        assert rel_err(
            got[i], fft_map_f64(data, k, sd.fft_h, sd.fft_w)
        ) < BF16_TOL


def test_aot_plan_bf16_tier(rng):
    """make_plan(store_dtype='bfloat16'): AOT plans at the tier — bf16
    spectral ABI, f32 maps out, tier accuracy, on both engines; ConvStream
    serves over the bf16 plan."""
    from cuda_fft_convolution_tpu.runtime import make_plan
    from cuda_fft_convolution_tpu import ConvStream

    data = _mk(rng, (32, 24, 2))
    kerns = np.stack([_mk(rng, (5, 7, 2)) for _ in range(3)])
    want = np.array(fc.fft_conv(data, kernels=kerns, mode="full"))
    plan = make_plan(data.shape, kerns.shape, store_dtype="bfloat16")
    dfft = plan.data_fft(data)
    assert dfft[0].dtype == jnp.bfloat16
    fh, fw = plan.fft_h, plan.fft_w
    got = np.array(plan.execute(data, kerns).astype(jnp.float32))
    for i in range(3):
        assert rel_err(got[i], fft_map_f64(data, kerns[i], fh, fw)) < BF16_TOL
    plant = make_plan(data.shape, kerns.shape, algorithm="tiled",
                      mode="full", store_dtype="bfloat16")
    gott = np.array(plant.execute(data, kerns).astype(jnp.float32))
    assert gott.shape == want.shape
    for i in range(3):
        assert rel_err(gott[i], want[i]) < BF16_TOL
    # serving stream over the bf16 plan
    with ConvStream(plan, kerns, depth=2) as stream:
        futs = [stream.submit(data) for _ in range(3)]
        outs = [np.array(f.result().astype(jnp.float32)) for f in futs]
    for o in outs:
        assert rel_err(o[0], fft_map_f64(data, kerns[0], fh, fw)) < BF16_TOL


def test_tier_composes_with_round3_options(rng):
    """bf16 tier × padding='clamp' / kernel_layout='centered' /
    correlation: each matches its fp32-tier counterpart to tier noise."""
    data = _mk(rng, (40, 32, 2))
    kerns = [_mk(rng, (5, 5, 2)) for _ in range(2)]
    for kw in (
        dict(padding="clamp"),
        dict(kernel_layout="centered"),
        dict(correlation=True),
    ):
        want = np.array(fc.fft_conv(data, 5, 5, kerns, **kw))
        got = np.array(
            fc.fft_conv(data, 5, 5, kerns, store_dtype="bfloat16", **kw)
            .astype(jnp.float32)
        )
        assert got.shape == want.shape, kw
        assert rel_err(got, want) < BF16_TOL, kw


def test_checkpoint_roundtrip_preserves_tier(rng, tmp_path):
    """save/load round-trips bf16 spectra (persisted as f32 planes — npz
    has no bfloat16 — with the store dtype recorded)."""
    data = _mk(rng, (32, 24, 2))
    sd = fc.fft_data(data, 5, 5, store_dtype="bfloat16")
    p = str(tmp_path / "sd_bf16.npz")
    fc.save_spectral(p, sd)
    sd2 = fc.load_spectral(p)
    assert sd2.re.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(sd.re, np.float32), np.asarray(sd2.re, np.float32)
    )
    # and the loaded spectra still convolve
    kerns = [_mk(rng, (5, 5, 2))]
    out = np.array(fc.conv_spectral(sd2, kerns).astype(jnp.float32))
    assert rel_err(
        out[0], fft_map_f64(data, kerns[0], sd.fft_h, sd.fft_w)
    ) < BF16_TOL


def test_store_dtype_mismatch_rejected_everywhere(rng):
    """The mismatch guard holds on EVERY bank entry point that accepts
    precomputed SpectralKernels — pipelined and sharded included (a silent
    mixed pair runs the upcast MAC at bf16 dot precision, degrading the
    f32 side ~1e-3 without an error)."""
    data = _mk(rng, (32, 32, 2))
    kerns = [_mk(rng, (5, 5, 2)) for _ in range(4)]
    sd32 = fc.fft_data(data, 5, 5)
    sk16 = fc.fft_kernels(kerns, spectral=sd32, store_dtype="bfloat16")
    with pytest.raises(InvalidInputError, match="store-dtype mismatch"):
        fc.conv_spectral_pipelined(sd32, sk16, chunk_size=2)
    mesh = fc.make_mesh(data=1)
    with pytest.raises(InvalidInputError, match="store-dtype mismatch"):
        fc.conv_spectral_sharded(sd32, sk16, mesh)


def test_sharded_raw_kernels_inherit_tier(rng):
    """conv_spectral_sharded transforms raw kernels at the DATA spectra's
    store dtype (a silent f32 bank against bf16 data doubles the intended
    per-device residency and mixes tiers)."""
    data = _mk(rng, (32, 32, 2))
    kerns = np.stack([_mk(rng, (5, 5, 2)) for _ in range(8)])
    sd = fc.fft_data(data, 5, 5, store_dtype="bfloat16")
    mesh = fc.make_mesh(data=1)
    out = np.array(
        fc.conv_spectral_sharded(sd, kerns, mesh).astype(jnp.float32)
    )
    # must match an explicitly bf16-precomputed bank bit-for-bit (an f32
    # bank would round differently everywhere)
    sk16 = fc.fft_kernels(kerns, spectral=sd, store_dtype="bfloat16")
    want = np.array(
        fc.conv_spectral_sharded(sd, sk16, mesh).astype(jnp.float32)
    )
    np.testing.assert_array_equal(out, want)
    for i in range(8):
        assert rel_err(
            out[i], fft_map_f64(data, kerns[i], sd.fft_h, sd.fft_w)
        ) < BF16_TOL


def test_tiled_chunk_model_is_tier_aware(rng):
    """The tiled engine's chunk-size model counts stored-spectra bytes at
    the tier's width: under the same tight budget the bf16 tier gets at
    least the f32 chunk (its fixed footprint halves)."""
    from cuda_fft_convolution_tpu import api as _api

    data = _mk(rng, (256, 256, 1))
    n = 16
    chunks = {}
    try:
        for tier in ("float32", "bfloat16"):
            sd = fc.fft_data_tiled(data, 9, 9, store_dtype=tier)
            # the sizer's contract is the BATCHED rank-6 block layout —
            # every call site passes spectral.re[None] when unbatched
            d_re = sd.re[None]
            # budget just above the f32 fixed footprint so per-kernel cost
            # becomes the binding constraint
            fc.set_config(hbm_budget_bytes=48 << 20)
            chunks[tier] = _api._tiled_chunk_size(sd, d_re, n)
            fc.set_config(hbm_budget_bytes=None)
    finally:
        fc.set_config(hbm_budget_bytes=None)
    assert chunks["bfloat16"] >= chunks["float32"]
    assert chunks["bfloat16"] > 1  # halved spectra must buy headroom


def test_sharded_streaming_spatial_bf16(rng):
    """The sharded giant-bank streaming path (raw bank too big to hold
    resident) accepts bf16-tier data spectra: per-chunk f32 kernel
    transforms run a mixed MAC against the bf16 data planes (tier-bound
    accuracy either way)."""
    data = _mk(rng, (48, 48, 2))
    bank = np.stack([_mk(rng, (5, 5, 2)) for _ in range(16)])
    sd = fc.fft_data(data, 5, 5, store_dtype="bfloat16")
    mesh = fc.make_mesh(data=1)
    try:
        fc.set_config(hbm_budget_bytes=1 << 20)  # forces streaming
        out = np.array(
            fc.conv_spectral_sharded(sd, bank, mesh).astype(jnp.float32)
        )
    finally:
        fc.set_config(hbm_budget_bytes=None)
    sd64 = fc.fft_data(data, 5, 5)
    want = np.array(fc.conv_spectral(sd64, bank))
    assert rel_err(out, want) < BF16_TOL


def test_fftmap_tiled_bf16_tier(rng):
    """mode='fftmap' through the TILED engine at the bf16 tier: the baked
    canvas flows with bf16 spectra; raw maps stay within tier tolerance of
    the fp32 direct engine's."""
    data = _mk(rng, (90, 80, 2))
    bank = np.stack([_mk(rng, (7, 7, 2)) for _ in range(4)])
    want = np.asarray(
        fc.fft_conv(data, kernels=bank, mode="fftmap", algorithm="direct")
    )
    got = np.asarray(
        fc.fft_conv(
            data, kernels=bank, mode="fftmap", algorithm="tiled",
            store_dtype="bfloat16",
        ).astype(jnp.float32)
    )
    assert got.shape == want.shape
    assert rel_err(got, want) < BF16_TOL
