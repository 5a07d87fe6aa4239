"""Runtime layer tests: native planner parity + AOT plan execution."""

import os
import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.runtime import make_plan, plan_bank
from cuda_fft_convolution_tpu.runtime.planner import (
    compute_fft_size_native,
    get_native_planner,
)
from cuda_fft_convolution_tpu.utils.fft_size import (
    FftSizePolicy,
    compute_fft_size,
    next_fast_len,
)
from tests.oracles import fft_conv_full_f64, rel_err


def test_native_planner_builds_and_matches_python():
    """The C++ planner (csrc/planner.cpp) must agree bit-for-bit with the
    Python definition of record (utils/fft_size.py)."""
    lib = get_native_planner()
    if lib is None:
        pytest.skip("native planner unavailable (no g++?)")
    for policy in FftSizePolicy:
        for dh, dw, kh, kw in [
            (64, 8, 10, 4),
            (2048, 2048, 64, 64),
            (1, 1, 1, 1),
            (100, 37, 13, 5),
            (511, 513, 33, 31),
        ]:
            assert compute_fft_size_native(dh, dw, kh, kw, policy) == (
                compute_fft_size(dh, dw, kh, kw, policy)
            ), (policy, dh, dw, kh, kw)
    for n in [1, 7, 73, 2111, 4097]:
        assert lib.ffc_next_fast_len(n) == next_fast_len(n)


def test_native_block_planner_matches_python():
    """The native analytic block-geometry planner (csrc/planner.cpp) must
    agree with the Python definition of record (ops/tiled.py analytic
    rules) across engines and kernel scales."""
    import ctypes

    from cuda_fft_convolution_tpu.ops.tiled import choose_block_fft
    from cuda_fft_convolution_tpu.runtime import autotune

    lib = get_native_planner()
    if lib is None:
        pytest.skip("native planner unavailable (no g++?)")

    # Analytic block plan: agreement with the Python fallback (the measured
    # table is a Python-side overlay — clear it for the comparison)
    c64 = ctypes.c_int64
    try:
        autotune._MEASURED.clear()
        for engine in (1, 0):
            for dh, dw, kh, kw in [
                (2048, 2048, 64, 64),
                (2048, 2048, 512, 512),
                (512, 512, 12, 12),
                (100, 90, 6, 6),
                (64, 64, 64, 64),   # declines: image spans < 2 blocks
                (40, 40, 33, 33),   # declines: extreme overlap redundancy
            ]:
                lh = c64(0); lw = c64(0); pkh = c64(0); pkw = c64(0)
                found = lib.ffc_choose_block_fft(
                    dh, dw, kh, kw, engine, 1024,
                    ctypes.byref(lh), ctypes.byref(lw),
                    ctypes.byref(pkh), ctypes.byref(pkw),
                )
                want = choose_block_fft(
                    dh, dw, kh, kw, matmul_engine=bool(engine),
                    _with_plan=True,
                )
                if want is None:
                    assert found == 0, (engine, dh, dw, kh, kw)
                else:
                    assert found == 1, (engine, dh, dw, kh, kw)
                    assert (lh.value, lw.value, pkh.value, pkw.value) == want
    finally:
        autotune._MEASURED.clear()


def test_plan_bank_chunk_bounds():
    p = plan_bank(100, 1, 2160, 2160, batch=1, hbm_budget_bytes=8 << 30)
    assert 1 <= p.chunk_size <= 100
    assert p.peak_bytes <= (8 << 30) or p.chunk_size == 1
    # tiny budget → chunk 1
    p1 = plan_bank(100, 31, 2160, 2160, batch=8, hbm_budget_bytes=1 << 20)
    assert p1.chunk_size == 1
    # huge budget → whole bank at once
    p2 = plan_bank(10, 1, 80, 16, batch=1, hbm_budget_bytes=8 << 30)
    assert p2.chunk_size == 10


def test_plan_bank_store_bytes():
    """bf16-tier spectra (store_bytes=2) halve the modeled footprint: never
    smaller chunks than f32, strictly larger in the chunk-bound regime."""
    kw = dict(batch=1, hbm_budget_bytes=5 << 30)
    f32 = plan_bank(128, 31, 540, 540, store_bytes=4, **kw)
    bf16 = plan_bank(128, 31, 540, 540, store_bytes=2, **kw)
    assert bf16.chunk_size >= f32.chunk_size
    assert bf16.peak_bytes < f32.peak_bytes
    assert f32.chunk_size < 128  # f32 must chunk at this budget...
    assert bf16.chunk_size > f32.chunk_size  # ...and bf16 chunks larger


def test_aot_plan_matches_api(rng):
    """FftConvPlan.execute ≡ fft_conv for the planned geometry, with zero
    retracing at call time."""
    data = rng.standard_normal((32, 24, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape)
    got = np.array(plan.execute(data, kerns))
    want = np.array(fc.fft_conv(data, kernels=kerns))
    # scale-relative: on an accelerator the AOT program and the API program
    # may schedule sums differently (~1e-6 rel fp32 reassociation noise)
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 1e-5
    # amortized path: precompute spectra once, execute_spectral repeatedly
    dfft = plan.data_fft(data)
    kfft = plan.kernel_fft(kerns)
    got2 = np.array(plan.execute_spectral(dfft, kfft))
    assert np.max(np.abs(got2 - want)) / scale < 1e-5


def test_aot_plan_batched_and_correlation(rng):
    data = rng.standard_normal((2, 16, 16, 1)).astype(np.float32)
    kerns = rng.standard_normal((4, 3, 3, 1)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape, correlation=True)
    got = np.array(plan.execute(data, kerns))
    assert got.shape[0:2] == (2, 4)
    flipped = kerns[:, ::-1, ::-1, :]
    want = np.array(fc.fft_conv(data, kernels=flipped))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_aot_plan_shape_validation(rng):
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape)
    with pytest.raises(ValueError):
        plan.execute(data[:8], kerns)
    with pytest.raises(ValueError):
        plan.execute(data, kerns[:, :2])


def test_plan_full_window_correct(rng):
    data = rng.standard_normal((20, 20, 3)).astype(np.float32)
    kerns = rng.standard_normal((2, 5, 5, 3)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape)
    maps = np.array(plan.execute(data, kerns))
    for i in range(2):
        assert rel_err(maps[i][:24, :24], fft_conv_full_f64(data, kerns[i])) < 1e-5


def test_aot_plan_tiled(rng):
    """Tiled plans compile the overlap-save engine with a baked 'full'
    window and match the direct plan's results."""
    data = rng.standard_normal((80, 70, 2)).astype(np.float32)
    kerns = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape, algorithm="tiled", mode="full")
    got = np.array(plan.execute(data, kerns))
    assert got.shape == (3, 85, 75)
    for i in range(3):
        assert rel_err(got[i], fft_conv_full_f64(data, kerns[i])) < 1e-5
    # amortized: block spectra + bank spectra precomputed
    dfft = plan.data_fft(data)
    kfft = plan.kernel_fft(kerns)
    got2 = np.array(plan.execute_spectral(dfft, kfft))
    np.testing.assert_allclose(got2, got, atol=1e-6)


def test_aot_plan_tiled_batched(rng):
    data = rng.standard_normal((2, 60, 60, 1)).astype(np.float32)
    kerns = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    plan = make_plan(data.shape, kerns.shape, algorithm="tiled", mode="same")
    got = np.array(plan.execute(data, kerns))
    assert got.shape == (2, 2, 60, 60)
    want = np.array(fc.fft_conv(data, kernels=kerns, mode="same",
                                algorithm="direct"))
    np.testing.assert_allclose(got, want, atol=2e-4)


def test_autotune_table_lookup_and_registration():
    """The measured-geometry table: registration keys by pow-2 kernel
    envelope + feature bucket; choose_block_fft consults it on the matmul
    engine."""
    from cuda_fft_convolution_tpu.ops.tiled import choose_block_fft
    from cuda_fft_convolution_tpu.runtime import autotune

    try:
        autotune.register_tuned_geometry(200, 200, 48, 192, f=1)
        assert autotune.lookup_tuned_geometry(200, 200, 1) == (48, 192)
        # same pow-2 envelope (129..256 -> 256) shares the entry
        assert autotune.lookup_tuned_geometry(140, 250, 1) == (48, 192)
        # different feature bucket and envelope are distinct
        assert autotune.lookup_tuned_geometry(200, 200, 31) is None
        assert autotune.lookup_tuned_geometry(512, 512, 1) is None
        # matmul-engine choose_block_fft returns the tuned geometry
        blk = choose_block_fft(4096, 4096, 200, 200, matmul_engine=True)
        assert blk == (48 + 199, 192 + 199)
        # ...but declines when the tuned block doesn't fit the image
        blk_small = choose_block_fft(200, 200, 200, 200, matmul_engine=True)
        assert blk_small != (48 + 199, 192 + 199)
    finally:
        autotune._MEASURED.clear()


def test_autotune_default_candidates_lane_aligned():
    """Every W candidate must give a Hermitian width that is a multiple
    of 128: block_w = vw + kw − 1 = 256·m − 1 so Wc = 128·m exactly —
    including kernels wider than 256 (the 512² big-kernel envelope)."""
    from cuda_fft_convolution_tpu.runtime.autotune import default_candidates

    for kw in (8, 32, 64, 128, 200, 512):
        cands = default_candidates(kw, kw)
        plain = [c for c in cands if len(c) == 2]
        assert plain, f"no analytic candidates for kw={kw}"
        for vh, vw in plain:
            bw = vw + kw - 1
            wc = bw // 2 + 1
            assert wc % 128 == 0, (kw, vw, bw, wc)
            assert vw >= 128


def test_autotune_live_measure_cpu(tmp_path, monkeypatch):
    """autotune_block_geometry measures candidates on the current backend
    and persists the table."""
    from cuda_fft_convolution_tpu.runtime import autotune

    try:
        best, timings = autotune.autotune_block_geometry(
            (96, 96, 1), 5, 5,
            n_kernels=4,
            candidates=[(16, 32), (32, 32)],
            iters=1,
        )
        assert best in timings and len(timings) == 2
        # full-fidelity registration: geometry + explicit blocks
        want = (*best, best[0] + 4, best[1] + 4)
        assert autotune.lookup_tuned_geometry(5, 5, 1) == want
        cache = tmp_path / "tune.json"
        monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(cache))
        autotune.save_user_cache()
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False
        assert autotune.lookup_tuned_geometry(5, 5, 1) == want
    finally:
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False


def test_autotune_roundtrip_preserves_fused_plan(monkeypatch):
    """tune → register → lookup → dispatch keeps explicit blocks: a tuned
    enlarged-envelope plan dispatches exactly the blocks it measured."""
    from cuda_fft_convolution_tpu.ops.tiled import choose_block_plan
    from cuda_fft_convolution_tpu.runtime import autotune

    try:
        # an enlarged-envelope candidate (4-tuple) must win and register
        # its explicit blocks
        best, timings = autotune.autotune_block_geometry(
            (128, 256, 1), 9, 9,
            n_kernels=2,
            candidates=[(24, 120, 40, 160)],
            iters=1,
        )
        assert best == (24, 120, 40, 160)
        hit = autotune.lookup_tuned_geometry(9, 9, 1)
        assert hit[0] == 24 and hit[1] == 120
        assert hit[2] == 40 and hit[3] == 160  # explicit blocks preserved
        # dispatch consumes the explicit blocks (enlarged envelope)
        plan = choose_block_plan(1024, 1024, 9, 9, matmul_engine=True)
        assert plan == (40, 160, 40 - 24 + 1, 160 - 120 + 1)
    finally:
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False


def test_autotune_multi_f_bucket():
    """2 <= F < 8 is its own bucket: envelopes without a bucket-2 entry
    fall back to the F=1 entry, user bucket-2 registrations override it,
    and F >= 8 keeps its own bucket."""
    from cuda_fft_convolution_tpu.runtime import autotune

    autotune._MEASURED.clear()
    try:
        autotune.register_tuned_geometry(64, 64, 192, 384, f=1,
                                         block_h=256, block_w=512)
        for f in (1, 2, 4, 7):
            assert autotune.lookup_tuned_geometry(64, 64, f) == (
                192, 384, 256, 512,
            )
        assert autotune.lookup_tuned_geometry(64, 64, 8) is None
        autotune.register_tuned_geometry(64, 64, 48, 192, f=3)
        assert autotune.lookup_tuned_geometry(64, 64, 5) == (48, 192)
        assert autotune.lookup_tuned_geometry(64, 64, 1)[3] == 512
        autotune.register_tuned_geometry(64, 64, 64, 384, f=8)
        assert autotune.lookup_tuned_geometry(64, 64, 31) == (64, 384)
    finally:
        autotune._MEASURED.clear()


def test_plan_bank_native_matches_python(monkeypatch):
    """csrc/planner.cpp ffc_plan_bank must agree with the Python fallback."""
    from cuda_fft_convolution_tpu.runtime import native, planner

    lib = planner.get_native_planner()
    if lib is None:
        pytest.skip("native planner unavailable")
    cases = [
        (256, 31, 540, 540, 1, 12 << 30),   # giant bank: unchunked
        (100, 1, 2160, 2160, 8, 4 << 30),   # tight: chunk 1
        (100, 1, 2160, 2160, 1, 12 << 30),
        (10, 3, 80, 16, 1, 8 << 30),
    ]
    native_plans = [planner.plan_bank(*c[:5], hbm_budget_bytes=c[5]) for c in cases]
    monkeypatch.setattr(native, "load", lambda: None)
    python_plans = [planner.plan_bank(*c[:5], hbm_budget_bytes=c[5]) for c in cases]
    for c, a, b in zip(cases, native_plans, python_plans):
        assert (a.chunk_size, a.peak_bytes) == (b.chunk_size, b.peak_bytes), c


def test_native_loader_stale_abi_falls_back(tmp_path, monkeypatch):
    """A stale libfftconv_planner.so missing current-ABI symbols (e.g. a
    prebuilt copy newer than planner.cpp) must yield None — falling back to
    the Python planners — not raise AttributeError out of load()."""
    import subprocess

    from cuda_fft_convolution_tpu.runtime import native

    src = tmp_path / "old.cpp"
    src.write_text('extern "C" long long ffc_ceil_div(long long a, '
                   "long long b) { return (a + b - 1) / b; }\n")
    so = tmp_path / "libfftconv_planner.so"
    subprocess.run(
        ["g++", "-O2", "-shared", "-fPIC", "-o", str(so), str(src)],
        check=True,
    )
    # a planner.cpp OLDER than the .so so the mtime check skips the rebuild
    planner_src = tmp_path / "planner.cpp"
    planner_src.write_text("// stub\n")
    os.utime(planner_src, (0, 0))
    monkeypatch.setattr(native, "_csrc_dir", lambda: str(tmp_path))
    monkeypatch.setattr(native, "_TRIED", False)
    monkeypatch.setattr(native, "_LIB", None)
    assert native.load() is None


def test_plan_direct_linear_modes(rng):
    """Direct plans compile linear windows too (static trim baked into the
    program): parity vs fft_conv for every mode × same_offset convention."""
    import jax.numpy as jnp

    import cuda_fft_convolution_tpu as fc

    data = rng.standard_normal((20, 22, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 4, 5, 2)).astype(np.float32)
    for mode in ("full", "same", "valid"):
        for off in ("scipy", "matlab"):
            plan = fc.make_plan(
                (20, 22, 2), (3, 4, 5, 2), algorithm="direct", mode=mode,
                same_offset=off,
            )
            got = np.asarray(plan.execute(jnp.asarray(data), jnp.asarray(bank)))
            want = np.asarray(
                fc.fft_conv(data, kernels=bank, mode=mode,
                            algorithm="direct", same_offset=off)
            )
            assert got.shape == want.shape, (mode, off)
            np.testing.assert_allclose(got, want, atol=1e-4)


def test_autotune_dtype_keys_and_fallback(tmp_path, monkeypatch):
    """Table keys carry the storage tier. A bf16 registration is distinct
    from f32; bf16 lookups FALL BACK to the f32 entry when no tier
    measurement exists; the cache file round-trips dtype keys and loads
    legacy 3-part keys (and their old flag field) as f32."""
    import json

    from cuda_fft_convolution_tpu.runtime import autotune

    try:
        autotune.register_tuned_geometry(200, 200, 48, 192, f=1)
        # bf16 falls back to the f32 measurement
        assert autotune.lookup_tuned_geometry(200, 200, 1, "bfloat16") == (
            48, 192,
        )
        autotune.register_tuned_geometry(
            200, 200, 96, 384, f=1, block_h=160, block_w=511,
            store_dtype="bfloat16",
        )
        assert autotune.lookup_tuned_geometry(200, 200, 1, "bfloat16") == (
            96, 384, 160, 511,
        )
        # f32 entry unchanged
        assert autotune.lookup_tuned_geometry(200, 200, 1) == (48, 192)
        # cache round-trip
        path = tmp_path / "tune.json"
        monkeypatch.setenv("FFTCONV_AUTOTUNE_CACHE", str(path))
        autotune.save_user_cache()
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False
        assert autotune.lookup_tuned_geometry(200, 200, 1, "bfloat16") == (
            96, 384, 160, 511,
        )
        # legacy 3-part key loads as the f32 tier, its flag field dropped
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False
        path.write_text(json.dumps({"512,512,1": [64, 256, False]}))
        assert autotune.lookup_tuned_geometry(512, 512, 1) == (64, 256)
    finally:
        autotune._MEASURED.clear()
        autotune._user_cache_loaded = False


def test_aot_plan_lazy_compiles_on_demand(rng):
    """make_plan(lazy=True) defers every stage's lower().compile() to its
    first use and matches the eager plan bit-for-bit; compile_now()
    forces the remaining stages. The serving streams rely on this: they
    dispatch through their own fused jit closures and only ever invoke
    kernel_fft, so eager builds of the other two executables would be
    wasted compiles."""
    data = rng.standard_normal((40, 52, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 7, 5, 2)).astype(np.float32)
    lazy = make_plan(data.shape, bank.shape, mode="same", lazy=True)
    assert lazy._data_fft_exec is None
    assert lazy._kernel_fft_exec is None
    assert lazy._conv_exec is None
    eager = make_plan(data.shape, bank.shape, mode="same")
    assert eager._conv_exec is not None  # default unchanged: AOT up front
    # single-stage use compiles ONLY that stage
    kfft = lazy.kernel_fft(bank)
    assert lazy._kernel_fft_exec is not None
    assert lazy._data_fft_exec is None and lazy._conv_exec is None
    out_lazy = lazy.execute_spectral(lazy.data_fft(data), kfft)
    assert lazy._data_fft_exec is not None and lazy._conv_exec is not None
    np.testing.assert_array_equal(
        np.asarray(out_lazy), np.asarray(eager.execute(data, bank))
    )
    # compile_now is idempotent and returns the plan
    assert lazy.compile_now() is lazy
    fresh = make_plan(
        data.shape, bank.shape, mode="same", algorithm="tiled", lazy=True
    ).compile_now()
    assert fresh._conv_exec is not None
