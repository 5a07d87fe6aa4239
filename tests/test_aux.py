"""Aux subsystem tests: config, checkpoint/resume, selftest (SURVEY.md §5)."""

import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.utils.checkpoint import load_spectral, save_spectral
from cuda_fft_convolution_tpu.utils.config import Config, get_config, set_config
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy
from cuda_fft_convolution_tpu.utils.selftest import selftest


def test_config_set_and_policy_effect():
    orig = get_config().policy
    try:
        set_config(policy="multiple16")
        assert get_config().policy is FftSizePolicy.MULTIPLE16
        # fft_data with policy=None picks the configured default
        sd = fc.fft_data(np.zeros((64, 8, 1), np.float32), 10, 4)
        assert (sd.fft_h, sd.fft_w) == (80, 16)
    finally:
        set_config(policy=orig)


def test_config_from_env(monkeypatch):
    monkeypatch.setenv("FFTCONV_POLICY", "pow2")
    monkeypatch.setenv("FFTCONV_USE_MATMUL_FFT", "0")
    monkeypatch.setenv("FFTCONV_CHUNK", "4")
    cfg = Config.from_env()
    assert cfg.policy is FftSizePolicy.POW2
    assert cfg.use_matmul_fft is False
    assert cfg.chunk_size == 4


@pytest.mark.parametrize("kind", ["data", "tiled", "tiled_same", "kernels"])
def test_checkpoint_roundtrip(tmp_path, rng, kind):
    data = rng.standard_normal((40, 30, 2)).astype(np.float32)
    kerns = [rng.standard_normal((5, 5, 2)).astype(np.float32) for _ in range(3)]
    if kind == "data":
        obj = fc.fft_data(data, 5, 5)
    elif kind == "tiled":
        obj = fc.fft_data_tiled(data, 5, 5, block_h=32, block_w=32)
    elif kind == "tiled_same":
        # baked output window: origin/win fields (incl. None) must survive
        obj = fc.fft_data_tiled(
            data, 5, 5, block_h=32, block_w=32, trim_mode="same"
        )
    else:
        obj = fc.fft_kernels(kerns, fft_h=64, fft_w=48, feature_dim=2)
    path = str(tmp_path / f"{kind}.npz")
    save_spectral(path, obj)
    back = load_spectral(path)
    assert type(back) is type(obj)
    np.testing.assert_allclose(fc.fetch(back.fft), fc.fetch(obj.fft), atol=1e-6)
    for field in ("fft_h", "fft_w", "data_h", "block_h", "kernel_hs",
                  "origin_h", "origin_w", "win_h", "win_w"):
        if hasattr(obj, field):
            assert getattr(back, field) == getattr(obj, field), field
    if kind == "tiled_same":
        got = np.array(fc.conv_spectral(back, kerns, mode="same"))
        want = np.array(fc.conv_spectral(obj, kerns, mode="same"))
        np.testing.assert_allclose(got, want, atol=1e-6)


def test_checkpoint_resume_produces_identical_results(tmp_path, rng):
    """A conv resumed from a loaded spectrum matches the live one — the
    reference's 'materialized intermediate' (src/cudaFFTData.cu:150) made
    durable."""
    data = rng.standard_normal((32, 32, 1)).astype(np.float32)
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    sd = fc.fft_data(data, 5, 5)
    want = np.array(fc.conv_spectral(sd, [kern]))
    path = str(tmp_path / "sd.npz")
    save_spectral(path, sd)
    got = np.array(fc.conv_spectral(load_spectral(path), [kern]))
    np.testing.assert_allclose(got, want, atol=1e-6)


def test_selftest_reports():
    rep = selftest()
    assert rep["fft_ok"] is True
    assert "backend" in rep and "device_kind" in rep
    assert isinstance(rep["native_planner_ok"], bool)


def test_bench_smoke_all_rows():
    """bench.py BENCH_SMOKE=1 end to end in a CPU subprocess: a plumbing
    error in any config branch (the full-size rows only run on the card)
    must fail CI, not the one measured run that counts. Asserts one valid
    JSON line with every row populated."""
    import json
    import os
    import subprocess
    import sys

    env = dict(os.environ)
    env.update(
        BENCH_SMOKE="1",
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="",  # no 8-device forcing: bench runs single-device
    )
    proc = subprocess.run(
        [sys.executable, "bench.py"],
        cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        env=env, capture_output=True, text=True, timeout=840,
    )
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = proc.stdout.strip().splitlines()[-1]
    rec = json.loads(line)
    assert rec["unit"] == "GPix*filters/s"
    assert rec["value"] > 0
    d = rec["detail"]
    assert d["max_rel_err_vs_f64_fft"] < 1e-5
    for key in (
        "headline_ms", "amortized_tiled_GPixF_s", "streaming_tiled_GPixF_s",
        "fftmap_parity_GPixF_s", "amortized_direct_GPixF_s",
        "bf16_GPixF_s", "bf16_streaming_GPixF_s",
        "bf16_bf16out_streaming_GPixF_s",
        "batch8_1024_GPixF_s", "bigkernel_512_GPixF_s",
        "bigkernel_streaming_GPixF_s", "dpm_hog_bf16_1024f_GPixF_s",
        "dpm_hog_streaming_GPixF_s", "dpm_direct_giantbank_GPixF_s",
        "dpm_direct_streaming_GPixF_s",
        "ragged_bank16_GPixF_s", "ragged_bank16_stream_GPixF_s",
    ):
        assert d.get(key) is not None and d[key] > 0, key


def test_checkpoint_fftmap_canvas_roundtrip(rng, tmp_path):
    """fftmap-baked tiled spectra survive checkpoint/resume: the canvas
    flag and window restore, and raw-map serving continues bit-identical."""
    import cuda_fft_convolution_tpu as fc
    from cuda_fft_convolution_tpu.utils.checkpoint import (
        load_spectral,
        save_spectral,
    )

    data = rng.standard_normal((40, 40, 1)).astype(np.float32)
    sd = fc.fft_data_tiled(data, 5, 5, trim_mode="fftmap")
    path = str(tmp_path / "sd_fftmap.npz")
    save_spectral(path, sd)
    sd2 = load_spectral(path)
    assert sd2.fftmap_canvas and sd2.win_h == sd.win_h
    kern = rng.standard_normal((5, 5, 1)).astype(np.float32)
    a = np.asarray(fc.conv_spectral(sd, [kern], mode="fftmap"))
    b = np.asarray(fc.conv_spectral(sd2, [kern], mode="fftmap"))
    np.testing.assert_array_equal(a, b)
