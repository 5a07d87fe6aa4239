"""Platform contract: nothing in the package is written for one accelerator
but the GPU, the memory budget comes from the device, the compile cache
lives where it is told, the benchmark knows its card's peaks, and the
on-card smoke script's phases run (here at tiny sizes on the CPU)."""

import json
import pathlib
import re
from types import SimpleNamespace

import numpy as np
import pytest

import bench
import chip_smoke
from cuda_fft_convolution_tpu import api
from cuda_fft_convolution_tpu.utils import compile_cache
from cuda_fft_convolution_tpu.utils.config import set_config

_ROOT = pathlib.Path(__file__).resolve().parents[1]
_PACKAGE = _ROOT / "cuda_fft_convolution_tpu"


@pytest.mark.parametrize(
    "pattern",
    [
        # a Pallas backend other than the GPU's (Triton, Mosaic GPU)
        r"pallas(\.| import )(?!triton\b|mosaic_gpu\b)[a-z_]+",
        r"interpret\s*=\s*(True|jax\.)",
        # a branch on any platform but the CPU's and the GPU's
        r"""(default_backend\(\)|platform)\s*[!=]=\s*["'](?!cpu["']|gpu["'])""",
    ],
    ids=["foreign_pallas_backend", "interpret_mode", "platform_branch"],
)
def test_package_has_no_code_for_other_accelerators(pattern):
    hits = [
        f"{path.relative_to(_ROOT)}:{n}"
        for path in sorted(_PACKAGE.rglob("*.py"))
        for n, line in enumerate(path.read_text().splitlines(), 1)
        if re.search(pattern, line)
    ]
    assert not hits, hits


class _FakeDevice(SimpleNamespace):
    def memory_stats(self):
        return self.stats


@pytest.mark.parametrize(
    "platform,stats,want",
    [
        ("gpu", {"bytes_limit": 60 << 30}, int(0.92 * (60 << 30))),
        ("cpu", None, 8 << 30),
        ("gpu", {}, RuntimeError),
    ],
    ids=["memory_stats", "cpu_default", "unknown_accelerator_raises"],
)
def test_device_memory_budget(monkeypatch, platform, stats, want):
    dev = _FakeDevice(platform=platform, device_kind="some card", stats=stats)
    monkeypatch.setattr(api.jax, "devices", lambda *a: [dev])
    set_config(hbm_budget_bytes=None, hbm_fraction=0.92)
    if want is RuntimeError:
        with pytest.raises(RuntimeError, match="bytes_limit"):
            api._device_memory_budget()
    else:
        assert api._device_memory_budget() == want


def test_memory_budget_override_wins(monkeypatch):
    dev = _FakeDevice(platform="gpu", device_kind="some card", stats={})
    monkeypatch.setattr(api.jax, "devices", lambda *a: [dev])
    try:
        set_config(hbm_budget_bytes=123 << 20)
        assert api._device_memory_budget() == 123 << 20
    finally:
        set_config(hbm_budget_bytes=None)


@pytest.mark.gpu
def test_memory_budget_on_gpu(gpu):
    set_config(hbm_budget_bytes=None)
    limit = gpu.memory_stats()["bytes_limit"]
    assert api._device_memory_budget() == int(0.92 * limit)


@pytest.mark.parametrize("env", ["set", "unset", "empty"])
def test_compile_cache_dir(monkeypatch, tmp_path, env):
    if env == "set":
        monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "c"))
        want = str(tmp_path / "c")
    else:
        if env == "unset":
            monkeypatch.delenv(compile_cache.ENV_VAR, raising=False)
        else:
            monkeypatch.setenv(compile_cache.ENV_VAR, "")
        want = str(_ROOT / ".jax_cache")
    assert compile_cache.compile_cache_dir() == want


def test_compile_cache_default_is_fixed_and_ignored(monkeypatch, tmp_path):
    import jax

    assert compile_cache.DEFAULT_DIR == str(_ROOT / ".jax_cache")
    ignored = (_ROOT / ".gitignore").read_text().split()
    assert ".jax_cache/" in ignored
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv(compile_cache.ENV_VAR, str(tmp_path / "cc"))
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path / "cc")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        assert (tmp_path / "cc").is_dir()
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_bench_peaks_table():
    h100 = bench.device_peaks("NVIDIA H100 80GB HBM3")
    assert h100["hbm_gbps"] == 3350.0
    with pytest.raises(KeyError, match="no published peaks"):
        bench.device_peaks("some unknown card")


# ---------------------------------------------------------------------------
# chip_smoke.py: each phase at a tiny size on the CPU (the script's main
# refuses to run anywhere but a GPU)
# ---------------------------------------------------------------------------


def test_chip_smoke_headline_and_amortized_phases():
    data, bank, maps = chip_smoke.phase_headline(
        "cpu", size=96, n=3, k=12, n_check=2
    )
    assert maps.shape == (3, 96, 96)
    chip_smoke.phase_amortized("cpu", data, bank, maps, frames=3)


def test_chip_smoke_dpm_phase():
    chip_smoke.phase_dpm("cpu", image=256, n=6, kd=6, n_check=2)


def test_chip_smoke_ragged_and_grad_phase():
    chip_smoke.phase_ragged_and_grad(
        "cpu", size=64, sizes=(5, 9), per_size=2, frames=2, train_hw=48,
        train_f=3, train_n=4, train_k=6,
    )


def test_chip_smoke_four_phase():
    import jax

    chip_smoke.phase_four(
        "cpu", jax.devices()[:4], image=256, n=8, kd=6, frames=2,
        train_hw=32, train_f=3, train_n=4,
    )


def test_chip_smoke_refuses_cpu(capsys):
    assert chip_smoke.main([]) != 0
    out = capsys.readouterr().out
    assert '"ok"' not in out


def test_chip_smoke_check_peak_rule():
    oracle = np.zeros((8, 8))
    oracle[2, 3] = 1.0
    oracle[5, 5] = 0.5
    chip_smoke._check_peak(oracle, (2, 3), 1.0, 1e-3)
    with pytest.raises(chip_smoke.PhaseError):
        chip_smoke._check_peak(oracle, (5, 5), 1.0, 1e-3)
    # a near tie: either position within the tier's error is right
    oracle[5, 5] = 0.9995
    chip_smoke._check_peak(oracle, (5, 5), 0.9995, 1e-3)


def test_chip_smoke_last_line_contract(monkeypatch, capsys):
    """With every phase passing, the last stdout line is exactly the JSON
    result object naming the device as JAX reports it."""
    import jax

    dev = SimpleNamespace(platform="gpu", device_kind="fake card")
    monkeypatch.setattr(jax, "devices", lambda *a: [dev])
    for name in ("phase_headline", "phase_amortized", "phase_dpm",
                 "phase_ragged_and_grad"):
        monkeypatch.setattr(
            chip_smoke, name, lambda *a, **k: (None, None, None)
        )
    assert chip_smoke.main([]) == 0
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "fake card", "count": 1},
    }
    # --four on one card refuses
    assert chip_smoke.main(["--four"]) != 0
