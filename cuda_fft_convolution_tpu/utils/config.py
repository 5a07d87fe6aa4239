"""Central runtime configuration.

The reference's "config system" is positional MEX args + compile-time
constants (SURVEY.md §5: thread-dim 4-vectors, GPU id, `static bool debug`,
FFT-size policy chosen by editing the source). Here it is one runtime
config object with env-var overrides:

  FFTCONV_POLICY        default FFT-size policy (multiple16|pow2|fast)
  FFTCONV_HBM_FRACTION  fraction of device memory the bank planner may use
  FFTCONV_CHUNK         fixed pipeline chunk size ('' = planner decides)
  FFTCONV_DEBUG         1 = debug logging (utils/logging.py)
"""

from __future__ import annotations

import dataclasses
import os

from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy


def _env_bool(name: str) -> bool | None:
    v = os.environ.get(name, "")
    if v == "":
        return None
    return v not in ("0", "false", "False")


def _env_int(name: str) -> int | None:
    v = os.environ.get(name, "")
    return int(v) if v else None


@dataclasses.dataclass
class Config:
    policy: FftSizePolicy = FftSizePolicy.FAST
    # Fraction of the device memory budget the planners may use. The
    # planners count RESIDENT tensors at their nominal bytes, so this only
    # covers untracked transients.
    hbm_fraction: float = 0.92
    # Absolute memory budget override (bytes). None = derive from the
    # device (memory_stats()["bytes_limit"]) × hbm_fraction. Set explicitly
    # for deterministic planning in tests and heterogeneous fleets.
    hbm_budget_bytes: int | None = None
    chunk_size: int | None = None  # None = planner decides
    # Transform engine: None/False = XLA FFT (cuFFT on the GPU); True = the
    # dense matmul-DFT engine (ops/dft.py), opt-in on every backend.
    # 'matmul_precision' applies to its DFT matmuls: 'highest' (fp32-exact,
    # default) | 'high' | 'default'.
    use_matmul_fft: bool | None = None
    matmul_precision: str = "highest"
    # Precision of the matmul-DFT engine's inverse-synthesis dots (the
    # tiled windowed inverse). Only 'highest' holds the library's ≤1e-5
    # fp32 bar on the GPU: there 'high' and 'default' run f32 dots in
    # TF32, which keeps about 3 decimal digits. The same holds for
    # 'matmul_precision'.
    inverse_precision: str = "highest"

    @classmethod
    def from_env(cls) -> "Config":
        return cls(
            policy=FftSizePolicy(os.environ.get("FFTCONV_POLICY", "fast")),
            hbm_fraction=float(os.environ.get("FFTCONV_HBM_FRACTION", "0.92")),
            hbm_budget_bytes=_env_int("FFTCONV_HBM_BUDGET_BYTES"),
            chunk_size=_env_int("FFTCONV_CHUNK"),
            use_matmul_fft=_env_bool("FFTCONV_USE_MATMUL_FFT"),
            matmul_precision=os.environ.get("FFTCONV_MATMUL_PRECISION", "highest"),
            inverse_precision=os.environ.get(
                "FFTCONV_INVERSE_PRECISION", "highest"
            ),
        )


_CONFIG = Config.from_env()

# jitted functions whose traced bodies read the config (transform-engine
# dispatch happens at trace time): set_config clears them so a config flip
# is not shadowed by a stale executable cached under the same static args.
_JIT_CONSUMERS: list = []


def register_jit_consumer(fn) -> None:
    _JIT_CONSUMERS.append(fn)


def invalidate_jit_consumers() -> None:
    """Clear every registered jitted consumer's executable cache.

    For dispatch-table mutations (tuned-geometry registration) that are
    read at TRACE time by jitted workers: clearing only the leaf wrapper is
    not enough — an outer jitted caller (e.g. ops.tiled.conv_blocks)
    inlines the leaf at trace time and would keep serving the stale
    dispatch from its own cache."""
    for fn in _JIT_CONSUMERS:
        try:
            fn.clear_cache()
        except Exception:
            pass


def get_config() -> Config:
    return _CONFIG


def set_config(**kwargs) -> Config:
    """Update global defaults, e.g. ``set_config(policy='pow2')``."""
    global _CONFIG
    updates = dict(kwargs)
    if "policy" in updates:
        updates["policy"] = FftSizePolicy(updates["policy"])
    _CONFIG = dataclasses.replace(_CONFIG, **updates)
    if {
        "use_matmul_fft", "matmul_precision", "inverse_precision",
    } & set(updates):
        for fn in _JIT_CONSUMERS:
            try:
                fn.clear_cache()
            except Exception:
                pass
    return _CONFIG
