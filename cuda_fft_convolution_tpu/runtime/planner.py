"""Planning API: FFT sizing + bank execution plans (native-accelerated).

Mirrors the decisions the reference makes in host code per call — FFT dims
(src/cudaConvolutionFFT.cu:103-112), buffer sizing (:116-127), and the
streams variant's fixed 2-slot pipeline (src/cudaConvFFTDataStreams.cu:124)
— but computes them from an explicit memory model, optionally through the
C++ planner (csrc/planner.cpp) when built.
"""

from __future__ import annotations

import ctypes
import dataclasses

from cuda_fft_convolution_tpu.runtime import native
from cuda_fft_convolution_tpu.utils.fft_size import FftSizePolicy

_POLICY_CODE = {
    FftSizePolicy.MULTIPLE16: 0,
    FftSizePolicy.POW2: 1,
    FftSizePolicy.FAST: 2,
}


def get_native_planner():
    """The loaded C++ planner library, or None (pure-Python fallback)."""
    return native.load()


def compute_fft_size_native(
    data_h: int, data_w: int, max_kh: int, max_kw: int,
    policy: FftSizePolicy | str = FftSizePolicy.FAST,
) -> tuple[int, int] | None:
    """FFT dims via the native planner; None if the library isn't available.
    Must agree exactly with utils.fft_size.compute_fft_size (tested)."""
    lib = native.load()
    if lib is None:
        return None
    oh, ow = ctypes.c_int64(), ctypes.c_int64()
    lib.ffc_compute_fft_size(
        data_h, data_w, max_kh, max_kw,
        _POLICY_CODE[FftSizePolicy(policy)],
        ctypes.byref(oh), ctypes.byref(ow),
    )
    return int(oh.value), int(ow.value)


@dataclasses.dataclass(frozen=True)
class BankPlan:
    """Execution plan for a bank convolution.

    chunk_size: kernels per pipelined chunk (the generalization of the
      streams variant's one-kernel-per-stream slots).
    peak_bytes: estimated device-memory working set at that chunk size.
    """

    chunk_size: int
    peak_bytes: int


def plan_bank(
    n_kernels: int,
    feature_dim: int,
    fft_h: int,
    fft_w: int,
    batch: int = 1,
    hbm_budget_bytes: int = 8 << 30,
    store_bytes: int = 4,
) -> BankPlan:
    """Choose the pipeline chunk size so one chunk's spectra + products +
    output maps (double-buffered) fit the memory budget.

    ``store_bytes``: per-element width of the stored spectra (4 = f32 tier,
    2 = the bf16 serving tier — data/bank/product spectra all halve; output
    maps stay f32)."""
    lib = native.load()
    if lib is not None:
        chunk, peak = ctypes.c_int64(), ctypes.c_int64()
        lib.ffc_plan_bank(
            n_kernels, feature_dim, fft_h, fft_w, batch, hbm_budget_bytes,
            store_bytes, ctypes.byref(chunk), ctypes.byref(peak),
        )
        return BankPlan(int(chunk.value), int(peak.value))
    # Pure-Python fallback — same arithmetic as csrc/planner.cpp:ffc_plan_bank.
    wc = fft_w // 2 + 1
    # Nominal bytes (csrc/planner.cpp keeps in sync).
    spec = fft_h * wc * 2 * store_bytes
    map_bytes = fft_h * fft_w * 4
    # Fixed: data spectra + input + RESIDENT bank spectra + full output maps.
    fixed = (
        batch * feature_dim * spec
        + batch * feature_dim * fft_h * fft_w * 4
        + n_kernels * feature_dim * spec
        + batch * n_kernels * map_bytes
    )
    budget = hbm_budget_bytes - fixed
    # Unchunked per-kernel cost: products + inverse scratch. For F > 1 keep
    # bank/16 slack for the F-contraction's operand relayouts. Prefer
    # unchunked whenever it fits (a chunked lax.map pays a bank-slice copy
    # per chunk). csrc/planner.cpp keeps in sync.
    per_unchunked = 2 * (batch * spec + 2 * batch * map_bytes)
    unchunked_extra = (
        (n_kernels * feature_dim * spec) // 16 if feature_dim > 1 else 0
    )
    if budget >= n_kernels * per_unchunked + unchunked_extra:
        return BankPlan(
            int(n_kernels),
            int(fixed + n_kernels * per_unchunked + unchunked_extra),
        )
    # Slice copy + its F-contraction relayout (F > 1) per kernel.
    slice_copies = (
        2 * feature_dim * spec if feature_dim > 1 else feature_dim * spec
    )
    per_chunked = 2 * (
        slice_copies + batch * spec + batch * (3 * map_bytes)
    )
    budget = max(budget, per_chunked)
    chunk = max(1, min(n_kernels, budget // per_chunked))
    return BankPlan(int(chunk), int(fixed + chunk * per_chunked))
