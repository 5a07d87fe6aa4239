"""Runtime layer: native planner + ahead-of-time compiled execution plans.

Replacement for the reference's host runtime: the MEX glue that
sizes FFTs, creates cuFFT plans, and allocates buffers per call
(src/cudaConvolutionFFT.cu:103-163), and the streams variant's hand-built
execution schedule (src/cudaConvFFTDataStreams.cu:273-328). Here:

  - ``native`` / ``planner``: C++ planning library (csrc/planner.cpp, loaded
    via ctypes, built on demand with g++) for FFT sizing and bank-chunk
    scheduling, with a pure-Python fallback that defines the semantics.
  - ``plan``: ``FftConvPlan`` — geometry fixed up front, all XLA executables
    compiled ahead of time (jax AOT). The cufftPlanMany analogue: pay
    compilation once, then every execute() is dispatch-only.
  - ``autotune``: measured block-geometry table + on-device tuner (the
    reference's thread-dim 4-vector knob, src/cudaConvolutionFFT.cu:72-82,
    done with measurements instead of magic numbers).
"""

from cuda_fft_convolution_tpu.runtime.planner import (
    BankPlan,
    get_native_planner,
    plan_bank,
)
from cuda_fft_convolution_tpu.runtime.plan import FftConvPlan, make_plan
from cuda_fft_convolution_tpu.runtime.stream import (
    ConvFuture,
    ConvStream,
    RaggedConvFuture,
    RaggedConvStream,
    ShardedConvStream,
)
from cuda_fft_convolution_tpu.runtime.autotune import (
    autotune_block_geometry,
    lookup_tuned_geometry,
    register_tuned_geometry,
    save_user_cache,
)

__all__ = [
    "autotune_block_geometry",
    "lookup_tuned_geometry",
    "register_tuned_geometry",
    "save_user_cache",
    "BankPlan",
    "get_native_planner",
    "plan_bank",
    "FftConvPlan",
    "make_plan",
    "ConvFuture",
    "ConvStream",
    "RaggedConvFuture",
    "RaggedConvStream",
    "ShardedConvStream",
]
