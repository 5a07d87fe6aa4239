"""Backend capability probe — ≈ ``checkDeviceProp``
(src/cudaConvFFTData.h:47-65), which printf'd compute capability and
concurrent-kernel support. Here: one call that reports what the attached
backend can actually do (an FFT round trip) and the basic hardware facts
the planner uses. Cheap enough to run at service startup; returns a dict
instead of printing."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np


def selftest() -> dict:
    dev = jax.devices()[0]
    report: dict = {
        "backend": jax.default_backend(),
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }
    stats = dev.memory_stats() or {}
    report["hbm_bytes_limit"] = int(stats.get("bytes_limit", 0))

    # FFT round trip
    try:
        x = jnp.ones((2, 16, 16), jnp.float32)
        y = jax.jit(
            lambda a: jnp.fft.irfft2(jnp.fft.rfft2(a), s=(16, 16))
        )(x)
        report["fft_ok"] = bool(
            np.allclose(np.asarray(y), np.ones((2, 16, 16)), atol=1e-5)
        )
    except Exception as e:
        report["fft_ok"] = False
        report["fft_error"] = repr(e)

    from cuda_fft_convolution_tpu.runtime.planner import get_native_planner

    report["native_planner_ok"] = get_native_planner() is not None
    return report
