"""Profiling & timing harness.

The reference vendors two timer stacks it never calls (src/cutil.h:613,
common/helper_timer.h:28 — SURVEY.md §5 "tracing: none wired in"). Here
profiling is a first-class utility:

  - ``trace(dir)``: context manager around ``jax.profiler`` — produces a
    TensorBoard-loadable XPlane trace of every XLA op.
  - ``benchmark(fn, *args)``: wall-clock timing with warmup and
    block_until_ready (async dispatch means naive timing measures nothing).
  - ``Timer``: the cutCreateTimer/cutStartTimer analogue for host phases.
  - ``card_description()``: the GPU name and power limit to report beside
    every timing.
"""

from __future__ import annotations

import contextlib
import dataclasses
import subprocess
import time

import jax


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a device trace: ``with trace('/tmp/trace'): fn()`` then
    ``tensorboard --logdir /tmp/trace``."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def benchmark(fn, *args, warmup: int = 2, iters: int = 10) -> dict:
    """Median/mean wall time of ``fn(*args)``, each call ending in
    ``jax.block_until_ready``.

    Returns {"mean_s", "median_s", "min_s", "iters"}."""
    for _ in range(max(warmup, 1)):
        jax.block_until_ready(fn(*args))
    times = []
    for _ in range(max(iters, 1)):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    n = len(times)
    return {
        "mean_s": sum(times) / n,
        "median_s": times[n // 2],
        "min_s": times[0],
        "iters": n,
    }


def card_description() -> str:
    """The GPUs' names and power limits as ``nvidia-smi`` reports them
    (``name, power.limit`` per card, ``" | "``-joined). A card below its
    maximum power limit runs slower under load, so every timing is
    reported beside this line."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30, check=True,
        ).stdout
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({type(exc).__name__})"
    return " | ".join(ln.strip() for ln in out.splitlines() if ln.strip())


@dataclasses.dataclass
class Timer:
    """Accumulating host-side phase timer (≈ cutStartTimer/cutStopTimer,
    src/cutil.h:613-660, which the reference never calls)."""

    total: float = 0.0
    _t0: float | None = None

    def start(self) -> None:
        self._t0 = time.perf_counter()

    def stop(self) -> float:
        assert self._t0 is not None, "Timer.stop() without start()"
        dt = time.perf_counter() - self._t0
        self.total += dt
        self._t0 = None
        return dt

    def reset(self) -> None:
        self.total = 0.0
        self._t0 = None
