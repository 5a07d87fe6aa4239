"""Bounded-depth asynchronous serving stream — the streams-variant runtime.

Equivalent of the reference's stream pool
(src/cudaConvFFTDataStreams.cu:279-349: a pool of cudaStreams round-robined
over the work loop, with the pool size bounding how much work is in flight
at once). The XLA runtime already dispatches asynchronously, so
streams-as-concurrency are free; what the pool actually buys a serving
system — *bounded* in-flight work plus overlap of host work with device
work across calls — is reproduced here explicitly:

  - ``submit(frame)`` dispatches the planned pipeline without waiting and
    returns a :class:`ConvFuture`;
  - at most ``depth`` submissions are unresolved at a time: submitting
    deeper first waits on the OLDEST one (the pool's round-robin reuse of a
    busy stream) so device memory for queued outputs stays bounded at
    ``depth`` working sets;
  - completion is ``jax.block_until_ready`` on the submission's outputs.
"""

from __future__ import annotations

import collections
import functools
from typing import Sequence

import jax
import jax.numpy as jnp

from cuda_fft_convolution_tpu.runtime.plan import FftConvPlan, make_plan
from cuda_fft_convolution_tpu.utils.errors import validate


class _FifoClock:
    """Shared resolution watermark for one stream's FIFO device queue.

    The device queue executes submissions in order, so waiting on
    submission N proves every submission ≤ N is complete. Futures carry
    their sequence number and this shared clock: resolving a LATER future
    marks all earlier ones done without a wait of their own."""

    __slots__ = ("resolved",)

    def __init__(self):
        self.resolved = -1


class ConvFuture:
    """Handle for one in-flight convolution dispatch.

    ``result()`` blocks until the device work is complete and returns the
    output maps as a device array. Idempotent; free when a LATER future on
    the same stream already resolved (FIFO order, see :class:`_FifoClock`).
    """

    __slots__ = ("_value", "_done", "_seq", "_clock")

    def __init__(self, value, seq: int = 0, clock=None):
        self._value = value
        self._done = False
        self._seq = seq
        self._clock = clock

    def done(self) -> bool:
        """Whether this submission is known complete (resolved directly,
        or implied by a later same-stream resolution — no device poll)."""
        return self._done or (
            self._clock is not None and self._clock.resolved >= self._seq
        )

    def result(self):
        if not self.done():
            jax.block_until_ready(self._value)
            if self._clock is not None:
                self._clock.resolved = self._seq
        self._done = True
        return self._value


class _BoundedStream:
    """Shared bounded-depth dispatch machinery for the serving streams:
    the in-flight deque, the FIFO resolution clock, sequence numbering,
    the dispatch-side depth bound, and the flush/context-manager surface.
    Subclasses own plan construction and per-submit validation and call
    :meth:`_dispatch` with their jitted frame program."""

    def _init_queue(self, depth: int) -> None:
        validate(depth >= 1, f"depth must be >= 1, got {depth}")
        self._depth = depth
        self._inflight: collections.deque[ConvFuture] = collections.deque()
        self._clock = _FifoClock()
        self._seq = 0

    @property
    def depth(self) -> int:
        return self._depth

    @property
    def inflight(self) -> int:
        """Number of unresolved submissions currently queued."""
        self._drain_resolved()
        return len(self._inflight)

    def _drain_resolved(self) -> None:
        # Futures resolved out-of-band (user called result() directly, or
        # a later same-stream resolution advanced the FIFO clock) no
        # longer occupy a slot; drop them from the front of the queue.
        while self._inflight and self._inflight[0].done():
            self._inflight.popleft()

    def _dispatch(self, frame_fn, frame) -> ConvFuture:
        # Bound BEFORE dispatching: never more than `depth` unresolved
        # working sets on device.
        self._drain_resolved()
        while len(self._inflight) >= self._depth:
            self._inflight.popleft().result()
        out = frame_fn(jnp.asarray(frame, jnp.float32))
        fut = ConvFuture(out, self._seq, self._clock)
        self._seq += 1
        self._inflight.append(fut)
        return fut

    def map(self, frames: Sequence) -> list:
        """Convenience: pipeline a whole sequence, return resolved results
        in order. Peak in-flight work stays at ``depth``."""
        futures = [self.submit(f) for f in frames]
        return [f.result() for f in futures]

    def flush(self) -> None:
        """Block until every outstanding submission has completed."""
        while self._inflight:
            self._inflight.popleft().result()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.flush()


class ConvStream(_BoundedStream):
    """Serving loop driver: repeated frames against one resident bank.

    Built over an AOT :class:`FftConvPlan` (zero retracing at submit time)
    with the kernel-bank spectra computed once and held on device — the
    reference's persistent ``cudaFFTData`` + repeated ``cudaConvFFTData``
    serving shape (src/cudaFFTData.cu:97-150), with the streams variant's
    bounded pipelining on top.

    Use :meth:`ConvStream.create` unless you already hold a plan::

        stream = fc.ConvStream.create(frame_shape, bank, algorithm="tiled",
                                      mode="same", depth=3)
        futures = [stream.submit(f) for f in frames]   # pipelined dispatch
        maps = [f.result() for f in futures]           # sync as consumed

    ``depth`` bounds in-flight submissions (device memory: ``depth`` output
    working sets). ``submit`` past the bound blocks on the oldest future
    first. The stream is also a context manager; exiting flushes.

    A DETECTION-SERVING loop passes ``head=`` through to the plan
    (``head='peaks'|'top_k'|'local_peaks'``, with ``head_k`` /
    ``head_window`` / ``head_threshold``): futures then resolve to
    ``(values, positions)`` — the reduction is compiled into the plan's
    program, each in-flight working set shrinks from full maps to (N, k)
    scalars (depth becomes nearly free), and ``result()`` moves bytes,
    not megabytes.

    Depth tuning: each extra slot hides more host latency at the cost of
    one output working set of device memory; size depth to
    (budget − resident spectra) / per-call output bytes.
    """

    def __init__(self, plan: FftConvPlan, kernels, *, depth: int = 3):
        self._init_queue(depth)
        self._plan = plan
        self.update_kernels(kernels)

    @classmethod
    def create(
        cls,
        data_shape: tuple,
        kernels,
        *,
        depth: int = 3,
        **plan_kwargs,
    ) -> "ConvStream":
        """Build the plan for ``data_shape`` × ``kernels.shape`` and wrap it.
        ``plan_kwargs`` go to :func:`make_plan` (``algorithm``, ``mode``,
        ``policy``, ``correlation``, ``out_dtype``,
        ``head``/``head_k``/``head_window``/``head_threshold``)."""
        kernels = jnp.asarray(kernels, jnp.float32)
        # lazy: the stream dispatches through its own fused jit closure
        # (below) — of the plan's three executables only kernel_fft is
        # ever invoked, so compiling the other two would be wasted.
        plan = make_plan(
            tuple(data_shape), tuple(kernels.shape), lazy=True,
            **plan_kwargs,
        )
        return cls(plan, kernels, depth=depth)

    @property
    def plan(self) -> FftConvPlan:
        return self._plan

    def update_kernels(self, kernels) -> None:
        """(Re)compute and pin the resident bank spectra — the model-update
        path of a serving loop. Accepts a spatial bank of the planned shape
        or a precomputed ``(re, im)`` spectra pair from ``plan.kernel_fft``."""
        if isinstance(kernels, tuple) and len(kernels) == 2:
            want = self._plan.kfft_aval
            for name, plane in zip(("re", "im"), kernels):
                validate(
                    tuple(plane.shape) == tuple(want.shape)
                    and plane.dtype == want.dtype,
                    f"spectra pair {name} plane {plane.dtype}"
                    f"{tuple(plane.shape)} != planned {want.dtype}"
                    f"{tuple(want.shape)} — pass plan.kernel_fft output "
                    "for this plan's geometry and store dtype",
                )
            self._kfft = kernels
            self._rebuild_submit_fn()
            return
        kernels = jnp.asarray(kernels, jnp.float32)
        validate(
            tuple(kernels.shape) == self._plan.kernel_shape,
            f"kernel shape {tuple(kernels.shape)} != planned "
            f"{self._plan.kernel_shape}",
        )
        self._kfft = self._plan.kernel_fft(kernels)
        self._rebuild_submit_fn()

    def _rebuild_submit_fn(self) -> None:
        # One whole-frame program (data FFT + spectral pipeline): a submit
        # is ONE dispatch. The resident bank spectra are an ARGUMENT of the
        # program, bound here: a closed-over array would be embedded in the
        # executable as a constant (see ShardedConvStream).
        plan = self._plan
        self._frame_fn = functools.partial(
            jax.jit(lambda kfft, frame: plan.trace_frame(frame, kfft)),
            self._kfft,
        )

    def submit(self, frame) -> ConvFuture:
        """Dispatch one frame; returns immediately unless ``depth`` calls
        are already in flight (then waits on the oldest first)."""
        validate(
            tuple(frame.shape) == self._plan.data_shape,
            f"frame shape {tuple(frame.shape)} != planned "
            f"{self._plan.data_shape}",
        )
        return self._dispatch(self._frame_fn, frame)


class RaggedConvFuture:
    """Handle over one :class:`RaggedConvStream` submission. ``result()``
    resolves the fused dispatch and returns the per-kernel maps in the
    ORIGINAL cell order — the contract of the reference's heterogeneous
    cell-array loop (src/cudaConvFFTDataStreams.cu:353-360), which emits
    one map per cell in cell order."""

    __slots__ = ("_future", "_groups", "_n", "_batched")

    def __init__(self, future, groups, n, batched=False):
        self._future = future  # ONE ConvFuture over the fused program
        self._groups = groups  # per-group original-cell index lists
        self._n = n
        self._batched = batched

    def done(self) -> bool:
        return self._future.done()

    def result(self) -> list:
        per_group = self._future.result()  # tuple, one entry per group
        out: list = [None] * self._n
        for stacked, idx in zip(per_group, self._groups):
            if isinstance(stacked, tuple):
                # head plans: (values, positions), kernel axis after batch
                kdim = 1 if self._batched else 0
                for pos, i in enumerate(idx):
                    out[i] = tuple(
                        jnp.take(x, pos, axis=kdim) for x in stacked
                    )
                continue
            kdim = 0 if stacked.ndim == 3 else 1
            for pos, i in enumerate(idx):
                out[i] = jnp.take(stacked, pos, axis=kdim)
        return out


class RaggedConvStream(_BoundedStream):
    """Bounded-depth serving for a HETEROGENEOUS kernel cell array — the
    composition the reference's streams loop does in one pass
    (src/cudaConvFFTDataStreams.cu:338-469: round-robin over a cell array
    of mixed kernel sizes) and that ``fft_conv`` reproduces one-shot via
    size bucketing (api._bucket_ragged). Here the same bucketing is fused
    with the serving runtime: kernels are grouped by exact spatial shape,
    each group gets its own AOT plan (its own FFT/block geometry — small
    kernels never pay the giant kernel's FFT size) with its bank spectra
    computed ONCE and pinned, and every group's per-frame pipeline is
    compiled into ONE fused program — a ``submit`` is a single dispatch
    per frame, not one per group (round 4's ragged row paid ~2× its
    device cost in per-bucket dispatch + per-frame bank FFTs).

        stream = fc.RaggedConvStream(frame_shape, cell_bank, depth=3)
        futures = [stream.submit(f) for f in frames]
        maps = [f.result() for f in futures]      # list, cell order

    ``depth`` bounds in-flight submissions (each holds every group's
    output working set). Kernels sharing a shape must also share the
    feature dim (they stack into one bank; fft_conv has the same
    requirement)."""

    def __init__(
        self,
        data_shape: tuple,
        kernels: Sequence,
        *,
        depth: int = 3,
        **plan_kwargs,
    ):
        validate(
            isinstance(kernels, (list, tuple)) and len(kernels) >= 1,
            "RaggedConvStream takes a non-empty kernel cell list",
        )
        ks = [jnp.asarray(k, jnp.float32) for k in kernels]
        for k in ks:
            validate(
                k.ndim == 3,
                f"each cell kernel must be (Kh, Kw, F), got {tuple(k.shape)}",
            )
        groups: dict = {}
        for i, k in enumerate(ks):
            groups.setdefault(tuple(k.shape), []).append(i)
        self._groups = list(groups.values())
        self._n = len(ks)
        self._data_shape = tuple(data_shape)
        self._init_queue(depth)
        # lazy: only each plan's kernel_fft executable is ever invoked
        # (once, just below) — the per-frame pipeline runs through the
        # fused jit closure, so eager data-FFT/conv builds would be 2
        # wasted compiles PER GROUP.
        self._plans = [
            make_plan(
                self._data_shape,
                (len(idx),) + tuple(ks[idx[0]].shape),
                lazy=True,
                **plan_kwargs,
            )
            for idx in self._groups
        ]
        # resident per-group bank spectra, computed once (the model-update
        # path of a serving loop)
        self._kffts = tuple(
            plan.kernel_fft(jnp.stack([ks[i] for i in idx]))
            for plan, idx in zip(self._plans, self._groups)
        )
        # ONE fused program: every group's data FFT + spectral pipeline
        # traced together, the resident spectra bound as arguments — a
        # submit is a single dispatch, not one per group.
        plans = self._plans
        self._fused_fn = functools.partial(
            jax.jit(
                lambda kffts, frame: tuple(
                    p.trace_frame(frame, kf) for p, kf in zip(plans, kffts)
                )
            ),
            self._kffts,
        )

    @property
    def num_groups(self) -> int:
        return len(self._groups)

    @property
    def plans(self) -> list:
        """Per-group plans (one FFT/block geometry per kernel shape)."""
        return list(self._plans)

    def submit(self, frame) -> RaggedConvFuture:
        """Dispatch the fused all-groups program for one frame (a SINGLE
        device dispatch); returns a future resolving to per-kernel maps
        in cell order (or per-kernel ``(values, positions)`` tuples under
        a head plan — positions are in each cell's own ``mode`` window
        frame). Bounded at ``depth`` unresolved submissions."""
        validate(
            tuple(frame.shape) == self._data_shape,
            f"frame shape {tuple(frame.shape)} != planned "
            f"{self._data_shape}",
        )
        fut = self._dispatch(self._fused_fn, frame)
        batched = len(self._data_shape) == 4
        return RaggedConvFuture(fut, self._groups, self._n, batched)


class ShardedConvStream(_BoundedStream):
    """Bounded-depth serving over a device MESH — the composed equivalent
    of the reference's full streams design: a stream pool for latency
    hiding × a multi-GPU kernel round-robin for scale
    (src/cudaConvFFTDataStreams.cu:273-349, the per-GPU stream pairs at
    :292-327 and the kernel round-robin at :341-349). Here the two are
    orthogonal primitives composed: ``conv_spectral_sharded`` (bank sharded
    over the mesh's kernel axis, data spectra replicated to every card via
    their PartitionSpec — NCCL over NVLink on the GPU) under the same
    bounded-depth future pipeline as :class:`ConvStream`.

    The bank spectra are computed once, PRE-SHARDED over the mesh
    (``shard_kernel_bank``) and pinned — submits never re-place them; the
    sharded executable is built once per geometry (mesh.py's exec cache),
    so a submit is pure dispatch::

        mesh = fc.make_mesh(data=1, kernels=8)
        stream = fc.ShardedConvStream(mesh, bank, frame_shape, depth=3)
        futures = [stream.submit(f) for f in frames]
        maps = [f.result() for f in futures]    # sharded over (data, kernels)

    ``algorithm='tiled'`` runs the overlap-save engine per device with the
    'same'/'valid' window — or the mode='fftmap' FFT canvas — baked into
    the block tiling; 'direct' runs the big-FFT engine. Stacked uniform
    banks only (ragged cells need per-size plans — bucket first).
    """

    def __init__(
        self,
        mesh,
        kernels,
        data_shape: tuple,
        *,
        depth: int = 3,
        mode: str = "same",
        algorithm: str = "tiled",
        correlation: bool = False,
        same_offset: str = "scipy",
        store_dtype: str = "float32",
        out_dtype: str | None = None,
    ):
        from cuda_fft_convolution_tpu import api as _api
        from cuda_fft_convolution_tpu.parallel import mesh as _mesh

        _api._resolve_out_dtype(out_dtype)  # validate at construction

        validate(
            algorithm in ("tiled", "direct"),
            "algorithm must be 'tiled' or 'direct'",
        )
        # mode='fftmap' works on BOTH engines: tiled bakes the direct
        # FFT canvas into the block tiling (fft_data_tiled trim_mode).
        kernels = jnp.asarray(kernels)
        validate(
            kernels.ndim == 4,
            "ShardedConvStream takes a stacked uniform bank (N, Kh, Kw, F)",
        )
        self._mesh = mesh
        self._mode = mode
        self._algorithm = algorithm
        self._same_offset = same_offset
        self._store_dtype = store_dtype
        self._out_dtype = out_dtype
        self._data_shape = tuple(data_shape)
        self._kh, self._kw = int(kernels.shape[1]), int(kernels.shape[2])
        self._init_queue(depth)

        # Abstract staging pass: fixes the FFT/block geometry and the baked
        # output window with ZERO device work — the spectral pytrees carry
        # geometry as static aux fields, so eval_shape yields everything
        # fft_kernels needs (a real zero-frame transform here would pay a
        # throwaway dispatch plus the data-FFT program's first compile).
        template = jax.ShapeDtypeStruct(self._data_shape, jnp.float32)
        sd = jax.eval_shape(self._stage, template)
        sk = _api.fft_kernels(
            kernels, spectral=sd, correlation=correlation,
            storage="planar",  # sharding takes planar (mesh.py validates)
            store_dtype=store_dtype,
        )
        self._sk = _mesh.shard_kernel_bank(sk, mesh)

        # One whole-frame program: staging + the sharded conv in a single
        # dispatch. The pre-sharded bank is an ARGUMENT of the program: as a
        # closed-over constant, a 1024-filter F=31 bf16 bank made an 834 MB
        # executable that took 173 s to compile on four H100s.
        def _frame(sk, frame):
            fsd = self._stage(frame)
            return _mesh.conv_spectral_sharded(
                fsd, sk, self._mesh, mode=self._mode,
                same_offset=self._same_offset, out_dtype=self._out_dtype,
            )

        self._frame_fn = functools.partial(jax.jit(_frame), self._sk)

    def _stage(self, frame):
        """Per-frame spectral staging at the planned geometry."""
        from cuda_fft_convolution_tpu import api as _api

        if self._algorithm == "tiled":
            if self._mode in ("same", "valid", "fftmap"):
                trim = self._mode
            else:
                trim = "full"
            return _api.fft_data_tiled(
                frame, self._kh, self._kw, trim_mode=trim,
                same_offset=self._same_offset,
                store_dtype=self._store_dtype,
            )
        return _api.fft_data(
            frame, self._kh, self._kw, store_dtype=self._store_dtype
        )

    def submit(self, frame) -> ConvFuture:
        """Dispatch one frame across the mesh (a single fused program);
        bounded at ``depth`` unresolved submissions (waits on the oldest
        first)."""
        validate(
            tuple(frame.shape) == self._data_shape,
            f"frame shape {tuple(frame.shape)} != planned "
            f"{self._data_shape}",
        )
        return self._dispatch(self._frame_fn, frame)
