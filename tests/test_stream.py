"""Serving-stream tests: bounded-depth pipelined dispatch (runtime/stream.py).

The analogue of the reference's stream pool round-robin
(src/cudaConvFFTDataStreams.cu:279-349): correctness must equal the
synchronous plan path, and the depth bound must hold at every point of a
submission burst.
"""

import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from tests.oracles import fft_conv_full_f64, rel_err


def test_stream_matches_plan(rng):
    """submit/result over a stream ≡ plan.execute frame by frame."""
    kerns = rng.standard_normal((3, 5, 5, 2)).astype(np.float32)
    frames = [rng.standard_normal((24, 20, 2)).astype(np.float32) for _ in range(4)]
    stream = fc.ConvStream.create((24, 20, 2), kerns, depth=2)
    plan = stream.plan
    futs = [stream.submit(f) for f in frames]
    for f, fut in zip(frames, futs):
        want = np.array(plan.execute(f, kerns))
        np.testing.assert_allclose(np.array(fut.result()), want, atol=1e-6)
    stream.flush()


def test_stream_oracle_full_mode(rng):
    """Tiled-plan stream against the f64 oracle ('full' maps)."""
    kerns = rng.standard_normal((2, 6, 6, 1)).astype(np.float32)
    frame = rng.standard_normal((40, 40, 1)).astype(np.float32)
    with fc.ConvStream.create(
        (40, 40, 1), kerns, algorithm="tiled", mode="full", depth=1
    ) as stream:
        got = np.array(stream.submit(frame).result())
    assert got.shape == (2, 45, 45)
    for i in range(2):
        assert rel_err(got[i], fft_conv_full_f64(frame, kerns[i])) < 1e-5


def test_stream_depth_bound(rng):
    """Never more than `depth` unresolved futures; over-submitting resolves
    the OLDEST first (the pool's round-robin stream reuse)."""
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    stream = fc.ConvStream.create((16, 16, 1), kerns, depth=2)
    futs = []
    for _ in range(5):
        futs.append(stream.submit(np.zeros((16, 16, 1), np.float32)))
        assert stream.inflight <= 2
    # 5 submitted at depth 2: the first three were force-resolved in order
    assert [f.done() for f in futs] == [True, True, True, False, False]
    stream.flush()
    assert stream.inflight == 0
    assert all(f.done() for f in futs)


def test_stream_map_order_and_flush(rng):
    kerns = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    frames = [np.full((12, 12, 1), i, np.float32) for i in range(1, 5)]
    with fc.ConvStream.create((12, 12, 1), kerns, depth=3) as stream:
        maps = stream.map(frames)
        assert stream.inflight == 0
    ksum = float(kerns.sum())
    for i, m in enumerate(maps, start=1):
        # interior of the conv map of a constant frame is ksum * i
        assert abs(float(np.array(m)[0, 4, 4]) - ksum * i) < 1e-4 * abs(ksum * i) + 1e-5


def test_stream_update_kernels(rng):
    """Model-update path: new bank spectra, same compiled plan; also accepts
    a precomputed (re, im) spectra pair."""
    k1 = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    k2 = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    frame = rng.standard_normal((16, 16, 1)).astype(np.float32)
    stream = fc.ConvStream.create((16, 16, 1), k1, depth=1)
    out1 = np.array(stream.submit(frame).result())
    stream.update_kernels(k2)
    out2 = np.array(stream.submit(frame).result())
    want2 = np.array(stream.plan.execute(frame, k2))
    np.testing.assert_allclose(out2, want2, atol=1e-6)
    assert not np.allclose(out1, out2)
    # spectra-pair form
    stream.update_kernels(stream.plan.kernel_fft(k1))
    out1b = np.array(stream.submit(frame).result())
    np.testing.assert_allclose(out1b, out1, atol=1e-6)


def test_stream_validation(rng):
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        fc.ConvStream.create((16, 16, 1), kerns, depth=0)
    stream = fc.ConvStream.create((16, 16, 1), kerns, depth=1)
    with pytest.raises(ValueError):
        stream.submit(np.zeros((8, 16, 1), np.float32))
    with pytest.raises(ValueError):
        stream.update_kernels(np.zeros((2, 5, 5, 1), np.float32))


def _mesh_or_skip():
    import jax

    if len(jax.devices()) < 2:
        pytest.skip("needs >= 2 devices (8-virtual-CPU mesh)")
    return fc.make_mesh(data=1, kernels=len(jax.devices()))


def test_sharded_stream_matches_single_device(rng):
    """ShardedConvStream (stream pool × kernel-sharded mesh — the composed
    streams-variant equivalent) must reproduce the single-device tiled
    result on every frame, with the depth bound holding mid-burst."""
    mesh = _mesh_or_skip()
    kerns = rng.standard_normal((5, 5, 5, 2)).astype(np.float32)  # non-divisible N
    frames = [
        rng.standard_normal((32, 28, 2)).astype(np.float32) for _ in range(4)
    ]
    with fc.ShardedConvStream(
        mesh, kerns, (32, 28, 2), depth=2, mode="same", algorithm="tiled"
    ) as stream:
        futs = []
        for f in frames:
            futs.append(stream.submit(f))
            assert stream.inflight <= 2
        got = [np.asarray(fut.result()) for fut in futs]
    for f, g in zip(frames, got):
        sd = fc.fft_data_tiled(f, 5, 5, trim_mode="same")
        want = np.asarray(fc.conv_spectral(sd, kerns, mode="same"))
        np.testing.assert_allclose(g, want, atol=1e-5)
        assert g.shape == (5, 32, 28)


def test_sharded_stream_direct_fftmap(rng):
    """Direct engine through the sharded stream: reference-parity circular
    maps, against the single-device direct result."""
    mesh = _mesh_or_skip()
    kerns = rng.standard_normal((4, 3, 3, 1)).astype(np.float32)
    frame = rng.standard_normal((20, 20, 1)).astype(np.float32)
    with fc.ShardedConvStream(
        mesh, kerns, (20, 20, 1), depth=1, mode="fftmap", algorithm="direct"
    ) as stream:
        got = np.asarray(stream.submit(frame).result())
    sd = fc.fft_data(frame, 3, 3)
    want = np.asarray(fc.conv_spectral(sd, kerns, mode="fftmap"))
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_sharded_stream_bf16_tier(rng):
    """The bf16 serving tier flows through the sharded stream: bf16 bank
    spectra sharded over the mesh, results within the tier's ~5e-3 of the
    fp32 path."""
    mesh = _mesh_or_skip()
    kerns = rng.standard_normal((6, 5, 5, 4)).astype(np.float32)
    frame = rng.standard_normal((40, 36, 4)).astype(np.float32)
    with fc.ShardedConvStream(
        mesh, kerns, (40, 36, 4), depth=2, mode="same",
        store_dtype="bfloat16",
    ) as stream:
        got = np.asarray(stream.submit(frame).result(), np.float32)
    sd = fc.fft_data_tiled(frame, 5, 5, trim_mode="same")
    want = np.asarray(fc.conv_spectral(sd, kerns, mode="same"))
    assert rel_err(got, want) < 2e-2


def test_sharded_stream_validation(rng):
    mesh = _mesh_or_skip()
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    with pytest.raises(ValueError):
        fc.ShardedConvStream(mesh, kerns, (16, 16, 1), depth=0)
    # mode='fftmap' + algorithm='tiled' is SUPPORTED (baked FFT canvas) —
    # parity pinned by test_sharded_stream_tiled_fftmap.
    stream = fc.ShardedConvStream(mesh, kerns, (16, 16, 1), depth=1)
    with pytest.raises(ValueError):
        stream.submit(np.zeros((8, 16, 1), np.float32))


def test_stream_result_idempotent(rng):
    kerns = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    stream = fc.ConvStream.create((12, 12, 1), kerns, depth=1)
    fut = stream.submit(np.ones((12, 12, 1), np.float32))
    a = np.array(fut.result())
    b = np.array(fut.result())
    np.testing.assert_array_equal(a, b)
    assert fut.done()


def test_stream_update_kernels_rejects_foreign_spectra_pair(rng):
    """A (re, im) pair from a different geometry or store dtype is rejected
    at update time — not at the next submit as an opaque XLA aval error."""
    kerns = rng.standard_normal((2, 3, 3, 1)).astype(np.float32)
    stream = fc.ConvStream.create((16, 16, 1), kerns, depth=1)
    other = fc.ConvStream.create((32, 32, 1), kerns, depth=1)
    with pytest.raises(ValueError, match="planned"):
        stream.update_kernels(other.plan.kernel_fft(kerns))
    # dtype mismatch (f32 pair into a bf16-tier plan)
    bf = fc.ConvStream.create((16, 16, 1), kerns, depth=1,
                              store_dtype="bfloat16")
    with pytest.raises(ValueError, match="planned"):
        bf.update_kernels(stream.plan.kernel_fft(kerns))
    # the right pair still flows
    bf.update_kernels(bf.plan.kernel_fft(kerns))
    frame = rng.standard_normal((16, 16, 1)).astype(np.float32)
    assert bf.submit(frame).result().shape[0] == 2


def test_sharded_stream_constructs_without_device_work(rng, monkeypatch):
    """ShardedConvStream resolves geometry via eval_shape — constructing it
    must not execute a staging transform (a throwaway zero-frame dispatch
    would cost a first compile)."""
    mesh = _mesh_or_skip()
    import cuda_fft_convolution_tpu.api as _api

    calls = {"n": 0}
    real = _api.fft_data_tiled

    def counting(*a, **kw):
        calls["n"] += 1
        return real(*a, **kw)

    monkeypatch.setattr(_api, "fft_data_tiled", counting)
    kerns = rng.standard_normal((8, 3, 3, 1)).astype(np.float32)
    stream = fc.ShardedConvStream(mesh, kerns, (16, 16, 1), depth=1)
    # the staging fn is traced abstractly (eval_shape) — that one call must
    # not have touched devices; probe by checking no frame was staged with
    # concrete inputs (eval_shape passes ShapeDtypeStructs through)
    assert calls["n"] == 1
    frame = rng.standard_normal((16, 16, 1)).astype(np.float32)
    out = np.array(stream.submit(frame).result())
    assert out.shape[0] == 8


def test_plan_tiled_fftmap_matches_direct(rng):
    """AOT tiled plans compile mode='fftmap' by baking the FFT canvas —
    the compiled program's raw maps match the direct engine exactly."""
    kerns = rng.standard_normal((3, 6, 6, 2)).astype(np.float32)
    data = rng.standard_normal((48, 40, 2)).astype(np.float32)
    plan = fc.make_plan((48, 40, 2), (3, 6, 6, 2), algorithm="tiled",
                        mode="fftmap")
    got = np.asarray(plan.execute(data, kerns))
    want = np.asarray(
        fc.fft_conv(data, kernels=kerns, mode="fftmap", algorithm="direct",
                    policy=fc.FftSizePolicy.FAST)
    )
    assert got.shape == want.shape
    scale = np.max(np.abs(want))
    assert np.max(np.abs(got - want)) / scale < 1e-5


def test_stream_tiled_fftmap(rng):
    """ConvStream over a tiled fftmap plan: bounded serving with raw-map
    output parity."""
    kerns = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    frames = [
        rng.standard_normal((36, 36, 1)).astype(np.float32) for _ in range(3)
    ]
    with fc.ConvStream.create(
        (36, 36, 1), kerns, depth=2, algorithm="tiled", mode="fftmap",
        policy=fc.FftSizePolicy.FAST,
    ) as stream:
        got = stream.map(frames)
    for f, g in zip(frames, got):
        want = np.asarray(
            fc.fft_conv(f, kernels=kerns, mode="fftmap", algorithm="direct",
                        policy=fc.FftSizePolicy.FAST)
        )
        np.testing.assert_allclose(np.asarray(g), want, atol=1e-5)


def test_sharded_stream_tiled_fftmap(rng):
    """ShardedConvStream with mode='fftmap' on the TILED engine: the baked
    canvas flows through the mesh; parity vs the single-device direct
    engine."""
    mesh = _mesh_or_skip()
    kerns = rng.standard_normal((4, 3, 3, 1)).astype(np.float32)
    frame = rng.standard_normal((40, 40, 1)).astype(np.float32)
    with fc.ShardedConvStream(
        mesh, kerns, (40, 40, 1), depth=1, mode="fftmap", algorithm="tiled"
    ) as stream:
        got = np.asarray(stream.submit(frame).result())
    want = np.asarray(
        fc.fft_conv(frame, kernels=kerns, mode="fftmap", algorithm="direct")
    )
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5)


def test_ragged_stream_matches_fft_conv_buckets(rng):
    """RaggedConvStream composes the serving runtime with fft_conv's size
    bucketing: a mixed 8²/64² cell bank served through per-shape-group
    plans must match fft_conv's bucketed one-shot output, in cell order
    (the reference's heterogeneous cell-array round-robin contract,
    src/cudaConvFFTDataStreams.cu:353-360)."""
    cells = [
        rng.standard_normal((8, 8, 1)).astype(np.float32),
        rng.standard_normal((64, 64, 1)).astype(np.float32),
        rng.standard_normal((8, 8, 1)).astype(np.float32),
        rng.standard_normal((5, 5, 1)).astype(np.float32),
    ]
    frames = [
        rng.standard_normal((80, 80, 1)).astype(np.float32) for _ in range(3)
    ]
    with fc.RaggedConvStream(
        (80, 80, 1), cells, depth=2, algorithm="direct", mode="same"
    ) as stream:
        got = stream.map(frames)
        assert stream.num_groups == 3  # 8², 64², 5² shape groups
    for f, maps in zip(frames, got):
        want = fc.fft_conv(f, kernels=cells, mode="same", algorithm="direct")
        assert isinstance(maps, list) and len(maps) == len(cells)
        for g, w in zip(maps, want):
            np.testing.assert_allclose(
                np.asarray(g), np.asarray(w), atol=1e-4
            )


def test_ragged_stream_future_join_and_validation(rng):
    """Joined futures resolve per-group exactly once; bad cells raise."""
    cells = [
        rng.standard_normal((4, 4, 2)).astype(np.float32),
        rng.standard_normal((16, 16, 2)).astype(np.float32),
    ]
    stream = fc.RaggedConvStream((30, 30, 2), cells, depth=1, mode="full")
    frame = rng.standard_normal((30, 30, 2)).astype(np.float32)
    fut = stream.submit(frame)
    maps = fut.result()
    assert fut.done()
    # 'full' windows differ per kernel size
    assert maps[0].shape == (33, 33) and maps[1].shape == (45, 45)
    want = fc.fft_conv(frame, kernels=cells, mode="full", algorithm="direct")
    for g, w in zip(maps, want):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), atol=1e-4)
    stream.flush()
    with pytest.raises(fc.InvalidInputError):
        fc.RaggedConvStream((30, 30, 2), [], depth=1)
    with pytest.raises(fc.InvalidInputError):
        fc.RaggedConvStream(
            (30, 30, 2), [rng.standard_normal((4, 4)).astype(np.float32)]
        )


def test_plan_head_peaks_and_top_k(rng):
    """Detection heads baked into AOT plans: the compiled program returns
    (values, positions) matching the reduction of the maps plan's output
    — direct and tiled engines, unbatched and batched."""
    from cuda_fft_convolution_tpu.ops.tiled import (
        peaks_from_maps, top_k_from_maps,
    )

    kerns = rng.standard_normal((3, 5, 7, 2)).astype(np.float32)
    frame = rng.standard_normal((40, 44, 2)).astype(np.float32)
    for algorithm in ("direct", "tiled"):
        maps_plan = fc.make_plan(
            (40, 44, 2), kerns.shape, algorithm=algorithm, mode="same"
        )
        maps = np.asarray(maps_plan.execute(frame, kerns))
        wv, wy, wx = peaks_from_maps(np.asarray(maps)[None])
        plan = fc.make_plan(
            (40, 44, 2), kerns.shape, algorithm=algorithm, mode="same",
            head="peaks",
        )
        assert plan.head == "peaks"
        vals, pos = plan.execute(frame, kerns)
        np.testing.assert_allclose(
            np.asarray(vals), np.asarray(wv)[0], rtol=1e-5
        )
        np.testing.assert_array_equal(
            np.asarray(pos),
            np.stack([np.asarray(wy)[0], np.asarray(wx)[0]], axis=-1),
        )
    # top_k, batched
    bframe = rng.standard_normal((2, 40, 44, 2)).astype(np.float32)
    mplan = fc.make_plan((2, 40, 44, 2), kerns.shape, mode="valid")
    bmaps = np.asarray(mplan.execute(bframe, kerns))
    wv, wy, wx = top_k_from_maps(bmaps, 4)
    tplan = fc.make_plan(
        (2, 40, 44, 2), kerns.shape, mode="valid", head="top_k", head_k=4
    )
    vals, pos = tplan.execute(bframe, kerns)
    assert vals.shape == (2, 3, 4) and pos.shape == (2, 3, 4, 2)
    np.testing.assert_allclose(np.asarray(vals), np.asarray(wv), rtol=1e-5)
    np.testing.assert_array_equal(
        np.asarray(pos), np.stack([np.asarray(wy), np.asarray(wx)], -1)
    )
    with pytest.raises(fc.InvalidInputError):
        fc.make_plan((40, 44, 2), kerns.shape, mode="fftmap", head="peaks")
    with pytest.raises(fc.InvalidInputError):
        fc.make_plan((40, 44, 2), kerns.shape, mode="same", head="argmax")


def test_stream_head_serving(rng):
    """ConvStream with a baked head: futures resolve to (values,
    positions); thresholded local-peaks plan recovers planted templates."""
    from cuda_fft_convolution_tpu.models import detect_local_peaks

    templ = rng.standard_normal((2, 9, 9, 1)).astype(np.float32)
    frames = []
    spots = [(10, 12), (40, 50)]
    for _ in range(3):
        f = 0.02 * rng.standard_normal((64, 64, 1)).astype(np.float32)
        for t, (y, x) in zip(templ, spots):
            f[y:y + 9, x:x + 9] += 2.0 * t
        frames.append(f)
    with fc.ConvStream.create(
        (64, 64, 1), templ, depth=2, mode="same", correlation=True,
        head="local_peaks", head_k=4, head_window=5,
    ) as stream:
        futs = [stream.submit(f) for f in frames]
        for f, fut in zip(frames, futs):
            vals, pos = fut.result()
            assert vals.shape == (2, 4) and pos.shape == (2, 4, 2)
            want_v, want_p = detect_local_peaks(
                f, templ, k=4, window=5, mode="same", correlation=True
            )
            np.testing.assert_allclose(
                np.asarray(vals), np.asarray(want_v), rtol=1e-4
            )
            np.testing.assert_array_equal(
                np.asarray(pos), np.asarray(want_p)
            )
            for i, (y, x) in enumerate(spots):
                assert tuple(np.asarray(pos)[i, 0]) == (y + 4, x + 4)


def test_ragged_stream_head_serving(rng):
    """RaggedConvStream under a head plan: per-cell (values, positions)
    tuples in cell order, each matching its own single-cell detection."""
    from cuda_fft_convolution_tpu.models import detect_peaks

    cells = [
        rng.standard_normal((5, 5, 1)).astype(np.float32),
        rng.standard_normal((11, 11, 1)).astype(np.float32),
        rng.standard_normal((5, 5, 1)).astype(np.float32),
    ]
    frame = rng.standard_normal((48, 48, 1)).astype(np.float32)
    with fc.RaggedConvStream(
        (48, 48, 1), cells, depth=1, mode="same", correlation=True,
        head="peaks",
    ) as stream:
        res = stream.submit(frame).result()
    assert len(res) == 3
    want_v, want_p = detect_peaks(
        frame, cells, mode="same", correlation=True
    )
    for i, (v, p) in enumerate(res):
        assert v.shape == () and p.shape == (2,)
        np.testing.assert_allclose(
            np.asarray(v), np.asarray(want_v)[i], rtol=1e-4
        )
        np.testing.assert_array_equal(np.asarray(p), np.asarray(want_p)[i])


def test_fifo_clock_marks_earlier_futures_done(rng, monkeypatch):
    """Resolving a LATER future marks all earlier same-stream futures
    complete without a wait of their own (the device queue is FIFO): a
    serving loop that syncs every k-th frame must not pay one stale wait
    per submit once the pipeline fills."""
    import jax

    from cuda_fft_convolution_tpu.runtime import stream as stream_mod

    bank = rng.standard_normal((2, 4, 4, 1)).astype(np.float32)
    frame = rng.standard_normal((24, 24, 1)).astype(np.float32)
    stream = fc.ConvStream.create(
        (24, 24, 1), bank, depth=8, algorithm="direct", mode="same"
    )
    waits = []
    real_wait = jax.block_until_ready
    monkeypatch.setattr(
        stream_mod.jax, "block_until_ready",
        lambda x: waits.append(1) or real_wait(x),
    )
    futs = [stream.submit(frame) for _ in range(5)]
    assert not any(f.done() for f in futs[:4])
    futs[-1].result()
    assert len(waits) == 1
    # FIFO implication: every earlier future is now done, and their
    # result() returns without another wait
    assert all(f.done() for f in futs)
    for f in futs[:-1]:
        np.testing.assert_allclose(
            np.asarray(f.result()), np.asarray(futs[-1].result()),
            rtol=1e-6,
        )
    assert len(waits) == 1
    # new submissions are NOT implied done by the old watermark
    f6 = stream.submit(frame)
    assert not f6.done()
    stream.flush()
    assert f6.done()
