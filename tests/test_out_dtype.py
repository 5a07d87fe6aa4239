"""bf16 output-maps option (``out_dtype='bfloat16'``).

The serving lever for score-map consumers (the reference's DPM/HOG
detection use case, README.md:4-6): output MAPS are the dominant write
traffic at serving geometries, and detection tolerates bf16 rounding on
the scores (~4e-3 — the same envelope as the bf16 spectra tier,
tests/test_bf16_tier.py). ``out_dtype`` halves the output write bytes
(a pre-reassembly cast on the tiled engine) and halves the in-flight bytes
of a depth-bounded server.

These tests pin: dtype on every surface (direct/tiled/pipelined/plan/
stream/sharded) and parity vs the f32 output within the bf16 envelope.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.utils.errors import InvalidInputError

BF16_OUT_TOL = 5e-3  # bf16 mantissa on the OUTPUT rounding only


def _rel(a, b):
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return np.abs(a - b).max() / max(np.abs(b).max(), 1e-30)


def test_direct_engine_out_dtype(rng):
    data = rng.standard_normal((48, 40, 3)).astype(np.float32)
    bank = rng.standard_normal((4, 7, 9, 3)).astype(np.float32)
    want = fc.fft_conv(data, 7, 9, bank, mode="same", algorithm="direct")
    got = fc.fft_conv(
        data, 7, 9, bank, mode="same", algorithm="direct",
        out_dtype="bfloat16",
    )
    assert got.dtype == jnp.bfloat16
    assert got.shape == want.shape
    assert _rel(got.astype(jnp.float32), want) < BF16_OUT_TOL


def test_tiled_engine_out_dtype(rng):
    data = rng.standard_normal((96, 96, 2)).astype(np.float32)
    bank = rng.standard_normal((4, 9, 9, 2)).astype(np.float32)
    want = fc.fft_conv(data, 9, 9, bank, mode="same", algorithm="tiled")
    got = fc.fft_conv(
        data, 9, 9, bank, mode="same", algorithm="tiled",
        out_dtype="bfloat16",
    )
    assert got.dtype == jnp.bfloat16
    assert _rel(got.astype(jnp.float32), want) < BF16_OUT_TOL


def test_out_dtype_composes_with_bf16_tier(rng):
    """store_dtype and out_dtype are orthogonal: bf16 spectra + bf16 maps
    (the full-serving tier) stays within the spectra tier's envelope."""
    data = rng.standard_normal((64, 64, 2)).astype(np.float32)
    bank = rng.standard_normal((3, 9, 9, 2)).astype(np.float32)
    want = fc.fft_conv(data, 9, 9, bank, mode="same")
    got = fc.fft_conv(
        data, 9, 9, bank, mode="same",
        store_dtype="bfloat16", out_dtype="bfloat16",
    )
    assert got.dtype == jnp.bfloat16
    assert _rel(got.astype(jnp.float32), want) < 2e-2  # spectra-tier bound


def test_out_dtype_ragged_list(rng):
    """Ragged banks return a list; every cell's maps carry out_dtype."""
    data = rng.standard_normal((40, 40, 1)).astype(np.float32)
    cells = [
        rng.standard_normal((k, k, 1)).astype(np.float32) for k in (3, 9)
    ]
    got = fc.fft_conv(data, 9, 9, cells, mode="same", out_dtype="bfloat16")
    want = fc.fft_conv(data, 9, 9, cells, mode="same")
    assert isinstance(got, list) and len(got) == 2
    for g, w in zip(got, want):
        assert g.dtype == jnp.bfloat16
        assert _rel(g.astype(jnp.float32), w) < BF16_OUT_TOL


def test_pipelined_out_dtype(rng):
    data = rng.standard_normal((48, 48, 2)).astype(np.float32)
    bank = rng.standard_normal((5, 7, 7, 2)).astype(np.float32)
    sd = fc.fft_data(data, 7, 7)
    want = fc.conv_spectral(sd, bank, mode="same")
    got = fc.conv_spectral_pipelined(
        sd, bank, chunk_size=2, mode="same", out_dtype="bfloat16"
    )
    assert got.dtype == jnp.bfloat16
    assert _rel(got.astype(jnp.float32), want) < BF16_OUT_TOL


def test_plan_and_stream_out_dtype(rng):
    """make_plan bakes the cast into the compiled program; ConvStream
    inherits via plan kwargs (both engines)."""
    frame = rng.standard_normal((32, 32, 1)).astype(np.float32)
    bank = rng.standard_normal((2, 5, 5, 1)).astype(np.float32)
    for algorithm in ("direct", "tiled"):
        plan = fc.make_plan(
            (32, 32, 1), (2, 5, 5, 1), mode="same", algorithm=algorithm,
            out_dtype="bfloat16",
        )
        out = plan.execute(jnp.asarray(frame), jnp.asarray(bank))
        assert out.dtype == jnp.bfloat16
        ref = fc.fft_conv(frame, 5, 5, bank, mode="same",
                          algorithm=algorithm)
        assert _rel(out.astype(jnp.float32), ref) < BF16_OUT_TOL
    with fc.ConvStream.create(
        (32, 32, 1), bank, depth=2, mode="same", out_dtype="bfloat16"
    ) as stream:
        got = stream.submit(frame).result()
    assert got.dtype == jnp.bfloat16


@pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices (simulated CPU mesh)"
)
def test_sharded_out_dtype(rng):
    mesh = fc.make_mesh(data=1)
    data = rng.standard_normal((24, 24, 2)).astype(np.float32)
    cells = [
        rng.standard_normal((5, 5, 2)).astype(np.float32) for _ in range(8)
    ]
    sd = fc.fft_data(data, 5, 5)
    want = fc.conv_spectral(sd, cells, mode="same")
    got = fc.conv_spectral_sharded(
        sd, cells, mesh, mode="same", out_dtype="bfloat16"
    )
    assert got.dtype == jnp.bfloat16
    assert _rel(np.asarray(got, np.float32), want) < BF16_OUT_TOL


@pytest.mark.skipif(
    len(jax.devices()) < 2, reason="needs >=2 devices (simulated CPU mesh)"
)
def test_sharded_stream_out_dtype(rng):
    mesh = fc.make_mesh(data=1)
    bank = rng.standard_normal((4, 5, 5, 1)).astype(np.float32)
    frame = rng.standard_normal((24, 24, 1)).astype(np.float32)
    with fc.ShardedConvStream(
        mesh, bank, (24, 24, 1), depth=2, mode="same",
        out_dtype="bfloat16",
    ) as stream:
        got = stream.submit(frame).result()
    assert got.dtype == jnp.bfloat16
    want = fc.fft_conv(frame, 5, 5, bank, mode="same")
    assert _rel(np.asarray(got, np.float32), want) < BF16_OUT_TOL


def test_out_dtype_validation(rng):
    data = rng.standard_normal((16, 16, 1)).astype(np.float32)
    bank = rng.standard_normal((1, 3, 3, 1)).astype(np.float32)
    with pytest.raises(InvalidInputError):
        fc.fft_conv(data, 3, 3, bank, out_dtype="float16")
    # 'float32' and None are both the default
    o1 = fc.fft_conv(data, 3, 3, bank, mode="same", out_dtype="float32")
    assert o1.dtype == jnp.float32
