"""The overlap-save tiled engine — the path every tiled call takes — over
the geometries the removed fused block-conv kernel's tests covered: every
feature width the library serves (F ∈ {1, 3, 8, 16, 31}), kernel sizes
{8, 17, 33, 64} at explicit blocks that are neither 5-smooth nor aligned,
both spectra tiers, both output dtypes and all four output modes; the XLA
peaks / top-k / local-peaks heads at both tiers; and the engine's VJP at
both tiers. Every case is checked against the float64 oracles."""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import cuda_fft_convolution_tpu as fc
from cuda_fft_convolution_tpu.models import (
    detect_local_peaks,
    detect_peaks,
    detect_top_k,
)
from tests.oracles import fft_conv_full_f64, fft_map_f64

# max |got - want| / max |want|: fp32 tier at the library's bar; bf16
# spectra (8 mantissa bits, f32 accumulation) at the tier's bar; bf16 output
# maps round each value to 8 mantissa bits (≤ 2^-9 of the peak).
_TOL = {
    ("float32", "float32"): 1e-5,
    ("float32", "bfloat16"): 5e-3,
    ("bfloat16", "float32"): 2e-2,
    ("bfloat16", "bfloat16"): 2e-2,
}

_COMBOS = list(itertools.product(
    ("float32", "bfloat16"), ("float32", "bfloat16"),
    ("same", "full", "valid", "fftmap"),
))
_CASES = [
    (f, k) + _COMBOS[i % len(_COMBOS)]
    for i, (f, k) in enumerate(
        itertools.product((1, 3, 8, 16, 31), (8, 17, 33, 64))
    )
]


def _rel(got, want):
    got = np.asarray(got, np.float64)
    return float(np.max(np.abs(got - want)) / np.max(np.abs(want)))


@pytest.mark.parametrize("f,k,tier,out_dtype,mode", _CASES)
def test_tiled_engine_matches_oracle(f, k, tier, out_dtype, mode):
    rng = np.random.default_rng(f * 100 + k)
    bh, bw = k + 23, 2 * k + 13  # neither 5-smooth nor aligned
    h, w = 2 * bh + 7, 2 * bw + 5
    data = rng.standard_normal((h, w, f)).astype(np.float32)
    bank = rng.standard_normal((2, k, k, f)).astype(np.float32)
    sd = fc.fft_data_tiled(
        data, k, k, block_h=bh, block_w=bw, store_dtype=tier,
        trim_mode="full" if mode == "full" else mode,
    )
    got = np.asarray(
        fc.conv_spectral(sd, bank, mode=mode, out_dtype=out_dtype),
        np.float32,
    )
    want_dtype = np.float32 if out_dtype == "float32" else jnp.bfloat16
    assert fc.conv_spectral(sd, bank[:1], mode=mode,
                            out_dtype=out_dtype).dtype == want_dtype
    for n in range(2):
        if mode == "fftmap":
            want = fft_map_f64(data, bank[n], *got.shape[1:])
        else:
            full = fft_conv_full_f64(data, bank[n])
            if mode == "full":
                want = full
            elif mode == "same":
                r0 = (k - 1) // 2
                want = full[r0 : r0 + h, r0 : r0 + w]
            else:
                want = full[k - 1 : h, k - 1 : w]
        assert got[n].shape == want.shape, (got.shape, want.shape)
        assert _rel(got[n], want) <= _TOL[(tier, out_dtype)], n


def _corr_same_f64(data, kern):
    kh, kw = kern.shape[:2]
    full = fft_conv_full_f64(data, kern[::-1, ::-1, :])
    r0, c0 = (kh - 1) // 2, (kw - 1) // 2
    return full[r0 : r0 + data.shape[0], c0 : c0 + data.shape[1]]


def _local_max_mask(m, window=3):
    r = window // 2
    rl = window - 1 - r
    pad = np.pad(m, ((rl, r), (rl, r)), constant_values=-np.inf)
    dil = np.max(
        [pad[i : i + m.shape[0], j : j + m.shape[1]]
         for i in range(window) for j in range(window)], axis=0,
    )
    return m >= dil


_GEOMS = {
    # (data shape, bank shape, blocks): a square 17² bank at 40x47 blocks,
    # and the 5x129 bank at 36x256 blocks the fused peaks kernel ran at
    "k17": ((90, 110, 1), (2, 17, 17, 1), (40, 47)),
    "k5x129": ((64, 300, 2), (3, 5, 129, 2), (36, 256)),
}


@pytest.mark.parametrize("geom", sorted(_GEOMS))
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
@pytest.mark.parametrize("head", ["peaks", "top_k", "local_peaks"])
def test_tiled_heads_match_oracle(head, tier, geom):
    dshape, bshape, (bh, bw) = _GEOMS[geom]
    rng = np.random.default_rng(7)
    data = rng.standard_normal(dshape).astype(np.float32)
    bank = rng.standard_normal(bshape).astype(np.float32)
    kh, kw = bshape[1:3]
    sd = fc.fft_data_tiled(
        data, kh, kw, block_h=bh, block_w=bw, trim_mode="same",
        store_dtype=tier,
    )
    tol = 1e-5 if tier == "float32" else 2e-2
    if head == "peaks":
        vals, pos = detect_peaks(sd, bank, mode="same", correlation=True)
        vals, pos = np.asarray(vals)[:, None], np.asarray(pos)[:, None]
    elif head == "top_k":
        vals, pos = detect_top_k(sd, bank, k=3, mode="same",
                                 correlation=True)
    else:
        vals, pos = detect_local_peaks(sd, bank, k=3, mode="same",
                                       correlation=True)
    vals, pos = np.asarray(vals), np.asarray(pos)
    for n in range(bshape[0]):
        oracle = _corr_same_f64(data, bank[n])
        scale = np.max(np.abs(oracle))
        cand = oracle if head != "local_peaks" else np.where(
            _local_max_mask(oracle), oracle, -np.inf
        )
        want = np.sort(cand.ravel())[::-1][: vals.shape[1]]
        # values match the oracle's best, in order, within the tier
        np.testing.assert_allclose(vals[n], want, atol=tol * scale)
        for v, (y, x) in zip(vals[n], pos[n]):
            # each position holds (within the tier) the value reported
            assert abs(oracle[y, x] - v) <= 2 * tol * scale, (n, y, x)
        if tier == "float32" and head == "peaks":
            assert tuple(pos[n, 0]) == np.unravel_index(
                np.argmax(oracle), oracle.shape
            )


@pytest.mark.parametrize("f", [1, 3, 16])
@pytest.mark.parametrize("tier", ["float32", "bfloat16"])
def test_tiled_vjp_matches_oracle(tier, f):
    """d/dk Σ w ⊙ conv_full(x, k) is the correlation of w with x: the
    tiled engine's VJP must reproduce it (float64 oracle via FFT)."""
    rng = np.random.default_rng(f)
    k, h, w, n = 9, 70, 58, 2
    data = rng.standard_normal((h, w, f)).astype(np.float32)
    bank = rng.standard_normal((n, k, k, f)).astype(np.float32)
    oh, ow = h + k - 1, w + k - 1
    wts = rng.standard_normal((n, oh, ow)).astype(np.float32)
    sd = fc.fft_data_tiled(data, k, k, block_h=31, block_w=29,
                           store_dtype=tier)

    def loss(b):
        return jnp.sum(jnp.asarray(wts) * fc.conv_spectral(sd, b,
                                                           mode="full"))

    got = np.asarray(jax.grad(loss)(jnp.asarray(bank)))
    want = np.zeros(bank.shape)
    for i in range(n):
        wf = np.fft.fft2(wts[i].astype(np.float64))
        for c in range(f):
            xf = np.fft.fft2(data[:, :, c].astype(np.float64), (oh, ow))
            corr = np.real(np.fft.ifft2(wf * np.conj(xf)))
            want[i, :, :, c] = corr[:k, :k]
    tol = 1e-5 if tier == "float32" else 2e-2
    assert _rel(got, want) <= tol
