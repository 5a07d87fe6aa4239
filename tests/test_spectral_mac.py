"""Spectral-MAC tests (ops/spectral_mac.py ≈ the
elementwiseProductAndNormalize + sumAlongFeatures pair,
src/cudaConvFFTData.cuh:47-92): the split-plane einsum MAC against a
complex128 numpy reference."""

import jax
import numpy as np
import jax.numpy as jnp
import pytest

from cuda_fft_convolution_tpu.ops.spectral_mac import (
    spectral_mac_einsum,
    spectral_mac_flat_planes,
    spectral_mac_planes,
)


def _random_spectra(rng, b, n, f, h, wc):
    mk = jax.jit(jax.lax.complex)
    d = mk(
        jnp.asarray(rng.standard_normal((b, f, h, wc)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((b, f, h, wc)).astype(np.float32)),
    )
    k = mk(
        jnp.asarray(rng.standard_normal((n, f, h, wc)).astype(np.float32)),
        jnp.asarray(rng.standard_normal((n, f, h, wc)).astype(np.float32)),
    )
    return d, k


def _ref(d, k):
    return np.einsum(
        "bfhw,nfhw->bnhw",
        np.asarray(d).astype(np.complex128),
        np.asarray(k).astype(np.complex128),
    )


_SHAPES = [
    (1, 1, 1, 8, 9),
    (1, 3, 5, 80, 9),  # demo geometry
    (2, 4, 2, 16, 130),  # wide wc
    (1, 2, 31, 33, 17),  # HOG-ish F, odd dims
]


@pytest.mark.parametrize("b,n,f,h,wc", _SHAPES)
def test_einsum_mac_matches_reference(rng, b, n, f, h, wc):
    d, k = _random_spectra(rng, b, n, f, h, wc)
    ref = _ref(d, k)
    got = np.asarray(spectral_mac_einsum(d, k))
    err = np.max(np.abs(got - ref)) / np.max(np.abs(ref))
    assert err < 1e-5


def test_flat_mac_matches_planar(rng):
    """The flat (one spectral-pixel axis) MAC is the planar MAC on a
    reshaped layout."""
    b, n, f, h, wc = 2, 3, 4, 12, 7
    dr, di, kr, ki = (
        jnp.asarray(rng.standard_normal(s).astype(np.float32))
        for s in [(b, f, h, wc)] * 2 + [(n, f, h, wc)] * 2
    )
    pr, pi = spectral_mac_planes(dr, di, kr, ki)
    fr, fi = spectral_mac_flat_planes(
        *(x.reshape(x.shape[0], f, h * wc) for x in (dr, di, kr, ki))
    )
    np.testing.assert_allclose(
        np.asarray(fr).reshape(pr.shape), np.asarray(pr), rtol=1e-6,
        atol=1e-5,
    )
    np.testing.assert_allclose(
        np.asarray(fi).reshape(pi.shape), np.asarray(pi), rtol=1e-6,
        atol=1e-5,
    )
