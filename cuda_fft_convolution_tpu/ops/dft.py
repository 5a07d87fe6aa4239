"""DFT transforms as dense matmuls — the opt-in transform engine.

The default engine is XLA's FFT (cuFFT on the GPU). This module computes
the same transforms as O(L³) dense-DFT matrix products instead
(``set_config(use_matmul_fft=True)``). Its one capability an FFT lacks is
the windowed inverse: the overlap-save engine can synthesize only each
block's valid window. On the H100 it measured slower than cuFFT at the
fp32 tier and faster at the bf16 DPM tier (PERF.md, Findings):

  rfft2(x)  =  F_h @ x @ Wfwd_w      (separable; Wfwd packs Hermitian)
  irfft2(S) =  Re( G_h @ S @ Winv_w )

Each complex-by-real / complex-by-complex product is expanded into 2 or 4
real fp32 matmuls with ``preferred_element_type=f32``. Precision is
configurable: HIGHEST (fp32; default — meets the ≤1e-5 accuracy bar) or
HIGH/DEFAULT, which run TF32 on the GPU (about 3 digits).

DFT matrices are built on host in float64 and cached per size; at block
sizes (≤1024) they are ≤8 MB and live in device memory like any constant.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

# Max axis size for the SINGLE-STAGE dense matmul transform: beyond this the
# O(L^3) flops and the matrices get big.
MATMUL_FFT_MAX_AXIS = 2304

# Max axis size for the TWO-STAGE Cooley–Tukey matmul transform (L = A·B,
# two dense stage matmuls + a twiddle multiply — the matmul answer for
# arbitrary plan sizes, src/cudaConvolutionFFT.cu:128-142 of the reference):
# per-vector cost is L·(A+B) MACs instead of L², so even 8192-point axes
# stay ~40× under the dense cost.
MATMUL_CT_MAX_AXIS = 8192

# Axis size above which a factorable length prefers the CT path over the
# dense single-stage matmul (dense is still used for the windowed partial
# inverses the overlap-save engine relies on — a capability CT lacks).
# None = only above the dense cap; overridable via FFTCONV_CT_MIN_AXIS for
# measurement.
MATMUL_CT_MIN_AXIS: int | None = None


def _ct_min_axis() -> int | None:
    import os

    env = os.environ.get("FFTCONV_CT_MIN_AXIS", "")
    if env:
        try:
            return int(env)
        except ValueError:
            pass
    return MATMUL_CT_MIN_AXIS


def _ct_dispatch(l: int) -> bool:
    """Whether this axis length runs the CT path (vs dense)."""
    if l > MATMUL_FFT_MAX_AXIS:
        return ct_factor(l) is not None
    lo = _ct_min_axis()
    return lo is not None and l >= lo and ct_factor(l) is not None


@functools.lru_cache(maxsize=64)
def _fwd_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Full forward DFT matrix F[k,n] = exp(-2πi kn/L), split planes f32."""
    k = np.arange(l)[:, None].astype(np.float64)
    n = np.arange(l)[None, :].astype(np.float64)
    ph = -2.0 * np.pi * k * n / l
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


@functools.lru_cache(maxsize=64)
def _fwd_packed_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Forward real→Hermitian-packed matrices, shape (L, L//2+1): the DFT
    matrix is symmetric, so right-multiplication x @ F[:, :Wc] transforms
    the last axis directly."""
    wc = l // 2 + 1
    cr, ci = _fwd_mats(l)
    return np.ascontiguousarray(cr[:, :wc]), np.ascontiguousarray(ci[:, :wc])


@functools.lru_cache(maxsize=64)
def _inv_packed_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Hermitian-packed → real inverse matrices (L//2+1 × L), weights folded.

    x[n] = (1/L) Σ_m w_m [ Sr[m] cos(2πnm/L) − Si[m] sin(2πnm/L) ],
    w_m = 1 for m ∈ {0, L/2}, else 2 (Hermitian double-count)."""
    wc = l // 2 + 1
    n = np.arange(l)[None, :].astype(np.float64)
    m = np.arange(wc)[:, None].astype(np.float64)
    w = np.where((m == 0) | (m == l / 2), 1.0, 2.0)
    ph = 2.0 * np.pi * n * m / l
    mr = (w * np.cos(ph) / l).astype(np.float32)  # (Wc, L)
    mi = (-w * np.sin(ph) / l).astype(np.float32)
    return mr, mi


@functools.lru_cache(maxsize=64)
def _inv_full_mats(l: int) -> tuple[np.ndarray, np.ndarray]:
    """Full inverse DFT matrix G[n,k] = exp(+2πi nk/L)/L, split planes f32."""
    n = np.arange(l)[:, None].astype(np.float64)
    k = np.arange(l)[None, :].astype(np.float64)
    ph = 2.0 * np.pi * n * k / l
    return (np.cos(ph) / l).astype(np.float32), (np.sin(ph) / l).astype(
        np.float32
    )


# Karatsuba 3-mult complex matmuls save 25% of the dot passes but keep a THIRD
# full-size temporary live; use them only when that temp is small enough not
# to matter for peak device memory.
_KARATSUBA_MAX_TEMP_BYTES = 2 << 30


def _use_karatsuba(out_elems: int) -> bool:
    return out_elems * 4 <= _KARATSUBA_MAX_TEMP_BYTES


def _mm(a, b, precision):
    """a (..., K) @ b (K, M) → (..., M), fp32 accumulate."""
    return jnp.einsum(
        "...k,km->...m", a, b,
        precision=precision, preferred_element_type=jnp.float32,
    )


def _mml(m, x, precision):
    """m (K, N) applied on the second-to-last axis: (..., N, M) → (..., K, M)."""
    return jnp.einsum(
        "kn,...nm->...km", m, x,
        precision=precision, preferred_element_type=jnp.float32,
    )


def rfft2_mm_planes(
    x: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """rfft2 of the trailing (H, W) axes via matmuls → (re, im) f32
    planes (the native output of the split-plane math — no complex is ever
    formed). Zero-padding to (fft_h, fft_w) is implicit (DFT matrix columns
    beyond the input extent multiply zeros, so the matrices are simply
    sliced to the input size — no padded copy of x is ever materialized,
    unlike the FFT path)."""
    if _ct_dispatch(fft_h) or _ct_dispatch(fft_w):
        return rfft2_ct_planes(x, fft_h, fft_w, precision=precision)
    h, w = x.shape[-2], x.shape[-1]
    x = x.astype(jnp.float32)
    wr_np, wi_np = _fwd_packed_mats(fft_w)
    wr = jnp.asarray(wr_np[:w])  # (w, Wc): rows beyond input extent hit zeros
    wi = jnp.asarray(wi_np[:w])
    fr_np, fi_np = _fwd_mats(fft_h)
    fr = jnp.asarray(fr_np[:, :h])  # (fft_h, h)
    fi = jnp.asarray(fi_np[:, :h])
    # W axis: real x → complex planes (..., h, Wc)
    xr = _mm(x, wr, precision)
    xi = _mm(x, wi, precision)
    # H axis: complex (fr + i fi) @ (xr + i xi); Karatsuba when the extra
    # temporary is cheap, 4-mult when it would push peak HBM.
    out_elems = int(np.prod(xr.shape[:-2])) * fft_h * xr.shape[-1]
    if _use_karatsuba(out_elems):
        t1 = _mml(fr, xr, precision)
        t2 = _mml(fi, xi, precision)
        t3 = _mml(fr + fi, xr + xi, precision)
        return t1 - t2, t3 - t1 - t2
    sr = _mml(fr, xr, precision) - _mml(fi, xi, precision)
    si = _mml(fr, xi, precision) + _mml(fi, xr, precision)
    return sr, si


def rfft2_mm(
    x: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """Complex-output wrapper of ``rfft2_mm_planes`` (interop/tests)."""
    sr, si = rfft2_mm_planes(x, fft_h, fft_w, precision=precision)
    return jax.lax.complex(sr, si)


def irfft2_mm_planes(
    sr: jnp.ndarray, si: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
    window: tuple[int, int, int, int] | None = None,
) -> jnp.ndarray:
    """irfft2 of split (re, im) f32 planes (..., fft_h, fft_w//2+1) →
    (..., fft_h, fft_w) f32 via matmuls, normalization 1/(fft_h·fft_w)
    folded into the matrices.

    ``window=(row0, nrows, col0, ncols)`` computes ONLY that output window —
    the inverse matrices are row-sliced, so flops and output bytes shrink
    proportionally. An FFT cannot do partial outputs; the overlap-save
    engine uses this to synthesize just each block's valid region."""
    # bf16 serving tier: bf16 spectra → bf16 dot operands (native
    # single-pass dots) with f32 ACCUMULATION (preferred_element_type in
    # _mm/_mml) — "bf16 inputs, fp32 spectral accumulation"
    # (BASELINE configs[4]). The synthesis matrices round to bf16 too;
    # measured tier accuracy is pinned by tests/test_bf16_tier.py.
    bf16 = sr.dtype == jnp.bfloat16
    if bf16 and (_ct_dispatch(fft_h) or _ct_dispatch(fft_w)) and window is None:
        sr, si = sr.astype(jnp.float32), si.astype(jnp.float32)
        bf16 = False
    if window is None and (_ct_dispatch(fft_h) or _ct_dispatch(fft_w)):
        return irfft2_ct_planes(sr, si, fft_h, fft_w, precision=precision)
    r0, nr, c0, nc = (
        window if window is not None else (0, fft_h, 0, fft_w)
    )
    mat_t = jnp.bfloat16 if bf16 else jnp.float32
    if bf16:
        precision = jax.lax.Precision.DEFAULT
    gr, gi = _inv_full_mats(fft_h)
    gr = jnp.asarray(gr[r0 : r0 + nr], mat_t)  # (nr, fft_h)
    gi = jnp.asarray(gi[r0 : r0 + nr], mat_t)
    mr, mi = _inv_packed_mats(fft_w)
    mr = jnp.asarray(mr[:, c0 : c0 + nc], mat_t)  # (Wc, nc)
    mi = jnp.asarray(mi[:, c0 : c0 + nc], mat_t)
    # H axis inverse (complex): (gr + i gi) @ (sr + i si); Karatsuba when
    # the extra temporary is cheap, 4-mult when it would push peak HBM.
    out_elems = int(np.prod(sr.shape[:-2])) * nr * sr.shape[-1]
    if _use_karatsuba(out_elems):
        t1 = _mml(gr, sr, precision)
        t2 = _mml(gi, si, precision)
        t3 = _mml(gr + gi, sr + si, precision)
        xr = t1 - t2
        xi = t3 - t1 - t2
    else:
        xr = _mml(gr, sr, precision) - _mml(gi, si, precision)
        xi = _mml(gr, si, precision) + _mml(gi, sr, precision)
    if bf16:
        # keep the W-stage dot single-pass too; the H-stage accumulated f32
        xr, xi = xr.astype(jnp.bfloat16), xi.astype(jnp.bfloat16)
    # W axis inverse (real output): Re part only
    return _mm(xr, mr, precision) + _mm(xi, mi, precision)


def irfft2_mm(
    s: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
    window: tuple[int, int, int, int] | None = None,
) -> jnp.ndarray:
    """Complex-input wrapper of ``irfft2_mm_planes`` (interop/tests)."""
    return irfft2_mm_planes(
        jnp.real(s), jnp.imag(s), fft_h, fft_w,
        precision=precision, window=window,
    )


# ---------------------------------------------------------------------------
# Two-stage Cooley–Tukey transforms (axes above the dense-matrix cap, and
# large axes where the A+B-stage cost beats the dense L-stage cost)
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=128)
def ct_factor(l: int) -> tuple[int, int] | None:
    """Factor L = A·B for the four-step transform, or None.

    B is the fast (minor) axis of the (A, B) view, so candidates prefer
    B ≡ 0 (mod 128), then mod 8; among equals, minimize
    A + B (per-vector MACs = L·(A+B)). Both factors must fit the dense
    stage cap."""
    if l < 4 or l > MATMUL_CT_MAX_AXIS:
        return None
    best, best_score = None, None
    for b in range(2, min(l, MATMUL_FFT_MAX_AXIS) + 1):
        if l % b:
            continue
        a = l // b
        if a < 2 or a > MATMUL_FFT_MAX_AXIS:
            continue
        align = 0 if b % 128 == 0 else (1 if b % 8 == 0 else 2)
        score = (align, a + b)
        if best_score is None or score < best_score:
            best, best_score = (a, b), score
    return best


@functools.lru_cache(maxsize=64)
def _ct_stage_mats(l: int, sign: int, scale: float) -> tuple:
    """Dense DFT matrix exp(sign·2πi·kn/L)·scale, split f32 planes (L, L)."""
    k = np.arange(l)[:, None].astype(np.float64)
    n = np.arange(l)[None, :].astype(np.float64)
    ph = sign * 2.0 * np.pi * k * n / l
    return (
        (np.cos(ph) * scale).astype(np.float32),
        (np.sin(ph) * scale).astype(np.float32),
    )


@functools.lru_cache(maxsize=64)
def _ct_twiddles(a: int, b: int, sign: int) -> tuple:
    """Twiddle T[j, n] = exp(sign·2πi·jn/(A·B)), split f32 planes (A, B)."""
    j = np.arange(a)[:, None].astype(np.float64)
    n = np.arange(b)[None, :].astype(np.float64)
    ph = sign * 2.0 * np.pi * j * n / (a * b)
    return np.cos(ph).astype(np.float32), np.sin(ph).astype(np.float32)


def _ct_axis_last(xr, xi, l: int, sign: int, precision, *,
                  normalize: bool = False, real_out: bool = False):
    """Length-L DFT (sign −1 fwd / +1 inv) of the LAST axis via the
    four-step algorithm, natural-order in and out:

        view x as (A, B) [row-major: n = B·n1 + n2]
        1. (A, A) stage matmul over n1          (matmul)
        2. twiddle multiply exp(sign·2πi·j·n2/L) (elementwise)
        3. (B, B) stage matmul over n2          (matmul)
        4. transpose (j, k) → (k, j), flatten    [out index = A·k + j]

    ``xi=None`` means real input (2 matmuls in stage 1 instead of 4).
    ``normalize`` folds 1/L into the stage-B matrix (inverse transforms).
    ``real_out`` skips the imaginary output plane of stage B (inverse
    transforms whose callers keep only the real part)."""
    a, b = ct_factor(l)
    in_len = xr.shape[-1]
    if in_len < l:
        pad = [(0, 0)] * (xr.ndim - 1) + [(0, l - in_len)]
        xr = jnp.pad(xr, pad)
        xi = None if xi is None else jnp.pad(xi, pad)
    xr = xr.reshape(*xr.shape[:-1], a, b)
    xi = None if xi is None else xi.reshape(*xi.shape[:-1], a, b)

    ar_np, ai_np = _ct_stage_mats(a, sign, 1.0)
    ar, ai = jnp.asarray(ar_np), jnp.asarray(ai_np)

    def stage_a(m, x):  # (A, A)[j, n1] contract over n1 (second-to-last)
        return jnp.einsum(
            "jn,...nb->...jb", m, x,
            precision=precision, preferred_element_type=jnp.float32,
        )

    if xi is None:
        yr, yi = stage_a(ar, xr), stage_a(ai, xr)
    else:
        yr = stage_a(ar, xr) - stage_a(ai, xi)
        yi = stage_a(ar, xi) + stage_a(ai, xr)

    twr_np, twi_np = _ct_twiddles(a, b, sign)
    twr, twi = jnp.asarray(twr_np), jnp.asarray(twi_np)
    yr, yi = yr * twr - yi * twi, yr * twi + yi * twr

    br_np, bi_np = _ct_stage_mats(b, sign, 1.0 / l if normalize else 1.0)
    br, bi = jnp.asarray(br_np), jnp.asarray(bi_np)

    def stage_b(x, m):  # (B, B)[k, n2] contract over n2 (last axis)
        return jnp.einsum(
            "...jn,kn->...jk", x, m,
            precision=precision, preferred_element_type=jnp.float32,
        )

    zr = stage_b(yr, br) - stage_b(yi, bi)
    zr = jnp.swapaxes(zr, -1, -2).reshape(*zr.shape[:-2], l)
    if real_out:
        return zr, None
    zi = stage_b(yr, bi) + stage_b(yi, br)
    zi = jnp.swapaxes(zi, -1, -2).reshape(*zi.shape[:-2], l)
    return zr, zi


def _ct_axis_h(xr, xi, l: int, sign: int, precision, *,
               normalize: bool = False):
    """Same four-step transform applied to the SECOND-TO-LAST axis (the H
    axis of (..., H, W) images) — einsums carry the trailing W axis so the
    minor dimension stays W and no global transpose is ever materialized."""
    a, b = ct_factor(l)
    in_len = xr.shape[-2]
    if in_len < l:
        pad = [(0, 0)] * (xr.ndim - 2) + [(0, l - in_len), (0, 0)]
        xr = jnp.pad(xr, pad)
        xi = None if xi is None else jnp.pad(xi, pad)
    w = xr.shape[-1]
    xr = xr.reshape(*xr.shape[:-2], a, b, w)
    xi = None if xi is None else xi.reshape(*xi.shape[:-2], a, b, w)

    ar_np, ai_np = _ct_stage_mats(a, sign, 1.0)
    ar, ai = jnp.asarray(ar_np), jnp.asarray(ai_np)

    def stage_a(m, x):
        return jnp.einsum(
            "jn,...nbw->...jbw", m, x,
            precision=precision, preferred_element_type=jnp.float32,
        )

    if xi is None:
        yr, yi = stage_a(ar, xr), stage_a(ai, xr)
    else:
        yr = stage_a(ar, xr) - stage_a(ai, xi)
        yi = stage_a(ar, xi) + stage_a(ai, xr)

    twr_np, twi_np = _ct_twiddles(a, b, sign)
    twr = jnp.asarray(twr_np)[:, :, None]
    twi = jnp.asarray(twi_np)[:, :, None]
    yr, yi = yr * twr - yi * twi, yr * twi + yi * twr

    br_np, bi_np = _ct_stage_mats(b, sign, 1.0 / l if normalize else 1.0)
    br, bi = jnp.asarray(br_np), jnp.asarray(bi_np)

    def stage_b(m, x):
        return jnp.einsum(
            "kn,...jnw->...jkw", m, x,
            precision=precision, preferred_element_type=jnp.float32,
        )

    zr = stage_b(br, yr) - stage_b(bi, yi)
    zi = stage_b(bi, yr) + stage_b(br, yi)
    zr = jnp.swapaxes(zr, -2, -3).reshape(*zr.shape[:-3], l, w)
    zi = jnp.swapaxes(zi, -2, -3).reshape(*zi.shape[:-3], l, w)
    return zr, zi


def _hermitian_unpack_last(sr, si, l: int):
    """Packed half-spectrum (..., L//2+1) → full (..., L) via conjugate
    symmetry S[L−m] = conj(S[m]) (real-signal spectra)."""
    wc = l // 2 + 1
    tail_r = sr[..., 1 : l - wc + 1][..., ::-1]
    tail_i = -si[..., 1 : l - wc + 1][..., ::-1]
    return (
        jnp.concatenate([sr, tail_r], axis=-1),
        jnp.concatenate([si, tail_i], axis=-1),
    )


def rfft2_ct_planes(
    x: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    """``rfft2_mm_planes`` for sizes beyond the dense cap: each axis runs
    dense when it fits, four-step CT when it doesn't. Output layout is
    identical (natural order, Hermitian-packed W axis)."""
    h, w = x.shape[-2], x.shape[-1]
    x = x.astype(jnp.float32)
    wc = fft_w // 2 + 1
    # W axis: real → packed complex
    if not _ct_dispatch(fft_w):
        wr_np, wi_np = _fwd_packed_mats(fft_w)
        xr = _mm(x, jnp.asarray(wr_np[:w]), precision)
        xi = _mm(x, jnp.asarray(wi_np[:w]), precision)
    else:
        xr, xi = _ct_axis_last(x, None, fft_w, -1, precision)
        xr, xi = xr[..., :wc], xi[..., :wc]
    # H axis: complex → complex
    if not _ct_dispatch(fft_h):
        fr_np, fi_np = _fwd_mats(fft_h)
        fr = jnp.asarray(fr_np[:, :h])
        fi = jnp.asarray(fi_np[:, :h])
        sr = _mml(fr, xr, precision) - _mml(fi, xi, precision)
        si = _mml(fr, xi, precision) + _mml(fi, xr, precision)
        return sr, si
    return _ct_axis_h(xr, xi, fft_h, -1, precision)


def irfft2_ct_planes(
    sr: jnp.ndarray, si: jnp.ndarray, fft_h: int, fft_w: int,
    *, precision=jax.lax.Precision.HIGHEST,
) -> jnp.ndarray:
    """``irfft2_mm_planes`` (window=None) for sizes beyond the dense cap.
    The 1/(fft_h·fft_w) normalization is folded into the W-axis stage."""
    # H axis inverse: complex → complex (1/fft_h folded either way)
    if not _ct_dispatch(fft_h):
        gr_np, gi_np = _inv_full_mats(fft_h)
        gr, gi = jnp.asarray(gr_np), jnp.asarray(gi_np)
        xr = _mml(gr, sr, precision) - _mml(gi, si, precision)
        xi = _mml(gr, si, precision) + _mml(gi, sr, precision)
    else:
        xr, xi = _ct_axis_h(sr, si, fft_h, +1, precision, normalize=True)
    # W axis inverse: packed → real (1/fft_w folded; the post-H planes are
    # Hermitian along W — real-signal products — so the packed/unpacked
    # inverses agree)
    if not _ct_dispatch(fft_w):
        mr_np, mi_np = _inv_packed_mats(fft_w)
        return _mm(xr, jnp.asarray(mr_np), precision) + _mm(
            xi, jnp.asarray(mi_np), precision
        )
    fr, fi = _hermitian_unpack_last(xr, xi, fft_w)
    out, _ = _ct_axis_last(
        fr, fi, fft_w, +1, precision, normalize=True, real_out=True
    )
    return out
