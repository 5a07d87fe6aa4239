"""PGM/PPM image I/O and array comparison helpers.

Equivalents of the reference's vendored NVIDIA helpers that the
detection workflow actually needs: PGM load/save (≈ sdkLoadPGM/sdkSavePGM,
common/helper_image.h:227; cutLoadPGMf, src/cutil.h:294-368) and tolerance
comparison (≈ cutComparef / sdkCompareL2fe, src/cutil.h:545,
common/helper_image.h:877 — vendored but never called there; asserted here).
Pure numpy on the host — image decode is not device work.
"""

from __future__ import annotations

import numpy as np

from cuda_fft_convolution_tpu.utils.errors import InvalidInputError, validate


def _read_token(f) -> bytes:
    """Next whitespace-delimited token, skipping '#' comment lines."""
    tok = b""
    while True:
        ch = f.read(1)
        if not ch:
            break
        if ch == b"#":
            f.readline()
            continue
        if ch.isspace():
            if tok:
                break
            continue
        tok += ch
    return tok


def load_pgm(path: str, *, normalize: bool = True) -> np.ndarray:
    """Load a binary (P5) or ASCII (P2) PGM → (H, W) float32 (in [0,1] when
    ``normalize``) — ≈ sdkLoadPGM<float>."""
    with open(path, "rb") as f:
        magic = _read_token(f)
        validate(magic in (b"P5", b"P2"), f"not a PGM file: magic {magic!r}")
        w = int(_read_token(f))
        h = int(_read_token(f))
        maxval = int(_read_token(f))
        validate(0 < maxval < 65536, f"bad PGM maxval {maxval}")
        if magic == b"P5":
            dtype = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
            data = np.frombuffer(f.read(h * w * dtype.itemsize), dtype=dtype)
        else:
            data = np.array(
                [int(_read_token(f)) for _ in range(h * w)], dtype=np.uint16
            )
        validate(data.size == h * w, "truncated PGM payload")
        img = data.reshape(h, w).astype(np.float32)
        return img / maxval if normalize else img


def save_pgm(path: str, img, *, maxval: int = 255) -> None:
    """Save (H, W) float array (values in [0,1]) as binary P5 PGM —
    ≈ sdkSavePGM."""
    arr = np.asarray(img, np.float64)
    validate(arr.ndim == 2, f"PGM needs a 2-D array; got {arr.shape}")
    q = np.clip(np.round(arr * maxval), 0, maxval)
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype("u1")
    with open(path, "wb") as f:
        f.write(f"P5\n{arr.shape[1]} {arr.shape[0]}\n{maxval}\n".encode())
        f.write(q.astype(dtype).tobytes())


def compare_l2(got, want, *, eps: float = 1e-5) -> bool:
    """Relative L2 comparison — ≈ sdkCompareL2fe
    (common/helper_image.h:877): ||got-want||₂ / ||want||₂ < eps."""
    got = np.asarray(got, np.float64).ravel()
    want = np.asarray(want, np.float64).ravel()
    if got.shape != want.shape:
        raise InvalidInputError(
            f"shape mismatch: {got.shape} vs {want.shape}"
        )
    denom = np.linalg.norm(want)
    if denom == 0:
        return float(np.linalg.norm(got)) < eps
    return float(np.linalg.norm(got - want) / denom) < eps


def compare_max(got, want, *, atol: float = 1e-5) -> bool:
    """Max-abs comparison — ≈ cutComparef (src/cutil.h:545)."""
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return bool(np.max(np.abs(got - want)) < atol)
