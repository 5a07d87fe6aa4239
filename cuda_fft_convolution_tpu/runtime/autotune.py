"""Measured block-geometry autotuning for the overlap-save engine.

The tiled engine's throughput is set by the (valid_h, valid_w) block
geometry; the right choice is a hardware property, not a formula — so this
module keeps a MEASURED table, filled on the user's own device by
``autotune_block_geometry`` (or ``register_tuned_geometry``) and persisted
to ``$FFTCONV_AUTOTUNE_CACHE``. No geometry ships with the library.

Key: (kernel-envelope pow2 per axis, feature-dim bucket, storage tier[,
head]). Lookup happens in ``ops.tiled.choose_block_fft`` on the matmul-DFT
engine, before the analytic rule.

The analogue of the reference's user-tunable thread-block dims (the
optional ``[H W D 2D]`` 4-vector, src/cudaConvolutionFFT.cu:72-82), with a
tuner instead of magic numbers.
"""

from __future__ import annotations

import json
import os
import time

# (kh_env, kw_env, f_bucket, dtype_tag[, head]) -> (valid_h, valid_w[,
# block_h, block_w]). Envelopes are pow-2 round-ups; f_bucket: 1 for
# F == 1, 2 for 2 <= F < 8 (falls back to bucket 1 when unmeasured), 8 for
# F >= 8; dtype_tag: 'f32' | 'bf16' (the serving tier; bf16 lookups fall
# back to the f32 entry). Optional explicit (block_h, block_w) override the
# derived vh+kh_env-1 block — plans whose effective kernel envelope is
# deliberately larger than the user's.
_MEASURED: dict = {}

_ENV_CACHE_PATH = "FFTCONV_AUTOTUNE_CACHE"


def _envelope(n: int) -> int:
    return max(1 << (int(n) - 1).bit_length(), 8)


def _dtype_tag(store_dtype) -> str:
    return "bf16" if str(store_dtype) in ("bfloat16", "bf16") else "f32"


def _key(
    kh: int, kw: int, f: int, store_dtype="float32", head: str = "conv"
) -> tuple:
    base = (
        _envelope(kh), _envelope(kw),
        8 if f >= 8 else (2 if f >= 2 else 1),
        _dtype_tag(store_dtype),
    )
    # conv entries keep the 4-tuple key; other heads (the peaks detection
    # head) append their tag — the geometry winner can differ per head.
    return base if head == "conv" else base + (head,)


def register_tuned_geometry(
    kh: int, kw: int, valid_h: int, valid_w: int, *, f: int = 1,
    block_h: int | None = None, block_w: int | None = None,
    store_dtype="float32", head: str = "conv",
) -> None:
    """Record a measured-best geometry for kernels in (kh, kw)'s envelope
    at the given storage tier. Explicit ``block_h/block_w`` pin the block
    beyond the derived vh+kh-1 (plans with an enlarged effective kernel
    envelope). ``head='peaks'`` records a detection-head geometry (looked
    up by models.detect_peaks; falls back to the conv entry when
    absent)."""
    entry = [int(valid_h), int(valid_w)]
    if block_h is not None and block_w is not None:
        entry += [int(block_h), int(block_w)]
    _MEASURED[_key(kh, kw, f, store_dtype, head)] = tuple(entry)


def _lookup_one(key) -> tuple | None:
    eh, ew, fb, tag = key[:4]
    head = key[4:]
    # Fallback chain: exact → F-bucket 1 at the same tier (the F=1 plan
    # is the best prior for an unmeasured 2 ≤ F < 8 bank) → the f32
    # entries in the same order.
    buckets = (fb, 1) if fb == 2 else (fb,)
    tags = (tag, "f32") if tag != "f32" else (tag,)
    for t in tags:
        for b in buckets:
            k = (eh, ew, b, t) + head
            hit = _MEASURED.get(k)
            if hit is not None:
                return hit
    return None


def lookup_tuned_geometry(
    kh: int, kw: int, f: int = 1, store_dtype="float32",
    head: str = "conv",
) -> tuple | None:
    """Best-known (valid_h, valid_w[, block_h, block_w]) for this kernel
    envelope at this storage tier, or None. bf16 lookups fall back to the
    f32 entry when the tier has no measurement of its own; non-conv heads
    fall back to the conv entry."""
    _load_user_cache()
    hit = _lookup_one(_key(kh, kw, f, store_dtype, head))
    if hit is None and head != "conv":
        hit = _lookup_one(_key(kh, kw, f, store_dtype))
    return None if hit is None else tuple(hit)


_user_cache_loaded = False


def _load_user_cache() -> None:
    global _user_cache_loaded
    if _user_cache_loaded:
        return
    _user_cache_loaded = True
    path = os.environ.get(_ENV_CACHE_PATH, "")
    if path and os.path.exists(path):
        try:
            with open(path) as fh:
                for k, v in json.load(fh).items():
                    parts = k.split(",")
                    env_h, env_w, fb = (int(x) for x in parts[:3])
                    # legacy 3-part keys load as the f32 tier; a 5th
                    # part is a non-conv head tag (e.g. "peaks")
                    tag = parts[3] if len(parts) > 3 else "f32"
                    key = (env_h, env_w, fb, tag) + tuple(parts[4:5])
                    if len(v) in (3, 5):  # older entries carried a flag
                        v = v[:2] + v[3:]
                    _MEASURED[key] = tuple(int(x) for x in v)
        except Exception:
            pass


def save_user_cache() -> None:
    """Persist the current table to $FFTCONV_AUTOTUNE_CACHE (if set)."""
    path = os.environ.get(_ENV_CACHE_PATH, "")
    if not path:
        return
    with open(path, "w") as fh:
        json.dump(
            {",".join(str(x) for x in k): list(v)
             for k, v in _MEASURED.items()},
            fh,
        )


def default_candidates(kh: int, kw: int) -> list[tuple]:
    """Candidate (vh, vw) geometries for ``autotune_block_geometry``:
    three heights around the kernel envelope × three widths whose
    Hermitian width Wc = (vw+kw−1)//2 + 1 is a multiple of 128."""
    base_h = [max(8, _envelope(kh - 1) // 2), _envelope(kh - 1),
              2 * _envelope(kh - 1)]
    cand_w = []
    m0 = -(-(128 + kw) // 256)
    for m in (m0, m0 + 1, m0 + 2):
        vw = 256 * m - kw
        if vw >= 128:
            cand_w.append(vw)
    return [(vh, vw) for vh in base_h for vw in cand_w]


def autotune_block_geometry(
    data_shape: tuple,  # (H, W, F) channels-last
    kh: int,
    kw: int,
    *,
    n_kernels: int = 32,
    candidates: list[tuple] | None = None,
    iters: int = 3,
    register: bool = True,
    store_dtype: str = "float32",
) -> tuple[tuple, dict]:
    """Measure candidate block plans ON THIS DEVICE for the given workload
    shape and return (best, {plan: seconds}). Plans are (valid_h, valid_w)
    or (valid_h, valid_w, block_h, block_w) — the latter pins explicit
    blocks with an enlarged effective kernel envelope (extra prehistory
    zeros; results identical). The winner is registered with its explicit
    blocks, under the storage tier's own key.

    Each timing ends in ``block_until_ready``. Each candidate costs one
    compile — run once per deployment shape, then ``save_user_cache``.
    """
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cuda_fft_convolution_tpu import api as _api

    h, w, f = data_shape
    if candidates is None:
        candidates = default_candidates(kh, kw)

    rng = np.random.default_rng(0)
    data = jnp.asarray(rng.standard_normal((h, w, f)).astype(np.float32))
    kerns = jnp.asarray(
        rng.standard_normal((n_kernels, kh, kw, f)).astype(np.float32)
    )
    conv = jax.jit(lambda s, k: _api.conv_spectral(s, k, mode="same"))

    timings: dict = {}
    for cand in candidates:
        if len(cand) == 4:
            vh, vw, bh, bw = cand
        else:
            vh, vw = cand
            bh, bw = vh + kh - 1, vw + kw - 1
        pkh, pkw = bh - vh + 1, bw - vw + 1  # effective envelope
        if pkh < kh or pkw < kw:
            continue
        if bh > h + pkh - 1 or bw > w + pkw - 1:
            continue
        try:
            sd = _api.fft_data_tiled(
                data, pkh, pkw, block_h=bh, block_w=bw,
                store_dtype=store_dtype,
            )
            sk = _api.fft_kernels(
                kerns, spectral=sd, store_dtype=store_dtype,
                storage="planar",
            )
            jax.block_until_ready(conv(sd, sk))  # compile + warm up
            t0 = time.perf_counter()
            for _ in range(iters):
                jax.block_until_ready(conv(sd, sk))
            timings[cand] = (time.perf_counter() - t0) / iters
            del sd, sk
        except Exception:
            continue
    if not timings:
        raise RuntimeError("no autotune candidate ran successfully")
    best = min(timings, key=timings.get)
    if len(best) == 4:
        vh, vw, bh, bw = best
    else:
        vh, vw = best
        bh, bw = vh + kh - 1, vw + kw - 1
    if register:
        register_tuned_geometry(
            kh, kw, vh, vw, f=f, block_h=bh, block_w=bw,
            store_dtype=store_dtype,
        )
    return best, timings
