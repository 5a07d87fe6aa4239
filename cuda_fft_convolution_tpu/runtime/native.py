"""ctypes loader for the native planner (csrc/planner.cpp).

Builds ``libfftconv_planner.so`` with g++ on first use (cached next to the
sources; rebuilt when the source is newer). Loading is best-effort: any
failure (no compiler, read-only filesystem) silently yields None and the
pure-Python implementations in utils/fft_size.py / runtime/planner.py take
over — the Python versions are the definition of record, the native library
is the fast path for host-side planning in hot serving loops.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

_LOCK = threading.Lock()
_LIB = None
_TRIED = False

_ABI_VERSION = 5


def _csrc_dir() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
        "csrc",
    )


def _build(src: str, out: str) -> bool:
    try:
        subprocess.run(
            ["g++", "-O2", "-shared", "-fPIC", "-std=c++17", "-o", out, src],
            check=True,
            capture_output=True,
            timeout=120,
        )
        return True
    except Exception:
        return False


def load():
    """Return the ctypes library handle, or None if unavailable."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        src = os.path.join(_csrc_dir(), "planner.cpp")
        so = os.path.join(_csrc_dir(), "libfftconv_planner.so")
        if not os.path.exists(src):
            return None
        if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(src):
            if not _build(src, so):
                return None
        try:
            lib = ctypes.CDLL(so)
        except OSError:
            return None
        try:
            _LIB = _bind(lib)
        except AttributeError:
            # Stale library missing current-ABI symbols (e.g. a prebuilt
            # .so newer than planner.cpp) — fall back to pure Python.
            _LIB = None
        return _LIB


def _bind(lib):
    """Bind the current-ABI symbols; AttributeError on a stale library,
    None on an ABI-version mismatch."""
    c64 = ctypes.c_int64
    lib.ffc_ceil_div.restype = c64
    lib.ffc_ceil_div.argtypes = [c64, c64]
    lib.ffc_align_up.restype = c64
    lib.ffc_align_up.argtypes = [c64, c64]
    lib.ffc_next_multiple_of_16.restype = c64
    lib.ffc_next_multiple_of_16.argtypes = [c64]
    lib.ffc_next_pow2.restype = c64
    lib.ffc_next_pow2.argtypes = [c64]
    lib.ffc_next_fast_len.restype = c64
    lib.ffc_next_fast_len.argtypes = [c64]
    lib.ffc_compute_fft_size.restype = None
    lib.ffc_compute_fft_size.argtypes = [
        c64, c64, c64, c64, ctypes.c_int32,
        ctypes.POINTER(c64), ctypes.POINTER(c64),
    ]
    lib.ffc_plan_bank.restype = None
    lib.ffc_plan_bank.argtypes = [
        c64, c64, c64, c64, c64, c64, c64,
        ctypes.POINTER(c64), ctypes.POINTER(c64),
    ]
    lib.ffc_choose_block_fft.restype = ctypes.c_int32
    lib.ffc_choose_block_fft.argtypes = [
        c64, c64, c64, c64, ctypes.c_int32, c64,
        ctypes.POINTER(c64), ctypes.POINTER(c64),
        ctypes.POINTER(c64), ctypes.POINTER(c64),
    ]
    lib.ffc_abi_version.restype = ctypes.c_int32
    lib.ffc_abi_version.argtypes = []
    if lib.ffc_abi_version() != _ABI_VERSION:
        return None
    return lib
