"""ctypes bindings for the native IO/RNG support library
(csrc/quandary_native.cpp, the port's own copy of native/quandary_native.cpp).

The library is built with g++ the first time it is needed, into the build
directory of utils/cache.py under a name keyed on a hash of the source
(as ops/cuda_build.py keys the CUDA libraries), and loaded once per process.
Every entry point has a pure-Python fallback: where the library cannot be
built, `get_lib()` is None, the writers fall back to Python formatting and
`mt19937_uniform` returns None (callers then draw from numpy, which is not
bit-equal to the reference's std::mt19937)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

import numpy as np

from ..ops.cuda_build import BUILD_DIR, CSRC_DIR

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
_TRIED = False

SRC = os.path.join(CSRC_DIR, "quandary_native.cpp")


def library_path() -> str:
    with open(SRC, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f"libquandary_native_{digest}.so")


def _build() -> Optional[str]:
    so = library_path()
    if os.path.exists(so):
        return so
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp, SRC],
            check=True, capture_output=True, timeout=120)
        os.replace(tmp, so)
        return so
    except (OSError, subprocess.SubprocessError):
        return None


def get_lib() -> Optional[ctypes.CDLL]:
    global _LIB, _TRIED
    with _LOCK:
        if _LIB is not None or _TRIED:
            return _LIB
        _TRIED = True
        so = _build()
        if so is None:
            return None
        lib = ctypes.CDLL(so)
        c_dp = ctypes.POINTER(ctypes.c_double)
        lib.qtpu_write_state_rows.argtypes = [
            ctypes.c_char_p, ctypes.c_char_p, c_dp, c_dp,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        lib.qtpu_write_state_rows.restype = ctypes.c_int
        lib.qtpu_mt19937_uniform.argtypes = [ctypes.c_uint32, ctypes.c_int64,
                                             c_dp]
        lib.qtpu_mt19937_uniform.restype = None
        lib.qtpu_read_table.argtypes = [ctypes.c_char_p, c_dp, ctypes.c_int64]
        lib.qtpu_read_table.restype = ctypes.c_int64
        lib.qtpu_read_triplets.argtypes = [
            ctypes.c_char_p, ctypes.c_int,
            ctypes.POINTER(ctypes.c_int64), c_dp, ctypes.c_int64]
        lib.qtpu_read_triplets.restype = ctypes.c_int64
        _LIB = lib
        return _LIB


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def mt19937_uniform(seed: int, n: int) -> Optional[np.ndarray]:
    """n uniform [0,1) doubles from std::mt19937(seed), bit-exact with the
    reference's random control init on Linux. None if the native library
    is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(n, dtype=np.float64)
    lib.qtpu_mt19937_uniform(ctypes.c_uint32(seed), n, _dp(out))
    return out


def write_state_rows(path: str, header: str, times: np.ndarray,
                     data: np.ndarray, decim: int = 1) -> bool:
    """Rows 'time  v0  v1 ...' every `decim` rows (output.cpp:256-262);
    False if the native library is unavailable."""
    lib = get_lib()
    if lib is None:
        return False
    times = np.ascontiguousarray(times, dtype=np.float64)
    data = np.ascontiguousarray(data, dtype=np.float64)
    nrows, ncols = data.shape
    rc = lib.qtpu_write_state_rows(path.encode(), header.encode(),
                                   _dp(times), _dp(data), nrows, ncols, decim)
    return rc == 0


def read_triplets(path: str, ncols_id: int,
                  maxn: int = 1 << 22) -> Optional[tuple]:
    """Sparse-triplet Hamiltonian file -> (ids (n, ncols_id) int64,
    vals (n,) complex128), or None if the native library is unavailable.
    ncols_id = 2 for 'row col re im' (Hsys), 3 for 'osc row col re im'
    (Hc). The capacity grows until the whole file fits (the C reader stops
    at maxn, and a full buffer is indistinguishable from an exact fit)."""
    lib = get_lib()
    if lib is None:
        return None
    try:
        maxn = min(maxn, max(64, os.path.getsize(path) // 8 + 1))
    except OSError:
        return None
    while True:
        ids = np.empty((maxn, ncols_id), dtype=np.int64)
        vals = np.empty((maxn, 2), dtype=np.float64)
        n = lib.qtpu_read_triplets(
            path.encode(), ncols_id,
            ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)), _dp(vals),
            maxn)
        if n < 0:
            return None
        if n < maxn:
            return ids[:n].copy(), (vals[:n, 0] + 1j * vals[:n, 1])
        maxn *= 2


def read_table(path: str, maxn: int) -> Optional[np.ndarray]:
    """Up to maxn numbers of a whitespace table ('#' comments skipped), or
    None if the native library is unavailable or the file unreadable."""
    lib = get_lib()
    if lib is None:
        return None
    out = np.empty(maxn, dtype=np.float64)
    n = lib.qtpu_read_table(path.encode(), _dp(out), maxn)
    if n < 0:
        return None
    return out[:n]
