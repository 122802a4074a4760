"""ctypes bindings for the C++ host runtime (native/libmqc_host.so).

Accelerates the host-side combinatorial layers (enumeration, MBE weights and
deltas, GMBE PIE DFS) with hash-based dedup. Every entry point has a NumPy
fallback in `frag/`; `available()` reports whether the library loaded so
callers can transparently pick the fast path.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

_LIB = None
_TRIED = False


def _lib_path() -> str:
    return os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "native",
        "libmqc_host.so",
    )


def _load():
    global _LIB, _TRIED
    if _TRIED:
        return _LIB
    _TRIED = True
    path = _lib_path()
    if not os.path.exists(path):
        return None
    try:
        lib = ctypes.CDLL(path)
    except OSError:
        return None
    i64 = ctypes.c_int64
    p_i64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    p_f64 = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    lib.mqc_enumerate_polymers.argtypes = [i64, i64, p_i64]
    lib.mqc_enumerate_polymers.restype = i64
    lib.mqc_mbe_weights.argtypes = [p_i64, i64, i64, p_i64]
    lib.mqc_mbe_weights.restype = i64
    lib.mqc_mbe_deltas.argtypes = [p_i64, i64, i64, p_f64, p_f64]
    lib.mqc_mbe_deltas.restype = i64
    lib.mqc_pie_enumerate.argtypes = [p_i64, i64, i64, i64, p_i64, p_i64, i64]
    lib.mqc_pie_enumerate.restype = i64
    _LIB = lib
    return _LIB


def available() -> bool:
    return _load() is not None


def enumerate_polymers(n_monomers: int, max_level: int) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    from .frag.combinatorics import get_nfrags

    n = get_nfrags(n_monomers, max_level)
    out = np.empty((n, max_level), dtype=np.int64)
    rows = lib.mqc_enumerate_polymers(n_monomers, max_level, out)
    assert rows == n
    return out


def mbe_weights(polymers: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    polymers = np.ascontiguousarray(polymers, dtype=np.int64)
    weights = np.zeros(polymers.shape[0], dtype=np.int64)
    rc = lib.mqc_mbe_weights(
        polymers, polymers.shape[0], polymers.shape[1], weights
    )
    if rc != 0:
        raise ValueError("polymer family is not subset-closed")
    return weights


def mbe_deltas(polymers: np.ndarray, energies: np.ndarray) -> np.ndarray:
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    polymers = np.ascontiguousarray(polymers, dtype=np.int64)
    energies = np.ascontiguousarray(energies, dtype=np.float64)
    deltas = np.zeros(polymers.shape[0], dtype=np.float64)
    rc = lib.mqc_mbe_deltas(
        polymers, polymers.shape[0], polymers.shape[1], energies, deltas
    )
    if rc != 0:
        raise ValueError("polymer family is not subset-closed")
    return deltas


def pie_enumerate(primaries: list, max_depth: int = 999):
    """primaries: list of sorted int arrays. Returns (atom_sets, coeffs)."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native library unavailable")
    n_prim = len(primaries)
    width = max(len(p) for p in primaries)
    prim = np.full((n_prim, width), -1, dtype=np.int64)
    for i, p in enumerate(primaries):
        arr = np.sort(np.asarray(p, dtype=np.int64))
        prim[i, : len(arr)] = arr
    cap = 1024
    while True:
        out_sets = np.full((cap, width), -1, dtype=np.int64)
        out_coeffs = np.zeros(cap, dtype=np.int64)
        n = lib.mqc_pie_enumerate(
            np.ascontiguousarray(prim), n_prim, width, max_depth,
            out_sets, out_coeffs, cap,
        )
        if n >= 0:
            sets = [row[row >= 0] for row in out_sets[:n]]
            return sets, out_coeffs[:n]
        cap *= 8
        if cap > 64_000_000:
            raise MemoryError("PIE term capacity exceeded")
