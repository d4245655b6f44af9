"""Host-native C++ cell-lists oracle, loaded via ctypes.

The port's own copy of ``zelll_tpu/oracle``: the exact-f64 reference
implementation that judges the engine at particle counts where O(n^2)
brute force is infeasible, plus the native ChaCha12 stream behind
`utils.datagen`. Compiled with g++ at first use into the checkout's
git-ignored ``build/`` directory.
"""

from __future__ import annotations

import ctypes
import subprocess
from pathlib import Path

import numpy as np

from ..ops._build import GXX_FLAGS, build_shared

__all__ = ["available", "lj_energy", "pairs", "query_neighbors",
           "query_neighbors_batch", "forces", "chacha12_u64"]

_SRC = Path(__file__).parent / "cell_lists.cpp"


def _load():
    if _load.lib is not None:
        return _load.lib
    path, _ = build_shared(_SRC, "g++", GXX_FLAGS, "cell_lists")
    lib = ctypes.CDLL(str(path))
    i64 = ctypes.c_int64
    f64p = ctypes.POINTER(ctypes.c_double)
    i64p = ctypes.POINTER(ctypes.c_int64)
    lib.zelll_oracle_lj.argtypes = [f64p, i64, ctypes.c_double, f64p, i64p]
    lib.zelll_oracle_lj.restype = None
    i32p = ctypes.POINTER(ctypes.c_int32)
    lib.zelll_oracle_pairs.argtypes = [f64p, i64, ctypes.c_double, i32p, i32p, i64]
    lib.zelll_oracle_pairs.restype = i64
    lib.zelll_oracle_query.argtypes = [f64p, i64, ctypes.c_double, f64p, i32p, i64]
    lib.zelll_oracle_query.restype = i64
    lib.zelll_oracle_query_batch.argtypes = [f64p, i64, ctypes.c_double, f64p, i64,
                                             i64p, i32p, i64]
    lib.zelll_oracle_query_batch.restype = i64
    lib.zelll_oracle_forces.argtypes = [f64p, i64, ctypes.c_double, f64p]
    lib.zelll_oracle_forces.restype = None
    u32p = ctypes.POINTER(ctypes.c_uint32)
    u64p = ctypes.POINTER(ctypes.c_uint64)
    lib.zelll_chacha12_u64.argtypes = [u32p, ctypes.c_uint64, i64, u64p]
    lib.zelll_chacha12_u64.restype = None
    _load.lib = lib
    return lib


_load.lib = None


def available() -> bool:
    try:
        _load()
        return True
    except (OSError, RuntimeError, FileNotFoundError, subprocess.SubprocessError):
        return False


def _pos_ptr(positions):
    pos = np.ascontiguousarray(positions, np.float64)
    if pos.ndim != 2 or pos.shape[1] != 3:
        raise ValueError(f"the oracle takes (n, 3) positions, got {pos.shape}")
    return pos, pos.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def lj_energy(positions, cutoff: float) -> tuple[float, int]:
    """Exact f64 (energy, cutoff-pair count)."""
    lib = _load()
    pos, ptr = _pos_ptr(positions)
    e = ctypes.c_double()
    p = ctypes.c_int64()
    lib.zelll_oracle_lj(ptr, pos.shape[0], cutoff, ctypes.byref(e), ctypes.byref(p))
    return e.value, p.value


def pairs(positions, cutoff: float, cap: int | None = None):
    """Cutoff-filtered unique pairs as (i, j) int32 arrays."""
    lib = _load()
    pos, ptr = _pos_ptr(positions)
    n = pos.shape[0]
    cap = cap or max(64, n * 40)
    i = np.empty(cap, np.int32)
    j = np.empty(cap, np.int32)
    total = lib.zelll_oracle_pairs(
        ptr, n, cutoff,
        i.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        j.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
    )
    if total > cap:
        return pairs(positions, cutoff, cap=int(total))
    return i[:total], j[:total]


def query_neighbors(positions, cutoff: float, q):
    """Full-space candidate neighbours of q (own cell and the 26 around
    it, no distance filter), or None if q is too far outside the grid."""
    lib = _load()
    pos, ptr = _pos_ptr(positions)
    qa = np.ascontiguousarray(q, np.float64)
    if qa.shape != (3,):
        raise ValueError(f"the oracle takes one (3,) query point, got {qa.shape}")
    cap = pos.shape[0]
    out = np.empty(cap, np.int32)
    total = lib.zelll_oracle_query(
        ptr, pos.shape[0], cutoff,
        qa.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
    )
    if total < 0:
        return None
    return out[:total]


def query_neighbors_batch(positions, cutoff: float, queries) -> list:
    """`query_neighbors` for (Q, 3) query points against one grid build: a
    list of Q candidate id arrays, None where a query is too far outside
    the grid."""
    lib = _load()
    pos, ptr = _pos_ptr(positions)
    qs = np.ascontiguousarray(queries, np.float64).reshape(-1, 3)
    counts = np.empty(len(qs), np.int64)
    cap = 27 * 16 * len(qs)
    for _ in range(2):  # a second pass when the first buffer was short
        out = np.empty(max(cap, 1), np.int32)
        total = lib.zelll_oracle_query_batch(
            ptr, pos.shape[0], cutoff,
            qs.ctypes.data_as(ctypes.POINTER(ctypes.c_double)), len(qs),
            counts.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)), cap,
        )
        if total <= cap:
            break
        cap = total
    ends = np.cumsum(np.maximum(counts, 0))
    return [None if c < 0 else out[e - c:e] for c, e in zip(counts, ends)]


def forces(positions, cutoff: float) -> np.ndarray:
    """Exact f64 per-particle LJ forces, (n, 3) in input order: the sum over
    cutoff partners j of 24 t (2t - 1) / dsq (p_i - p_j), t = dsq^-3."""
    lib = _load()
    pos, ptr = _pos_ptr(positions)
    out = np.zeros_like(pos)
    lib.zelll_oracle_forces(ptr, pos.shape[0], cutoff,
                            out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)))
    return out


def chacha12_u64(key_words: np.ndarray, start_u32: int, n: int) -> np.ndarray:
    """Native ChaCha12 u64 stream (rand 0.8 StdRng layout)."""
    lib = _load()
    key = np.ascontiguousarray(key_words, np.uint32)
    out = np.empty(n, np.uint64)
    lib.zelll_chacha12_u64(
        key.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        ctypes.c_uint64(start_u32),
        n,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
    )
    return out
