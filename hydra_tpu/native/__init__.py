"""ctypes bindings for the native BED kernels (builds on first use).

Falls back to the NumPy implementations in hydra_tpu.io.plink when no C++
toolchain is available; `available()` reports which path is active.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading
from typing import Optional, Tuple

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_HERE, "bedio.cpp")
_LIB = os.path.join(_HERE, "libbedio.so")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> bool:
    cmd = ["g++", "-O3", "-march=native", "-fopenmp", "-shared", "-fPIC",
           _SRC, "-o", _LIB]
    try:
        subprocess.run(cmd, check=True, capture_output=True, timeout=300)
        return True
    except (subprocess.SubprocessError, FileNotFoundError):
        return False


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        if not os.path.exists(_LIB) or (
                os.path.getmtime(_LIB) < os.path.getmtime(_SRC)):
            if not _build():
                return None
        try:
            lib = ctypes.CDLL(_LIB)
        except OSError:
            return None
        i64 = ctypes.c_int64
        u8p = np.ctypeslib.ndpointer(np.uint8, flags="C")
        i64p = np.ctypeslib.ndpointer(np.int64, flags="C")
        f32p = np.ctypeslib.ndpointer(np.float32, flags="C")
        f64p = np.ctypeslib.ndpointer(np.float64, flags="C")
        u32p = np.ctypeslib.ndpointer(np.uint32, flags="C")
        lib.bed_counts.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64p]
        lib.bed_decode.argtypes = [u8p, i64, i64, f32p, f32p]
        lib.bed_remove_individuals.argtypes = [u8p, i64, i64, i64, u8p, u8p, i64]
        lib.bed_sparse_fill.argtypes = [u8p, i64, i64, i64, i64p, i64p, i64p,
                                        u32p, u32p, u32p]
        lib.bed_dot.argtypes = [u8p, i64, i64, i64, f64p, f64p, f64p, f64p]
        lib.bed_pack.argtypes = [u8p, i64, i64, u8p, i64]
        lib.bed_generate.argtypes = [u8p, i64, i64, u8p, u8p, u8p, i64]
        lib.bed_hpack.argtypes = [u8p, i64, u8p]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def bed_counts(packed: np.ndarray, n: int
               ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    m, nbytes = packed.shape
    n1 = np.empty(m, np.int64)
    n2 = np.empty(m, np.int64)
    nm = np.empty(m, np.int64)
    lib.bed_counts(np.ascontiguousarray(packed), m, nbytes, n, n1, n2, nm)
    return n1, n2, nm


def bed_hpack(packed: np.ndarray) -> Optional[np.ndarray]:
    """PLINK-coded bytes -> h-packed device bytes (OpenMP LUT pass).
    None if the native library is unavailable (NumPy fallback in
    ops/decode.hpack_bytes)."""
    lib = _load()
    if lib is None:
        return None
    pk = np.ascontiguousarray(packed)
    out = np.empty_like(pk)
    lib.bed_hpack(pk.reshape(-1), pk.size, out.reshape(-1))
    return out


def bed_decode(packed: np.ndarray) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    lib = _load()
    if lib is None:
        return None
    m, nbytes = packed.shape
    geno = np.empty((m, nbytes * 4), np.float32)
    mask = np.empty((m, nbytes * 4), np.float32)
    lib.bed_decode(np.ascontiguousarray(packed), m, nbytes, geno, mask)
    return geno, mask


def bed_remove_individuals(packed: np.ndarray, n: int,
                           na_indices: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    m, nbytes = packed.shape
    keep = np.ones(n, np.uint8)
    keep[np.asarray(na_indices, np.int64)] = 0
    n_new = int(keep.sum())
    out_nbytes = (n_new + 3) // 4
    out = np.empty((m, out_nbytes), np.uint8)
    lib.bed_remove_individuals(np.ascontiguousarray(packed), m, nbytes, n,
                               keep, out, out_nbytes)
    return out


def bed_sparse_fill(packed: np.ndarray, n: int, s1, s2, sm, c1, c2, cm,
                    out=None):
    """out: optional (i1, i2, im) uint32 buffers to fill (capacity checked);
    reuse avoids cold-page faults that dominate blockwise conversion."""
    lib = _load()
    if lib is None:
        return None
    m, nbytes = packed.shape
    need = (int(c1.sum()), int(c2.sum()), int(cm.sum()))
    if out is not None and all(b.size >= k for b, k in zip(out, need)):
        i1, i2, im = (b[:k] for b, k in zip(out, need))
    else:
        i1, i2, im = (np.empty(k, np.uint32) for k in need)
    lib.bed_sparse_fill(np.ascontiguousarray(packed), m, nbytes, n,
                        np.ascontiguousarray(s1, np.int64),
                        np.ascontiguousarray(s2, np.int64),
                        np.ascontiguousarray(sm, np.int64), i1, i2, im)
    return i1, i2, im


def bed_pack(geno: np.ndarray, nbytes: int) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    m, n = geno.shape
    out = np.empty((m, nbytes), np.uint8)
    lib.bed_pack(np.ascontiguousarray(geno, np.uint8), m, n, out, nbytes)
    return out


def bed_generate(rand_bytes: np.ndarray, thr_a: np.ndarray, thr_b: np.ndarray,
                 nbytes: int) -> Optional[np.ndarray]:
    """HWE genotype generation + packing: g = (u < a) + (u < b) per marker."""
    lib = _load()
    if lib is None:
        return None
    m, n = rand_bytes.shape
    out = np.empty((m, nbytes), np.uint8)
    lib.bed_generate(np.ascontiguousarray(rand_bytes), m, n,
                     np.ascontiguousarray(thr_a, np.uint8),
                     np.ascontiguousarray(thr_b, np.uint8), out, nbytes)
    return out


def bed_dot(packed: np.ndarray, n: int, eps: np.ndarray, mave: np.ndarray,
            mstd: np.ndarray) -> Optional[np.ndarray]:
    lib = _load()
    if lib is None:
        return None
    m, nbytes = packed.shape
    num = np.empty(m, np.float64)
    eps_pad = np.zeros(nbytes * 4, np.float64)
    eps_pad[: len(eps)] = eps
    lib.bed_dot(np.ascontiguousarray(packed), m, nbytes, n, eps_pad,
                np.ascontiguousarray(mave, np.float64),
                np.ascontiguousarray(mstd, np.float64), num)
    return num
