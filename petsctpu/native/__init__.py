"""ctypes loader for the native plan-time kernels (native/*.cpp).

Builds lazily with g++ on first use when the shared library is missing
or older than its source (a ~1 s compile); falls back to pure-Python
implementations when no toolchain is available. All entry points
mirror numpy-CSR signatures; see native/petsctpu_native.cpp for the C ABI.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

_HERE = os.path.dirname(__file__)
_SO = os.path.join(_HERE, "libpetsctpu_native.so")
_SRC = os.path.join(_HERE, "..", "..", "native", "petsctpu_native.cpp")

_lib = None


def _build() -> bool:
    # build beside the target and rename into place, so concurrent
    # processes never load a half-written library
    tmp = f"{_SO}.{os.getpid()}.tmp"
    try:
        subprocess.run(
            ["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", tmp,
             _SRC], check=True, capture_output=True, timeout=120)
        os.replace(tmp, _SO)
        return True
    except Exception:
        return False


def _stale() -> bool:
    if not os.path.exists(_SRC):
        return False
    return (not os.path.exists(_SO)
            or os.path.getmtime(_SRC) > os.path.getmtime(_SO))


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if _stale():
        _build()
    if os.path.exists(_SO):
        try:
            lib = ctypes.CDLL(_SO)
            i64 = ctypes.c_int64
            p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
            p32 = np.ctypeslib.ndpointer(np.int32, flags="C")
            pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.ilu0_csr.restype = i64
            lib.ilu0_csr.argtypes = [i64, p64, p32, pf64]
            lib.tri_levels.restype = i64
            lib.tri_levels.argtypes = [i64, p64, p32, ctypes.c_int32, p64]
            lib.greedy_color.restype = i64
            lib.greedy_color.argtypes = [i64, i64, p64, p32, p64, p32, p32]
            lib.aggregate.restype = i64
            lib.aggregate.argtypes = [i64, p64, p32, p64]
            lib.rcm.restype = i64
            lib.rcm.argtypes = [i64, p64, p32, p32]
            _lib = lib
        except Exception:
            _lib = False
    else:
        _lib = False
    return _lib


def available() -> bool:
    return bool(_load())


# ---- numpy-facing wrappers --------------------------------------------------
def ilu0_csr_inplace(indptr, indices, data) -> None:
    """Numeric ILU(0) on CSR arrays in place. Raises on zero pivot."""
    lib = _load()
    n = len(indptr) - 1
    rc = lib.ilu0_csr(n, np.ascontiguousarray(indptr, np.int64),
                      np.ascontiguousarray(indices, np.int32), data)
    if rc < 0:
        raise ValueError(f"ILU(0): missing diagonal in row {-rc - 1}")
    if rc > 0:
        raise ZeroDivisionError(f"ILU(0): zero pivot in row {rc - 1}")


def tri_levels(indptr, indices, lower: bool):
    lib = _load()
    n = len(indptr) - 1
    out = np.zeros(n, np.int64)
    lib.tri_levels(n, np.ascontiguousarray(indptr, np.int64),
                   np.ascontiguousarray(indices, np.int32),
                   1 if lower else 0, out)
    return out


def greedy_color(row_ptr, row_idx, col_ptr, col_idx, n_rows, n_cols):
    lib = _load()
    out = np.zeros(n_cols, np.int32)
    lib.greedy_color(n_rows, n_cols,
                     np.ascontiguousarray(row_ptr, np.int64),
                     np.ascontiguousarray(row_idx, np.int32),
                     np.ascontiguousarray(col_ptr, np.int64),
                     np.ascontiguousarray(col_idx, np.int32), out)
    return out


def aggregate(indptr, indices):
    lib = _load()
    n = len(indptr) - 1
    out = np.zeros(n, np.int64)
    lib.aggregate(n, np.ascontiguousarray(indptr, np.int64),
                  np.ascontiguousarray(indices, np.int32), out)
    return out


def rcm(indptr, indices):
    lib = _load()
    n = len(indptr) - 1
    out = np.zeros(n, np.int32)
    lib.rcm(n, np.ascontiguousarray(indptr, np.int64),
            np.ascontiguousarray(indices, np.int32), out)
    return out


def _register_round2(lib):
    i64 = ctypes.c_int64
    p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
    p32 = np.ctypeslib.ndpointer(np.int32, flags="C")
    pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
    pp64 = ctypes.POINTER(ctypes.POINTER(ctypes.c_int64))
    lib.native_free.restype = None
    lib.native_free.argtypes = [ctypes.c_void_p]
    lib.iluk_pattern.restype = i64
    lib.iluk_pattern.argtypes = [i64, p64, p32, i64, pp64, pp64]
    lib.icck_pattern.restype = i64
    lib.icck_pattern.argtypes = [i64, p64, p32, i64, pp64, pp64]
    lib.icc_numeric.restype = i64
    lib.icc_numeric.argtypes = [i64, p64, p32, pf64, p64, p64, pf64,
                                pf64, ctypes.c_int32, ctypes.c_double,
                                ctypes.c_double, pf64]


def _have_round2() -> bool:
    lib = _load()
    if not lib:
        return False
    if not getattr(lib, "_round2_ok", False):
        try:
            _register_round2(lib)
            lib._round2_ok = True
        except AttributeError:
            # stale .so from round 1: rebuild once
            try:
                os.remove(_SO)
            except OSError:
                pass
            global _lib
            _lib = None
            lib = _load()
            if not lib:
                return False
            try:
                _register_round2(lib)
                lib._round2_ok = True
            except AttributeError:
                return False
    return True


def _take_pattern(lib, nnz, ip_p, cols_p, n):
    indptr = np.ctypeslib.as_array(ip_p, shape=(n + 1,)).copy()
    cols = np.ctypeslib.as_array(cols_p, shape=(max(int(nnz), 1),))[
        :int(nnz)].copy()
    lib.native_free(ctypes.cast(ip_p, ctypes.c_void_p))
    lib.native_free(ctypes.cast(cols_p, ctypes.c_void_p))
    return indptr, cols


def iluk_pattern(indptr, indices, k: int):
    """Symbolic ILU(k) pattern: returns (indptr, cols) CSR arrays.
    None if the native library is unavailable."""
    if not _have_round2():
        return None
    lib = _load()
    n = len(indptr) - 1
    ip_p = ctypes.POINTER(ctypes.c_int64)()
    cols_p = ctypes.POINTER(ctypes.c_int64)()
    nnz = lib.iluk_pattern(n, np.ascontiguousarray(indptr, np.int64),
                           np.ascontiguousarray(indices, np.int32), k,
                           ctypes.byref(ip_p), ctypes.byref(cols_p))
    return _take_pattern(lib, nnz, ip_p, cols_p, n)


def icck_pattern(indptr, indices, levels: int):
    """Symbolic IC(k) strict-upper pattern: (indptr, cols) or None."""
    if not _have_round2():
        return None
    lib = _load()
    n = len(indptr) - 1
    ip_p = ctypes.POINTER(ctypes.c_int64)()
    cols_p = ctypes.POINTER(ctypes.c_int64)()
    nnz = lib.icck_pattern(n, np.ascontiguousarray(indptr, np.int64),
                           np.ascontiguousarray(indices, np.int32),
                           levels, ctypes.byref(ip_p),
                           ctypes.byref(cols_p))
    return _take_pattern(lib, nnz, ip_p, cols_p, n)


def _have_round3() -> bool:
    lib = _load()
    if not lib:
        return False
    if not getattr(lib, "_round3_ok", False):
        try:
            i64 = ctypes.c_int64
            p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
            p32 = np.ctypeslib.ndpointer(np.int32, flags="C")
            lib.kway_partition.restype = i64
            lib.kway_partition.argtypes = [i64, p64, p32, ctypes.c_void_p,
                                           i64, ctypes.c_uint64, p32]
            lib._round3_ok = True
        except AttributeError:
            # stale .so: rebuild once
            try:
                os.remove(_SO)
            except OSError:
                pass
            global _lib
            _lib = None
            return _have_round3() if _load() else False
    return True


def sbaij_block_udu(ai, aj, av, ui, uj, bs: int, shift: float = 0.0):
    """Blocked UᵀDU numeric factorization (sbaijfact.c analog) over a
    strict-upper block pattern. av: [nnzb_A, bs, bs] upper blocks of A
    (incl. diagonal). Returns (uv [nnzb_U, bs, bs], dv [nb, bs, bs])
    or None when unavailable; raises on a singular block pivot."""
    lib = _load()
    if not lib:
        return None
    if not getattr(lib, "_sbaij_ok", False):
        try:
            i64 = ctypes.c_int64
            p64 = np.ctypeslib.ndpointer(np.int64, flags="C")
            pf64 = np.ctypeslib.ndpointer(np.float64, flags="C")
            lib.sbaij_block_udu.restype = i64
            lib.sbaij_block_udu.argtypes = [i64, i64, p64, p64, pf64,
                                            p64, p64, pf64, pf64,
                                            ctypes.c_double]
            lib._sbaij_ok = True
        except AttributeError:
            try:
                os.remove(_SO)
            except OSError:
                pass
            global _lib
            _lib = None
            if not _load():
                return None
            return sbaij_block_udu(ai, aj, av, ui, uj, bs, shift)
    nb = len(ai) - 1
    ui = np.ascontiguousarray(ui, np.int64)
    uv = np.zeros((int(ui[-1]), bs, bs), np.float64)
    dv = np.zeros((nb, bs, bs), np.float64)
    rc = lib.sbaij_block_udu(
        nb, bs, np.ascontiguousarray(ai, np.int64),
        np.ascontiguousarray(aj, np.int64),
        np.ascontiguousarray(av, np.float64).reshape(-1), ui,
        np.ascontiguousarray(uj, np.int64),
        uv.reshape(-1), dv.reshape(-1), shift)
    if rc > 0:
        raise ZeroDivisionError(
            f"sbaij UtDU: singular block pivot {rc - 1}")
    return uv, dv


def kway_partition(indptr, indices, nparts: int, ewts=None, seed: int = 1):
    """Multilevel k-way partition (HEM coarsen + greedy grow + FM
    refine — the ParMetis-analog, pmetis.c). Returns (part, edgecut)
    or None when the native library is unavailable."""
    if not _have_round3():
        return None
    lib = _load()
    n = len(indptr) - 1
    part = np.zeros(n, np.int32)
    if ewts is not None:
        ewts = np.ascontiguousarray(ewts, np.int64)
        ewts_p = ewts.ctypes.data_as(ctypes.c_void_p)
    else:
        ewts_p = None
    cut = lib.kway_partition(n, np.ascontiguousarray(indptr, np.int64),
                             np.ascontiguousarray(indices, np.int32),
                             ewts_p, nparts, seed, part)
    if cut < 0:
        raise ValueError("kway_partition failed")
    return part, int(cut)


_SHIFT_CODES = {"none": 0, "nonzero": 1, "inblocks": 2,
                "positive_definite": 3}


def icc_numeric(ai, aj, aa, ui, uj, shift_type: str, zeropivot: float,
                shift_amount: float):
    """Numeric UᵀDU incomplete Cholesky on the (ui, uj) strict-upper
    pattern. Returns (uv, d, nshift, shift) or None if unavailable;
    raises ZeroDivisionError on an unshifted zero pivot."""
    if not _have_round2():
        return None
    lib = _load()
    n = len(ai) - 1
    ui = np.ascontiguousarray(ui, np.int64)
    uv = np.zeros(int(ui[-1]), np.float64)
    d = np.zeros(n, np.float64)
    shift_out = np.zeros(1, np.float64)
    rc = lib.icc_numeric(n, np.ascontiguousarray(ai, np.int64),
                         np.ascontiguousarray(aj, np.int32),
                         np.ascontiguousarray(aa, np.float64), ui,
                         np.ascontiguousarray(uj, np.int64), uv, d,
                         _SHIFT_CODES[shift_type], zeropivot,
                         shift_amount, shift_out)
    if rc < 0:
        raise ZeroDivisionError(
            f"icc: zero pivot row {-rc - 1} (native)")
    return uv, d, int(rc), float(shift_out[0])
