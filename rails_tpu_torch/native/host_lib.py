"""ctypes bindings to the port's C++ host library (``librails_host.cpp``),
the counterpart of the JAX package's ``native/host_lib.py``.

The library provides what the reference does natively on the host: a
MatrixMarket coordinate reader (the EpetraExt I/O role) and a serial
Gilbert-Peierls sparse LU with partial pivoting and transpose solves
(the Amesos/KLU role for the Schur path's A11 solve).  It is built with
g++ at first use (``rails_tpu_torch/_build.py::load_host``); a failed
build raises, where the JAX package's loader falls back to scipy.
"""

from __future__ import annotations

import ctypes

import numpy as np
import scipy.sparse as sp

__all__ = ["NativeSparseLU", "library", "read_matrix_market"]

_i64p = ctypes.POINTER(ctypes.c_int64)
_f64p = ctypes.POINTER(ctypes.c_double)
_LIB = None


def library() -> ctypes.CDLL:
    """The host library with its C signatures set, built at first use."""
    global _LIB
    if _LIB is None:
        from rails_tpu_torch import _build

        lib = _build.load_host()
        lib.rails_mm_read_header.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _i64p, _i64p]
        lib.rails_mm_read_header.restype = ctypes.c_int
        lib.rails_mm_read_coo.argtypes = [
            ctypes.c_char_p, _i64p, _i64p, _f64p, ctypes.c_int64]
        lib.rails_mm_read_coo.restype = ctypes.c_int64
        lib.rails_splu_factor.argtypes = [ctypes.c_int64, _i64p, _i64p,
                                          _f64p]
        lib.rails_splu_factor.restype = ctypes.c_void_p
        lib.rails_splu_solve.argtypes = [ctypes.c_void_p, _f64p,
                                         ctypes.c_int64, ctypes.c_int]
        lib.rails_splu_solve.restype = ctypes.c_int
        lib.rails_splu_free.argtypes = [ctypes.c_void_p]
        lib.rails_splu_free.restype = None
        _LIB = lib
    return _LIB


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctype)


def read_matrix_market(path: str):
    """A coordinate MatrixMarket file (real, integer or pattern; general
    or symmetric) as scipy CSR, or None for a variant the reader declines
    (array format, complex, hermitian, skew-symmetric), which the caller
    reads with scipy."""
    lib = library()
    head = np.zeros(4, dtype=np.int64)   # rows, cols, nnz, symmetric
    rc = lib.rails_mm_read_header(
        str(path).encode(), *(_ptr(head[i:], _i64p) for i in range(4)))
    if rc != 0:
        return None
    rows, cols, n, symmetric = (int(v) for v in head)
    ii = np.empty(n, dtype=np.int64)
    jj = np.empty(n, dtype=np.int64)
    vv = np.empty(n, dtype=np.float64)
    got = lib.rails_mm_read_coo(str(path).encode(), _ptr(ii, _i64p),
                                _ptr(jj, _i64p), _ptr(vv, _f64p), n)
    if got != n:
        return None
    a = sp.coo_matrix((vv, (ii, jj)), shape=(rows, cols))
    if symmetric:
        a = a + (sp.triu(a, k=1) + sp.tril(a, k=-1)).T
    return a.tocsr()


class NativeSparseLU:
    """Serial sparse LU of a square scipy matrix (Gilbert-Peierls with
    partial pivoting); ``solve`` takes numpy arrays, ``trans=True``
    solves with the transpose."""

    def __init__(self, a):
        lib = library()
        csc = sp.csc_matrix(a)
        if csc.shape[0] != csc.shape[1]:
            raise ValueError(f"NativeSparseLU needs a square matrix, got "
                             f"{csc.shape}")
        self.n = csc.shape[0]
        indptr = np.ascontiguousarray(csc.indptr, dtype=np.int64)
        indices = np.ascontiguousarray(csc.indices, dtype=np.int64)
        data = np.ascontiguousarray(csc.data, dtype=np.float64)
        self._lib = lib
        self._handle = lib.rails_splu_factor(
            self.n, _ptr(indptr, _i64p), _ptr(indices, _i64p),
            _ptr(data, _f64p))
        if not self._handle:
            raise RuntimeError("native sparse LU factorization failed")

    def solve(self, b, trans: bool = False) -> np.ndarray:
        """x with A x = b (A' x = b with ``trans``), float64, of b's
        shape; b is (n,) or (n, ...)."""
        b = np.asarray(b, dtype=np.float64)
        cols = b.reshape(self.n, -1)
        # the C side solves contiguous columns in place, so in a copy: for
        # one column cols.T is already contiguous, and would be b itself
        out = np.array(cols.T, order="C", copy=True)
        rc = self._lib.rails_splu_solve(self._handle, _ptr(out, _f64p),
                                        cols.shape[1], 1 if trans else 0)
        if rc != 0:
            raise RuntimeError("native sparse LU solve failed")
        return out.T.reshape(b.shape)

    def __del__(self):
        if getattr(self, "_handle", None):
            self._lib.rails_splu_free(self._handle)
            self._handle = None
