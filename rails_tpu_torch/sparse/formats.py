"""Device sparse-matrix formats: the counterpart of the JAX package's
``sparse/formats.py``, DIA part.

- **DIA (diagonal)**: offsets + dense diagonal data.  The PDE matrices the
  reference targets (2D Laplacian stencils, structured-grid Jacobians)
  have a handful of distinct diagonals; SpMM is a short sum of shifted
  multiply-adds with no gathers, bound by the bytes it moves.  On a CUDA
  tensor every apply goes to the hand-written kernel
  (``sparse/spmm.py::dia_spmm``, ``csrc/dia_spmm.cu``).

ELL and HYB (the JAX package's ``EllMatrix``/``HybMatrix`` and their
windowed-ELL kernels) are not ported yet: ``sparse_from_scipy`` raises
``NotImplementedError`` where the JAX package would pick one of them
(ROADMAP, the ELL/HYB slice).  Host-side analysis uses scipy.sparse.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = [
    "DiaMatrix",
    "SparseOperator",
    "payload_to_scipy",
    "sparse_from_dense",
    "sparse_from_scipy",
    "sparse_from_csr",
]

_ELL_TODO = ("the ELL and HYB formats are not ported to rails_tpu_torch "
             "yet (ROADMAP: the ELL/HYB slice); ")


@dataclasses.dataclass
class DiaMatrix:
    """data[d, i] multiplies x[i + offsets[d]] into y[i]; terms with
    i + offsets[d] outside [0, n) are dropped.

    ``offsets`` is a tuple of Python ints (the plain version's slices);
    ``offsets_t`` is the same offsets as an int32 tensor on the data's
    device, which the CUDA kernel reads."""

    data: torch.Tensor               # (d, m)
    offsets: Tuple[int, ...]
    shape: Tuple[int, int]
    offsets_t: torch.Tensor = dataclasses.field(init=False, repr=False)

    def __post_init__(self):
        self.offsets = tuple(int(o) for o in self.offsets)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        if tuple(self.data.shape) != (len(self.offsets), self.shape[0]):
            raise ValueError(
                f"DIA data shape {tuple(self.data.shape)} != "
                f"({len(self.offsets)}, {self.shape[0]})")
        self.offsets_t = torch.tensor(self.offsets, dtype=torch.int32,
                                      device=self.data.device)

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch product (``dia_spmm_reference``)."""
        from rails_tpu_torch.sparse.spmm import dia_spmm_reference

        return dia_spmm_reference(self, x)

    def transpose(self) -> "DiaMatrix":
        """A'[j, i]: diagonal o of A becomes diagonal -o of A', with data
        re-indexed so data'[-o][i] = data[o][i - o] (square A)."""
        m, n = self.shape
        rolled = [torch.roll(self.data[idx], off)
                  for idx, off in enumerate(self.offsets)]
        return DiaMatrix(torch.stack(rolled),
                         tuple(-o for o in self.offsets), (n, m))

    def astype(self, dtype) -> "DiaMatrix":
        if self.data.dtype == dtype:
            return self
        return DiaMatrix(self.data.to(dtype), self.offsets, self.shape)

    def to(self, device) -> "DiaMatrix":
        dev = resolve_device(device)
        if self.data.device == dev:
            return self
        return DiaMatrix(self.data.to(dev), self.offsets, self.shape)


class SparseOperator(LinearOperator):
    """LinearOperator over a DIA payload, with a transposed payload for
    rmatmat (built host-side at construction; None when symmetric)."""

    def __init__(self, fwd: DiaMatrix, bwd: Optional[DiaMatrix], *,
                 is_symmetric=False, is_spd=False, is_hurwitz=False,
                 nnz: int = 0):
        self.fwd = fwd
        self.bwd = bwd
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def format(self) -> str:
        return "dia"

    @property
    def payload_dtype(self):
        return self.fwd.data.dtype

    @property
    def payload_device(self):
        return self.fwd.data.device

    @staticmethod
    def _apply(payload: DiaMatrix, x: torch.Tensor) -> torch.Tensor:
        from rails_tpu_torch.sparse.spmm import dia_spmm

        if x.ndim == 1:
            return dia_spmm(payload, x[:, None].contiguous())[:, 0]
        return dia_spmm(payload, x.contiguous())

    def matmat(self, x):
        return self._apply(self.fwd, x)

    def rmatmat(self, x):
        return self._apply(self.fwd if self.bwd is None else self.bwd, x)

    def to_dense(self, dtype=None, device=None):
        return self.fwd.matmat(torch.eye(
            self.shape[1], dtype=self.fwd.data.dtype,
            device=self.fwd.data.device))

    def _like(self, fwd, bwd):
        return SparseOperator(fwd, bwd, is_symmetric=self.is_symmetric,
                              is_spd=self.is_spd, is_hurwitz=self.is_hurwitz,
                              nnz=self.nnz)

    def astype(self, dtype):
        fwd = self.fwd.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if fwd is self.fwd and bwd is self.bwd:
            return self
        return self._like(fwd, bwd)

    def to(self, device):
        fwd = self.fwd.to(device)
        bwd = None if self.bwd is None else self.bwd.to(device)
        if fwd is self.fwd and bwd is self.bwd:
            return self
        return self._like(fwd, bwd)


def payload_to_scipy(p: DiaMatrix) -> sp.csr_matrix:
    """Host-side inverse of sparse_from_scipy for a DIA payload
    (diagnostics: condest checks, test oracles)."""
    if not isinstance(p, DiaMatrix):
        raise TypeError(type(p))
    m, n = p.shape
    data = p.data.detach().cpu().numpy()
    rows, cols, vals = [], [], []
    for k, off in enumerate(p.offsets):
        lo, hi = max(0, -off), min(m, n - off)
        if hi <= lo:
            continue
        i = np.arange(lo, hi)
        rows.append(i)
        cols.append(i + off)
        vals.append(data[k, lo:hi])
    if not vals:
        return sp.csr_matrix(p.shape, dtype=data.dtype)
    return sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=p.shape).tocsr()


def _dia_from_scipy(a: sp.spmatrix, dtype, device) -> DiaMatrix:
    m, n = a.shape
    adia = a.todia()
    offsets = tuple(int(o) for o in adia.offsets)
    # scipy dia: data[k, j] is the value at column j on diagonal k, i.e.
    # entry (j - offset, j).  Our convention: data[k, i] multiplies
    # x[i + offset] into y[i], i.e. entry (i, i + offset) -> data[k, i] =
    # scipy_data[k, i + offset].
    data = np.zeros((len(offsets), m), dtype=np.float64)
    sd = adia.data
    for k, off in enumerate(offsets):
        lo, hi = max(0, -off), min(m, n - off)
        if hi > lo:
            data[k, lo:hi] = sd[k, lo + off:hi + off]
    return DiaMatrix(as_tensor(data, device, dtype), offsets, (m, n))


def sparse_from_scipy(a: sp.spmatrix, *, fmt: str = "auto",
                      dia_max_offsets: int = 96, dia_fill_limit: float = 8.0,
                      dtype=None, device=None, **tags) -> SparseOperator:
    """Build a SparseOperator on ``device`` (default ``cuda``) from a
    scipy sparse matrix.

    fmt: 'auto' | 'dia'.  'auto' picks DIA when the matrix has at most
    ``dia_max_offsets`` distinct diagonals *and* the DIA fill (d*m values
    stored for nnz actual entries) stays under ``dia_fill_limit`` - the
    JAX package's rule.  Where that rule would fall back to HYB or ELL,
    and for fmt='hyb'/'ell', this raises ``NotImplementedError``: those
    formats have no kernel in the port yet, and a quiet plain apply on
    the card would hide that.
    """
    if dtype is None:
        dtype = torch.get_default_dtype()
    dev = resolve_device(device)
    a = a.tocsr()
    m, n = a.shape
    nnz = int(a.nnz)
    if fmt == "auto":
        coo = a.tocoo()
        n_offsets = len(np.unique(coo.col - coo.row))
        dia_ok = (n_offsets <= dia_max_offsets
                  and n_offsets * m <= dia_fill_limit * max(nnz, 1))
        if not dia_ok:
            raise NotImplementedError(
                _ELL_TODO + f"this matrix has {n_offsets} distinct "
                f"diagonals (fill {n_offsets * m / max(nnz, 1):.1f}x), so "
                f"'auto' would pick HYB or ELL; pass fmt='dia' to force DIA")
        fmt = "dia"
    if fmt in ("hyb", "ell"):
        raise NotImplementedError(_ELL_TODO + f"fmt={fmt!r} was asked for")
    if fmt != "dia":
        raise ValueError(f"unknown sparse format {fmt!r}")
    sym = bool(tags.get("is_symmetric", False))
    if not sym and nnz and m == n and (a != a.T).nnz == 0:
        sym = True
        tags["is_symmetric"] = True
    fwd = _dia_from_scipy(a, dtype, dev)
    bwd = None if sym else _dia_from_scipy(a.T.tocsr(), dtype, dev)
    return SparseOperator(fwd, bwd, nnz=nnz, **tags)


def sparse_from_dense(a, **kw) -> SparseOperator:
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    return sparse_from_scipy(sp.csr_matrix(np.asarray(a)), **kw)


def sparse_from_csr(indptr, indices, data, shape=None, **kw) -> SparseOperator:
    """From raw CSR arrays."""
    indptr = np.asarray(indptr)
    if shape is None:
        m = len(indptr) - 1
        shape = (m, m)
    csr = sp.csr_matrix((np.asarray(data), np.asarray(indices), indptr),
                        shape=shape)
    return sparse_from_scipy(csr, **kw)
