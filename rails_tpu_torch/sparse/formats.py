"""Device sparse-matrix formats: the counterpart of the JAX package's
``sparse/formats.py``.

- **DIA (diagonal)**: offsets + dense diagonal data.  The PDE matrices the
  reference targets (2D Laplacian stencils, structured-grid Jacobians)
  have a handful of distinct diagonals; SpMM is a short sum of shifted
  multiply-adds with no gathers, bound by the bytes it moves.  On a CUDA
  tensor every apply goes to ``sparse/spmm.py::dia_spmm``
  (``csrc/dia_spmm.cu``).
- **ELL (padded row-wise)**: column indices + values padded to the
  largest row degree; y[i] = sum_l values[i, l] * x[indices[i, l]].
  Handles general sparsity: the Schur path's A12, A21 and A22.  On a CUDA
  tensor every apply goes to ``sparse/ell_spmm.py::ell_spmm``
  (``csrc/ell_spmm.cu``).
- **HYB**: the densely occupied diagonals as DIA plus a skinny ELL
  remainder; an apply is one launch of each kernel.

``sparse_from_scipy(fmt='auto')`` picks the format by the JAX package's
rule and builds the same payloads (indices, values, offsets, data).  The
JAX package's windowed-ELL payload (``WindowedEll``: window starts and
window-local indices for the TPU's DMA) has no counterpart: the CUDA
kernel reads the plain ``indices``/``values``.  ``wide_s=True`` adds the
dense-window payload for wide multivectors to an ELL matrix
(``sparse/wide_spmm.py``, ``csrc/wide_spmm.cu``).  Host-side analysis
uses scipy.sparse.

``matmat2`` is the error-free apply of the refined driver: (hi, lo) with
hi + lo = A x up to O(eps^2), every product by ``two_prod`` and every
accumulation by ``two_sum`` (plain tensor operations, as in the JAX
package).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.sparse.ell_spmm import ell_spmm, ell_spmm_reference
from rails_tpu_torch.sparse.spmm import dia_spmm, dia_spmm_reference
from rails_tpu_torch.sparse.tiling import TILE_ROWS, tile_windows
from rails_tpu_torch.sparse.wide_spmm import WideWindow, build_wide_window
from rails_tpu_torch.utils.compensated import two_prod, two_sum
from rails_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = [
    "DiaMatrix",
    "EllMatrix",
    "HybMatrix",
    "SparseOperator",
    "ell_arrays_from_scipy",
    "payload_to_scipy",
    "sparse_from_dense",
    "sparse_from_scipy",
    "sparse_from_csr",
]


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
        return dia_spmm_reference(self, x)

    def matmat2(self, x: torch.Tensor):
        """Error-free A @ x: (hi, lo) with A x = hi + lo up to O(eps^2)."""
        m, n = self.shape
        hi = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        lo = torch.zeros_like(hi)
        tail = (1,) * (x.ndim - 1)
        for idx, off in enumerate(self.offsets):
            a, b = max(0, -off), min(m, n - off)
            if b <= a:
                continue
            p, e = two_prod(self.data[idx, a:b].reshape((b - a,) + tail),
                            x[a + off:b + off])
            s, e2 = two_sum(hi[a:b], p)
            hi[a:b] = s
            lo[a:b] += e + e2
        return hi, lo

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


@dataclasses.dataclass
class EllMatrix:
    """Padded row-wise format: y[i] = sum_l values[i, l] * x[indices[i, l]].
    Padding slots have values == 0 and *row-local* indices (the row's own
    first column; an empty row's clamped row id), as the JAX package
    builds them.  Every index lies in [0, n): checked here, once, so the
    kernel gathers without a bounds test.  With that check the windows
    of its row tiles are taken: ``tiles`` (T, 2) int32 on the payload's
    device, for each ``TILE_ROWS`` rows the smallest and largest index
    (the rows of x the tile reads; the kernel stages them in shared
    memory), and ``window_rows`` their widths on the host (the kernel's
    plan, ``sparse/ell_spmm.py::ell_plan``)."""

    TILE_ROWS = TILE_ROWS

    indices: torch.Tensor            # (m, L) int32
    values: torch.Tensor             # (m, L)
    shape: Tuple[int, int]
    # dense-window payload for wide multivectors (sparse/wide_spmm.py),
    # built on request (sparse_from_scipy(..., wide_s=True)); bfloat16
    # planes whatever the values' dtype
    wide: Optional[WideWindow] = None
    tiles: torch.Tensor = dataclasses.field(init=False, repr=False,
                                            compare=False)
    window_rows: np.ndarray = dataclasses.field(init=False, repr=False,
                                                compare=False)

    def __post_init__(self):
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        m, n = self.shape
        if self.indices.dtype != torch.int32:
            raise TypeError(f"ELL indices must be int32, got "
                            f"{self.indices.dtype}")
        if self.indices.ndim != 2 or self.indices.shape[0] != m \
                or self.values.shape != self.indices.shape:
            raise ValueError(
                f"ELL indices {tuple(self.indices.shape)} and values "
                f"{tuple(self.values.shape)} do not match shape {self.shape}")
        if self.values.device != self.indices.device:
            raise ValueError("ELL indices and values on different devices")
        self.tiles = tile_windows(self.indices, self.TILE_ROWS)
        win = self.tiles.cpu().numpy()     # the one host read
        self.window_rows = (win[:, 1].astype(np.int64) - win[:, 0] + 1)
        if n > 0 and self.indices.numel():
            lo, hi = int(win[:, 0].min()), int(win[:, 1].max())
            if lo < 0 or hi >= n:
                raise ValueError(f"ELL indices span [{lo}, {hi}], outside "
                                 f"[0, {n})")

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        """The plain PyTorch product (``ell_spmm_reference``)."""
        return ell_spmm_reference(self, x)

    def matmat2(self, x: torch.Tensor):
        """Error-free A @ x -> (hi, lo), slot by slot."""
        m = self.shape[0]
        hi = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                         device=x.device)
        lo = torch.zeros_like(hi)
        if self.shape[1] == 0:
            return hi, lo
        vshape = (m,) + (1,) * (x.ndim - 1)
        for l in range(self.indices.shape[1]):
            p, e = two_prod(self.values[:, l].reshape(vshape),
                            x.index_select(0, self.indices[:, l]))
            hi, e2 = two_sum(hi, p)
            lo = lo + e + e2
        return hi, lo

    def astype(self, dtype) -> "EllMatrix":
        if self.values.dtype == dtype:
            return self
        return EllMatrix(self.indices, self.values.to(dtype), self.shape,
                         self.wide)

    def to(self, device) -> "EllMatrix":
        dev = resolve_device(device)
        if self.values.device == dev:
            return self
        return EllMatrix(self.indices.to(dev), self.values.to(dev),
                         self.shape,
                         None if self.wide is None else self.wide.to(dev))


@dataclasses.dataclass
class HybMatrix:
    """Hybrid DIA + ELL split: the densely occupied diagonals ride the DIA
    kernel, the stray off-stencil entries a skinny ELL remainder."""

    dia: DiaMatrix
    ell: EllMatrix
    shape: Tuple[int, int]

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        return self.dia.matmat(x) + self.ell.matmat(x)

    def matmat2(self, x: torch.Tensor):
        h1, l1 = self.dia.matmat2(x)
        h2, l2 = self.ell.matmat2(x)
        hi, e = two_sum(h1, h2)
        return hi, l1 + l2 + e

    def astype(self, dtype) -> "HybMatrix":
        dia = self.dia.astype(dtype)
        ell = self.ell.astype(dtype)
        if dia is self.dia and ell is self.ell:
            return self
        return HybMatrix(dia, ell, self.shape)

    def to(self, device) -> "HybMatrix":
        dia = self.dia.to(device)
        ell = self.ell.to(device)
        if dia is self.dia and ell is self.ell:
            return self
        return HybMatrix(dia, ell, self.shape)


class SparseOperator(LinearOperator):
    """LinearOperator over a DIA, ELL or HYB payload, with a transposed
    payload for rmatmat (built host-side at construction; None when
    symmetric)."""

    def __init__(self, fwd, bwd, *, is_symmetric=False, is_spd=False,
                 is_hurwitz=False, nnz: int = 0):
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
        if isinstance(self.fwd, DiaMatrix):
            return "dia"
        return "hyb" if isinstance(self.fwd, HybMatrix) else "ell"

    def _values(self) -> torch.Tensor:
        p = self.fwd.dia if isinstance(self.fwd, HybMatrix) else self.fwd
        return p.data if isinstance(p, DiaMatrix) else p.values

    @property
    def payload_dtype(self):
        return self._values().dtype

    @property
    def payload_device(self):
        return self._values().device

    @staticmethod
    def _apply(payload, x: torch.Tensor) -> torch.Tensor:
        """On a CUDA tensor each payload goes to its kernel: DIA to
        ``dia_spmm``, ELL to ``ell_spmm``, HYB to one launch of each."""
        if x.ndim == 1:
            return SparseOperator._apply(payload, x[:, None])[:, 0]
        x = x.contiguous()
        if isinstance(payload, DiaMatrix):
            return dia_spmm(payload, x)
        if isinstance(payload, EllMatrix):
            return ell_spmm(payload, x)
        if isinstance(payload, HybMatrix):
            return dia_spmm(payload.dia, x) + ell_spmm(payload.ell, x)
        raise TypeError(type(payload))

    def matmat(self, x):
        return self._apply(self.fwd, x)

    def rmatmat(self, x):
        return self._apply(self.fwd if self.bwd is None else self.bwd, x)

    def matmat2(self, x):
        """Error-free apply (hi, lo) for the refined driver (plain tensor
        operations on any device)."""
        return self.fwd.matmat2(x)

    def to_dense(self, dtype=None, device=None):
        v = self._values()
        return self.fwd.matmat(torch.eye(self.shape[1], dtype=v.dtype,
                                         device=v.device))

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


def payload_to_scipy(p) -> sp.csr_matrix:
    """Host-side inverse of sparse_from_scipy for a device payload
    (diagnostics: condest checks, test oracles)."""
    if isinstance(p, DiaMatrix):
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
            (np.concatenate(vals),
             (np.concatenate(rows), np.concatenate(cols))),
            shape=p.shape).tocsr()
    if isinstance(p, EllMatrix):
        ind = p.indices.detach().cpu().numpy()
        val = p.values.detach().cpu().numpy()
        m, ell_l = ind.shape
        rows = np.repeat(np.arange(m), ell_l)
        out = sp.coo_matrix((val.ravel(), (rows, ind.ravel())),
                            shape=p.shape).tocsr()
        out.eliminate_zeros()
        return out
    if isinstance(p, HybMatrix):
        return (payload_to_scipy(p.dia) + payload_to_scipy(p.ell)).tocsr()
    raise TypeError(type(p))


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


def ell_arrays_from_scipy(a: sp.spmatrix):
    """Raw padded row-ELL (indices int32, values float64) of a scipy
    matrix, as the JAX package builds them: padding slots take the row's
    own first column index, an empty row its row id clamped to n - 1
    (value 0 either way)."""
    csr = a.tocsr()
    m, n = csr.shape
    deg = np.diff(csr.indptr)
    ell_l = max(int(deg.max()), 1) if m else 1
    # empty rows pad with the clamped row id; the clamp keeps the index
    # below n for the wide-short A21 of a Schur split
    pad = np.minimum(np.arange(m, dtype=np.int64), max(n - 1, 0))
    if csr.nnz:
        first = np.where(deg > 0, csr.indices[np.minimum(
            csr.indptr[:-1], csr.nnz - 1)], pad)
    else:
        first = pad
    indices = np.repeat(first[:, None], ell_l, axis=1).astype(np.int32)
    values = np.zeros((m, ell_l), dtype=np.float64)
    if csr.nnz:
        rows = np.repeat(np.arange(m), deg)
        slots = np.arange(csr.nnz) - np.repeat(csr.indptr[:-1], deg)
        indices[rows, slots] = csr.indices
        values[rows, slots] = csr.data
    return indices, values


def _ell_from_scipy(a: sp.spmatrix, dtype, device, wide_s: bool = False,
                    wide_passes: int = 3) -> EllMatrix:
    indices, values = ell_arrays_from_scipy(a)
    ell = EllMatrix(as_tensor(indices, device),
                    as_tensor(values, device, dtype), a.shape)
    if wide_s:
        ell.wide = build_wide_window(ell, passes=wide_passes)
    return ell


def _hyb_split(a: sp.csr_matrix, dia_fill_limit: float,
               dia_max_offsets: int):
    """Pick the diagonals worth storing densely: greedily keep the most
    occupied ones while the DIA fill (one m-vector per kept diagonal)
    stays under ``dia_fill_limit`` x the nnz they cover.  Returns
    (dia_part, ell_part) as scipy matrices, or None if the split isn't
    worthwhile (covers < 50% of nnz or the remainder isn't small)."""
    coo = a.tocoo()
    m = a.shape[0]
    offs = coo.col - coo.row
    uniq, counts = np.unique(offs, return_counts=True)
    order = np.argsort(-counts)
    kept = []
    covered = 0
    for j in order[:dia_max_offsets]:
        # marginal test: a diagonal stored densely costs m slots; one
        # whose own fill m/count exceeds the limit belongs in the ELL
        # remainder (counts sorted desc, so stop at the first such)
        if m > dia_fill_limit * counts[j]:
            break
        if (len(kept) + 1) * m > dia_fill_limit * (covered + counts[j]):
            break
        kept.append(uniq[j])
        covered += counts[j]
    if not kept or covered < 0.5 * max(coo.nnz, 1):
        return None
    kept_mask = np.isin(offs, kept)
    if (~kept_mask).sum() == 0:
        return None  # pure DIA, no remainder
    dia_part = sp.coo_matrix(
        (coo.data[kept_mask], (coo.row[kept_mask], coo.col[kept_mask])),
        shape=a.shape)
    ell_part = sp.coo_matrix(
        (coo.data[~kept_mask], (coo.row[~kept_mask], coo.col[~kept_mask])),
        shape=a.shape).tocsr()
    # remainder must be skinny, or ELL padding defeats the purpose
    if np.diff(ell_part.indptr).max() > max(
            8, 2 * coo.nnz // max(m, 1)):
        return None
    return dia_part.tocsr(), ell_part


def _hyb_from_scipy(a: sp.csr_matrix, dtype, device, dia_fill_limit: float,
                    dia_max_offsets: int) -> Optional[HybMatrix]:
    split = _hyb_split(a, dia_fill_limit, dia_max_offsets)
    if split is None:
        return None
    dia_part, ell_part = split
    return HybMatrix(_dia_from_scipy(dia_part, dtype, device),
                     _ell_from_scipy(ell_part, dtype, device), a.shape)


def sparse_from_scipy(a: sp.spmatrix, *, fmt: str = "auto",
                      dia_max_offsets: int = 96, dia_fill_limit: float = 8.0,
                      dtype=None, device=None, wide_s: bool = False,
                      wide_passes: int = 3, **tags) -> SparseOperator:
    """Build a SparseOperator on ``device`` (default ``cuda``) from a
    scipy sparse matrix.

    fmt: 'auto' | 'dia' | 'hyb' | 'ell'.  'auto' picks DIA when the
    matrix has at most ``dia_max_offsets`` distinct diagonals *and* the
    DIA fill (d*m values stored for nnz actual entries) stays under
    ``dia_fill_limit``; else HYB when a subset of diagonals covers most
    of the nnz and leaves a skinny remainder; else ELL - the JAX
    package's rule.  A HYB whose transpose does not split takes an ELL
    transpose payload.

    ``wide_s=True`` also builds the dense-window payload for wide
    multivector applies (``sparse/wide_spmm.py``) on each ELL payload that
    has a window, with ``wide_passes`` 3 (~1.5e-5 relative) or 6 (float32
    grade); it costs w/L stored values per nonzero, so it is opt-in.  A
    matrix that resolves to DIA or HYB warns and gets none, and neither
    does an ELL transpose payload of a HYB matrix.
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
        fmt = "dia" if dia_ok else "hyb"
    if fmt not in ("dia", "hyb", "ell"):
        raise ValueError(f"unknown sparse format {fmt!r}")
    sym = bool(tags.get("is_symmetric", False))
    if not sym and nnz and m == n and (a != a.T).nnz == 0:
        sym = True
        tags["is_symmetric"] = True
    fwd = bwd = None
    if fmt == "dia":
        fwd = _dia_from_scipy(a, dtype, dev)
        bwd = None if sym else _dia_from_scipy(a.T.tocsr(), dtype, dev)
    elif fmt == "hyb":
        fwd = _hyb_from_scipy(a, dtype, dev, dia_fill_limit,
                              dia_max_offsets)
        if fwd is None:
            fmt = "ell"
        elif not sym:
            at = a.T.tocsr()
            bwd = _hyb_from_scipy(at, dtype, dev, dia_fill_limit,
                                  dia_max_offsets)
            if bwd is None:  # the transpose split can fail on its own
                bwd = _ell_from_scipy(at, dtype, dev)
    if wide_s and fmt != "ell":
        warnings.warn(
            f"wide_s=True only applies to the ELL format; this matrix "
            f"resolved to fmt={fmt!r} and no dense-window payload was "
            f"built - pass fmt='ell' to force it", stacklevel=2)
    if fmt == "ell":
        fwd = _ell_from_scipy(a, dtype, dev, wide_s, wide_passes)
        bwd = None if sym else _ell_from_scipy(a.T.tocsr(), dtype, dev,
                                               wide_s, wide_passes)
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
