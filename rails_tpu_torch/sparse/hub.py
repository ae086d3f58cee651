"""Hub splitting for power-law sparsity - the counterpart of the JAX
package's ``sparse/hub.py``.

The ELL payload pads every row to the widest one, so a matrix with a few
rows or columns of very high degree (hubs) costs the hub degree in every
row: about 8 GB at the JAX bench's hub matrix (m = 2^19, 64 hubs of
degree 4096).  ``hub_operator`` splits A by a degree threshold into

- **hub rows** (degree above the threshold, at most ``max_hubs``),
  stored dense as D = A[H, :] (h, m): their apply is one (h, m) @ (m, s)
  GEMM (cuBLAS on the card, at full precision: the JAX package records a
  2e-3 error when a reduced-precision default slipped into this product),
  scattered back by one ``index_add_`` onto the rows H;
- **hub columns** (the same set, in the other rows), remapped onto the
  compacted index space [0, h) and stored as an (m, h) ELL;
- **the remainder** (other rows by other columns), the low-degree bulk,
  as an ELL.

Both ELL parts go through ``ell_spmm``, so through the ELL kernel
(``csrc/ell_spmm.cu``) on the card: two launches per apply.  The JAX
package's windowed payload of the bulk (``op.rest.well``) has no
counterpart: the kernel reads the plain indices and values.

The split pays on matrices with local structure plus superhubs
(geographic networks with shortcuts, meshes with global constraint rows
or columns, observation or coupling rows).  For a pure Barabasi-Albert
graph the share of edge ends that any small hub set covers is about
sqrt(h/m) (``hub_coverage``): the remainder keeps most of the nonzeros.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.sparse.ell_spmm import ell_spmm
from rails_tpu_torch.sparse.formats import EllMatrix, _ell_from_scipy
from rails_tpu_torch.utils.device import as_tensor, resolve_device
from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["HubSplitOperator", "hub_operator", "hub_coverage"]

_DENSE_BYTES_CAP = 1 << 30    # refuse silently huge dense hub blocks


def hub_coverage(a: sp.spmatrix, n_hubs: int) -> float:
    """Fraction of nnz incident to the ``n_hubs`` highest-degree
    rows/columns - the feasibility number (for pure Barabasi-Albert this
    is ~sqrt(n_hubs/m): the split cannot pay)."""
    a = a.tocsr()
    deg = np.asarray(np.diff(a.indptr)) + np.asarray(
        np.diff(a.tocsc().indptr))
    hubs = np.argsort(-deg)[:n_hubs]
    mask = np.zeros(a.shape[0], bool)
    mask[hubs] = True
    coo = a.tocoo()
    covered = mask[coo.row] | mask[coo.col]
    return float(covered.sum() / max(coo.nnz, 1))


class HubSplitOperator(LinearOperator):
    """y = rest @ x + hubcol @ x[H] + e_H (D @ x).

    ``rest`` and ``hubcol`` are ``EllMatrix`` payloads (the latter over
    the compacted hub space, None when no other row touches a hub
    column), ``hub_idx`` the (h,) int64 hub indices, ``d`` the (h, n)
    dense hub rows (None without hubs).  A symmetric matrix reuses its
    split for rmatmat; a nonsymmetric one carries the transpose's split
    as ``bwd``."""

    def __init__(self, rest: EllMatrix, hubcol: Optional[EllMatrix],
                 hub_idx: torch.Tensor, d: Optional[torch.Tensor],
                 shape: Tuple[int, int], *,
                 bwd: Optional["HubSplitOperator"] = None,
                 is_symmetric=False, is_hurwitz=False, nnz: int = 0):
        self.rest = rest
        self.hubcol = hubcol
        self.hub_idx = hub_idx
        self.d = d
        self._shape = (int(shape[0]), int(shape[1]))
        self.bwd = bwd
        self.is_symmetric = is_symmetric
        self.is_spd = False
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self._shape

    @property
    def payload_dtype(self):
        return self.rest.values.dtype

    @property
    def payload_device(self):
        return self.rest.values.device

    def _apply(self, x: torch.Tensor) -> torch.Tensor:
        """On a CUDA tensor both ELL parts launch the ELL kernel and D @ x
        is one cuBLAS GEMM with TF32 off."""
        if x.ndim == 1:
            return self._apply(x[:, None])[:, 0]
        x = x.contiguous()
        y = ell_spmm(self.rest, x)
        if self.hubcol is not None:
            y = y + ell_spmm(self.hubcol, x.index_select(0, self.hub_idx))
        if self.d is not None:
            with full_precision():
                y.index_add_(0, self.hub_idx, self.d @ x)
        return y

    def matmat(self, x):
        return self._apply(x)

    def rmatmat(self, x):
        if self.bwd is None:
            return self._apply(x)   # symmetric
        return self.bwd.matmat(x)

    def _like(self, rest, hubcol, hub_idx, d, bwd):
        return HubSplitOperator(rest, hubcol, hub_idx, d, self._shape,
                                bwd=bwd, is_symmetric=self.is_symmetric,
                                is_hurwitz=self.is_hurwitz, nnz=self.nnz)

    def astype(self, dtype):
        if self.rest.values.dtype == dtype:
            return self
        return self._like(
            self.rest.astype(dtype),
            None if self.hubcol is None else self.hubcol.astype(dtype),
            self.hub_idx, None if self.d is None else self.d.to(dtype),
            None if self.bwd is None else self.bwd.astype(dtype))

    def to(self, device):
        dev = resolve_device(device)
        if self.rest.values.device == dev:
            return self
        return self._like(
            self.rest.to(dev),
            None if self.hubcol is None else self.hubcol.to(dev),
            self.hub_idx.to(dev), None if self.d is None else self.d.to(dev),
            None if self.bwd is None else self.bwd.to(dev))

    def to_dense(self, dtype=None, device=None):
        return self.matmat(torch.eye(
            self._shape[1], dtype=dtype or self.payload_dtype,
            device=device or self.payload_device))


def _split_one(a: sp.csr_matrix, hubs: np.ndarray, dtype, device,
               dense_cap: int):
    """One direction of the split; returns (rest, hubcol, hub_idx, d) or
    None when the dense block would exceed the cap."""
    m, n = a.shape
    h = len(hubs)
    itemsize = torch.empty((), dtype=dtype).element_size()
    if h and h * n * itemsize > dense_cap:
        return None
    hub_row = np.zeros(m, bool)
    hub_row[hubs] = True
    hub_col = np.zeros(n, bool)
    hub_col[hubs] = True
    coo = a.tocoo()
    in_d = hub_row[coo.row]
    in_hc = hub_col[coo.col] & ~in_d
    in_rest = ~in_d & ~in_hc

    def part(mask, shape, cols=None):
        c = coo.col[mask] if cols is None else cols
        return sp.coo_matrix(
            (coo.data[mask], (coo.row[mask], c)), shape=shape).tocsr()

    rest = _ell_from_scipy(part(in_rest, (m, n)), dtype, device)
    hubcol = None
    if in_hc.sum():
        # compact hub columns onto [0, h)
        remap = np.zeros(n, np.int64)
        remap[hubs] = np.arange(h)
        hubcol = _ell_from_scipy(
            part(in_hc, (m, h), remap[coo.col[in_hc]]), dtype, device)
    d = None
    if h:
        d = as_tensor(part(in_d, (m, n))[hubs].toarray(), device, dtype)
    return rest, hubcol, as_tensor(hubs.astype(np.int64), device), d


def hub_operator(a: sp.spmatrix, *, max_hubs: int = 256,
                 degree_factor: float = 8.0, dtype=None, device=None,
                 dense_cap: int = _DENSE_BYTES_CAP,
                 **tags) -> HubSplitOperator:
    """Build the hub-split operator (module docstring) on ``device``
    (default ``cuda``) at ``dtype`` (default
    ``torch.get_default_dtype()``).

    Hubs = rows/columns whose (in + out) degree exceeds
    ``degree_factor`` times the median degree, capped at ``max_hubs``
    (highest degree first), sorted.  A factor of the median separates
    genuine superhubs from the bulk however many there are, where a
    quantile rule can cut mid-cluster and leave hub rows in the remainder
    (each of which pads the remainder's ELL to its degree).  Check
    ``hub_coverage`` for the share of nonzeros the hubs take.
    """
    if dtype is None:
        dtype = torch.get_default_dtype()
    dev = resolve_device(device)
    a = a.tocsr()
    m, n = a.shape
    if m != n:
        raise ValueError("hub_operator expects a square matrix")
    deg = np.asarray(np.diff(a.indptr)) + np.asarray(
        np.diff(a.tocsc().indptr))
    thresh = degree_factor * max(np.median(deg), 1.0)
    hubs = np.flatnonzero(deg > thresh)
    if len(hubs) > max_hubs:
        hubs = hubs[np.argsort(-deg[hubs])[:max_hubs]]
    hubs = np.sort(hubs)
    fwd = _split_one(a, hubs, dtype, dev, dense_cap)
    if fwd is None:
        raise ValueError(
            f"dense hub block {len(hubs)} x {n} exceeds dense_cap="
            f"{dense_cap}; lower max_hubs or raise the cap")
    sym = bool(tags.pop("is_symmetric", False))
    if not sym and a.nnz and (a != a.T).nnz == 0:
        sym = True
    bwd = None
    if not sym:
        bwd_parts = _split_one(a.T.tocsr(), hubs, dtype, dev, dense_cap)
        if bwd_parts is None:
            raise ValueError("transpose dense hub block exceeds cap")
        bwd = HubSplitOperator(*bwd_parts, (n, m), is_symmetric=False)
    return HubSplitOperator(*fwd, (m, n), bwd=bwd, is_symmetric=sym,
                            nnz=int(a.nnz), **tags)
