"""Row-sharded ELL SpMM with an explicit halo exchange - the counterpart
of the JAX package's ``parallel/halo_ell.py``.

It extends the halo pattern of ``halo_spmm.py`` to ELL payloads: the
reference's Epetra SpMV on arbitrary sparsity under a row distribution,
for every matrix whose per-shard remote references stay within the
adjacent slabs (banded sparsity, and general sparsity after RCM).

- ``build_halo_ell`` rebases every column index of shard r into the
  *extended local* coordinates [0, halo_lo + m_loc + halo_hi), where
  ``halo_lo``/``halo_hi`` are the largest remote spans over all shards
  (uniform over the shards, as in the JAX package), and keeps each
  shard's rows as a plain ``EllMatrix`` of shape (m_loc, ext) on the
  shard's device.
- An apply builds ``[halo_lo | x_loc | halo_hi]`` for each shard from
  its neighbours' rows (zeros beyond the boundary) and runs the ELL
  kernel (``sparse/ell_spmm.py``, ``csrc/ell_spmm.cu``) on it; on CPU
  tensors the kernel's plain version.
- On a multi-process mesh a process keeps its own shards' payloads, and
  the halos at its first and last shard come from the neighbouring
  processes (``halo_spmm.process_halos``), one exchange per apply,
  captured (NCCL) or a host step (gloo) in a compiled solve.

The JAX package's windowed payload (window starts, window-local indices,
``w_cap``, super-window group tables) and its 128-row slab rule serve the
TPU's DMA; the port has neither (ROADMAP rule "No TPU layout
constraints"), and no dense-window (``wide``) planes either, as the JAX
halo payload carries none.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.parallel.halo_spmm import process_halos
from rails_tpu_torch.parallel.mesh import Mesh
from rails_tpu_torch.sparse.ell_spmm import ell_spmm
from rails_tpu_torch.sparse.formats import EllMatrix

__all__ = ["HaloEll", "build_halo_ell", "halo_ell_spmm", "HaloEllOperator",
           "HaloHybOperator"]


@dataclasses.dataclass
class HaloEll:
    """Per-shard ELL payloads in extended-local coordinates: ``shards[i]``
    is (m_loc, halo_lo + m_loc + halo_hi) on ``mesh.devices[i]``, this
    process's shards only.  The halos are uniform over all shards;
    ``shape`` is the global (m, m)."""

    shards: List[EllMatrix]
    halo_lo: int
    halo_hi: int
    shape: Tuple[int, int]

    def astype(self, dtype) -> "HaloEll":
        if self.shards[0].values.dtype == dtype:
            return self
        return HaloEll([e.astype(dtype) for e in self.shards], self.halo_lo,
                       self.halo_hi, self.shape)


def build_halo_ell(ell: EllMatrix, mesh: Mesh) -> Optional[HaloEll]:
    """Host-side shard analysis.  Returns None when the decomposition
    does not qualify: non-square payload, rows not divisible by the
    mesh, or remote references reaching beyond the adjacent slabs."""
    m, n = ell.shape
    nd = mesh.size
    if m != n or m % nd:
        return None
    m_loc = m // nd
    indices = ell.indices.cpu().numpy()
    # largest remote spans over all shards; padding slots carry row-local
    # indices (formats.ell_arrays_from_scipy), so they never widen them
    halo_lo = halo_hi = 0
    for r0, r1 in mesh.row_slabs(m):
        blk = indices[r0:r1]
        halo_lo = max(halo_lo, r0 - int(blk.min()))
        halo_hi = max(halo_hi, int(blk.max()) - (r1 - 1))
    if halo_lo > m_loc or halo_hi > m_loc:
        return None  # needs rows beyond the adjacent slabs
    ext = halo_lo + m_loc + halo_hi
    shards = []
    for (r0, r1), dev in zip(mesh.local_slabs(m), mesh.devices):
        loc = torch.from_numpy(
            (indices[r0:r1] - (r0 - halo_lo)).astype(np.int32))
        shards.append(EllMatrix(loc.to(dev),
                                ell.values[r0:r1].to(dev, copy=True),
                                (m_loc, ext)))
    return HaloEll(shards, halo_lo, halo_hi, (m, n))


def halo_ell_spmm(p: HaloEll, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A @ x over the mesh with the explicit neighbour halo exchange (x
    this process's rows)."""
    if x.ndim == 1:
        return halo_ell_spmm(p, x[:, None], mesh)[:, 0]
    m, s = x.shape
    ext_lo, ext_hi = process_halos(x, p.halo_lo, p.halo_hi, mesh)
    slabs = mesh.shard_slabs(m)
    ys = []
    for i, ((r0, r1), dev, e) in enumerate(zip(slabs, mesh.devices,
                                               p.shards)):
        parts = []
        if p.halo_lo:
            if i == 0 and ext_lo is not None:
                parts.append(ext_lo)
            else:
                parts.append(x[r0 - p.halo_lo:r0] if r0 > 0 else torch.zeros(
                    (p.halo_lo, s), dtype=x.dtype, device=dev))
        parts.append(x[r0:r1])
        if p.halo_hi:
            if i == len(slabs) - 1 and ext_hi is not None:
                parts.append(ext_hi)
            else:
                parts.append(x[r1:r1 + p.halo_hi] if r1 < m else torch.zeros(
                    (p.halo_hi, s), dtype=x.dtype, device=dev))
        ys.append(ell_spmm(e, torch.cat([t.to(dev) for t in parts])))
    return torch.cat(ys)


class HaloEllOperator(LinearOperator):
    """LinearOperator running the row-sharded ELL SpMM.

    Built by ``shard_operator`` from a SparseOperator with ELL payloads
    when ``build_halo_ell`` accepts both directions."""

    def __init__(self, fwd: HaloEll, mesh: Mesh,
                 bwd: Optional[HaloEll] = None, *,
                 is_symmetric=False, is_spd=False, is_hurwitz=False,
                 nnz: int = 0):
        self.fwd = fwd
        self.bwd = bwd
        self.mesh = mesh
        self.is_symmetric = is_symmetric or bwd is None
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.fwd.shape

    @property
    def payload_dtype(self):
        return self.fwd.shards[0].values.dtype

    @property
    def payload_device(self):
        return self.mesh.device

    def astype(self, dtype):
        fwd = self.fwd.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if fwd is self.fwd and bwd is self.bwd:
            return self
        return HaloEllOperator(fwd, self.mesh, bwd,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd, is_hurwitz=self.is_hurwitz,
                               nnz=self.nnz)

    def matmat(self, x):
        return halo_ell_spmm(self.fwd, x, self.mesh)

    def rmatmat(self, x):
        if self.bwd is None:
            return self.matmat(x)
        return halo_ell_spmm(self.bwd, x, self.mesh)

    def to_dense(self, dtype=None, device=None):
        return self.matmat(torch.eye(self.shape[1], dtype=self.payload_dtype,
                                     device=self.mesh.device))


class HaloHybOperator(LinearOperator):
    """Row-sharded HYB apply: the dense diagonals through the DIA halo
    path (``halo_spmm.py``), the irregular remainder through the ELL halo
    path, each with its own exchange, summed.  ``rmat_op``, when set,
    computes the whole A'x (a transpose stored as one ELL payload rather
    than a HYB split); otherwise the transpose is the sum of the parts'
    rmatmat."""

    def __init__(self, dia_op, ell_op, *, rmat_op=None, is_symmetric=False,
                 is_spd=False, is_hurwitz=False, nnz: int = 0):
        self.dia_op = dia_op
        self.ell_op = ell_op
        self.rmat_op = rmat_op
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self.nnz = nnz

    @property
    def shape(self):
        return self.dia_op.shape

    @property
    def payload_dtype(self):
        return self.dia_op.payload_dtype

    @property
    def payload_device(self):
        return self.dia_op.payload_device

    def astype(self, dtype):
        dia = self.dia_op.astype(dtype)
        ell = self.ell_op.astype(dtype)
        rmat = None if self.rmat_op is None else self.rmat_op.astype(dtype)
        if dia is self.dia_op and ell is self.ell_op \
                and rmat is self.rmat_op:
            return self
        return HaloHybOperator(dia, ell, rmat_op=rmat,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd, is_hurwitz=self.is_hurwitz,
                               nnz=self.nnz)

    def matmat(self, x):
        return self.dia_op.matmat(x) + self.ell_op.matmat(x)

    def rmatmat(self, x):
        if self.rmat_op is not None:
            return self.rmat_op.matmat(x)
        return self.dia_op.rmatmat(x) + self.ell_op.rmatmat(x)

    def to_dense(self, dtype=None, device=None):
        return self.dia_op.to_dense() + self.ell_op.to_dense()
