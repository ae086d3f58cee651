"""Row-sharded Schur-complement operator - the counterpart of the JAX
package's ``parallel/schur_dist.py``, the production posture of the
reference's main program: its solve runs on the SchurOperator, with
every A12/A21/A22 apply a distributed Epetra SpMM and only the
factorization of A11 serial.

- **A22** (n2 x n2) goes through ``shard_operator``: the halo ELL/DIA
  operators where the slab geometry allows, as a direct solve would.
- **A21 and A12'** are n2-row ELL arrays cut into the shards' row slabs
  (the row space of the solver state):

  * ``A21 @ y`` and ``A12' @ y`` (y an (n1, s) block every shard sees)
    are row-local gathers, one ELL apply per shard
    (``sparse/ell_spmm.py``);
  * ``A12 @ x`` and ``A21' @ x`` (x row-sharded (n2, s)) are a
    scatter-add (``index_add_``) of each shard's rows into an (n1, s)
    partial, and the partials are summed: the JAX package's per-device
    scatter and ``psum``; on a multi-process mesh each process sums its
    shards' partials and the processes' sums are reduced
    (``RowComm.allreduce``), one skinny (n1, s) block per apply, which a
    compiled solve captures (NCCL) or runs as a host step (gloo).
- **A11^{-1}** is the dense LU of the ``SchurReduction``, applied with
  ``torch.linalg.lu_solve`` on the mesh's device: the JAX package
  replicates it on every device, and every process holds it.

On a multi-process mesh a process holds only its own shards' rows of
A21, A12' and A22, and of the vectors it applies S to.

``distribute_schur(red, mesh)`` builds the operator from a
``SchurReduction``; ``LyapunovSolver(op, red.bs, red.ms, mesh=mesh)``
then runs it (``shard_operator`` passes it through).  ``pad_system``
appends decoupled rows so that the dynamic row count divides by the
mesh size.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.parallel.mesh import Mesh
from rails_tpu_torch.sparse.ell_spmm import ell_spmm
from rails_tpu_torch.sparse.formats import EllMatrix
from rails_tpu_torch.utils.device import as_tensor

__all__ = ["DistributedSchurOperator", "distribute_schur", "pad_system"]


def pad_system(a, m, b, multiple: int, singular_tol: float = 1e-12):
    """Append decoupled stable dynamic rows so that the DYNAMIC row count
    (|diag(M)| >= ``singular_tol``, the ``SchurReduction`` split) becomes
    a multiple of ``multiple``.

    Padding rows carry a = -1, m = 1, b = 0: stable dynamics with zero
    forcing, whose Lyapunov solution block is exactly zero, so the
    padded system's solution restricted to the original rows is the
    original solution.  Returns (a, m, b, n_pad)."""
    import scipy.sparse as sp

    a = sp.csr_matrix(a)
    m_sp = sp.csr_matrix(m)
    mdiag = np.asarray(m_sp.diagonal()).ravel()
    n2 = int(np.sum(np.abs(mdiag) >= singular_tol))
    pad = (-n2) % multiple
    if pad == 0:
        return a, m_sp, b, 0
    a_pad = sp.block_diag([a, -sp.eye(pad)], format="csr")
    m_pad = sp.block_diag([m_sp, sp.eye(pad)], format="csr")
    b_arr = np.asarray(b.todense()) if sp.issparse(b) else np.asarray(b)
    if b_arr.ndim == 1:
        b_arr = b_arr[:, None]
    b_pad = np.vstack([b_arr, np.zeros((pad, b_arr.shape[1]))])
    return a_pad, m_pad, b_pad, pad


def _cut_rows(idx, val, n_cols: int, mesh: Mesh) -> List[EllMatrix]:
    """This process's per-shard (n2_loc, n_cols) ELL payloads of n2-row
    ELL arrays."""
    idx = torch.as_tensor(idx)
    val = torch.as_tensor(val)
    return [EllMatrix(idx[r0:r1].to(dev, copy=True),
                      val[r0:r1].to(dev, copy=True), (r1 - r0, n_cols))
            for (r0, r1), dev in zip(mesh.local_slabs(idx.shape[0]),
                                     mesh.devices)]


class DistributedSchurOperator(LinearOperator):
    """S = A22 - A21 A11^{-1} A12, matrix-free over the row mesh, with the
    layout of the module docstring.  ``already_placed`` makes
    ``shard_operator`` pass it through unchanged.

    ``a21_idx``/``a21_val`` and ``a12t_idx``/``a12t_val`` are the n2-row
    ELL arrays (indices into [0, n1)) of A21 and A12'; ``lu``/``piv`` the
    dense LU factors of A11 (``torch.linalg.lu_factor``)."""

    already_placed = True

    def __init__(self, a22_op, a21_idx, a21_val, a12t_idx, a12t_val,
                 lu, piv, n1: int, mesh: Mesh, *, is_hurwitz=False):
        self.a22 = a22_op
        self.n1 = n1
        self.mesh = mesh
        self.is_hurwitz = is_hurwitz
        self.a21 = _cut_rows(a21_idx, a21_val, n1, mesh)
        self.a12t = _cut_rows(a12t_idx, a12t_val, n1, mesh)
        self.lu = lu.to(mesh.device)
        self.piv = piv.to(mesh.device)

    @property
    def shape(self):
        return self.a22.shape

    @property
    def payload_dtype(self):
        return self.a21[0].values.dtype

    @property
    def payload_device(self):
        return self.mesh.device

    def _scatter(self, shards: List[EllMatrix], x: torch.Tensor):
        """(n2-row ELL)' @ x: each shard scatter-adds its rows into an
        (n1, s) partial; the partials are summed, over the processes
        too."""
        total = None
        for (r0, r1), e in zip(self.mesh.shard_slabs(x.shape[0]), shards):
            x_l = x[r0:r1].to(e.values.device)
            s = x_l.shape[1]
            part = torch.zeros((self.n1, s), dtype=x.dtype,
                               device=x_l.device)
            part.index_add_(0, e.indices.reshape(-1),
                            (e.values[:, :, None] * x_l[:, None, :])
                            .reshape(-1, s))
            total = part if total is None else total + part.to(total.device)
        if self.mesh.comm is not None:
            total = self.mesh.comm.allreduce(total)
        return total

    def _gather(self, shards: List[EllMatrix], y: torch.Tensor):
        """(n2-row ELL) @ y for an (n1, s) block every shard sees: one
        row-local ELL apply per shard, concatenated."""
        return torch.cat([ell_spmm(e, y.to(e.values.device).contiguous())
                          for e in shards])

    def _a11_solve(self, y, adjoint: bool):
        return torch.linalg.lu_solve(self.lu, self.piv, y, adjoint=adjoint)

    def matmat(self, x):
        if x.ndim == 1:
            return self.matmat(x[:, None])[:, 0]
        y1 = self._scatter(self.a12t, x)                  # A12 @ x
        y2 = self._a11_solve(y1, False)                   # A11^{-1}
        return self.a22.matmat(x) - self._gather(self.a21, y2)

    def rmatmat(self, x):
        # S' = A22' - A12' A11^{-T} A21'
        if x.ndim == 1:
            return self.rmatmat(x[:, None])[:, 0]
        y1 = self._scatter(self.a21, x)                   # A21' @ x
        y2 = self._a11_solve(y1, True)                    # A11^{-T}
        return self.a22.rmatmat(x) - self._gather(self.a12t, y2)

    def astype(self, dtype):
        if self.payload_dtype == dtype:
            return self
        out = DistributedSchurOperator.__new__(DistributedSchurOperator)
        out.__dict__.update(self.__dict__)
        out.a22 = self.a22.astype(dtype)
        out.a21 = [e.astype(dtype) for e in self.a21]
        out.a12t = [e.astype(dtype) for e in self.a12t]
        out.lu = self.lu.to(dtype)
        return out


def distribute_schur(red, mesh: Mesh, *, fmt: str = "auto",
                     spmm: str = "auto") -> LinearOperator:
    """The operator of a ``SchurReduction`` on the mesh.

    With an empty singular part (n1 = 0) this is ``shard_operator`` on
    the plain A22.  The A11 factorization must be the dense LU
    (``a11_solver='dense_lu'``, the default), and the dynamic row count
    n2 must divide by the mesh size (``pad_system`` first if it does
    not)."""
    from rails_tpu_torch.parallel.sharded import shard_operator
    from rails_tpu_torch.sparse.formats import (
        ell_arrays_from_scipy, sparse_from_scipy)

    if red.n1 == 0:
        return shard_operator(red.operator, mesh, spmm=spmm)
    nd = mesh.size
    if red.n2 % nd:
        raise ValueError(
            f"dynamic row count n2={red.n2} is not divisible by the "
            f"mesh size {nd}; pad the system first "
            f"(rails_tpu_torch.parallel.schur_dist.pad_system)")
    if red.a11_solver_kind != "dense_lu" or red._a11_lu is None:
        raise ValueError(
            "distribute_schur needs the dense-LU A11 factorization "
            "(a11_solver='dense_lu'); other A11 solvers are "
            "single-controller - run without the mesh")
    dtype, dev = red.dtype, mesh.device
    a22_op = shard_operator(
        sparse_from_scipy(red._a22_scipy, fmt=fmt, dtype=dtype, device=dev),
        mesh, spmm=spmm)

    def ell(a):
        idx, val = ell_arrays_from_scipy(a)
        return torch.from_numpy(idx), as_tensor(val, dev, dtype)

    lu, piv = red._a11_lu
    return DistributedSchurOperator(
        a22_op, *ell(red._a21_scipy), *ell(red._a12_scipy.T.tocsr()),
        lu.to(dtype), piv, red.n1, mesh, is_hurwitz=red.hurwitz)
