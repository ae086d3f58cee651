"""Placement of operators and solver state on the row mesh - the
counterpart of the JAX package's ``parallel/sharded.py``.

``shard_operator`` picks the row-sharded apply of a sparse operator:
the explicit-halo operators of ``halo_spmm.py`` (DIA) and
``halo_ell.py`` (ELL, HYB) whenever the slab geometry allows, with the
JAX package's dispatch and its ``spmm="halo"`` errors.  ``"gspmd"``, and
``"auto"`` on a payload that does not qualify, return the operator
unsharded: its applies run the single-device kernels, the one-device
counterpart of the JAX package's ``SparseOperator(..., use_pallas=False)``
under its partitioner (torch has no partitioner).

With one process dense, diagonal, identity and callable operators, the
solver state and row-sharded arrays need no placement: ``shard_state``
and ``shard_array_rows`` are identity maps.  On a multi-process mesh
(``mesh.comm`` set) each process holds only its own rows
(``Mesh.local_range``): ``shard_array_rows`` and ``shard_state`` cut an
m-row tensor to them (a rank slab from ``multihost.make_global_array``
stays as it is), the halo operators keep this process's shards, a
diagonal operator its rows, and any other operator becomes a
``GatheredOperator``: its input rows gathered from every process, the
whole product formed, this process's rows kept (the partitioner's
fallback in the JAX package).
"""

from __future__ import annotations

import torch

from rails_tpu_torch.operators import (
    CallableOperator, DenseOperator, DiagonalOperator, IdentityOperator,
    LinearOperator)
from rails_tpu_torch.parallel.halo_ell import (
    HaloEllOperator, HaloHybOperator, build_halo_ell)
from rails_tpu_torch.parallel.halo_spmm import (
    HaloDiaOperator, halo_geometry_ok)
from rails_tpu_torch.parallel.mesh import Mesh
from rails_tpu_torch.sparse.formats import (
    DiaMatrix, EllMatrix, HybMatrix, SparseOperator)

__all__ = ["shard_operator", "shard_state", "shard_array_rows",
           "GatheredOperator"]


def shard_array_rows(x, mesh: Mesh, m=None):
    """This process's rows of an (m, ...) array (``m`` defaults to x's
    rows: the array is taken as whole); a tensor that holds this rank's
    m / world rows already (a slab from ``multihost.make_global_array``)
    stays as it is.  The identity with one process."""
    if mesh.comm is None or x is None:
        return x
    rows = x.shape[0]
    m = rows if m is None else m
    if rows == m:
        r0, r1 = mesh.local_range(m)
        return x[r0:r1]
    if rows * mesh.comm.world == m:
        return x
    raise ValueError(f"{rows} rows are neither the whole {m} rows nor this "
                     f"rank's {m // mesh.comm.world}")


def shard_state(state, mesh: Mesh, m=None):
    """The solver state on the mesh: every m-row tensor of ``state`` (a
    tensor or a dict of them) cut to this process's rows, the rest
    replicated as it is; the identity with one process."""
    if mesh.comm is None:
        return state
    if isinstance(state, dict):
        return {k: shard_state(v, mesh, m) for k, v in state.items()}
    if isinstance(state, torch.Tensor) and state.ndim \
            and state.shape[0] == m:
        return shard_array_rows(state, mesh, m)
    return state


class GatheredOperator(LinearOperator):
    """``op`` on a multi-process mesh where it has no row-local apply: an
    input with ``m`` rows is gathered from every process
    (``RowComm.allgather_rows``), the whole product formed on every
    process, and an output with ``m`` rows cut to this process's rows.
    An (m, p) B therefore gives a replicated B' x and a row-local B y."""

    def __init__(self, op: LinearOperator, mesh: Mesh, m: int):
        self.op = op
        self.mesh = mesh
        self.m = m
        self.is_symmetric = op.is_symmetric
        self.is_spd = op.is_spd
        self.is_hurwitz = op.is_hurwitz

    @property
    def shape(self):
        return self.op.shape

    @property
    def payload_dtype(self):
        return self.op.payload_dtype

    @property
    def payload_device(self):
        return self.op.payload_device

    def _apply(self, fn, x, n_in, n_out):
        if n_in == self.m:
            x = self.mesh.comm.allgather_rows(x)
        y = fn(x)
        if n_out == self.m:
            r0, r1 = self.mesh.local_range(self.m)
            y = y[r0:r1]
        return y

    def matmat(self, x):
        n_out, n_in = self.op.shape
        return self._apply(self.op.matmat, x, n_in, n_out)

    def rmatmat(self, x):
        n_in, n_out = self.op.shape
        return self._apply(self.op.rmatmat, x, n_in, n_out)

    def astype(self, dtype):
        op = self.op.astype(dtype)
        return self if op is self.op else GatheredOperator(op, self.mesh,
                                                           self.m)


def _try_halo_hyb(op: SparseOperator, mesh: Mesh):
    """HYB: the explicit-halo DIA path for the dense diagonals plus the
    ELL halo path for the remainder, summed.  None unless every part,
    both directions, satisfies its slab geometry; the transpose may be a
    HYB split or a single ELL payload."""
    fwd = op.fwd
    if not halo_geometry_ok(fwd.dia, mesh):
        return None
    ell_f = build_halo_ell(fwd.ell, mesh)
    if ell_f is None:
        return None
    tags = dict(is_symmetric=op.is_symmetric, is_spd=op.is_spd,
                is_hurwitz=op.is_hurwitz)
    if op.bwd is None:
        return HaloHybOperator(HaloDiaOperator(fwd.dia, mesh),
                               HaloEllOperator(ell_f, mesh), nnz=op.nnz,
                               **tags)
    if isinstance(op.bwd, HybMatrix):
        if not halo_geometry_ok(op.bwd.dia, mesh):
            return None
        ell_b = build_halo_ell(op.bwd.ell, mesh)
        if ell_b is None:
            return None
        return HaloHybOperator(HaloDiaOperator(fwd.dia, mesh, op.bwd.dia),
                               HaloEllOperator(ell_f, mesh, ell_b),
                               nnz=op.nnz, **tags)
    if isinstance(op.bwd, EllMatrix):
        whole_b = build_halo_ell(op.bwd, mesh)
        if whole_b is None:
            return None
        return HaloHybOperator(HaloDiaOperator(fwd.dia, mesh),
                               HaloEllOperator(ell_f, mesh),
                               rmat_op=HaloEllOperator(whole_b, mesh),
                               nnz=op.nnz, **tags)
    return None


def shard_operator(op: LinearOperator, mesh: Mesh,
                   spmm: str = "auto") -> LinearOperator:
    """The row-sharded form of ``op`` on the mesh.

    ``spmm`` picks the strategy for sparse payloads: ``'halo'`` the
    explicit-halo operators (raising where the geometry does not allow
    them), ``'gspmd'`` the unsharded operator, ``'auto'`` halo whenever
    the geometry allows."""
    if spmm not in ("auto", "halo", "gspmd"):
        raise ValueError(f"unknown spmm strategy {spmm!r}")
    if getattr(op, "already_placed", False):
        # DistributedSchurOperator (anything built on a mesh) arrives
        # with its payloads already cut
        return op
    if isinstance(op, (DenseOperator, DiagonalOperator)):
        return _unsharded(op, mesh)
    if isinstance(op, SparseOperator):
        tags = dict(is_symmetric=op.is_symmetric, is_spd=op.is_spd,
                    is_hurwitz=op.is_hurwitz)
        if spmm != "gspmd" and isinstance(op.fwd, DiaMatrix):
            bwd_ok = op.bwd is None or isinstance(op.bwd, DiaMatrix)
            if bwd_ok and halo_geometry_ok(op.fwd, mesh) and (
                    op.bwd is None or halo_geometry_ok(op.bwd, mesh)):
                return HaloDiaOperator(op.fwd, mesh, op.bwd, **tags)
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires a square DIA payload with rows "
                    "divisible by the mesh and stencil span within one "
                    "per-device slab")
        if spmm != "gspmd" and isinstance(op.fwd, EllMatrix):
            fwd = build_halo_ell(op.fwd, mesh)
            if fwd is not None:
                bwd = None
                if op.bwd is not None and isinstance(op.bwd, EllMatrix):
                    bwd = build_halo_ell(op.bwd, mesh)
                if op.bwd is None or bwd is not None:
                    return HaloEllOperator(fwd, mesh, bwd, nnz=op.nnz,
                                           **tags)
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires a square ELL payload with rows "
                    "divisible by the mesh and remote references within "
                    "the adjacent slabs (both directions)")
        if spmm != "gspmd" and isinstance(op.fwd, HybMatrix):
            halo = _try_halo_hyb(op, mesh)
            if halo is not None:
                return halo
            if spmm == "halo":
                raise ValueError(
                    "spmm='halo' requires both the DIA and ELL parts of the "
                    "HYB payload (and its transpose) to satisfy the halo "
                    "slab geometry")
        return _unsharded(op, mesh)
    if isinstance(op, (CallableOperator, IdentityOperator)):
        return _unsharded(op, mesh)
    raise TypeError(f"cannot shard operator of type {type(op)}")



def _unsharded(op: LinearOperator, mesh: Mesh) -> LinearOperator:
    """An operator with no halo form: itself with one process; on a
    multi-process mesh a diagonal operator's rows of this process, the
    identity as it is, and anything else a ``GatheredOperator``."""
    if mesh.comm is None or isinstance(op, IdentityOperator):
        return op
    m = op.shape[0]
    if isinstance(op, DiagonalOperator):
        r0, r1 = mesh.local_range(m)
        return DiagonalOperator(op.d[r0:r1], is_spd=op.is_spd,
                                device=op.d.device)
    return GatheredOperator(op, mesh, m)
