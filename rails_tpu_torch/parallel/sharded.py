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

While the mesh is one device (``mesh.py``) dense, diagonal, identity and
callable operators, the solver state and row-sharded arrays need no
placement: ``shard_state`` and ``shard_array_rows`` are identity maps.
"""

from __future__ import annotations

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

__all__ = ["shard_operator", "shard_state", "shard_array_rows"]


def shard_array_rows(x, mesh: Mesh):
    """Row-shard an (m, ...) array: the identity on a one-device mesh."""
    return x


def shard_state(state, mesh: Mesh):
    """Row-shard the m-sized solver buffers and replicate the rest: the
    identity on a one-device mesh."""
    return state


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
        return op
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
        return op
    if isinstance(op, (CallableOperator, IdentityOperator)):
        return op
    raise TypeError(f"cannot shard operator of type {type(op)}")
