"""Row-sharded DIA SpMM with an explicit halo exchange - the counterpart
of the JAX package's ``parallel/halo_spmm.py``.

The pattern is the reference's Epetra SpMV (a column-halo import inside
Epetra_CrsMatrix::Apply), as the JAX package pins it down with
``shard_map`` and ``ppermute``:

- each shard owns a contiguous row slab of x and of the diagonal data
  (``Mesh.row_slabs``);
- the only remote rows a shard needs are the ``span_lo`` rows below and
  the ``span_hi`` rows above its slab, which its two neighbours own;
- a boundary shard gets zeros there, the Dirichlet padding of the
  unsharded product (the JAX package's non-cyclic permutes).

Here every apply copies each shard's halo rows out of its neighbours'
slabs into that shard's own (span, s) buffers on its device, so a shard
reads nothing but its slab and its two halos, then launches TPU kernel
#3's counterpart (``sparse/spmm.py::dia_spmm_halo``,
``csrc/dia_spmm_halo.cu``) once per shard into that shard's rows of y.
On a multi-process mesh a process holds only its own shards' rows and
payloads; the halos at its first and last shard come from the
neighbouring processes (``RowComm.neighbour_halos``, the JAX package's
``ppermute``), one exchange per apply: one all-gather of every rank's
boundary rows, captured in a compiled solve's graph segments under NCCL
and a host step of the recording under gloo.
On CPU tensors the same structure runs the kernel's plain version.  The
JAX package sends only f32, ``m_loc >= 4096`` and two-sided stencils to
its TPU kernel; the port has no such gate.

``LyapunovSolver(mesh=...)`` routes DIA operators through
``HaloDiaOperator`` whenever the slab geometry allows (see
``parallel.sharded.shard_operator``).
"""

from __future__ import annotations

from typing import List, Optional

import torch

from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.parallel.mesh import Mesh
from rails_tpu_torch.sparse.formats import DiaMatrix
from rails_tpu_torch.sparse.spmm import dia_spmm_halo

__all__ = ["halo_dia_spmm", "HaloDiaOperator", "halo_geometry_ok"]


def _spans(offsets):
    return max(0, -min(offsets, default=0)), max(0, max(offsets, default=0))


def halo_geometry_ok(dia: DiaMatrix, mesh: Mesh) -> bool:
    """True when the slab decomposition supports the halo exchange:
    square, rows divisible by the mesh, stencil span within one slab."""
    m, n = dia.shape
    nd = mesh.size
    if m != n or m % nd:
        return False
    m_loc = m // nd
    span_lo, span_hi = _spans(dia.offsets)
    return span_lo < m_loc and span_hi < m_loc


def _cut(dia: DiaMatrix, mesh: Mesh) -> List[DiaMatrix]:
    """Contiguous (d, m_loc) copies of the diagonal data of this process's
    shards, on the shards' devices."""
    out = []
    for (r0, r1), dev in zip(mesh.local_slabs(dia.shape[0]), mesh.devices):
        data = dia.data[:, r0:r1].to(dev, copy=True).contiguous()
        out.append(DiaMatrix(data, dia.offsets, (r1 - r0, r1 - r0)))
    return out


def _halo(x: torch.Tensor, a: int, b: int, dev) -> Optional[torch.Tensor]:
    """Rows [a, b) of x as a buffer of its own on ``dev``: zeros where the
    rows lie outside x (a boundary shard), None when empty."""
    if b <= a:
        return None
    if a < 0 or b > x.shape[0]:
        return torch.zeros((b - a, x.shape[1]), dtype=x.dtype, device=dev)
    return x[a:b].to(dev, copy=True)


def process_halos(x: torch.Tensor, lo: int, hi: int, mesh: Mesh):
    """The ``lo`` rows below and ``hi`` rows above this process's rows x,
    from the neighbouring processes (None at the mesh's ends, for an
    empty halo and with one process)."""
    if mesh.comm is None:
        return None, None
    return mesh.comm.neighbour_halos(x[:hi] if hi else None,
                                     x[x.shape[0] - lo:] if lo else None)


def _halo_apply(shards: List[DiaMatrix], offsets, x: torch.Tensor,
                mesh: Mesh) -> torch.Tensor:
    """y = A @ x over the mesh, x this process's rows: per shard, the halo
    exchange and one launch of the shard-local kernel into that shard's
    rows of y."""
    if x.ndim == 1:
        return _halo_apply(shards, offsets, x[:, None], mesh)[:, 0]
    x = x.contiguous()
    span_lo, span_hi = _spans(offsets)
    ext_lo, ext_hi = process_halos(x, span_lo, span_hi, mesh)
    y = torch.empty_like(x)
    slabs = mesh.shard_slabs(x.shape[0])
    for i, ((r0, r1), dev, dia_loc) in enumerate(zip(slabs, mesh.devices,
                                                     shards)):
        hl = ext_lo.to(dev) if i == 0 and ext_lo is not None \
            else _halo(x, r0 - span_lo, r0, dev)
        hh = ext_hi.to(dev) if i == len(slabs) - 1 and ext_hi is not None \
            else _halo(x, r1, r1 + span_hi, dev)
        dia_spmm_halo(dia_loc.data, dia_loc.offsets_t, x[r0:r1], hl, hh,
                      out=y[r0:r1], offsets=dia_loc.offsets)
    return y


def _check(dia: DiaMatrix, mesh: Mesh) -> None:
    m = dia.shape[0]
    if m % mesh.size:
        raise ValueError(f"rows {m} not divisible by mesh size {mesh.size}")
    if not halo_geometry_ok(dia, mesh):
        raise ValueError("stencil span exceeds the per-device slab")


def halo_dia_spmm(dia: DiaMatrix, x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """A @ x with the explicit neighbour halo exchange over the mesh.

    ``dia.data`` must be (d, m) and ``x`` (m, s) - this process's rows of
    it on a multi-process mesh - with m divisible by the mesh size and
    the stencil's spans below one slab."""
    _check(dia, mesh)
    return _halo_apply(_cut(dia, mesh), dia.offsets, x, mesh)


class HaloDiaOperator(LinearOperator):
    """LinearOperator running the explicit-halo SpMM over the mesh.

    The payloads are cut into per-shard slabs at construction (the JAX
    package places them column-sharded there), this process's shards
    only; ``bwd`` is the transpose's payload, None when symmetric."""

    def __init__(self, dia: DiaMatrix, mesh: Mesh,
                 bwd: Optional[DiaMatrix] = None, *,
                 is_symmetric=False, is_spd=False, is_hurwitz=False):
        for p in (dia, bwd):
            if p is not None:
                _check(p, mesh)
        self.dia = dia
        self.bwd = bwd
        self.mesh = mesh
        self.is_symmetric = is_symmetric or bwd is None
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        self._fwd_shards = _cut(dia, mesh)
        self._bwd_shards = None if bwd is None else _cut(bwd, mesh)

    @property
    def shape(self):
        return self.dia.shape

    @property
    def payload_dtype(self):
        return self.dia.data.dtype

    @property
    def payload_device(self):
        return self.mesh.device

    def astype(self, dtype):
        dia = self.dia.astype(dtype)
        bwd = None if self.bwd is None else self.bwd.astype(dtype)
        if dia is self.dia and bwd is self.bwd:
            return self
        return HaloDiaOperator(dia, self.mesh, bwd,
                               is_symmetric=self.is_symmetric,
                               is_spd=self.is_spd, is_hurwitz=self.is_hurwitz)

    def matmat(self, x):
        return _halo_apply(self._fwd_shards, self.dia.offsets, x, self.mesh)

    def rmatmat(self, x):
        if self.bwd is None:
            return self.matmat(x)
        return _halo_apply(self._bwd_shards, self.bwd.offsets, x, self.mesh)

    def to_dense(self, dtype=None, device=None):
        return self.matmat(torch.eye(self.shape[1], dtype=self.payload_dtype,
                                     device=self.mesh.device))
