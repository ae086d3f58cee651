"""Linear operator protocol - the counterpart of the JAX package's
``operators.py`` (the reference's backend wrapper layer, L2).

Multivectors are plain (m, s) tensors; only the operator (the sparse,
structured or matrix-free A, M or B) needs an abstraction.  Operators are
plain Python objects holding tensors on one device: ``to(device)`` moves
the payload, ``astype(dtype)`` casts it, and both return ``self`` when
nothing changes.

Operator tags (``is_symmetric``, ``is_spd``, ``is_hurwitz``) drive the
selection of the projected dense solver (eigh vs schur vs sign), resolved
once per solve from the tags, never from data.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rails_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = [
    "LinearOperator",
    "DenseOperator",
    "DiagonalOperator",
    "IdentityOperator",
    "CallableOperator",
    "LowRankOperator",
    "as_operator",
    "operator_norm2",
]


class LinearOperator:
    """Base protocol.  Subclasses implement matmat/rmatmat.

    Attributes:
      shape: (m, n) global shape.
      is_symmetric: A == A' (enables eigh projected solves).
      is_spd: symmetric positive definite (mass matrices).
      is_hurwitz: spectrum in the open left half-plane (enables the sign
        projected solver).
    """

    shape: Tuple[int, int]
    is_symmetric: bool = False
    is_spd: bool = False
    is_hurwitz: bool = False

    def matmat(self, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def rmatmat(self, x: torch.Tensor) -> torch.Tensor:
        """A' @ x."""
        raise NotImplementedError

    def __matmul__(self, x):
        if isinstance(x, torch.Tensor):
            return self.matmat(x)
        return NotImplemented

    @property
    def T(self) -> "LinearOperator":
        return _TransposedOperator(self)

    def _payload(self) -> Optional[torch.Tensor]:
        for attr in ("a", "d", "u"):
            x = getattr(self, attr, None)
            if isinstance(x, torch.Tensor):
                return x
        return None

    @property
    def payload_dtype(self):
        """dtype of the numeric payload, or None for matrix-free ops."""
        p = self._payload()
        return None if p is None else p.dtype

    @property
    def payload_device(self):
        """device of the numeric payload, or None for matrix-free ops."""
        p = self._payload()
        return None if p is None else p.device

    def to_dense(self, dtype=None, device=None) -> torch.Tensor:
        eye = torch.eye(self.shape[1],
                        dtype=dtype or self.payload_dtype
                        or torch.get_default_dtype(),
                        device=device or self.payload_device
                        or resolve_device(None))
        return self.matmat(eye)

    def astype(self, dtype) -> "LinearOperator":
        """This operator with numeric payloads cast to ``dtype``.
        Matrix-free operators return themselves: their output dtype
        follows the operand."""
        return self

    def to(self, device) -> "LinearOperator":
        """This operator with its payloads on ``device``; matrix-free
        operators return themselves."""
        return self


class _TransposedOperator(LinearOperator):
    def __init__(self, base: LinearOperator):
        self.base = base

    @property
    def shape(self):
        return (self.base.shape[1], self.base.shape[0])

    @property
    def is_symmetric(self):
        return self.base.is_symmetric

    @property
    def is_spd(self):
        return self.base.is_spd

    @property
    def payload_dtype(self):
        return self.base.payload_dtype

    @property
    def payload_device(self):
        return self.base.payload_device

    def matmat(self, x):
        return self.base.rmatmat(x)

    def rmatmat(self, x):
        return self.base.matmat(x)

    def astype(self, dtype):
        base = self.base.astype(dtype)
        return self if base is self.base else _TransposedOperator(base)

    def to(self, device):
        base = self.base.to(device)
        return self if base is self.base else _TransposedOperator(base)


class DenseOperator(LinearOperator):
    """A dense m-by-n matrix."""

    def __init__(self, a, *, is_symmetric=False, is_spd=False,
                 is_hurwitz=False, device=None):
        self.a = as_tensor(a, device)
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz

    @property
    def shape(self):
        return tuple(self.a.shape)

    def matmat(self, x):
        return self.a @ x

    def rmatmat(self, x):
        return self.a.T @ x

    def to_dense(self, dtype=None, device=None):
        return self.a

    def _like(self, a):
        return DenseOperator(a, is_symmetric=self.is_symmetric,
                             is_spd=self.is_spd, is_hurwitz=self.is_hurwitz,
                             device=a.device)

    def astype(self, dtype):
        return self if self.a.dtype == dtype else self._like(
            self.a.to(dtype))

    def to(self, device):
        dev = resolve_device(device)
        return self if self.a.device == dev else self._like(self.a.to(dev))


class DiagonalOperator(LinearOperator):
    """diag(d) - the common mass-matrix case (M = spdiags(rand(n,1)) in the
    reference tests, matlab/test/test_Laplace.m:37)."""

    is_symmetric = True

    def __init__(self, d, *, is_spd=None, device=None):
        self.d = as_tensor(d, device)
        if is_spd is None:
            is_spd = bool(torch.all(self.d > 0))
        self.is_spd = is_spd

    @property
    def shape(self):
        n = self.d.shape[0]
        return (n, n)

    def matmat(self, x):
        return self.d[:, None] * x

    def matmat2(self, x):
        """Error-free apply (hi, lo) for the refined driver."""
        from rails_tpu_torch.utils.compensated import two_prod

        return two_prod(self.d[:, None], x)

    def rmatmat(self, x):
        return self.d[:, None] * x

    def to_dense(self, dtype=None, device=None):
        return torch.diag(self.d)

    def astype(self, dtype):
        if self.d.dtype == dtype:
            return self
        return DiagonalOperator(self.d.to(dtype), is_spd=self.is_spd,
                                device=self.d.device)

    def to(self, device):
        dev = resolve_device(device)
        if self.d.device == dev:
            return self
        return DiagonalOperator(self.d.to(dev), is_spd=self.is_spd,
                                device=dev)


class IdentityOperator(LinearOperator):
    is_symmetric = True
    is_spd = True

    def __init__(self, n: int):
        self.n = n

    @property
    def shape(self):
        return (self.n, self.n)

    def matmat(self, x):
        return x

    def matmat2(self, x):
        return x, torch.zeros_like(x)

    def rmatmat(self, x):
        return x


class CallableOperator(LinearOperator):
    """Matrix-free operator from callables on tensors (the reference's
    Epetra_Operator-wrapped SchurOperator, src/SchurOperator.cpp:201-233,
    and MATLAB's function-handle A, matlab/RAILSsolver.m:259-270)."""

    def __init__(self, fn, shape, rfn=None, *, is_symmetric=False,
                 is_spd=False, is_hurwitz=False):
        self.fn = fn
        self.rfn = rfn
        self._shape = tuple(shape)
        self.is_symmetric = is_symmetric
        self.is_spd = is_spd
        self.is_hurwitz = is_hurwitz
        if rfn is None and not is_symmetric:
            raise ValueError(
                "CallableOperator needs rfn (transpose apply) unless symmetric")

    @property
    def shape(self):
        return self._shape

    def matmat(self, x):
        return self.fn(x)

    def rmatmat(self, x):
        if self.is_symmetric and self.rfn is None:
            return self.fn(x)
        return self.rfn(x)


class LowRankOperator(LinearOperator):
    """U @ W' as an operator (solution operators V T V', B B', ...)."""

    def __init__(self, u, w=None, *, device=None):
        self.u = as_tensor(u, device)
        self.w = self.u if w is None else as_tensor(w, self.u.device)

    @property
    def shape(self):
        return (self.u.shape[0], self.w.shape[0])

    @property
    def is_symmetric(self):
        return self.u is self.w

    def matmat(self, x):
        return self.u @ (self.w.T @ x)

    def rmatmat(self, x):
        return self.w @ (self.u.T @ x)

    def _like(self, u, w):
        return LowRankOperator(u, None if self.u is self.w else w,
                               device=u.device)

    def astype(self, dtype):
        if self.u.dtype == dtype and self.w.dtype == dtype:
            return self
        return self._like(self.u.to(dtype), self.w.to(dtype))

    def to(self, device):
        dev = resolve_device(device)
        if self.u.device == dev and self.w.device == dev:
            return self
        return self._like(self.u.to(dev), self.w.to(dev))


def as_operator(a, *, device=None, dtype=None, **tags) -> LinearOperator:
    """Coerce a tensor / numpy array / scipy sparse matrix into an
    operator on ``device`` (default ``cuda``), cast to ``dtype`` when
    given.  A 1-D array is a diagonal operator.  Operators pass through
    unchanged."""
    if isinstance(a, LinearOperator):
        return a
    import scipy.sparse as _sp

    if _sp.issparse(a):
        from rails_tpu_torch.sparse.formats import sparse_from_scipy

        return sparse_from_scipy(a, device=device, dtype=dtype, **tags)
    if callable(a) and not hasattr(a, "ndim"):
        raise TypeError("wrap callables explicitly with CallableOperator "
                        "(a shape is required)")
    arr = as_tensor(a, device, dtype)
    if arr.ndim == 1:
        return DiagonalOperator(arr, device=arr.device, **tags)
    return DenseOperator(arr, device=arr.device, **tags)


def operator_norm2(op: LinearOperator, iters: int = 30,
                   generator: Optional[torch.Generator] = None,
                   dtype=None, device=None) -> torch.Tensor:
    """Spectral 2-norm via power iteration on A'A (matrix-free; the
    reference forms A'A explicitly, src/Epetra_OperatorWrapper.cpp:
    115-145).  The start vector is drawn from ``generator`` (default: a
    generator seeded with 0 on the operator's device)."""
    n = op.shape[1]
    dtype = dtype or op.payload_dtype or torch.get_default_dtype()
    dev = resolve_device(device or op.payload_device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    v = torch.randn((n, 1), generator=generator, dtype=dtype, device=dev)
    v = v / torch.linalg.norm(v)
    for _ in range(iters):
        w = op.rmatmat(op.matmat(v))
        v = w / (torch.linalg.norm(w) + 1e-300)
    return torch.sqrt(torch.linalg.norm(op.rmatmat(op.matmat(v))))
