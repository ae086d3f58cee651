"""Schur-complement preprocessing for singular mass matrices - the
counterpart of the JAX package's ``schur.py``.

Ocean-model Jacobians are index-2 DAEs: most fields have no time
derivative, so diag(M) is mostly zero.  The reference reduces the problem
to the nonsingular part via a matrix-free Schur complement (C++
SchurOperator, src/SchurOperator.cpp; MATLAB RAILSschur.m):

    split by |diag(M)| < tol into parts 1 (singular) and 2 (dynamic);
    S x = A22 x - A21 A11^{-1} A12 x ;  MS = M22 ;  BS = B2 (restricted)

and the solver runs on (S, MS, BS).  Here:

- the index split and the submatrix extraction happen on the host
  (scipy), once;
- A12, A21 and A22 become device sparse operators, ELL by default, so
  every apply of S launches the ELL kernel three times;
- the A11 solve is pluggable (``a11_solver``): ``'dense_lu'`` (default)
  factors A11 densely on the device once with ``torch.linalg.lu_factor``
  and applies it with ``lu_solve``; ``'native_lu'`` factors A11 once
  with the port's C++ sparse LU on the host (``native/host_lib.py``) and
  solves there, each solve a round trip device -> numpy -> LU -> device
  (the counterpart of the JAX package's ``pure_callback``; a host step
  of a recorded iteration, ``core/engine.py::host_call``), O(nnz of the
  factors) memory where the dense LU holds n1^2; ``'iterative'`` runs a
  Jacobi-preconditioned BiCGStab whose matvec is the A11 sparse operator
  (format by ``'auto'``); or any callable (MATLAB's opts.Ainv contract).
  Inside each apply of S it runs in a ``Schur/a11_solve`` span
  (``timer.span``);
- S is tagged symmetric (``red.symmetric``, then the solver's projected
  solve takes its eigh route) when A is symmetric and the A11 solve is
  direct (``dense_lu``, ``native_lu``); the JAX package leaves S
  untagged.

Post-solution analysis (the full-space solution operator for eigenvalue
extraction, and its trace, C++ SchurOperator::Apply(hasSolution)/Trace,
SchurOperator.cpp:235-342) is implemented on SchurReduction as well.
"""

from __future__ import annotations

import warnings
from typing import Callable

import numpy as np
import scipy.sparse as sp
import torch

from rails_tpu_torch.core.engine import host_call
from rails_tpu_torch.operators import (
    CallableOperator, DiagonalOperator, LinearOperator)
from rails_tpu_torch.sparse.formats import SparseOperator, sparse_from_scipy
from rails_tpu_torch.timer import span
from rails_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = ["SchurReduction", "schur_reduce"]


def _host_solver(lu, trans: bool, rows=None, n=None):
    """x -> the native LU's solve of x on the host, back on x's device in
    x's dtype, a host step of a recorded iteration (``host_call``).  With
    ``rows`` (and the full size ``n``), x is scattered into those rows of
    a zero right-hand side and the solution read back from them
    (``sinv``'s reorder trick)."""
    def solve(x):
        return host_call(on_host, x, name="a11_solve")

    def on_host(x):
        xh = x.detach().cpu().double().numpy()
        if rows is not None:
            rhs = np.zeros((n,) + xh.shape[1:])
            rhs[rows] = xh
            xh = lu.solve(rhs, trans=trans)[rows]
        else:
            xh = lu.solve(xh, trans=trans)
        return torch.from_numpy(xh).to(device=x.device, dtype=x.dtype)

    return solve


def _bicgstab(matvec, b: torch.Tensor, *, tol: float, maxiter: int,
              precond) -> torch.Tensor:
    """Preconditioned BiCGStab from x0 = 0, the iteration of
    ``jax.scipy.sparse.linalg.bicgstab``: a multivector b is one vector
    (inner products over all its entries); stops when ||r||^2 <=
    tol^2 ||b||^2, after ``maxiter`` steps, or on a breakdown (rho,
    alpha or omega exactly 0).  Returns the last iterate."""
    def dot(u, v):
        return torch.sum(u * v)

    atol2 = tol * tol * dot(b, b)
    x = torch.zeros_like(b)
    r = b.clone()
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    rho = alpha = omega = one
    for _ in range(maxiter):
        if not bool(dot(r, r) > atol2):
            break
        rho_ = dot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = precond(p)
        q = matvec(phat)
        alpha = rho_ / dot(rhat, q)
        s = r - alpha * q
        exit_early = bool(dot(s, s) < atol2)
        if exit_early:
            x = x + alpha * phat
            r = s
            omega = one  # unused: the loop stops on ||r|| next
        else:
            shat = precond(s)
            t = matvec(shat)
            omega = dot(t, s) / dot(t, t)
            x = x + (alpha * phat + omega * shat)
            r = s - omega * t
        rho = rho_
        if bool(rho_ == 0) or bool(omega == 0) or bool(alpha == 0):
            break
    return x


def _is_symmetric(a: sp.csr_matrix) -> bool:
    """|A - A'| <= 8 eps(float64) max|A| entrywise, in O(nnz) on the
    host.  A is symmetric exactly when its blocks on the singular /
    dynamic split are (A11 and A22 symmetric, A12 = A21'), as the split
    is a symmetric permutation.  The tolerance admits an assembly that
    rounds the two halves of a pair of entries apart by a few ulps, and
    nothing an asymmetric model could hold: its asymmetry is far above
    rounding."""
    tol = 8 * np.finfo(np.float64).eps * abs(a).max()
    return bool(abs(a - a.T).max() <= tol)


_HOST_STEPS = {"native_lu": "the A11 solve of native_lu",
               "iterative": "the A11 BiCGStab (its stopping test reads "
                            "the device)"}


class SchurReduction:
    """Holds the reduced operators; use .operator/.ms/.bs with the solver.

    ``device``: where the operators live (default ``cuda``); ``dtype``:
    their dtype (default ``torch.get_default_dtype()``)."""

    def __init__(self, a, m, b, *, a11_solver="dense_lu", singular_tol=1e-12,
                 dtype=None, device=None, fmt="ell", hurwitz=False,
                 factorize_sinv=False, a11_tol=None, a11_maxiter=500):
        self.a11_tol = a11_tol
        self.a11_maxiter = a11_maxiter
        self.hurwitz = hurwitz
        self.dtype = torch.get_default_dtype() if dtype is None else dtype
        self.device = resolve_device(device)
        a = sp.csr_matrix(a)
        n = a.shape[0]
        if sp.issparse(m):
            mdiag = np.asarray(m.diagonal()).ravel()
        else:
            m = np.asarray(m)
            mdiag = np.diag(m) if m.ndim == 2 else m
        # index split (RAILSschur.m:23-24; C++ SchurOperator.cpp:73-94)
        self.idx1 = np.flatnonzero(np.abs(mdiag) < singular_tol)
        self.idx2 = np.flatnonzero(np.abs(mdiag) >= singular_tol)
        self.n = n
        self.n1 = len(self.idx1)
        self.n2 = len(self.idx2)
        self._i1 = torch.as_tensor(self.idx1, device=self.device)
        self._i2 = torch.as_tensor(self.idx2, device=self.device)

        a11 = a[self.idx1][:, self.idx1].tocsr()
        a12 = a[self.idx1][:, self.idx2].tocsr()
        a21 = a[self.idx2][:, self.idx1].tocsr()
        a22 = a[self.idx2][:, self.idx2].tocsr()
        self._a_scipy = a
        self._a11_scipy = a11
        # kept for distribute_schur (parallel/schur_dist.py), which cuts
        # its per-shard payloads from the host blocks
        self._a12_scipy = a12
        self._a21_scipy = a21
        self._a22_scipy = a22
        kw = dict(fmt=fmt, dtype=self.dtype, device=self.device)
        self.A12 = sparse_from_scipy(a12, **kw)
        self.A21 = sparse_from_scipy(a21, **kw)
        self.A22 = sparse_from_scipy(a22, **kw)

        self._setup_a11(a11_solver)
        # the tag ``operator`` gives S.  S is tagged symmetric (the
        # projected solve's eigh route) only with a direct A11 solve:
        # exact to rounding, so any asymmetry of V'SV is rounding.  An
        # iterative or callable A11 solve is accurate only to its own
        # tolerance, and symmetrising V'SV would change the answer at
        # that level.  With n1 = 0, S is A22 itself, with A22's own tag.
        if self.n1 == 0:
            self.symmetric = self.A22.is_symmetric
        else:
            self.symmetric = (
                self.a11_solver_kind in ("dense_lu", "native_lu")
                and _is_symmetric(a))

        self.ms_diag = as_tensor(mdiag[self.idx2], self.device, self.dtype)

        b = np.asarray(b.todense()) if sp.issparse(b) else np.asarray(b)
        if b.ndim == 1:
            b = b[:, None]
        if np.abs(b[self.idx1]).max(initial=0.0) > np.sqrt(
                np.finfo(np.float64).eps):
            # BS = B2 - A21 A11^{-1} B1 (RAILSschur.m:46-49)
            warnings.warn("B is not zero in the singular part",
                          stacklevel=2)
            b1 = as_tensor(b[self.idx1], self.device, self.dtype)
            b2 = as_tensor(b[self.idx2], self.device, self.dtype)
            self.bs = b2 - self.A21.matmat(self.a11_solve(b1))
        else:
            self.bs = as_tensor(b[self.idx2], self.device, self.dtype)
        self.mvps = 0
        self._sinv_factors = None
        self._sinv_native = None
        if factorize_sinv:
            # MATLAB RAILSschur(A, M, B, true) pre-factorizes the whole-A
            # LU used by Sinv at reduction time (RAILSschur.m:51-64)
            self.sinv()

    # -- A11 solver plumbing ------------------------------------------------
    def _dense(self, a: sp.spmatrix) -> torch.Tensor:
        """A scipy matrix as a dense tensor, scattered on the device (no
        dense host copy)."""
        coo = a.tocoo()
        out = torch.zeros(a.shape, dtype=self.dtype, device=self.device)
        rows = torch.as_tensor(coo.row.astype(np.int64), device=self.device)
        cols = torch.as_tensor(coo.col.astype(np.int64), device=self.device)
        out.index_put_((rows, cols), as_tensor(coo.data, self.device,
                                               self.dtype), accumulate=True)
        return out

    def _setup_a11(self, a11_solver):
        self.a11_solver_kind = (
            a11_solver if isinstance(a11_solver, str) else "custom")
        self._a11_lu = None  # (lu, piv) when dense_lu; distribute_schur
        if callable(a11_solver):
            self.a11_solve = a11_solver
            self.a11_solve_t = getattr(a11_solver, "transpose_solve", None)
            return
        if a11_solver == "dense_lu":
            if self.n1 == 0:
                self.a11_solve = self.a11_solve_t = lambda x: x
                return
            lu, piv = torch.linalg.lu_factor(self._dense(self._a11_scipy))
            self._a11_lu = (lu, piv)

            # no recursion for a 1-D x: a closure that calls itself is a
            # reference cycle, and would keep the factor alive after its
            # reduction until the collector runs
            def lu_apply(x, adjoint):
                if x.ndim == 1:
                    return torch.linalg.lu_solve(
                        lu, piv, x[:, None], adjoint=adjoint)[:, 0]
                return torch.linalg.lu_solve(lu, piv, x, adjoint=adjoint)

            self.a11_solve = lambda x: lu_apply(x, False)
            self.a11_solve_t = lambda x: lu_apply(x, True)
        elif a11_solver == "native_lu":
            if self.n1 == 0:
                self.a11_solve = self.a11_solve_t = lambda x: x
                return
            from rails_tpu_torch.native.host_lib import NativeSparseLU

            lu = NativeSparseLU(self._a11_scipy)
            self.a11_solve = _host_solver(lu, False)
            self.a11_solve_t = _host_solver(lu, True)
        elif a11_solver == "iterative":
            # the scalable device-side option: O(nnz) memory, where the
            # dense LU needs O(n1^2).  Suited to diagonally dominant /
            # elliptic A11 blocks; a saddle-structured A11 (zero
            # diagonals) should keep a direct method or pass a callable.
            a11_op = sparse_from_scipy(self._a11_scipy, dtype=self.dtype,
                                       device=self.device)
            d = np.asarray(self._a11_scipy.diagonal())
            safe = np.where(np.abs(d) > 1e-30, d, 1.0)
            dinv = as_tensor(1.0 / safe, self.device, self.dtype)
            tol = self.a11_tol
            if tol is None:
                # f32: 30*eps (~3.6e-6 relative) routinely stagnates in
                # BiCGStab's f32 recurrences; 1e-5 is attainable and still
                # far below the outer solver's targets.  f64 keeps 30*eps.
                tol = 30 * float(torch.finfo(self.dtype).eps)
                if self.dtype == torch.float32:
                    tol = max(tol, 1e-5)
            maxiter = self.a11_maxiter

            def precond(r):
                return r * dinv.reshape((-1,) + (1,) * (r.ndim - 1))

            def solver(matvec):
                # the whole BiCGStab is one host step of a recorded
                # iteration: its stopping test reads the device
                def run(x):
                    return _bicgstab(matvec, x, tol=tol, maxiter=maxiter,
                                     precond=precond)
                return lambda x: host_call(run, x, name="a11_solve")

            self.a11_solve = solver(a11_op.matmat)
            self.a11_solve_t = solver(a11_op.rmatmat)
            self._a11_op = a11_op
            self._a11_tol_eff = tol
        else:
            raise ValueError(f"unknown a11_solver {a11_solver!r}")

    def a11_residual_check(self, x=None, warn: bool = True):
        """Relative residual ||A11 y - x|| / ||x|| of one forward and one
        transpose A11 solve on a probe vector (default: U[-1, 1) from
        ``default_rng(0)``), on the host in float64.  The iterative path
        returns its last iterate even when stagnated; this check, and its
        warning when the residual exceeds 10x the iterative tolerance,
        surfaces that before the outer solve misattributes it."""
        if x is None:
            x = np.random.default_rng(0).uniform(-1, 1, (self.n1, 1))
        x = as_tensor(x, self.device, self.dtype)
        a11 = self._a11_scipy
        xh = x.detach().cpu().double().numpy()
        y = self.a11_solve(x).detach().cpu().double().numpy()
        res = float(np.linalg.norm(a11 @ y - xh) / np.linalg.norm(xh))
        res_t = None
        if self.a11_solve_t is not None:
            yt = self.a11_solve_t(x).detach().cpu().double().numpy()
            res_t = float(np.linalg.norm(a11.T @ yt - xh)
                          / np.linalg.norm(xh))
        tol = getattr(self, "_a11_tol_eff", None)
        if warn and tol is not None:
            worst = max(res, res_t if res_t is not None else 0.0)
            if worst > 10 * tol:
                warnings.warn(
                    f"iterative A11 solve residual {worst:.2e} exceeds "
                    f"10x its tolerance {tol:.2e}; increase a11_maxiter, "
                    f"loosen a11_tol, or use a direct a11_solver",
                    RuntimeWarning)
        return res, res_t

    # -- the reduced operators ---------------------------------------------
    @property
    def operator(self) -> LinearOperator:
        """S = A22 - A21 A11^{-1} A12, matrix-free
        (SchurOperator::Apply pre-solution, SchurOperator.cpp:201-233).
        With an empty singular part (n1 = 0) S = A22 = A, returned as the
        SparseOperator itself, with the hurwitz tag applied."""
        if self.n1 == 0:
            op = self.A22
            if self.hurwitz and not op.is_hurwitz:
                op = SparseOperator(
                    op.fwd, op.bwd, is_symmetric=op.is_symmetric,
                    is_spd=op.is_spd, is_hurwitz=True, nnz=op.nnz)
            return op

        def apply(x):
            z, y = self.A22.matmat(x), self.A12.matmat(x)
            with span("Schur", "a11_solve"):
                y = self.a11_solve(y)
            return z - self.A21.matmat(y)

        def apply_t(x):
            z, y = self.A22.rmatmat(x), self.A21.rmatmat(x)
            with span("Schur", "a11_solve"):
                y = self.a11_solve_t(y)
            return z - self.A12.rmatmat(y)

        op = CallableOperator(apply, (self.n2, self.n2), rfn=apply_t,
                              is_symmetric=self.symmetric,
                              is_hurwitz=self.hurwitz)
        # what a recorded iteration (solve(compiled=True) on the card)
        # runs as a host step inside each apply of S (``host_call``): the
        # native LU's host solve, BiCGStab with its host-side stopping
        # test; reported in info.engine
        op.host_steps = _HOST_STEPS.get(self.a11_solver_kind)
        return op

    @property
    def ms(self) -> DiagonalOperator:
        return DiagonalOperator(self.ms_diag, device=self.device)

    def sinv(self, method: str = "dense_lu") -> Callable:
        """x -> S^{-1} x via a full-A solve with the reorder trick
        (RAILSschur.m:57-64): solve A z = P' [0; x], return z[idx2].
        ``method='dense_lu'`` factors A densely on the device (cached);
        ``method='native_lu'`` factors it with the C++ sparse LU on the
        host (cached) and solves there, the scalable choice for a large
        sparse A (the role of MATLAB's sparse ``lu``, RAILSschur.m:31-33).
        """
        if method == "native_lu":
            if self._sinv_native is None:
                from rails_tpu_torch.native.host_lib import NativeSparseLU

                self._sinv_native = NativeSparseLU(self._a_scipy)
            return _host_solver(self._sinv_native, False, self.idx2, self.n)
        if method != "dense_lu":
            raise ValueError(f"unknown sinv method {method!r}")
        if self._sinv_factors is None:
            self._sinv_factors = torch.linalg.lu_factor(
                self._dense(self._a_scipy))
        lu, piv = self._sinv_factors

        def solve(x):
            rhs = torch.zeros((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            rhs[self._i2] = x
            if rhs.ndim == 1:
                return torch.linalg.lu_solve(lu, piv, rhs[:, None])[
                    self._i2, 0]
            return torch.linalg.lu_solve(lu, piv, rhs)[self._i2]

        return solve

    # -- full-space transforms ---------------------------------------------
    def restrict(self, x):
        """Full space -> reduced: x2 - A21 A11^{-1} x1 (RAILSschur.m:68-70)."""
        x = as_tensor(x, self.device, self.dtype)
        return x[self._i2] - self.A21.matmat(self.a11_solve(x[self._i1]))

    def prolongate(self, x):
        """Reduced -> full space: reorder([-A11^{-1} A12 x; x])
        (RAILSschur.m:72-74)."""
        x = as_tensor(x, self.device, self.dtype)
        out = torch.zeros((self.n,) + tuple(x.shape[1:]), dtype=x.dtype,
                          device=x.device)
        out[self._i1] = -self.a11_solve(self.A12.matmat(x))
        out[self._i2] = x
        return out

    def vtrans(self, v):
        """MATLAB Vtrans: restrict or prolongate by row count."""
        if v.shape[0] == self.n:
            return self.restrict(v)
        if v.shape[0] == self.n2:
            return self.prolongate(v)
        raise ValueError(f"size of v = {v.shape[0]}")

    # -- post-solution analysis --------------------------------------------
    def solution_operator(self, v, t) -> LinearOperator:
        """The full-space solution operator X_full reconstructed from
        X22 ~= V T V' (SchurOperator::Apply with hasSolution_,
        SchurOperator.cpp:235-296), for eigenvalue analysis:

          X22 = V T V',  X12 = -A11^{-1} A12 X22,  X21 = X12',
          X11 = A11^{-1} A12 X22 A12' A11^{-T}.
        """
        v = as_tensor(v, self.device, self.dtype)
        t = as_tensor(t, self.device, self.dtype)
        i1, i2 = self._i1, self._i2

        def x22(x2):
            return v @ (t @ (v.T @ x2))

        if self.n1 == 0:
            # nonsingular M: the full space IS the reduced space
            return CallableOperator(x22, (self.n, self.n),
                                    is_symmetric=True)

        def apply(x):
            x1 = x[i1]
            x22x = x22(x[i2])
            x12x = -self.a11_solve(self.A12.matmat(x22x))
            x21x = -x22(self.A12.rmatmat(self.a11_solve_t(x1)))
            x11x = -self.a11_solve(self.A12.matmat(x21x))
            out = torch.zeros_like(x)
            out[i1] = x11x + x12x
            out[i2] = x22x + x21x
            return out

        return CallableOperator(apply, (self.n, self.n), is_symmetric=True)

    def trace(self, v, t) -> torch.Tensor:
        """tr(X_full) = tr(T) + tr(T V' A12' A11^{-T} A11^{-1} A12 V)
        (SchurOperator::Trace, SchurOperator.cpp:298-342)."""
        v = as_tensor(v, self.device, self.dtype)
        t = as_tensor(t, self.device, self.dtype)
        if self.n1 == 0:  # nonsingular M: tr(X_full) = tr(T)
            return torch.trace(t)
        w = self.a11_solve(self.A12.matmat(v))
        g = v.T @ self.A12.rmatmat(self.a11_solve_t(w))
        return torch.trace(t) + torch.trace(t @ g)


def schur_reduce(a, m, b, **kw) -> SchurReduction:
    """RAILSschur equivalent: returns a SchurReduction; solve with
    ``rails_tpu_torch.solve(red.operator, red.bs, red.ms, ...)`` and map
    the basis back with ``red.vtrans(V)``."""
    return SchurReduction(a, m, b, **kw)
