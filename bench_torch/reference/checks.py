"""The float64 host checks that decide ``correct``: plain torch on the
CPU, scipy for the sparse LU and ``eigsh``.

For a low-rank solution X = V T V' of A X M' + M X A' + B B' = 0:

- ``true_residual``: ||R||_2 / ||B'B||_2 with R = A X M' + M X A' + B B',
  by power iteration on the factored R (the JAX bench's check,
  bench.py:829-851);
- ``galerkin``: ||V'RV||_F / ||V'B B'V||_F, computed from V, T and the
  inputs alone.  RAILS takes T as the solution of the projected
  equation on span(V), so V'RV vanishes up to the rounding of the
  precision the solve ran in: the number reaches the stated precision,
  where the residual, held to the tolerance, does not;
- ``rel_gap``: ||x - ref||_F / ||ref||_F, e.g. the solver's stored A V
  (what the SpMM kernel produced) against A V in float64;
- ``SchurHost``: the reduced operator S = A22 - A21 A11^-1 A12 and the
  full-space solution operator of the reference's SchurOperator
  (src/SchurOperator.cpp:201-296), A11 by scipy's splu; its leading
  eigenvalue by ``eigsh``.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla
import torch

from bench_torch.reference.problems import schur_blocks

F64 = torch.float64


def _t(x) -> torch.Tensor:
    return torch.as_tensor(np.asarray(x), dtype=F64)


def true_residual(av, mv, b, t, seed: int, iters: int = 60) -> float:
    """||AV T MV' + MV T AV' + B B'||_2 / ||B'B||_2 (float64; ``av`` = A V,
    ``mv`` = M V) by ``iters`` steps of power iteration from a start
    drawn from ``seed``."""
    av, mv, b, t = _t(av), _t(mv), _t(b), _t(t)

    def r_apply(x):
        return b @ (b.T @ x) + av @ (t @ (mv.T @ x)) \
            + mv @ (t @ (av.T @ x))

    gen = torch.Generator().manual_seed(seed)
    x = torch.randn((av.shape[0], 1), generator=gen, dtype=F64)
    x /= torch.linalg.norm(x)
    lam = 0.0
    for _ in range(iters):
        y = r_apply(x)
        lam = float(torch.linalg.norm(y))
        if lam == 0.0:
            break
        x = y / lam
    return lam / float(torch.linalg.matrix_norm(b.T @ b, 2))


def galerkin(av, mv, b, v, t) -> float:
    """||V'RV||_F / ||V'B B'V||_F in float64."""
    av, mv, b, v, t = _t(av), _t(mv), _t(b), _t(v), _t(t)
    ap, mp, bp = v.T @ av, v.T @ mv, v.T @ b
    c = bp @ bp.T
    g = ap @ t @ mp.T + mp @ t @ ap.T + c
    return float(torch.linalg.norm(g) / torch.linalg.norm(c))


def worse(a: float, b: float) -> float:
    """The larger of two readings; NaN, a reading that failed, wins."""
    return a if a != a else b if b != b else max(a, b)


def rel_gap(x, ref) -> float:
    x, ref = _t(x), _t(ref)
    return float(torch.linalg.norm(x - ref) / torch.linalg.norm(ref))


class SchurHost:
    """The reduced equation S X M22 + M22 X S' + B2 B2' = 0 of A, M =
    diag(md), and the full-space solution operator, in float64 on the
    host."""

    def __init__(self, a, md):
        self.n = a.shape[0]
        self.md = np.asarray(md, np.float64)
        self.i1, self.i2, self.blk = schur_blocks(a, self.md)
        self.lu = spla.splu(self.blk["A11"].tocsc())

    def s_apply(self, v):
        blk = self.blk
        return blk["A22"] @ v - blk["A21"] @ self.lu.solve(blk["A12"] @ v)

    def m22(self, v):
        return self.md[self.i2][:, None] * v

    def leading_eigenvalue(self, v, t, seed: int) -> float:
        """The largest-magnitude eigenvalue of the full-space X by
        ``eigsh`` (tol 1e-12), the start drawn from ``seed``."""
        i1, i2, a12, lu = self.i1, self.i2, self.blk["A12"], self.lu

        def x22(y):
            return v @ (t @ (v.T @ y))

        def xfull(x):
            x = np.asarray(x, np.float64).ravel()
            x22x = x22(x[i2])
            x12x = -lu.solve(a12 @ x22x)
            x21x = -x22(a12.T @ lu.solve(x[i1], trans="T"))
            x11x = -lu.solve(a12 @ x21x)
            out = np.empty(self.n)
            out[i1] = x11x + x12x
            out[i2] = x22x + x21x
            return out

        op = spla.LinearOperator((self.n, self.n), matvec=xfull,
                                 dtype=np.float64)
        v0 = np.random.default_rng(seed).standard_normal(self.n)
        lam = spla.eigsh(op, k=1, which="LM", tol=1e-12, v0=v0,
                         return_eigenvectors=False)
        return float(lam[0])
