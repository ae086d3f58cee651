"""Residual-corrected (iteratively refined) low-rank Lyapunov solves: the
counterpart of the JAX package's ``refine.py``, with the same algorithm.

A single float32 solve floors at a relative residual of about 1e-6: the
stored V/T factors carry about 7 significant digits.  Defect correction
at the level of the equation goes past it:

1. solve  A X0 M' + M X0 A' + B B' = 0  to a loose tolerance;
2. the residual of the stored factors is a signed low-rank form
   R(X0) = U S U'; compress it on the host in float64 (``residual_factor``,
   with A V and M V taken error-free through ``matmat2``);
3. solve the correction equation  A X1 M' + M X1 A' + U2 S2 U2' = 0  with
   the solver's signed right-hand side (``LyapunovSolver(b_sign=...)``)
   to a loose relative tolerance;
4. return the composed factors V = [V0 V1], T = blockdiag(T0, T1) (V is
   not orthonormal; X = V T V' does not need it).

Each stage works inside float32; the composition carries about 1e-10
relative residuals because each correction is stored separately instead
of being rounded into X0.  Verify the composed residual in float64 on
the host: recombining in float32 would bring the floor back.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rails_tpu_torch.core.options import SolverOptions
from rails_tpu_torch.core.solver import LyapunovSolver
from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["solve_refined", "RefineInfo", "residual_factor", "cholqr2"]


@dataclasses.dataclass
class RefineInfo:
    stages: list              # per-stage SolveInfo
    stage_res: list           # per-stage relative residual estimates
    res: float                # composed relative residual bound estimate
    converged: bool

    @property
    def iter(self) -> int:
        return sum(s.iter for s in self.stages)


def cholqr2(u: torch.Tensor, eps_rel: float = 0.0):
    """CholeskyQR2 of a tall-skinny block (two Gram products and two small
    Cholesky factorisations).  Returns (q, r) with u = q r; rank
    deficiency is regularised by a relative shift."""
    def one(w):
        g = w.T @ w
        g = 0.5 * (g + g.T)
        shift = (eps_rel if eps_rel > 0.0
                 else 10 * torch.finfo(w.dtype).eps) * torch.trace(g)
        g = g + shift * torch.eye(g.shape[0], dtype=w.dtype, device=w.device)
        c = torch.linalg.cholesky(g)
        qw = torch.linalg.solve_triangular(c, w.T, upper=False).T
        return qw, c.T

    with full_precision():
        q1, r1 = one(u)
        q2, r2 = one(q1)
        return q2, r2 @ r1


def _host64(x: torch.Tensor) -> np.ndarray:
    return x.detach().to("cpu", torch.float64).numpy()


def residual_factor(A: LinearOperator, M: Optional[LinearOperator],
                    b_arr: torch.Tensor, b_sign, v: torch.Tensor,
                    t: torch.Tensor, drop_rel: float = 1e-9):
    """Compress R(X0) = A V T V' M' + M V T V' A' + B S B' into (U2, S2),
    U2 with orthonormal columns (rounded once to float32) and S2 the
    refitted signed core, on the host in float64.

    A V and M V are taken error-free on the device (``matmat2``: hi + lo
    is the exact product) and recombined in float64.  Every stored piece
    is a numerically evaluated part of R0 at R0's own scale (S_VV =
    V'R0V, Z = P_perp R0 V, the perp-perp coefficients over an orthonormal
    complement basis Q), so no large blocks cancel.  S2 is refitted by
    float64 normal equations against the basis exactly as stored, so the
    returned representation error is measured.

    Returns (U2 tensor on v's device in v's dtype, S2 tensor, rep_err,
    ||R0||_2)."""
    import scipy.linalg as sla

    k = v.shape[1]
    p = b_arr.shape[1]

    def apply64(op):
        if hasattr(op, "matmat2"):
            hi, lo = op.matmat2(v)
            return _host64(hi) + _host64(lo)
        # no error-free apply: this product's float32 rounding becomes
        # the accuracy floor
        return _host64(op.matmat(v))

    v64 = _host64(v)
    b64 = _host64(b_arr)
    t64 = _host64(t)
    av64 = apply64(A)
    w64 = apply64(M) if M is not None else None
    # re-orthonormalise V in f64: V = Vq Rv, X0 = Vq (Rv T Rv') Vq'
    vq, rv = np.linalg.qr(v64)
    tq = rv @ t64 @ rv.T
    avq = sla.solve_triangular(rv.T, av64.T, lower=True).T   # A @ Vq
    ga = vq.T @ avq
    ca = avq - vq @ ga                     # P_perp A Vq
    if M is not None:
        wq = sla.solve_triangular(rv.T, w64.T, lower=True).T
        gw = vq.T @ wq
        cw = wq - vq @ gw
    else:
        gw = np.eye(k)
        cw = None
    sp0 = np.eye(p) if b_sign is None else _host64(torch.as_tensor(b_sign))
    bv = vq.T @ b64
    bperp = b64 - vq @ bv
    s_vv = ga @ tq @ gw.T + gw @ tq @ ga.T + bv @ sp0 @ bv.T
    z = ca @ (tq @ gw.T) + bperp @ (sp0 @ bv.T)
    if cw is not None:
        z = z + cw @ (tq @ ga.T)
    # orthonormal complement basis Q of [Z, Ca, (Cw,) Bperp] by a
    # rank-revealing QR of the column-normalised blocks
    pool = [z, ca, bperp] if cw is None else [z, ca, cw, bperp]
    pool = np.concatenate(pool, axis=1)
    nrm = np.linalg.norm(pool, axis=0)
    pool = pool / np.where(nrm > 0, nrm, 1.0)[None, :]
    qq, rr, _ = sla.qr(pool, mode="economic", pivoting=True)
    rdiag = np.abs(np.diag(rr))
    qrank = int((rdiag > 1e-12 * max(rdiag[0], np.finfo(float).tiny)).sum())
    qmat = qq[:, :qrank]
    cz = qmat.T @ z
    c_bp = qmat.T @ bperp
    nx = k + qrank
    s_x = np.zeros((nx, nx))
    s_x[:k, :k] = 0.5 * (s_vv + s_vv.T)
    s_x[k:, :k] = cz
    s_x[:k, k:] = cz.T
    s_perp = c_bp @ sp0 @ c_bp.T
    if cw is not None:
        cross = (qmat.T @ ca) @ tq @ (qmat.T @ cw).T
        s_perp = s_perp + cross + cross.T
    s_x[k:, k:] = 0.5 * (s_perp + s_perp.T)
    x64 = np.concatenate([vq, qmat], axis=1)
    lam, w = np.linalg.eigh(s_x)
    order = np.argsort(-np.abs(lam))
    lam = lam[order]
    w = w[:, order]
    scale = max(abs(lam[0]), np.finfo(np.float64).tiny)
    keep = np.abs(lam) > drop_rel * scale
    u2_64 = x64 @ w[:, keep]               # f64 basis, then round once
    u2r = u2_64.astype(np.float32).astype(np.float64)
    # refit S2 to the rounded basis: Lam = H^-1 (U2' R0 U2) H^-1 with
    # U2' R0 U2 = K' S_X K, K = X' U2
    h = u2r.T @ u2r
    kmat = x64.T @ u2r
    hinv = np.linalg.inv(h)
    lam2 = hinv @ (kmat.T @ s_x @ kmat) @ hinv
    lam2 = 0.5 * (lam2 + lam2.T)
    # measured representation error ||R0 - U2 Lam2 U2'||_F, term by term
    # at each term's own scale: the dropped tail, the refit drift, and
    # the (known) float32 rounding delta of the basis
    delta = u2r - u2_64
    drop_tail = float(np.sqrt((lam[~keep] ** 2).sum()))
    t_fit = float(np.linalg.norm(lam2 - np.diag(lam[keep])))
    c1 = u2_64 @ lam2
    dtd = delta.T @ delta
    t2 = np.sqrt(max(np.trace((c1.T @ c1) @ dtd), 0.0))
    t3 = np.sqrt(max(np.trace(lam2 @ dtd @ lam2 @ dtd), 0.0))
    rep_err = float(drop_tail + t_fit + 2.0 * t2 + t3)
    r_norm2 = float(abs(lam[0])) if len(lam) else 0.0   # ||R0||_2
    u2 = torch.from_numpy(u2r).to(v.device, v.dtype)
    return u2, torch.from_numpy(lam2).to(v.device, v.dtype), rep_err, r_norm2


def solve_refined(a, b, m=None, *, tol: float = 1e-8,
                  stage_tol: float = 1e-5, max_stages: int = 3,
                  drop_rel: float = 1e-9, compiled: bool = False,
                  progress=None, options: Optional[SolverOptions] = None,
                  device=None, draws=None, **opt_kwargs):
    """Solve A X M' + M X A' + B B' = 0 to ``tol`` relative residual by
    staged defect correction (see the module docstring).

    Runs on ``device`` (default ``cuda``); every stage's
    ``LyapunovSolver`` gets the same options, ``device`` and ``draws``
    hook.  The solve dtype is fixed by the first stage (``dtype`` in the
    options, else B's).  Returns (V, T, RefineInfo) with X = V T V', V
    the concatenated stage bases (not orthonormal), T block-diagonal."""
    base = dataclasses.asdict(options) if options is not None else {}
    base.update(opt_kwargs)
    base.pop("tol", None)
    kw = dict(device=device, draws=draws)

    # the first stage fixes the operators (moved and cast once), the
    # dtype and the normalisation of the original equation
    solver0 = LyapunovSolver(a, b, m, tol=min(stage_tol, tol), **kw, **base)
    base["dtype"] = solver0.dtype
    A, Mop = solver0.A, solver0.M
    b_arr = solver0._b_array
    if b_arr is None:
        raise TypeError("solve_refined takes B as an array, not an operator")
    r0sq = float(solver0._b_norm2sq())

    vs, ts = [], []
    stages, stage_res = [], []
    cur_b, cur_sign = b_arr, None
    cur_scale = 1.0          # ||current RHS|| / ||B B'||
    drop_abs = 0.0           # accumulated compression drop (relative)
    total = 1.0              # composed relative residual bound
    converged = False
    for stage in range(max_stages):
        # the looser of stage_tol and what the composition needs
        want = tol / max(cur_scale, np.finfo(np.float32).tiny)
        stage_tol_i = max(stage_tol, min(want, 0.5))
        solver = LyapunovSolver(A, cur_b, Mop, b_sign=cur_sign,
                                tol=stage_tol_i, **kw, **base)
        v_i, t_i, info = solver.solve(compiled=compiled, progress=progress)
        stages.append(info)
        vs.append(v_i)
        ts.append(t_i)
        total = float(info.res) * cur_scale + drop_abs
        stage_res.append(total)
        if total <= tol or not np.isfinite(total):
            converged = total <= tol
            break
        if stage == max_stages - 1:
            break
        # the next stage's right-hand side: this stage's residual (the
        # stage solutions telescope, up to the measured compression drop)
        u2, s2, rep_err, r_norm = residual_factor(
            solver.A, solver.M, cur_b.to(v_i.dtype), cur_sign, v_i, t_i,
            drop_rel=drop_rel)
        cur_b, cur_sign = u2, s2
        drop_abs += rep_err / r0sq
        cur_scale = r_norm / r0sq

    info = RefineInfo(stages=stages, stage_res=stage_res,
                      res=stage_res[-1], converged=converged)
    return torch.cat(vs, dim=1), torch.block_diag(*ts), info
