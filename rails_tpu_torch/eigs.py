"""Large-scale eigensolvers - the counterpart of the JAX package's
``eigs.py`` (the Anasazi BlockKrylovSchur role).

The reference computes the dominant eigenpairs of the (symmetric) solution
operator with Anasazi's block Krylov-Schur
(src/Epetra_OperatorWrapper.cpp:147-222), dropping eigenvalues below a
tolerance.  Here, as in the JAX package: thick-restarted (block) Lanczos
with full reorthogonalization for a symmetric operator (``eigs``), and
thick-restarted (block) Arnoldi on a complex basis for a general one
(``eigs_general``).  A sweep extends the basis to L columns on the
device; restarts and the convergence test run on the host between
sweeps.

Random directions come from a ``torch.Generator`` (default: seeded with
0 on the solve's device), where the JAX package splits
``jax.random.PRNGKey(0)``: the two give other numbers, so the two
packages agree on converged pairs, not iterate by iterate.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Optional

import numpy as np
import torch

from rails_tpu_torch.linalg.dense_lyap import schur_factors
from rails_tpu_torch.operators import LinearOperator
from rails_tpu_torch.parallel.comm import psum, row_norm
from rails_tpu_torch.utils.device import resolve_device
from rails_tpu_torch.utils.dtypes import complex_dtype_for, full_precision

__all__ = ["eigs", "eigs_general", "EigsInfo", "EigsConvergenceWarning"]


class EigsConvergenceWarning(UserWarning):
    """Emitted when the eigensolver exhausts its restarts with
    unconverged pairs - the role of Anasazi's returned solver status."""


@dataclasses.dataclass
class EigsInfo:
    """Convergence report (the Anasazi status equivalent)."""

    converged: bool            # all requested pairs converged
    n_converged: int           # leading converged pairs
    restarts: int              # sweeps/restarts performed
    residuals: np.ndarray      # ||A v - lambda v|| per returned pair


def _setup(op, dtype, device, generator):
    if not isinstance(op, LinearOperator):
        raise TypeError("eigs expects a LinearOperator (wrap callables with "
                        "CallableOperator)")
    dtype = dtype or op.payload_dtype or torch.get_default_dtype()
    dev = resolve_device(device or op.payload_device)
    if generator is None:
        generator = torch.Generator(dev).manual_seed(0)
    return op.shape[0], dtype, dev, generator


def _keep_count(num, L, mags):
    """Thick restart: keep the leading num + a few Ritz vectors, never
    cutting through a cluster of (near-)equal modulus (a degenerate
    eigenspace, or a complex-conjugate pair)."""
    keep = min(num + max(num // 2, 3), L - 2)
    while keep < L - 2 and mags[keep] > (1 - 1e-8) * mags[keep - 1]:
        keep += 1
    return keep


def _n_converged(resid, tol, scale):
    n_conv = 0
    for r in resid:
        if r > tol * scale:
            break
        n_conv += 1
    return n_conv


def eigs(op: LinearOperator, num: int = 6, *, tol: float = 1e-8,
         max_restarts: int = 100, subspace: Optional[int] = None,
         drop_tol: Optional[float] = None, block_size: int = 1,
         generator: Optional[torch.Generator] = None, dtype=None,
         device=None, return_info: bool = False, mesh=None):
    """Largest-|lambda| eigenpairs of a symmetric operator.

    Returns (eigenvalues, eigenvectors) sorted by |lambda| descending
    (plus an EigsInfo when ``return_info=True``).  ``drop_tol`` mirrors
    the reference's filtering of converged eigenvalues with
    |lambda| <= tol * |lambda_max| (Epetra_OperatorWrapper.cpp:205-218).
    Emits EigsConvergenceWarning if restarts are exhausted before the
    requested pairs converge.

    ``block_size=b`` builds the band-Lanczos space K(A, [v1..vb]) - each
    new column is A applied to the column b back - which represents
    eigenvalue multiplicity up to b directly (Anasazi's "Block Size").
    ``generator`` draws the random directions; ``device`` (default: the
    mesh's device, else the operator's payload device, else ``cuda``) is
    where the basis lives.  ``mesh``: the row mesh the operator applies
    over (``parallel/mesh.py``); the JAX package places the basis
    row-sharded on it, which on a one-device mesh needs no placement.
    On a multi-process mesh the operator applies to this process's rows
    (a halo operator, a ``LowRankOperator`` with ``comm``): the basis
    holds this process's rows of the whole random draws, its Gram, norm
    and Rayleigh reductions are summed over the processes, the
    eigenvalues are the same on every process and the eigenvectors come
    back as this process's rows.
    """
    if mesh is not None and device is None:
        device = mesh.device
    comm = None if mesh is None else mesh.comm
    m, dtype, dev, gen = _setup(op, dtype, device, generator)
    r0, r1 = (0, m) if comm is None else mesh.local_range(m)
    num = min(num, m)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    b = min(block_size, m)
    if subspace is None:
        subspace = min(m, max(2 * num + 10, 20, 4 * b))
    # a subspace barely larger than num cannot host a thick restart:
    # grow it (capped by m, where the sweep is exact anyway)
    L = min(m, max(subspace, num + 2, num + b + 1))
    eps = float(torch.finfo(dtype).eps)

    def randn():
        return torch.randn(m, generator=gen, dtype=dtype, device=dev)[r0:r1]

    def sweep(basis, nb):
        """Extend an orthonormal basis (m, L) holding nb valid columns by
        (band-)Lanczos with full reorthogonalization to L columns; return
        the Ritz vectors, their images, the Ritz values and residuals."""
        q = basis.clone()
        for j in range(L):
            # kept Ritz columns pass through; new columns are A applied to
            # the column b back; starting-block columns with no column b
            # back are fresh random directions
            rnd = randn()
            if j < nb:
                col = q[:, j]
            elif j < b:
                col = rnd
            else:
                col = op.matmat(q[:, j - b:j - b + 1])[:, 0]
            qm = q[:, :j]
            for _ in range(2):
                col = col - qm @ psum(comm, qm.T @ col)
            small = row_norm(comm, col) < eps * 100
            col = torch.where(small, rnd, col)
            for _ in range(2):
                col = col - qm @ psum(comm, qm.T @ col)
            q[:, j] = col / row_norm(comm, col)
        aq = op.matmat(q)
        g = psum(comm, q.T @ aq)
        g = 0.5 * (g + g.T)
        evals, evecs = torch.linalg.eigh(g)
        order = torch.argsort(-torch.abs(evals))
        evals, evecs = evals[order], evecs[:, order]
        ritz = q @ evecs
        resid = row_norm(comm, aq @ evecs - ritz * evals[None, :], dim=0)
        return ritz, evals, resid

    with full_precision():
        basis = torch.zeros((r1 - r0, L), dtype=dtype, device=dev)
        nb = 0
        converged = False
        restart = 0
        for restart in range(max(1, max_restarts)):
            ritz, evals, resid = sweep(basis, nb)
            ev = evals.detach().cpu().numpy()
            rs = resid.detach().cpu().numpy()
            scale = max(abs(float(ev[0])), eps)
            if (rs[:num] <= tol * scale).all():
                converged = True
                break
            if L >= m:
                # full-space sweep = dense eigh of Q'AQ with Q square:
                # exact up to roundoff; the residual tolerance may simply
                # be unattainable - do not spin
                converged = bool((rs[:num] <= np.sqrt(eps) * scale).all())
                break
            # converged leading pairs ride along locked in the kept block
            keep = _keep_count(num, L, np.abs(ev))
            basis[:, :keep] = ritz[:, :keep]
            nb = keep

    resid_out = rs[:num]
    scale = float(max(abs(float(ev[0])), eps))
    n_conv = _n_converged(resid_out, tol, scale)
    if not converged:
        warnings.warn(
            f"eigs: {num - n_conv} of {num} requested eigenpairs did not "
            f"converge to tol={tol:g} in {restart + 1} restarts "
            f"(max residual {resid_out.max():.3e}, scale {scale:.3e})",
            EigsConvergenceWarning)
    evals = evals[:num]
    evecs = ritz[:, :num]
    if drop_tol is not None:
        keep_mask = np.abs(ev[:num]) > drop_tol * abs(float(ev[0]))
        mask = torch.as_tensor(keep_mask, device=dev)
        evals, evecs = evals[mask], evecs[:, mask]
        resid_out = resid_out[keep_mask]
    if return_info:
        info = EigsInfo(converged=converged, n_converged=n_conv,
                        restarts=restart + 1, residuals=resid_out)
        return evals, evecs, info
    return evals, evecs


def _small_eig(h: torch.Tensor):
    """Eigenpairs of a small dense complex matrix via Schur
    (``linalg/dense_lyap.schur_factors``: LAPACK's zgees on the host, as
    the JAX package takes it on the CPU) + protected back-substitution
    on the triangular factor (the LAPACK ztrevc scheme).  For the
    eigenvalue at Schur position i, solve
    (T[:i,:i] - lam_i) y[:i] = -T[:i, i] with y[i] = 1, y[i+1:] = 0;
    near-singular pivots are pushed off zero along their phase, first at
    an eps floor, then at sqrt(eps), then the Schur vector itself (a
    cluster of c coincident values grows y like (scale/floor)^c)."""
    t, u = schur_factors(h)
    lam = torch.diagonal(t)
    k = h.shape[0]
    rdt = lam.real.dtype
    eps_t = torch.finfo(rdt).eps
    t_scale = torch.max(torch.abs(t)) + torch.finfo(rdt).tiny
    idx = torch.arange(k, device=h.device)
    eye = torch.eye(k, dtype=h.dtype, device=h.device)
    # batch over i: d_i = T - lam_i I, restricted to the leading i x i
    d = t[None, :, :] - lam[:, None, None] * eye[None]
    inner = (idx[None, :, None] < idx[:, None, None]) & \
        (idx[None, None, :] < idx[:, None, None])
    rhs = torch.where(idx[None, :] < idx[:, None], -t.T,
                      (idx[None, :] == idx[:, None]).to(h.dtype))

    def solve(tiny):
        dj = torch.diagonal(d, dim1=1, dim2=2)
        mag = torch.abs(dj)
        phase = torch.where(mag > 0, dj / torch.where(mag > 0, mag,
                                                      torch.ones_like(mag)),
                            torch.ones_like(dj))
        dj_safe = torch.where(mag < tiny, tiny * phase, dj)
        dd = d - torch.diag_embed(dj) + torch.diag_embed(dj_safe)
        dt = torch.where(inner, dd, eye[None])
        return torch.linalg.solve_triangular(dt, rhs[:, :, None],
                                             upper=True)[:, :, 0]

    y1 = solve(eps_t * t_scale)
    y2 = solve(eps_t ** 0.5 * t_scale)
    ok1 = torch.isfinite(torch.view_as_real(y1)).all(dim=(1, 2))
    ok2 = torch.isfinite(torch.view_as_real(y2)).all(dim=(1, 2))
    y = torch.where(ok1[:, None], y1, torch.where(ok2[:, None], y2, eye))
    vecs = u @ y.T
    nrm = torch.linalg.norm(vecs, dim=0, keepdim=True)
    return lam, vecs / torch.where(nrm > 0, nrm, torch.ones_like(nrm))


def _conjugate_order(lam: torch.Tensor, rtol: float = 1e-8) -> torch.Tensor:
    """The order of ``lam`` by descending modulus, each conjugate pair
    with its + imaginary member first (a pair's moduli tie up to
    roundoff, which would otherwise pick the member that ``num`` keeps
    when it splits the pair; the JAX package returns the + member)."""
    order = torch.argsort(-torch.abs(lam))
    z = lam[order].detach().cpu().numpy()
    idx = order.cpu().numpy().copy()
    tol = rtol * (abs(z[0]) if z.size else 0.0)
    i = 0
    while i + 1 < z.size:
        if z[i].imag < 0 < z[i + 1].imag \
                and abs(z[i] - np.conj(z[i + 1])) <= tol:
            idx[i], idx[i + 1] = idx[i + 1], idx[i]
            i += 2
        else:
            i += 1
    return torch.as_tensor(idx, device=lam.device)


def eigs_general(op: LinearOperator, num: int = 6, *,
                 max_restarts: int = 60, subspace: Optional[int] = None,
                 tol: float = 1e-8, block_size: int = 1,
                 generator: Optional[torch.Generator] = None, dtype=None,
                 device=None, return_info: bool = False):
    """Largest-|lambda| eigenpairs of a general (nonsymmetric) operator
    via thick-restarted (block) Arnoldi on a complex basis, with real
    random directions (so complex pairs of a real operator enter
    together).  Each sweep extends the basis with full
    reorthogonalization, forms G = Q^H A Q and solves it with the port's
    complex Schur plus protected back-substitution; restarts keep an
    orthonormal basis of the leading Ritz subspace.

    Returns complex (eigenvalues, eigenvectors), |lambda| descending,
    the + imaginary member of a conjugate pair first, so that a pair
    split by ``num`` gives its + member as the JAX package does (plus an
    EigsInfo when ``return_info=True``); warns with
    EigsConvergenceWarning on restart exhaustion.
    """
    m, dtype, dev, gen = _setup(op, dtype, device, generator)
    num = min(num, m)
    if block_size < 1:
        raise ValueError(f"block_size must be >= 1, got {block_size}")
    b = min(block_size, m)
    L = subspace or min(m, max(4 * num + 20, 30, 4 * b))
    L = min(m, max(L, num + 2, num + b + 1))
    eps = float(torch.finfo(dtype).eps)
    cdtype = complex_dtype_for(dtype)

    def apply_c(z):
        return torch.complex(op.matmat(z.real.contiguous()),
                             op.matmat(z.imag.contiguous()))

    def sweep(basis, nb):
        q = basis.clone()
        for j in range(L):
            rnd = torch.randn(m, generator=gen, dtype=dtype,
                              device=dev).to(cdtype)
            if j < nb:
                col = q[:, j]
            elif j < b:
                col = rnd
            else:
                col = apply_c(q[:, j - b:j - b + 1])[:, 0]
            qm = q[:, :j]
            for _ in range(2):
                col = col - qm @ (qm.conj().T @ col)
            small = torch.linalg.norm(col) < eps * 100
            col = torch.where(small, rnd, col)
            for _ in range(2):
                col = col - qm @ (qm.conj().T @ col)
            q[:, j] = col / torch.linalg.norm(col)
        aq = apply_c(q)
        return q, aq, q.conj().T @ aq

    with full_precision():
        basis = torch.zeros((m, L), dtype=cdtype, device=dev)
        nb = 0
        converged = False
        restart = 0
        for restart in range(max(1, max_restarts)):
            q, aq, g = sweep(basis, nb)
            lam, svecs = _small_eig(g)
            order = _conjugate_order(lam)
            lam, svecs = lam[order], svecs[:, order]
            ritz_all = q @ svecs
            nr = torch.linalg.norm(ritz_all, dim=0, keepdim=True)
            nr = torch.where(nr > 0, nr, torch.ones_like(nr))
            ritz_all = ritz_all / nr
            aritz = aq @ (svecs / nr)
            rnorm = torch.linalg.norm(
                aritz[:, :num] - ritz_all[:, :num] * lam[None, :num], dim=0)
            best = (lam[:num], ritz_all[:, :num])
            lam_abs = torch.abs(lam).detach().cpu().numpy()
            rn = rnorm.detach().cpu().numpy()
            scale = float(lam_abs[0]) + 1e-300
            conv = rn <= tol * scale
            if conv.all() or L >= m:
                # L >= m: the factorization is exact up to roundoff;
                # accept sqrt(eps)-level residuals rather than spinning
                converged = bool(conv.all()) or (
                    L >= m and bool((rn <= np.sqrt(eps) * scale).all()))
                break
            keep = _keep_count(num, L, lam_abs)
            kq, _ = torch.linalg.qr(ritz_all[:, :keep])
            basis = torch.zeros((m, L), dtype=cdtype, device=dev)
            basis[:, :keep] = kq
            nb = keep
    n_conv = _n_converged(rn, tol, scale)
    if not converged:
        warnings.warn(
            f"eigs_general: {num - n_conv} of {num} requested eigenpairs "
            f"did not converge to tol={tol:g} in {restart + 1} restarts "
            f"(max residual {rn.max():.3e}, scale {scale:.3e})",
            EigsConvergenceWarning)
    if return_info:
        info = EigsInfo(converged=converged, n_converged=n_conv,
                        restarts=restart + 1, residuals=rn)
        return best[0], best[1], info
    return best
