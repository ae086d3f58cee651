"""Dense (projected) continuous-time Lyapunov solvers in PyTorch - the
counterpart of the JAX package's ``linalg/dense_lyap.py``.

Solves the k-by-k dense equation

    A @ X @ E' + E @ X @ A' + C = 0        (E = I when e is None)

which is the role SLICOT's ``sb03md`` (standard) and ``sg03ad``
(generalized) play in the reference.  The methods are the JAX package's:

- ``eigh``: symmetric A.  ``A = Q diag(w) Q'`` then
  ``X = -Q ((Q'CQ) / (w_i + w_j)) Q'``.
- ``schur``: general A.  The real Schur form (dgees) and the real
  trsyl for the whole Bartels-Stewart step, on the host, as SLICOT's
  ``sb03md`` solves: PyTorch has no Schur, so the factor comes from
  LAPACK through scipy, on every device.  The JAX package takes the
  complex form (zgees) on the CPU and its own QR sweeps on the TPU.
- ``sign``: Newton iteration for the matrix sign function, Hurwitz A.
- ``kron``: O(k^6) Kronecker linear solve; robust oracle and small-k
  fallback.

All methods accept an optional nonsingular ``e`` and reduce the
generalized equation to standard form (eigenvalue-clipped congruence for
SPD or symmetric E, E^{-1} otherwise) after a symmetric diagonal
balancing, followed by residual-tracked refinement on the generalized
residual.

Spans (``timer.span``): ``DenseLyap/host_schur`` around the host's LAPACK
work: each Schur factor (dgees, sgees at float32; its copy from the
device included) and each solve (the real trsyl and its round trip);
``lyap``'s refinement arithmetic lies outside it.  Each holds one child
that names the work: ``DenseLyap/host_schur/zgees`` around a factor
(the name the benchmark reads), ``DenseLyap/host_schur/trsyl`` around a
solve's round trip.
"""

from __future__ import annotations

import functools
from typing import Optional

import scipy.linalg
import torch

from rails_tpu_torch.timer import span
from rails_tpu_torch.utils.dtypes import highest_precision
from rails_tpu_torch.utils.host_blas import single_thread_blas

__all__ = ["lyap", "lyap_residual", "DenseCalls", "CaptureCalls"]


class DenseCalls:
    """The dense factorizations of the eigh, sign and kron routes, as
    ``lyap`` makes them: PyTorch's ``torch.linalg`` calls, which check
    LAPACK's ``info`` on the host (a device synchronisation on the card)
    and raise on failure."""

    def eigh(self, a):
        return torch.linalg.eigh(a)

    def inv(self, a):
        return torch.linalg.inv(a)

    def slogdet(self, a):
        return torch.linalg.slogdet(a)

    def solve(self, a, b):
        return torch.linalg.solve(a, b)

    def cholesky(self, a):
        return torch.linalg.cholesky(a)


class CaptureCalls(DenseCalls):
    """The same calls inside a recorded iteration (``core/engine.py``):
    the ``_ex`` forms, which leave ``info`` on the device and capture into
    a CUDA graph (a failed factorization gives non-finite values, which
    the solver's blowup test turns into status -2, as in the JAX package);
    ``eigh`` as a host step of the recording, since neither
    ``torch.linalg.eigh`` nor cuSOLVER's syevd or syevj capture on the
    card (``rails_tpu_torch/capture_audit.py``)."""

    def __init__(self, host):
        self.host = host

    def eigh(self, a):
        return self.host(torch.linalg.eigh, a, name="eigh")

    def inv(self, a):
        return torch.linalg.inv_ex(a)[0]

    def solve(self, a, b):
        return torch.linalg.solve_ex(a, b)[0]

    def cholesky(self, a):
        return torch.linalg.cholesky_ex(a)[0]


EAGER_CALLS = DenseCalls()


def _sym(x):
    return 0.5 * (x + x.mH) if torch.is_complex(x) else 0.5 * (x + x.T)


def _balance_scaling(e):
    """Symmetric diagonal balancing D: D E D has unit-ish diagonal, which
    collapses the dynamic range of graded mass matrices before any
    factorization sees them.  Entries with negligible diagonal fall back
    to the global scale so D stays bounded."""
    fi = torch.finfo(e.dtype)
    de = torch.abs(torch.diagonal(e))
    dmax = torch.max(de) + fi.tiny
    return torch.rsqrt(torch.maximum(de, fi.eps * dmax))


def _reduce_generalized(a, c, e, e_kind: str):
    """Reduce A X E' + E X A' + C = 0 to standard form At Y + Y At' + Ct
    = 0.  Returns (at, c_fwd, back): ``c_fwd`` maps a symmetric right-hand
    side into the reduced space, ``back`` maps a reduced solution to X.

    - 'spd': E = Q diag(lam) Q', Z = Q diag(max(lam, delta))^{-1/2}, so
      Z'EZ = I (multiplication-only; keeps A symmetric).
    - 'symmetric' (indefinite allowed): the sign congruence,
      Z = Q |lam|_clip^{-1/2}, S = sign(lam), A2 = S (Z'AZ),
      C2 = S (Z'CZ) S.
    - general: At = E^{-1} A, Ct = E^{-1} C E^{-T}, X = Y.
    """
    fi = torch.finfo(e.dtype)
    if e_kind in ("spd", "symmetric"):
        lam, q = torch.linalg.eigh(_sym(e))
        delta = 10 * fi.eps * (torch.max(torch.abs(lam)) + fi.tiny)
        if e_kind == "spd":
            z = q * torch.rsqrt(torch.maximum(lam, delta))[None, :]
            at = z.T @ a @ z

            def c_fwd(cc):
                return _sym(z.T @ cc @ z)

            def back(y):
                return z @ y @ z.T

            return at, c_fwd, back

        s = torch.where(lam < 0, -1.0, 1.0).to(e.dtype)
        z = q * torch.rsqrt(torch.maximum(torch.abs(lam), delta))[None, :]
        at = s[:, None] * (z.T @ a @ z)

        def c_fwd(cc):
            return _sym(s[:, None] * (z.T @ cc @ z) * s[None, :])

        def back(y):
            return z @ y @ z.T

        return at, c_fwd, back

    at = torch.linalg.solve(e, a)

    def c_fwd(cc):
        return _sym(torch.linalg.solve(e, torch.linalg.solve(e, cc).T).T)

    return at, c_fwd, lambda y: y


def _eigh_factor(a, calls=EAGER_CALLS):
    """Factored solver for symmetric A: one eigh, then each solve is two
    matmuls and a Cauchy scaling."""
    w, q = calls.eigh(_sym(a))
    denom = w[:, None] + w[None, :]
    # a zero denominator means a singular Lyapunov operator: those modes
    # are zeroed (pseudo-inverse); callers can check the residual
    eps = torch.finfo(denom.dtype).eps * (torch.max(torch.abs(w)) + 1.0)
    bad = torch.abs(denom) < eps
    denom = torch.where(bad, torch.ones_like(denom), denom)

    def solve(c):
        ct = q.T @ c @ q
        xt = torch.where(bad, torch.zeros_like(ct), -ct / denom)
        return q @ xt @ q.T

    return solve


def _lapack_schur(a: torch.Tensor, output: str = "complex"):
    """LAPACK's Schur form of a tensor on the host, on one BLAS thread:
    numpy (t, u) with a = u t u^H.  ``output`` "complex": zgees (cgees at
    single precision); "real", of a real tensor: dgees (sgees), t
    quasi-triangular.  scipy factors a copy: a CPU tensor's memory is
    the array's."""
    a = a.detach().cpu().numpy()
    with single_thread_blas():
        return scipy.linalg.schur(a, output=output, check_finite=False)


def schur_factors(a: torch.Tensor):
    """Complex Schur factors (t, u) of a complex tensor: zgees (cgees) on
    the host, the factors moved to a's device."""
    t, u = _lapack_schur(a)
    return (torch.from_numpy(t).to(a.device),
            torch.from_numpy(u).to(a.device))


def _schur_factor(a):
    """General A: the real Schur form A = U T U' (T quasi-upper
    triangular, a 2 x 2 block for each complex-conjugate pair) by dgees
    (sgees at float32), then T Y + Y T' = G by the real trsyl and X =
    U Y U', all on the host in a's own real dtype, as SLICOT's sb03md
    solves, whatever a's device; each solve moves C there and X back."""
    with span("DenseLyap", "host_schur"), \
            span("DenseLyap", "host_schur", "zgees"):
        t, u = _lapack_schur(a, "real")
    trsyl = scipy.linalg.get_lapack_funcs("trsyl", (t,))

    def solve(c):
        with span("DenseLyap", "host_schur"), \
                span("DenseLyap", "host_schur", "trsyl"):
            c = c.detach().cpu().numpy().astype(t.dtype)
            with single_thread_blas():
                y, scale, _ = trsyl(t, t, -(u.T @ c @ u), trana="N",
                                    tranb="T")
                x = u @ (y / scale) @ u.T
            return _sym(torch.from_numpy(x).to(a.device))

    return solve


def _lyap_sign(a, c, iterations: int = 30, calls=EAGER_CALLS):
    """Newton sign iteration (Hurwitz A only), with determinant scaling:
    Z <- (s Z + (s Z)^{-1}) / 2, Q <- (s Q + (s Z)^{-T} Q (s Z)^{-1}) / 2.
    At convergence Z -> sign(A) = -I and X = Q_inf / 2."""
    k = a.shape[0]
    z, q = a, c
    for _ in range(iterations):
        zinv = calls.inv(z)
        _, logdet = calls.slogdet(z)
        s = torch.exp(-logdet / k)
        s = torch.where(torch.isfinite(s) & (s > 0), s, torch.ones_like(s))
        z_new = 0.5 * (s * z + zinv / s)
        q = _sym(0.5 * (s * q + (zinv @ q @ zinv.T) / s))
        z = z_new
    return _sym(0.5 * q)


def _lyap_kron(a, c, e=None, calls=EAGER_CALLS):
    """Row-major Kronecker solve: (a (x) e + e (x) a) rvec(x) = -rvec(c)."""
    k = a.shape[0]
    if e is None:
        e = torch.eye(k, dtype=a.dtype, device=a.device)
    big = torch.kron(a, e) + torch.kron(e, a)
    x = calls.solve(big, -c.reshape(-1))
    return _sym(x.reshape(k, k))


@highest_precision
def lyap(a: torch.Tensor, c: torch.Tensor, e: Optional[torch.Tensor] = None,
         *, method: str = "schur", assume_e_spd: bool = False,
         e_kind: Optional[str] = None, sign_iterations: int = 30,
         refine: Optional[int] = None,
         refine_generalized: Optional[int] = None,
         calls: DenseCalls = EAGER_CALLS) -> torch.Tensor:
    """Solve A X E' + E X A' + C = 0 for symmetric X.

    Args:
      a: (k, k) real matrix.
      c: (k, k) real symmetric matrix.
      e: optional (k, k) nonsingular matrix (generalized equation).
      method: 'schur' (general A), 'eigh' (symmetric A), 'sign' (Hurwitz
        A), or 'kron' (small-k robust fallback / oracle).
      assume_e_spd: alias for ``e_kind='spd'``.
      e_kind: 'general' (default), 'spd', or 'symmetric' (indefinite E
        allowed; see ``_reduce_generalized``).
      refine: rounds of refinement with the cached factorization
        (default 1 at float32, 0 at float64).
      refine_generalized: rounds of residual-tracked refinement on the
        generalized residual (default 8 for a general E, 2 for an SPD or
        symmetric one, 0 without E); the best iterate is kept and the loop
        stops when a round improves the residual by less than 10%.
    """
    if a.ndim != 2 or a.shape[0] != a.shape[1]:
        raise ValueError(f"a must be square, got {tuple(a.shape)}")
    if e_kind is None:
        e_kind = "spd" if assume_e_spd else "general"
    if e_kind not in ("general", "spd", "symmetric"):
        raise ValueError(f"unknown e_kind {e_kind!r}")
    if refine is None:
        refine = 1 if a.dtype == torch.float32 else 0
    if refine_generalized is None:
        refine_generalized = 0 if e is None else (
            8 if e_kind == "general" else 2)
    if calls is not EAGER_CALLS and (e is not None or method == "schur"):
        raise ValueError("lyap: other dense calls serve only the eigh, "
                         "sign and kron routes without e")

    d = None
    if e is not None:
        d = _balance_scaling(e)
        a = d[:, None] * a * d[None, :]
        c = d[:, None] * c * d[None, :]
        e = d[:, None] * e * d[None, :]

    if method == "kron":
        x = _lyap_kron(a, c, e, calls)
        # X = D X_bal D (the balanced solution is X_bal = D^{-1} X D^{-1})
        return x if d is None else x * d[:, None] * d[None, :]

    c_fwd = _sym
    back = lambda y: y  # noqa: E731
    a_red = a
    if e is not None:
        a_red, c_fwd, back = _reduce_generalized(a, c, e, e_kind)

    if method == "eigh":
        slv = _eigh_factor(a_red, calls)
    elif method == "schur":
        slv = _schur_factor(a_red)
    elif method == "sign":
        slv = functools.partial(_lyap_sign, a_red,
                                iterations=sign_iterations, calls=calls)
    else:
        raise ValueError(f"unknown method {method!r}")

    ct = c_fwd(c) if e is not None else c
    y = slv(ct)
    if method in ("eigh", "schur"):
        # one cheap correction with the cached factorization recovers most
        # of the accuracy float32 loses in the transform roundoff
        for _ in range(refine):
            r = a_red @ y + y @ a_red.T + ct
            y = y - slv(-r)
    x = back(_sym(y))
    if e is not None and refine_generalized > 0:
        def gen_res(xx):
            return _sym(a @ xx @ e.T + e @ xx @ a.T + c)

        rn = torch.linalg.norm(gen_res(x))
        best_x, best_rn = x, rn
        for _ in range(refine_generalized):
            x = x + back(_sym(slv(c_fwd(gen_res(x)))))
            rn_new = torch.linalg.norm(gen_res(x))
            better = rn_new < best_rn
            best_x = torch.where(better, x, best_x)
            best_rn = torch.where(better, rn_new, best_rn)
            # stall: essentially no progress this round (convergence or
            # cond-limited stagnation); the best iterate is kept
            stalled = bool(rn_new > 0.9 * rn)
            rn = rn_new
            if stalled:
                break
        x = best_x
    if e is not None:
        x = _sym(x) * d[:, None] * d[None, :]
    return x


def lyap_residual(a, x, c, e=None):
    """|| A X E' + E X A' + C ||_F — correctness check used by the tests."""
    if e is None:
        r = a @ x + x @ a.T + c
    else:
        r = a @ x @ e.T + e @ x @ a.T + c
    return torch.linalg.norm(r)
