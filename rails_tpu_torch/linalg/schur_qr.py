"""Complex Schur decomposition in PyTorch - the counterpart of the JAX
package's ``linalg/schur_qr.py``.

PyTorch has no Schur decomposition (``torch.linalg`` stops at eig/eigh),
but the projected solve for a general, untagged A needs exactly SLICOT
sb03md's capability: factor a general real k-by-k matrix A = U T U^H with
T upper triangular.  Built from scratch, as in the JAX package:

1. ``hessenberg``: Householder reduction A = Q H Q^H in k-2 rank-1 update
   steps.
2. ``complex_schur``: single-shift QR iteration with Wilkinson shifts and
   aggressive deflation, one full-size complex QR factorization per sweep
   (``torch.linalg.qr``: cuSOLVER on the card, LAPACK on the CPU).
   Deflated trailing blocks stay upper triangular under full-matrix QR
   steps, so only the shift tracks the active window.

The sweep loop is a Python loop: each sweep reads the active size back to
the host to decide whether to go on.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from rails_tpu_torch.utils.dtypes import highest_precision

__all__ = ["hessenberg", "complex_schur"]


def _csign(z):
    """z/|z| with sign(0) = 1 (complex-safe Householder phase)."""
    az = torch.abs(z)
    return torch.where(az == 0, torch.ones_like(z),
                       z / torch.where(az == 0, torch.ones_like(az), az))


@highest_precision
def hessenberg(a: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Reduce a (real or complex) square matrix to upper Hessenberg form.

    Returns (h, q) with a = q @ h @ q^H and h[i, j] == 0 for i > j + 1.
    """
    k = a.shape[0]
    h = a.clone()
    q = torch.eye(k, dtype=a.dtype, device=a.device)
    if k <= 2:
        return h, q
    rows = torch.arange(k, device=a.device)
    zero = torch.zeros((), dtype=a.dtype, device=a.device)
    for j in range(k - 2):
        # Householder vector zeroing h[j+2:, j], pivot row j+1.
        x = torch.where(rows >= j + 1, h[:, j], zero)
        pivot = x[j + 1]
        nrm = torch.linalg.norm(x)
        alpha = -_csign(pivot) * nrm
        e1 = (rows == j + 1).to(h.dtype)
        v = x - alpha * e1
        vnrm = torch.linalg.norm(v)
        # skip degenerate column (already reduced): v = 0 -> P = I
        v = torch.where(vnrm > 0, v / torch.where(
            vnrm > 0, vnrm, torch.ones_like(vnrm)), zero)
        vc = torch.conj(v)
        # P = I - 2 v v^H applied from both sides + accumulate Q
        h = h - 2.0 * torch.outer(v, vc @ h)
        h = h - 2.0 * torch.outer(h @ v, vc)
        q = q - 2.0 * torch.outer(q @ v, vc)
    return h, q


def _wilkinson_shift(h, p: int):
    """Eigenvalue of the trailing active 2x2 block closest to its (2,2)
    entry."""
    a, b = h[p - 2, p - 2], h[p - 2, p - 1]
    c, d = h[p - 1, p - 2], h[p - 1, p - 1]
    tr = a + d
    det = a * d - b * c
    disc = torch.sqrt(tr * tr - 4.0 * det)
    l1 = 0.5 * (tr + disc)
    l2 = 0.5 * (tr - disc)
    return torch.where(torch.abs(l1 - d) < torch.abs(l2 - d), l1, l2)


@highest_precision
def complex_schur(a: torch.Tensor, max_sweeps: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Complex Schur decomposition a = u @ t @ u^H, t upper triangular.

    Args:
      a: (k, k) complex (cast real input to complex first).
      max_sweeps: iteration bound; default 12*k + 60.  Each sweep is one
        shifted full-matrix QR step.
    """
    if not torch.is_complex(a):
        raise TypeError("complex_schur expects a complex tensor; cast first")
    k = a.shape[0]
    if max_sweeps is None:
        max_sweeps = 12 * k + 60
    if k == 0:
        return a, a
    if k == 1:
        return a, torch.eye(1, dtype=a.dtype, device=a.device)

    h, u = hessenberg(a)
    dev = a.device
    eye = torch.eye(k, dtype=a.dtype, device=dev)
    rows = torch.arange(k, device=dev)[:, None].expand(k, k)
    cols = torch.arange(k, device=dev)[None, :].expand(k, k)
    sub_i = torch.arange(k - 1, device=dev)
    eps = torch.finfo(a.real.dtype).eps
    zero = torch.zeros((), dtype=a.dtype, device=dev)
    below = rows > cols + 1
    subdiag = rows == cols + 1
    sub_col = torch.clamp(cols, max=k - 2)

    def clean_and_active(h):
        """Zero negligible subdiagonals; return (h, p) with p = active
        size."""
        # Enforce exact Hessenberg form: roundoff junk below the
        # subdiagonal would otherwise be amplified into deflated positions
        # whenever a shift makes H - mu*I nearly singular.
        h = torch.where(below, zero, h)
        diag = torch.abs(torch.diagonal(h))
        sub = torch.diagonal(h, offset=-1)
        small = torch.abs(sub) <= eps * (diag[:-1] + diag[1:] + eps)
        # zero all small subdiagonal entries (aggressive deflation)
        h = torch.where(subdiag & small[sub_col], zero, h)
        sub_nz = torch.abs(torch.diagonal(h, offset=-1)) > 0
        # active window = [0, p): p = 2 + last index with nonzero subdiag
        p = int(torch.max(torch.where(sub_nz, sub_i + 2,
                                      torch.ones_like(sub_i))))
        return h, p

    h, p = clean_and_active(h)
    sweeps, stagnant = 0, 0
    while p > 1 and sweeps < max_sweeps:
        mu = _wilkinson_shift(h, p)
        if stagnant >= 8:
            # exceptional shift if no deflation for a while (breaks cycles)
            mu = h[p - 1, p - 1] + 0.75 * torch.abs(h[p - 1, p - 2])
        qs, r = torch.linalg.qr(h - mu * eye)
        h = r @ qs + mu * eye
        u = u @ qs
        h, p_new = clean_and_active(h)
        stagnant = 0 if p_new < p else stagnant + 1
        p = p_new
        sweeps += 1
    # enforce exact triangularity on output
    t = torch.where(rows > cols, zero, h)
    return t, u
