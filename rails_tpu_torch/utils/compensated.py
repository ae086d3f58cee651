"""Compensated float32 reductions (error-free transforms): the counterpart
of the JAX package's ``utils/compensated.py``, with the same algorithms.

A plain float32 contraction of length m carries about sqrt(m)*eps of
relative rounding noise, which is the solver's accuracy floor at float32
in its long m-length reductions (Gram blocks, Lanczos scalars,
orthogonalisation).  The error-free transforms of Ogita, Rump & Oishi
("Accurate sum and dot product", SIAM J. Sci. Comput. 26(6), 2005)
restore near-float64 results from float32 storage:

- ``two_sum(a, b)``  -> (s, e) with s = fl(a+b) and a+b = s+e exactly.
- ``two_prod(a, b)`` -> (p, e) with a*b = p+e exactly (Dekker split).
- ``dot2(x, y)``     -> x' @ y along axis 0, compensated: products by
  ``two_prod``, a pairwise ``two_sum`` tree, the product errors folded
  into the compensation stream.
- ``gram2(x, w)``    -> x' @ w from chunked matrix products (each chunk in
  plain float32) reduced across chunks by a compensated pairwise tree:
  the error drops from ~sqrt(m)*eps to ~sqrt(chunk)*eps.

Across processes (``comm``, a ``parallel.comm.RowComm``) each rank's
(hi, lo) partial is gathered and the his are reduced in rank order by the
``two_sum`` tree, the los added to the compensation (``psum2``): the JAX
package's psum of the partial pair, kept compensated.

These are plain tensor operations, as in the JAX package, where they run
in XLA outside any Pallas kernel.  The chunk products run under
``utils/dtypes.full_precision`` (TF32 off): a TF32 chunk product would
keep about three decimal digits and defeat the compensation.
"""

from __future__ import annotations

import torch

from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["two_sum", "two_prod", "dot2", "dot2_pair", "gram2",
           "gram2_pair", "sum2", "psum2", "rank_pair_sum"]


def two_sum(a, b):
    """Error-free sum: returns (s, e) with s = fl(a+b), a+b = s+e exactly."""
    s = a + b
    bv = s - a
    e = (a - (s - bv)) + (b - bv)
    return s, e


def _split(a):
    """Dekker split: a = hi + lo with hi, lo each representable in half
    the mantissa, so hi*hi etc. are exact.  f32: factor 2^12 + 1; f64:
    2^27 + 1."""
    factor = 2.0 ** 27 + 1.0 if a.dtype == torch.float64 else 2.0 ** 12 + 1.0
    c = factor * a
    hi = c - (c - a)
    lo = a - hi
    return hi, lo


def two_prod(a, b):
    """Error-free product: returns (p, e) with p = fl(a*b), a*b = p+e."""
    p = a * b
    ah, al = _split(a)
    bh, bl = _split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def _pairwise_two_sum(parts):
    """Compensated pairwise-tree sum over axis 0 of ``parts``: returns
    (hi, lo), hi the working-precision estimate of sum(parts, 0) and lo
    the compensation term.  Each level uses two_sum and plain-adds the
    error terms (errors of errors are O(eps^2) relative)."""
    lo = torch.zeros_like(parts[0])
    while parts.shape[0] > 1:
        n = parts.shape[0]
        half = n // 2
        s, e = two_sum(parts[:half], parts[half:2 * half])
        err = torch.sum(e, dim=0)
        parts = torch.cat([s, parts[2 * half:]], dim=0) if n % 2 else s
        lo = lo + err
    return parts[0], lo


def sum2(x, dim: int = 0):
    """Compensated sum along ``dim``; returns hi + lo in x's dtype."""
    hi, lo = _pairwise_two_sum(torch.movedim(x, dim, 0))
    return hi + lo


def psum2(comm, pairs):
    """The compensated sum over ranks of each rank's (hi, lo) pairs, in
    one collective: every rank's his reduced by the ``two_sum`` tree in
    rank order, their errors and every rank's lo added to the
    compensation; returns the collapsed sums."""
    flat = [t for pair in pairs for t in pair]
    gathered = comm.allgather_many(flat)
    return [rank_pair_sum(gathered[2 * i], gathered[2 * i + 1])
            for i in range(len(pairs))]


def rank_pair_sum(his, los):
    """The collapsed compensated sum of gathered (world, ...) pairs: the
    his by the ``two_sum`` tree, their errors and the los, rank 0 first,
    into the compensation."""
    hi, lo = _pairwise_two_sum(his)
    for i in range(los.shape[0]):
        lo = lo + los[i]
    return hi + lo


def dot2(x, y, block: int = 65536, comm=None):
    """Compensated x' @ y along axis 0 at full working-precision accuracy.

    x: (m,) or (m, a); y: (m,) or (m, b).  Output (), (a,), (b,) or
    (a, b) matching a plain ``x.T @ y``.  Elementwise (about ten flops
    per product term): for skinny operands, where the op is bound by the
    bytes it reads.  The (m, a, b) product stream is reduced in blocks of
    ``block`` rows to bound memory.  ``comm``: x and y are this rank's
    rows, the result is reduced over the ranks (``psum2``)."""
    hi, lo = dot2_pair(x, y, block)
    out = hi + lo if comm is None else psum2(comm, [(hi, lo)])[0]
    if x.ndim == 1 and y.ndim == 1:
        return out[0, 0]
    if x.ndim == 1:
        return out[0]
    if y.ndim == 1:
        return out[:, 0]
    return out


def dot2_pair(x, y, block: int = 65536):
    """Like ``dot2`` but returns the (a, b) pair (hi, lo) uncollapsed."""
    xv = x[:, None] if x.ndim == 1 else x
    yv = y[:, None] if y.ndim == 1 else y
    m, a = xv.shape
    b = yv.shape[1]
    nblk = max(1, -(-m // block))
    hi = torch.zeros((a, b), dtype=xv.dtype, device=xv.device)
    lo = torch.zeros_like(hi)
    for i in range(nblk):
        xs = xv[i * block:(i + 1) * block]
        ys = yv[i * block:(i + 1) * block]
        p, e = two_prod(xs[:, :, None], ys[:, None, :])
        ph, pl = _pairwise_two_sum(p)
        hi, e2 = two_sum(hi, ph)
        lo = lo + e2 + pl + torch.sum(e, dim=0)
    return hi, lo


def _chunk_parts(x, w, chunk: int):
    """(nc, a, b) per-chunk float32 products x_c' @ w_c, the rows padded
    with zeros to a multiple of ``chunk``."""
    m = x.shape[0]
    pad = (-m) % chunk
    if pad:
        x = torch.nn.functional.pad(x, (0, 0, 0, pad))
        w = torch.nn.functional.pad(w, (0, 0, 0, pad))
    nc = x.shape[0] // chunk
    with full_precision():
        return torch.bmm(x.reshape(nc, chunk, x.shape[1]).transpose(1, 2),
                         w.reshape(nc, chunk, w.shape[1]))


def gram2_pair(x, w, chunk: int = 1024):
    """Like ``gram2`` but returns the (hi, lo) pair uncollapsed, so that a
    host consumer can rebuild the float64-quality result exactly
    (hi.double() + lo.double())."""
    return _pairwise_two_sum(_chunk_parts(x, w, chunk))


def gram2(x, w, chunk: int = 1024, comm=None):
    """x' @ w for x (m, a), w (m, b) -> (a, b): chunked float32 products
    and a compensated cross-chunk pairwise reduction.  Memory overhead is
    the (nchunks, a, b) partial buffer.  ``comm``: x and w are this
    rank's rows, the result is reduced over the ranks (``psum2``)."""
    hi, lo = gram2_pair(x, w, chunk)
    if comm is not None:
        return psum2(comm, [(hi, lo)])[0]
    return hi + lo
