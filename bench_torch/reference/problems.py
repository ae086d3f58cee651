"""Problem builders of the benchmark's configurations, plain scipy.

``laplacian2`` is RAILS's ``laplacian2`` (matlab/test/test_Laplace.m) on a
side x side grid, built as the JAX bench's solve and scale phases build
it: kron(I, tridiag(1, -4, 1)) + kron(offdiag(1, 1), I).  ``schur_blocks``
is the index split of the reference's SchurOperator (src/SchurOperator.cpp:
73-153): the rows where diag(M) is zero against the rest.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def laplacian2(side: int) -> sp.csr_matrix:
    return (sp.kron(sp.eye(side),
                    sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()


FAMILIES = {"laplacian2": laplacian2}


def operator(config) -> sp.csr_matrix:
    """A of ``config`` (its ``family`` and ``side``) in float64."""
    return FAMILIES[config["family"]](int(config["side"]))


def schur_blocks(a: sp.csr_matrix, md: np.ndarray):
    """(i1, i2, {A11, A12, A21, A22}) for M = diag(md): i1 the rows where
    md is zero."""
    i1 = np.flatnonzero(md == 0.0)
    i2 = np.flatnonzero(md != 0.0)
    a = a.tocsr()
    blocks = {"A11": a[i1][:, i1], "A12": a[i1][:, i2],
              "A21": a[i2][:, i1], "A22": a[i2][:, i2]}
    return i1, i2, {k: v.tocsr() for k, v in blocks.items()}
