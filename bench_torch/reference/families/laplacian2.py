"""RAILS's ``laplacian2`` (matlab/test/test_Laplace.m) on a side x side
grid, built as the JAX bench's solve and scale phases build it:
kron(I, tridiag(1, -4, 1)) + kron(offdiag(1, 1), I)."""

import scipy.sparse as sp


def operator(config) -> sp.csr_matrix:
    side = int(config["side"])
    return (sp.kron(sp.eye(side),
                    sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()
