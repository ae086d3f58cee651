"""Benchmark / test problem families - the framework's "model zoo".

A copy of the JAX package's ``models/problems.py`` (the port imports
nothing of that package), plus ``laplacian2_sparse``, the sparse 2D
Laplacian that the JAX bench's solve and scale phases build.

The reference ships four problem classes across its test suites; each is
reproduced here as a generator (host-side numpy, converted to operators):

- 2D Laplacian (matlab/test/test_Laplace.m:14-21 laplacian2)
- random stable tridiagonal (test/LyapunovSolver_test.cpp:181-200)
- random sparse (matlab/test/test_random.m sprand(n,n,10/n))
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp

__all__ = [
    "laplacian2",
    "laplacian2_sparse",
    "laplacian1d",
    "tridiagonal_problem",
    "random_sparse",
    "laplace_lyapunov_pair",
]


def laplacian2_sparse(side: int) -> sp.csr_matrix:
    """2D 5-point Laplacian on a side x side grid as scipy CSR, built as
    the JAX bench builds it (bench.py phase_solve / phase_scale):
    kron(I, tridiag(1, -4, 1)) + kron(offdiag(1, 1), I).  Offsets
    0, +-1, +-side: five diagonals."""
    return (sp.kron(sp.eye(side),
                    sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()


def laplacian2(n: int) -> np.ndarray:
    """2D 5-point Laplacian on a sqrt(n) x sqrt(n) grid, dense (n, n).

    Mirrors laplacian2 (matlab/test/test_Laplace.m:14-21):
    A = kron(I, T) + kron(S, I), T = tridiag(1, -4, 1), S = offdiag(1, 1).
    """
    m = int(math.isqrt(n))
    if m * m != n:
        raise ValueError(f"n={n} must be a perfect square")
    t = np.diag(-4.0 * np.ones(m)) + np.diag(np.ones(m - 1), 1) \
        + np.diag(np.ones(m - 1), -1)
    s = np.diag(np.ones(m - 1), 1) + np.diag(np.ones(m - 1), -1)
    eye = np.eye(m)
    return np.kron(eye, t) + np.kron(s, eye)


def laplacian1d(m: int) -> np.ndarray:
    """1D Laplacian tridiag(1, -2, 1), (m, m)."""
    return (np.diag(-2.0 * np.ones(m)) + np.diag(np.ones(m - 1), 1)
            + np.diag(np.ones(m - 1), -1))


def tridiagonal_problem(rng, n: int = 20, shift: float = 0.0
                        ) -> Tuple[np.ndarray, np.ndarray]:
    """Random tridiagonal A (diagonal x3) + random B with last entry zeroed
    (get_tridiagonal_problem, test/LyapunovSolver_test.cpp:181-200).
    ``shift`` < 0 makes it Hurwitz."""
    a = rng.uniform(-1, 1, (n, n))
    a = np.where(np.abs(np.subtract.outer(np.arange(n), np.arange(n))) > 1,
                 0.0, a)
    a[np.diag_indices(n)] *= 3.0
    a += shift * np.eye(n)
    b = rng.uniform(-1, 1, (n, 1))
    b[n - 1, 0] = 0.0
    return a, b


def random_sparse(rng, n: int = 64, density: Optional[float] = None
                  ) -> np.ndarray:
    """sprand(n, n, 10/n) equivalent (matlab/test/test_random.m:24)."""
    if density is None:
        density = 10.0 / n
    nnz = int(density * n * n)
    a = np.zeros((n, n))
    ii = rng.integers(0, n, nnz)
    jj = rng.integers(0, n, nnz)
    a[ii, jj] = rng.uniform(0, 1, nnz)
    return a


def laplace_lyapunov_pair(n: int, rng):
    """The Laplace<->Lyapunov equivalence setup
    (matlab/test/test_Laplace.m:83-111): A = 1D Laplacian (m, m) with
    m = sqrt(n); the 2D Laplace solve A2d x = -vec(B B') equals
    vec(V S V') of the Lyapunov solve."""
    m = int(math.isqrt(n))
    a = laplacian1d(m)
    a2d = np.kron(a, np.eye(m)) + np.kron(np.eye(m), a)
    b = rng.uniform(0, 1, (m, 1))
    return a, a2d, b
