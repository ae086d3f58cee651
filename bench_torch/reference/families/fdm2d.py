"""The convection-diffusion operator of LyaPack's and M-M.E.S.S.'s
``fdm_2d_matrix(n0, fx, fy, g)`` (M-M.E.S.S. helpers/fdm_2d_matrix.m):
the central-difference discretisation of

    Δu - fx(x, y) u_x - fy(x, y) u_y - g u

on the unit square with zero Dirichlet boundaries, n0 = ``side`` interior
points a side, h = 1/(n0 + 1).  The configuration's keys: ``side``,
``convection`` ({"x": cx, "y": cy}: fx = cx x, fy = cy y) and
``reaction`` (g, a constant).  The grid point (i, j), x = i h and y = j h
for i, j = 1..n0, is unknown (j - 1) n0 + (i - 1): x runs fastest.  Its
row:

    diagonal        -4/h² - g
    u(i ± 1, j)      1/h² ∓ fx(x, y)/(2h)
    u(i, j ± 1)      1/h² ∓ fy(x, y)/(2h)

a neighbour on the boundary left out (u = 0 there).  A is not symmetric
where fx or fy is not zero.  Where the largest cell Péclet number
max(|fx|, |fy|) h/2 is below 1, every off-diagonal of A is positive, so
-A is an irreducibly diagonally dominant M-matrix: every principal
submatrix (A11 of a Schur split) is non-singular.
"""

import numpy as np
import scipy.sparse as sp


def operator(config) -> sp.csr_matrix:
    n0 = int(config["side"])
    h = 1.0 / (n0 + 1)
    g = float(config["reaction"])
    grid = h * np.arange(1, n0 + 1)
    fx = float(config["convection"]["x"]) * np.tile(grid, n0)
    fy = float(config["convection"]["y"]) * np.repeat(grid, n0)
    n = n0 * n0
    p = np.arange(n)
    i, j = p % n0, p // n0
    rows, cols = [p], [p]
    vals = [np.full(n, -4.0 / h ** 2 - g)]
    # (offset of the neighbour, where it is inside the grid, its f, sign)
    for step, inside, f, sign in ((1, i < n0 - 1, fx, -1.0),
                                  (-1, i > 0, fx, 1.0),
                                  (n0, j < n0 - 1, fy, -1.0),
                                  (-n0, j > 0, fy, 1.0)):
        q = p[inside]
        rows.append(q)
        cols.append(q + step)
        vals.append(1.0 / h ** 2 + sign * f[q] / (2.0 * h))
    a = sp.csr_matrix((np.concatenate(vals),
                       (np.concatenate(rows), np.concatenate(cols))),
                      shape=(n, n))
    a.sort_indices()
    return a
