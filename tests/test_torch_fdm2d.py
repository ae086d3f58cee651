"""The benchmark's convection-diffusion family
(``bench_torch/reference/families/fdm2d.py``: ``fdm_2d_matrix(n0, fx, fy,
g)`` of LyaPack and M-M.E.S.S.) and the reference driver on its index-1
DAE, on the CPU.

- The family against a build point by point from the PDE, and exact on a
  quadratic that vanishes on the boundary, where central differences
  are: the signs of fx and fy, the 1/h² scaling, which neighbour is x.
- -A is an M-matrix at the cell's side 96 (cell Péclet number 0.51) and
  not at side 40 (1.19).
- ``cli.main --x64`` on the DAE at side 16 takes the Schur route (S not
  symmetric), converges, and the benchmark's reference puts its numbers
  under the cell's limits; the same run in float32 fails ``galerkin``.
"""

import contextlib
import io
from types import SimpleNamespace

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from bench_torch import harness
from bench_torch.entries import cli as cli_entry
from bench_torch.reference import problems

CELL = "fdm2d_dae.cli_n9k"
SEED = 2 ** 35 + 11
PUBLISHED = {"family": "fdm2d", "side": 96,
             "convection": {"x": 10.0, "y": 100.0}, "reaction": 0.0}


def family(**keys):
    return problems.operator({**PUBLISHED, **keys})


def per_point(n0, cx, cy, g):
    """The five-point rows written out from Δu - fx u_x - fy u_y - g u
    with u_xx ~ (u(i+1) - 2u + u(i-1))/h², u_x ~ (u(i+1) - u(i-1))/(2h),
    one grid point at a time; unknown (j - 1) n0 + (i - 1)."""
    h = 1.0 / (n0 + 1)
    a = np.zeros((n0 * n0, n0 * n0))
    for j in range(1, n0 + 1):
        for i in range(1, n0 + 1):
            x, y = i * h, j * h
            fx, fy = cx * x, cy * y
            row = (j - 1) * n0 + (i - 1)
            terms = {(i, j): -2 / h ** 2 - 2 / h ** 2 - g,
                     (i + 1, j): 1 / h ** 2 - fx / (2 * h),
                     (i - 1, j): 1 / h ** 2 + fx / (2 * h),
                     (i, j + 1): 1 / h ** 2 - fy / (2 * h),
                     (i, j - 1): 1 / h ** 2 + fy / (2 * h)}
            for (ii, jj), v in terms.items():
                if 1 <= ii <= n0 and 1 <= jj <= n0:
                    a[row, (jj - 1) * n0 + (ii - 1)] += v
    return a


@pytest.mark.parametrize("cx, cy, g", [(10.0, 100.0, 0.0),
                                       (-3.0, 7.0, 2.5)])
def test_family_is_the_per_point_stencil(cx, cy, g):
    n0 = 6
    a = family(side=n0, convection={"x": cx, "y": cy}, reaction=g)
    assert isinstance(a, sp.csr_matrix) and a.dtype == np.float64
    assert a.has_sorted_indices
    np.testing.assert_allclose(a.toarray(), per_point(n0, cx, cy, g),
                               rtol=1e-14, atol=0)


@pytest.mark.parametrize("cx, cy, g", [(10.0, 100.0, 0.0),
                                       (-3.0, 7.0, 2.5)])
def test_family_exact_on_a_quadratic(cx, cy, g):
    """u = x(1-x) y(1-y) is zero on the boundary and quadratic along
    each axis, so A u equals Δu - fx u_x - fy u_y - g u at the grid
    points: a sign of fx or fy, the scaling, or x taken for y would
    not."""
    n0 = 9
    h = 1.0 / (n0 + 1)
    grid = h * np.arange(1, n0 + 1)
    x, y = np.tile(grid, n0), np.repeat(grid, n0)   # x fastest
    u = x * (1 - x) * y * (1 - y)
    lu = (-2 * y * (1 - y) - 2 * x * (1 - x)
          - cx * x * (1 - 2 * x) * y * (1 - y)
          - cy * y * x * (1 - x) * (1 - 2 * y) - g * u)
    a = family(side=n0, convection={"x": cx, "y": cy}, reaction=g)
    np.testing.assert_allclose(a @ u, lu, rtol=0, atol=1e-11)


def is_m_matrix(a) -> bool:
    """-A is a Z-matrix with a positive x such that -A x > 0: x =
    (-A)^-1 1 by a sparse LU, positive exactly when -A is a non-singular
    M-matrix."""
    m = (-a).tocsr()
    off = m - sp.diags(m.diagonal())
    if off.max() > 0 or m.diagonal().min() <= 0:
        return False
    x = spla.splu(m.tocsc()).solve(np.ones(m.shape[0]))
    return bool(np.all(x > 0))


def test_minus_a_is_an_m_matrix_above_the_peclet_floor():
    assert is_m_matrix(family())            # Péclet 0.51
    assert not is_m_matrix(family(side=40))  # Péclet 1.19
    assert abs(family() - family().T).max() > 0


def run_cli(dtype):
    """One request of the cell at side 16 with fx = x, fy = 10 y
    (Péclet 0.28) through the benchmark's CLI entry on the CPU: the
    driver's output, the record and the reference's readings."""
    cell = harness.load_cell(CELL, SEED, device="cpu")
    cell.config.update(side=16, convection={"x": 1.0, "y": 10.0})
    cell.dtype = dtype
    state = cli_entry.setup(cell)
    main, texts = state["program"]["cli"].main, []

    def kept(argv):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            rc = main(argv)
        texts.append(out.getvalue())
        print(texts[-1], end="")
        return rc

    state["program"]["cli"] = SimpleNamespace(main=kept)
    rec = cli_entry.request(state, 0)
    return cell, texts[-1], rec, cli_entry.check(state, [rec], cell)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_cli_on_the_dae_takes_schur_and_holds_the_limits():
    cell, text, rec, readings = run_cli("float64")
    assert "Projected solver: schur (S not symmetric)" in text
    assert "Solver converged" in text and rec["ok"] and rec["iters"] > 0
    for k, lim in cell.limits.items():
        assert readings[k] <= lim["limit"], (k, readings[k])


def test_cli_on_the_dae_in_float32_fails_galerkin():
    cell, text, rec, readings = run_cli("float32")
    assert "Projected solver: schur (S not symmetric)" in text
    assert readings["galerkin"] > cell.limits["galerkin"]["limit"]
