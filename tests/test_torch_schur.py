"""The port's Schur reduction and the Schur-path solve against the JAX
package, at float64 on the CPU.

Problems: tests/test_schur_path.py's ``small_dae`` (a random DAE, n=40)
and the Laplacian DAE (2D Laplacian; M = diag(U[0.5, 1.5]) with a random
third of the diagonal zeroed; B zero in the singular rows), at side 16
(A11 in DIA for the iterative solver) and side 32 (A11 in HYB).

Tolerances, relative to the largest entry of the JAX result:
- 1e-12 for ``dense_lu``: both packages factor A11 with LAPACK's
  partial-pivoting LU, so results differ by roundoff times cond(A11)
  (below 10 here);
- 1e-10 for ``iterative``: both run Jacobi-BiCGStab to a relative
  residual of 30 eps, and the two stop at different iterates within it;
- the payloads and the restricted B are equal bit for bit.
The solve is held draw for draw through the ``draws`` hook, as in
tests/test_torch_parity.py, with that file's tolerances.
"""

import gc
import weakref

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu.schur import schur_reduce as jax_schur
import rails_tpu_torch
from rails_tpu_torch.models.problems import laplacian2_sparse
from rails_tpu_torch.parallel.mesh import make_mesh
from rails_tpu_torch.parallel.schur_dist import distribute_schur
from rails_tpu_torch.schur import schur_reduce
from rails_tpu_torch.sparse.formats import SparseOperator

from test_torch_ell import _same_payload
from test_torch_parity import (  # noqa: F401  (jax_sign_fixed: fixture)
    JaxDraws, assert_same_run, jax_sign_fixed)

torch.set_num_threads(1)

TOL = {"dense_lu": 1e-12, "iterative": 1e-10}


def small_dae(rng, n=40, nsing=15):
    """tests/test_schur_path.py:18's random DAE."""
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = a - 3.0 * np.eye(n)
    mdiag = rng.uniform(0.5, 1.5, n)
    sing = rng.permutation(n)[:nsing]
    mdiag[sing] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[sing] = 0.0
    return sp.csr_matrix(a), mdiag, b


def laplacian_dae(side, p=8, seed=0):
    """The Laplacian DAE, drawn from default_rng(seed) in this order: M's
    diagonal, the zeroed third, B."""
    n = side * side
    rng = np.random.default_rng(seed)
    mdiag = rng.uniform(0.5, 1.5, n)
    mdiag[rng.permutation(n)[: n // 3]] = 0.0
    b = rng.uniform(0, 1, (n, p))
    b[mdiag == 0] = 0.0
    return laplacian2_sparse(side), mdiag, b


def _problem(name, rng):
    if name == "small_dae":
        return small_dae(rng)
    if name == "dae_120":
        # large enough that the solve converges before its space spans
        # the whole reduced space (where the residual is roundoff noise)
        return small_dae(rng, n=120, nsing=40)
    return laplacian_dae(int(name.split("_")[1]))


def _close(yt, yj, tol):
    yt = yt.detach().numpy() if isinstance(yt, torch.Tensor) else yt
    yj = np.asarray(yj)
    assert yt.shape == yj.shape
    assert np.abs(yt - yj).max() <= tol * max(np.abs(yj).max(), 1e-300)


def _both(a, md, b, **kw):
    red_j = jax_schur(a, md, b, dtype=jnp.float64, **kw)
    red_t = schur_reduce(a, md, b, dtype=torch.float64, device="cpu", **kw)
    return red_j, red_t


@pytest.mark.parametrize("solver,problem", [
    ("dense_lu", "small_dae"), ("dense_lu", "lap_16"),
    ("iterative", "small_dae"), ("iterative", "lap_16"),
    ("iterative", "lap_32")])
def test_reduction_matches_jax(rng, solver, problem):
    a, md, b = _problem(problem, rng)
    red_j, red_t = _both(a, md, b, a11_solver=solver)
    tol = TOL[solver]
    assert np.array_equal(red_t.idx1, red_j.idx1)
    assert np.array_equal(red_t.idx2, red_j.idx2)
    for name in ("A12", "A21", "A22"):
        opt, opj = getattr(red_t, name), getattr(red_j, name)
        assert opt.format == opj.format == "ell"
        _same_payload(opt.fwd, opj.fwd)
    assert np.array_equal(red_t.bs.numpy(), np.asarray(red_j.bs))
    assert np.array_equal(red_t.ms_diag.numpy(), np.asarray(red_j.ms_diag))
    if solver == "iterative":
        assert red_t._a11_op.format == red_j._a11_op.format
    res, res_t = red_t.a11_residual_check()
    assert max(res, res_t) <= 100 * TOL[solver]

    x2 = rng.uniform(-1, 1, (red_t.n2, 3))
    xf = rng.uniform(-1, 1, (red_t.n, 3))
    st, sj = red_t.operator, red_j.operator
    _close(st.matmat(torch.from_numpy(x2)), sj.matmat(jnp.asarray(x2)), tol)
    _close(st.rmatmat(torch.from_numpy(x2)), sj.rmatmat(jnp.asarray(x2)),
           tol)
    _close(red_t.restrict(xf), red_j.restrict(xf), tol)
    _close(red_t.prolongate(x2), red_j.prolongate(x2), tol)
    _close(red_t.vtrans(torch.from_numpy(xf)), red_j.vtrans(xf), tol)

    v = np.linalg.qr(rng.uniform(-1, 1, (red_t.n2, 4)))[0]
    t = rng.uniform(-1, 1, (4, 4))
    t = t @ t.T
    _close(red_t.trace(v, t).reshape(1), np.reshape(red_j.trace(v, t), 1),
           tol)
    sol_t = red_t.solution_operator(v, t)
    sol_j = red_j.solution_operator(v, t)
    _close(sol_t.matmat(torch.from_numpy(xf)), sol_j.matmat(jnp.asarray(xf)),
           tol)


def test_sinv_matches_jax(rng):
    a, md, b = laplacian_dae(16)
    red_j, red_t = _both(a, md, b)
    x = rng.uniform(-1, 1, (red_t.n2, 2))
    _close(red_t.sinv()(torch.from_numpy(x)), red_j.sinv()(jnp.asarray(x)),
           1e-12)
    # S sinv(x) = x
    _close(red_t.operator.matmat(red_t.sinv()(torch.from_numpy(x))), x,
           1e-10)


def test_a11_factor_dies_with_its_reduction():
    """With the cyclic collector off, the dense A11 factor is freed when
    its reduction is, after S applies and a 1-D A11 solve: no reference
    cycle holds it."""
    a, md, b = laplacian_dae(8)
    gc.disable()
    try:
        red = schur_reduce(a, md, b, dtype=torch.float64, device="cpu")
        red.operator.matmat(torch.ones(red.n2, 2, dtype=torch.float64))
        red.a11_solve(torch.ones(red.n1, dtype=torch.float64))
        lu = weakref.ref(red._a11_lu[0])
        del red
        assert lu() is None
    finally:
        gc.enable()


def test_b_in_singular_part_is_restricted(rng):
    a, md, b = small_dae(rng)
    b = b + 0.5  # nonzero in the singular rows
    with pytest.warns(UserWarning, match="singular part"):
        red_j = jax_schur(a, md, b, dtype=jnp.float64)
    with pytest.warns(UserWarning, match="singular part"):
        red_t = schur_reduce(a, md, b, dtype=torch.float64, device="cpu")
    _close(red_t.bs, red_j.bs, 1e-12)


def test_nonsingular_m_returns_a22(rng):
    a, md, b = small_dae(rng, nsing=0)
    red = schur_reduce(a, md, b, dtype=torch.float64, device="cpu",
                       hurwitz=True)
    assert red.n1 == 0
    op = red.operator
    assert isinstance(op, SparseOperator) and op.is_hurwitz
    assert op.fwd is red.A22.fwd
    assert red.symmetric is op.is_symmetric is False
    v = np.linalg.qr(rng.uniform(-1, 1, (red.n, 3)))[0]
    t = np.diag([3.0, 2.0, 1.0])
    assert float(red.trace(v, t)) == pytest.approx(6.0)


def _a11_callable(a, md):
    """The A11 solve as a callable (MATLAB's opts.Ainv contract), both
    directions by ``torch.linalg.solve`` on the dense A11."""
    i1 = np.flatnonzero(md == 0)
    a11 = torch.from_numpy(a[i1][:, i1].toarray())

    def solve(x):
        return torch.linalg.solve(a11, x)

    solve.transpose_solve = lambda x: torch.linalg.solve(a11.T, x)
    return solve


def test_callable_and_unported_solvers(rng):
    a, md, b = small_dae(rng)
    red_c = schur_reduce(a, md, b, dtype=torch.float64, device="cpu",
                         a11_solver=_a11_callable(a, md))
    red_d = schur_reduce(a, md, b, dtype=torch.float64, device="cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (red_d.n2, 2)))
    _close(red_c.operator.rmatmat(x), red_d.operator.rmatmat(x).numpy(),
           1e-12)
    # the solvers once unported: the C++ sparse LU on the host, for the
    # A11 solves of S (both directions) and for sinv, against dense_lu
    red_n = schur_reduce(a, md, b, dtype=torch.float64, device="cpu",
                         a11_solver="native_lu")
    yd = red_d.operator.matmat(x).numpy()
    _close(red_n.operator.matmat(x), yd, 1e-12)
    _close(red_n.operator.rmatmat(x), red_d.operator.rmatmat(x).numpy(),
           1e-12)
    _close(red_d.sinv(method="native_lu")(x),
           red_d.sinv()(x).numpy(), 1e-12)


def _nudged_laplacian():
    """lap_16 with one off-diagonal entry of A moved by 1e-10 max|A|:
    far above rounding, so A is no longer symmetric."""
    a, md, b = laplacian_dae(16)
    a = a.tolil()
    a[0, 1] += 1e-10 * abs(a).max()
    return a.tocsr(), md, b


@pytest.mark.parametrize("solver,problem,tagged", [
    ("dense_lu", "lap_16", True), ("native_lu", "lap_16", True),
    ("dense_lu", "small_dae", False), ("native_lu", "small_dae", False),
    ("iterative", "lap_16", False), ("callable", "lap_16", False),
    ("dense_lu", "nudged", False)])
def test_symmetry_tag(rng, solver, problem, tagged):
    """S is tagged symmetric when A is and the A11 solve is direct; the
    solver then takes the projected solve's eigh route, and the Schur
    route otherwise.  The distributed operator keeps the tag."""
    a, md, b = (_nudged_laplacian() if problem == "nudged"
                else _problem(problem, rng))
    kw = dict(a11_solver=_a11_callable(a, md) if solver == "callable"
              else solver)
    red = schur_reduce(a, md, b, dtype=torch.float64, device="cpu", **kw)
    assert red.symmetric is tagged
    assert red.operator.is_symmetric is tagged
    lyap_solver = rails_tpu_torch.LyapunovSolver(
        red.operator, red.bs, red.ms, device="cpu")
    assert lyap_solver._resolve_lyap_method()[0] == (
        "eigh" if tagged else "schur")
    if solver == "dense_lu":
        dist = distribute_schur(red, make_mesh(devices=["cpu"]))
        assert dist.is_symmetric is tagged


@pytest.mark.parametrize("solver", ["dense_lu", "iterative"])
def test_symmetry_tag_without_singular_part(solver):
    """With n1 = 0, S is A22 = A, with A22's own tag whatever the A11
    solver: the reduction's tag and the operator's agree."""
    a = laplacian2_sparse(8)
    md = np.random.default_rng(0).uniform(0.5, 1.5, 64)
    red = schur_reduce(a, md, np.ones((64, 2)), dtype=torch.float64,
                       device="cpu", a11_solver=solver)
    assert red.n1 == 0
    assert red.symmetric is red.operator.is_symmetric is True


def test_eigh_route_solves_the_same_equation(rng):
    """On the tagged Laplacian DAE the default options (the eigh route)
    and ``projected_solver="schur"`` on the same reduction both converge
    to the same X = V T V'."""
    a, md, b = laplacian_dae(16)
    red = schur_reduce(a, md, b[:, :4], dtype=torch.float64, device="cpu")
    assert red.operator.is_symmetric
    opts = dict(tol=1e-4, expand=4, restart_size=60, reduced_size=30,
                maxit=200, dtype=torch.float64, device="cpu")
    xs = []
    for route in ("auto", "schur"):
        v, t, info = rails_tpu_torch.solve(
            red.operator, red.bs, red.ms, projected_solver=route, **opts)
        assert info.converged
        xs.append((v @ t @ v.T).numpy())
    _close(xs[0], xs[1], 1e-8)


@pytest.mark.parametrize("problem,opts", [
    ("dae_120", dict(tol=1e-4, expand=2, maxit=100)),
    ("lap_16", dict(tol=1e-4, expand=4, restart_size=60, reduced_size=30,
                    maxit=200)),
])
def test_schur_solve_parity(rng, jax_sign_fixed, problem, opts):
    """The reference's main-program path, draw for draw: M22 diagonal, Bs
    restricted.  The random DAE's S is untagged (the projected solve's
    schur route); the Laplacian DAE's S is tagged symmetric by the port
    and untagged by the JAX package, which is asked for the eigh route
    the port takes."""
    a, md, b = _problem(problem, rng)
    jax_opts = dict(opts)
    if problem != "dae_120":
        b = b[:, :4]
        jax_opts["projected_solver"] = "eigh"
    red_j, red_t = _both(a, md, b)
    assert red_t.operator.is_symmetric is (problem != "dae_120")
    vj, tj, ij = rails_tpu.solve(red_j.operator, jnp.asarray(red_j.bs),
                                 red_j.ms, dtype=jnp.float64, **jax_opts)
    draws = JaxDraws(4634)
    vt, tt, it = rails_tpu_torch.solve(
        red_t.operator, red_t.bs, red_t.ms, dtype=torch.float64,
        device="cpu", draws=draws, **opts)
    assert ij.iter >= 5
    assert draws.calls["lanczos_normal"] == ij.iter
    assert_same_run((np.asarray(vj), np.asarray(tj), ij),
                    (vt.numpy(), tt.numpy(), it))
