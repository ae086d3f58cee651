"""The MATLAB option set on the port: tests/test_solver_matlab.py (the
mirrors of test_Laplace.m, test_opts.m and test_random.m) and
tests/test_options_wired.py, translated onto rails_tpu_torch.

Every solve takes the JAX package's random draws through the ``draws``
hook (``JaxDraws``, the key chain of rails_tpu's default seed 4634), so
the port runs the JAX suites' realizations, and their bounds stay as the
JAX suites have them.  The problems come from the same numpy generator
(``rng``: default_rng(4634)) in the same order.  The singular-M cases of
test_options_wired.py are in tests/test_torch_schur_compiled.py.
"""

import os
import sys
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu_torch as rt
from rails_tpu_torch.core.options import (
    InvalidOption, InverseNotUsedWarning, ProjectionMethodWarning,
    SingularMassMatrixWarning)
from rails_tpu_torch.models.problems import (
    laplace_lyapunov_pair, laplacian2, random_sparse, tridiagonal_problem)
from rails_tpu_torch.utils.host_blas import single_thread_blas

from test_torch_parity import JaxDraws

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One OpenBLAS thread (the projected Schur solve's LAPACK calls):
    the suite runs in several workers at once."""
    with single_thread_blas():
        yield


def solve(a, b, m=None, **kw):
    """``rt.solve`` on the CPU with the JAX package's draws."""
    return rt.solve(a, b, m, draws=JaxDraws(4634), **CPU, **kw)


def solver(a, b, m=None, **kw):
    return rt.LyapunovSolver(a, b, m, draws=JaxDraws(4634), **CPU, **kw)


def dense(a, **tags):
    return rt.DenseOperator(a, **tags, **CPU)


def diag(md):
    return rt.DiagonalOperator(md, **CPU)


def laplace_setup(rng, n):
    a = laplacian2(n)
    md = rng.uniform(0, 1, n)
    b = rng.uniform(0, 1, (n, 1))
    return a, md, b


def rel_true_residual(a, v, t, b, md=None):
    v, t = np.asarray(v), np.asarray(t)
    x = v @ t @ v.T
    if md is None:
        r = a @ x + x @ a.T + b @ b.T
    else:
        m = np.diag(np.asarray(md))
        r = a @ x @ m.T + m @ x @ a.T + b @ b.T
    return np.linalg.norm(r, 2) / np.linalg.norm(b.T @ b, 2)


def max_residual(a, v, t, b, m=None):
    """tests/test_solver.py::true_residual: the largest entry of R."""
    v, t = np.asarray(v), np.asarray(t)
    x = v @ t @ v.T
    m = np.eye(a.shape[0]) if m is None else m
    return np.abs(a @ x @ m.T + m @ x @ a.T + b @ b.T).max()


def solve_laplace(a, md, b, **kw):
    return solve(dense(a, is_symmetric=True), b, diag(md), **kw)


# ----------------------------------------------------- test_Laplace.m
class TestLaplace:
    @pytest.mark.parametrize("n", [64, 256])
    def test_laplace(self, rng, n):
        # test_Laplace_64 / _256 (test_Laplace.m:31-59), maxit up to the
        # asserted bound n - 10 as in the JAX suite
        a, md, b = laplace_setup(rng, n)
        v, t, info = solve_laplace(a, md, b, maxit=max(100, n - 10))
        assert info.converged
        assert info.iter < n - 10
        assert info.res < 1e-4
        assert rel_true_residual(a, v, t, b, md) < 1e-4

    def test_laplace_maxit(self, rng):
        # test_Laplace_maxit (test_Laplace.m:61-69)
        a, md, b = laplace_setup(rng, 64)
        with pytest.warns(ProjectionMethodWarning):
            _, _, info = solve_laplace(a, md, b, maxit=10)
        assert info.status == -1

    def test_laplace_equivalence(self, rng):
        # test_Laplace_equivalence (test_Laplace.m:83-111), n=1024
        a1d, a2d, b = laplace_lyapunov_pair(1024, rng)
        x_direct = np.linalg.solve(a2d, -(b @ b.T).reshape(-1))
        v, s, info = solve(dense(a1d, is_symmetric=True), b,
                           restart_upon_convergence=False)
        assert info.res < 1e-4
        assert rel_true_residual(a1d, v, s, b) < 1e-4
        x_lyap = (v.numpy() @ s.numpy() @ v.numpy().T).reshape(-1)
        assert np.linalg.norm(x_lyap - x_direct) < 1e-4


# ------------------------------------------------------- test_opts.m
class TestOpts:
    @pytest.mark.parametrize("ortho", [None, "M"], ids=["tol", "morth"])
    def test_converges_within_n_minus_10(self, rng, ortho):
        # test_tol (test_opts.m:29-44: the residual lands in [tol/10,
        # tol] for tol = 5e-5) and test_morth (test_opts.m:181-194)
        n = 256
        a, md, b = laplace_setup(rng, n)
        if ortho is None:
            tol = 5e-5
            v, t, info = solve_laplace(a, md, b, tol=tol, maxit=n - 10)
        else:
            tol = 1e-4
            v, t, info = solve_laplace(a, md, b, ortho=ortho, maxit=n - 10)
        assert info.iter < n - 10
        assert info.res < tol
        r = rel_true_residual(a, v, t, b, md)
        assert r < tol
        if ortho is None:
            assert r > tol / 10

    @pytest.mark.parametrize("case", ["restart", "restart2", "restart3"])
    def test_restart(self, rng, case):
        # test_restart, test_restart2, test_restart3 (test_opts.m:46-104)
        # on a well-conditioned M draw, as in the JAX suite
        n = 256
        a = laplacian2(n)
        md = rng.uniform(0.5, 1.5, n)
        b = rng.uniform(0, 1, (n, 1))
        opts, limit = {
            "restart": (dict(restart_size=50, reduced_size=10,
                             maxit=150), 100),
            "restart2": (dict(maxit=110, reduced_size=15,
                              restart_iterations=40), 110),
            "restart3": (dict(maxit=150, restart_size=50, reduced_size=10,
                              restart_iterations=20,
                              restart_tolerance=1e-2), 150)}[case]
        v, t, info = solve_laplace(a, md, b, **opts)
        assert info.iter < limit
        assert info.res < 1e-4
        assert rel_true_residual(a, v, t, b, md) < 1e-4
        if case == "restart":
            assert v.shape[1] <= 10
            assert t.shape[1] == v.shape[1]

    @pytest.mark.parametrize("case", ["restart", "lanczos"])
    def test_wrong_options(self, case):
        # test_wrong_restart (test_opts.m:106-117); the C++
        # set_parameters check that Lanczos exceeds expand
        with pytest.raises(InvalidOption):
            if case == "restart":
                rt.SolverOptions(restart_size=10, reduced_size=50)
            else:
                rt.SolverOptions(expand=5, lanczos_vectors=5)

    @pytest.mark.parametrize("case", ["expand", "space"])
    def test_wrong_inputs(self, rng, case):
        # test_wrong_expand (test_opts.m:122-132), test_wrong_space
        # (test_opts.m:133-144)
        n = 64
        a, md, b = laplace_setup(rng, n)
        kw = {"expand": 3} if case == "expand" \
            else {"space": np.ones((n - 1, 1))}
        with pytest.raises(InvalidOption):
            solve_laplace(a, md, b, **kw)

    def test_no_inverse(self, rng):
        # test_no_inverse (test_opts.m:146-156)
        a, md, b = laplace_setup(rng, 64)
        with pytest.warns(InverseNotUsedWarning):
            solver(dense(a, is_symmetric=True), b, diag(md),
                   inv_a=lambda x: x)

    def test_singular_mass_warning(self, rng):
        # RAILSsolver:SingularMassMatrix (RAILSsolver.m:272-277)
        a, md, b = laplace_setup(rng, 64)
        md = md.copy()
        md[:3] = 0.0
        with pytest.warns(SingularMassMatrixWarning):
            solver(dense(a, is_symmetric=True), b, diag(md))

    def test_default_expand_follows_b(self, rng):
        # MATLAB default expand = min(3, size(B, 2)) (RAILSsolver.m:127)
        n = 64
        a, md, b = laplace_setup(rng, n)
        s = solver(dense(a, is_symmetric=True), b, diag(md))
        assert s.options.expand == 1
        b4 = rng.uniform(0, 1, (n, 4))
        s4 = solver(dense(a, is_symmetric=True), b4, diag(md))
        assert s4.options.expand == 3

    def test_space_warm_start(self, rng):
        # test_space (test_opts.m:160-179)
        n = 256
        a, md, b = laplace_setup(rng, n)
        opts = dict(maxit=150, restart_size=50, reduced_size=10)
        v, t, info = solve_laplace(a, md, b, **opts)
        v2, t2, info2 = solve_laplace(a, md, b, space=v.numpy()[:, :9],
                                      **opts)
        assert info2.iter < info.iter
        assert info2.res < 1e-4
        assert rel_true_residual(a, v2, t2, b, md) < 1e-4

    def test_nullspace(self, rng):
        # test_nullspace (test_opts.m:196-218): P A P, ||Q'V|| < 1e-10
        n = 256
        a, md, b = laplace_setup(rng, n)
        q = rng.uniform(0, 1, (n, 1))
        q /= np.linalg.norm(q)
        p = np.eye(n) - q @ q.T
        a = p @ a @ p
        b = p @ b
        m = p @ np.diag(md) @ p
        v, t, info = solve(dense(a, is_symmetric=True), b,
                           dense(m, is_symmetric=True), nullspace=q,
                           projected_solver="schur", maxit=n - 10)
        v, t = v.numpy(), t.numpy()
        assert np.linalg.norm(q.T @ v) < 1e-10
        assert info.res < 1e-4
        x = v @ t @ v.T
        r = a @ x @ m.T + m @ x @ a.T + b @ b.T
        assert np.linalg.norm(r, 2) / np.linalg.norm(b.T @ b, 2) < 1e-4


# ----------------------------------------------------- test_random.m
class TestRandom:
    def test_random_ev(self, rng):
        # test_random_ev (test_random.m:20-33): B = the dominant
        # eigenvector of A, M = I: < 10 iterations
        n = 64
        a = random_sparse(rng, n)
        ew, evec = np.linalg.eig(a)
        b = np.real(evec[:, [np.argmax(np.abs(ew))]])
        v, t, info = solve(a, b, maxit=64)
        assert info.converged
        assert info.iter < 10
        assert info.res < 1e-4
        assert rel_true_residual(a, v, t, b) < 1e-4

    def test_random_64(self, rng):
        # test_random_64 (test_random.m:35-48)
        n = 64
        a = random_sparse(rng, n)
        b = rng.uniform(0, 1, (n, 1))
        md = rng.uniform(0, 1, n)
        v, t, info = solve(a, b, diag(md), restart_upon_convergence=False)
        assert info.res < 1e-4
        assert rel_true_residual(a, v, t, b, md) < 1e-4


class TestMatlabReplica:
    def test_replica_consistency_n64(self, rng):
        """The numpy/scipy replica of MATLAB RAILSsolver
        (benchmarks/replica/matlab_replica.py) and the port on the n=64
        Laplace draw: both converge to < 1e-4, the replica inside the
        MATLAB default budget, the counts within 25 of each other."""
        sys.path.insert(0, os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "benchmarks", "replica"))
        from matlab_replica import matlab_rails_replica

        n = 64
        a, md, b = laplace_setup(rng, n)
        seed = rng.uniform(-1, 1, (n, 1))
        it, resvec, conv = matlab_rails_replica(
            np.asarray(a), b, md, maxit=100, seed_vec=seed)
        assert conv and it <= 100
        assert resvec[-1] < 1e-4
        v, t, info = solve_laplace(a, md, b, maxit=100)
        assert info.converged
        assert abs(info.iter - it) <= 25, (info.iter, it)


# ----------------------------------------- tests/test_options_wired.py
class TestFastOrthogonalization:
    @pytest.mark.parametrize("fast", [True, False])
    def test_converges_and_orthonormal(self, rng, fast):
        a, b = tridiagonal_problem(rng)
        v, t, info = solve(a, b, tol=1e-6, fast_orthogonalization=fast)
        assert info.converged
        assert max_residual(a, v, t, b) < 1e-3
        g = (v.T @ v).numpy()
        assert np.abs(g - np.eye(g.shape[0])).max() < 1e-8

    def test_fast_with_restarts(self, rng):
        a, b = tridiagonal_problem(rng, 20)
        v, t, info = solve(
            a, b, tol=1e-3, restart_size=19, reduced_size=15, expand=1,
            fast_orthogonalization=True, restart_upon_convergence=False)
        assert info.converged
        assert max_residual(a, v, t, b) < 1e-3

    def test_fast_m_orthogonalization(self, rng):
        n = 20
        a, b = tridiagonal_problem(rng, n)
        md = rng.uniform(0.5, 1.5, n)
        v, t, info = solve(a, b, diag(md), tol=1e-4, ortho="M",
                           fast_orthogonalization=True)
        assert info.converged
        v = v.numpy()
        g = v.T @ (md[:, None] * v)
        assert np.abs(g - np.eye(g.shape[0])).max() < 1e-8
        assert max_residual(a, v, t, b, m=np.diag(md)) < 1e-3


class TestRestartFromSolution:
    def test_requires_space(self):
        with pytest.raises(InvalidOption):
            solver(-np.eye(4), np.ones((4, 1)), restart_from_solution=True)

    def test_warm_start_from_previous_v(self, rng):
        # the C++ continuation use case (LyapunovSolver_test.cpp:312-352)
        n = 20
        a, b = tridiagonal_problem(rng, n)
        v1, t1, info1 = solve(a, b, tol=1e-8)
        assert info1.converged
        a2 = a.copy()
        a2[n - 1, n - 1] = 4.0
        v2, t2, info2 = solve(a2, b, tol=1e-8, space=v1,
                              restart_from_solution=True)
        assert info2.converged
        assert max_residual(a2, v2, t2, b) < 1e-3
        # the previous basis is taken as it is: a second warm solve on
        # the same A converges at once
        v3, t3, info3 = solve(a, b, tol=1e-8, space=v1,
                              restart_from_solution=True)
        assert info3.converged
        assert info3.iter <= 2


class TestLanczosTolerance:
    def test_changes_residual_estimates(self, rng):
        a, b = tridiagonal_problem(rng)
        _, _, info_ref = solve(a, b, tol=1e-6)
        _, _, info_trunc = solve(a, b, tol=1e-6, lanczos_tolerance=0.5)
        r1, r2 = info_ref.resvec, info_trunc.resvec
        k = min(len(r1), len(r2))
        assert (len(r1) != len(r2)
                or not np.allclose(r1[:k], r2[:k], rtol=1e-6))


class TestDtypeGuards:
    def test_complex_payload_real_dtype_raises(self):
        a = (-np.eye(4) + 1j * np.triu(np.ones((4, 4)), 1)).astype(complex)
        with pytest.raises(InvalidOption):
            solver(dense(a), np.ones((4, 1)), dtype=np.float32)

    def test_hyb_astype_same_dtype_is_self(self):
        # banded + 120 stray entries on distinct off-stencil diagonals
        n = 512
        m = sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (n, n)).tolil()
        for i in range(120):
            m[i, 2 * i + 30] = 0.5
        op = rt.sparse_from_scipy(m.tocsr(), fmt="hyb", **CPU)
        assert op.format == "hyb"
        op32 = op.astype(torch.float32)
        assert op32.astype(torch.float32) is op32


def test_nonsingular_diagonal_m_silent(rng):
    """A diagonal M bounded away from zero passes the check silently."""
    a, md, b = laplace_setup(rng, 64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SingularMassMatrixWarning)
        solver(dense(a, is_symmetric=True), b, diag(md + 0.5))
