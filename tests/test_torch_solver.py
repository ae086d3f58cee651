"""The port's solver on the CPU: the JAX package's solver tests
(tests/test_solver.py) run against ``rails_tpu_torch``, including the
r0sq and M-presence regressions; ``TestNotPortedYet`` held the options
that raised before they were ported and now checks them against the
eager path."""

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu_torch as rt
from rails_tpu_torch.core.solver import LyapunovSolver, _round_up
from rails_tpu_torch.models.problems import tridiagonal_problem

# one intra-op thread: the suite runs in several worker processes at once,
# and small ops with many threads each oversubscribe the cores
torch.set_num_threads(1)

CPU = {"device": "cpu"}


def tri(rng, n=20):
    a, b = tridiagonal_problem(rng, n)
    return a, b


def true_residual(a, v, t, b, m=None):
    v, t = np.asarray(v), np.asarray(t)
    x = v @ t @ v.T
    if m is None:
        r = a @ x + x @ a.T + b @ b.T
    else:
        r = a @ x @ m.T + m @ x @ a.T + b @ b.T
    return np.abs(r).max()


class TestStlSolverMirror:
    def test_basic_solve(self, rng):
        a, b = tri(rng)
        v, t, info = rt.solve(a, b, tol=1e-3, **CPU)
        assert info.converged, info
        assert v.dtype == torch.float64 and v.device.type == "cpu"
        assert true_residual(a, v, t, b) < 1e-3

    def test_solve_twice(self, rng):
        a, b = tri(rng)
        solver = LyapunovSolver(a, b, tol=1e-3, **CPU)
        runs = [solver.solve() for _ in range(2)]
        for v, t, info in runs:
            assert info.converged
            assert true_residual(a, v, t, b) < 1e-3
        assert runs[0][2].iter == runs[1][2].iter  # seeded: same draws

    def test_restart_size(self, rng):
        a, b = tri(rng, 20)
        v, t, info = rt.solve(a, b, tol=1e-3, restart_size=19,
                              reduced_size=15, expand=1,
                              restart_upon_convergence=False, **CPU)
        assert info.converged
        assert v.shape[1] < 20
        # the solver's guarantee is lambda_max(R) < tol * ||B||^2 (the
        # port's draws differ from jax.random's, so its run is another)
        thr = 1e-3 * float(np.linalg.norm(b) ** 2)
        assert true_residual(a, v, t, b) < 1.5 * thr

    def test_minimize_solution_space(self, rng):
        a, b = tri(rng, 20)
        v1, t1, i1 = rt.solve(a, b, tol=1e-8,
                              restart_upon_convergence=False, **CPU)
        v2, t2, i2 = rt.solve(a, b, tol=1e-8,
                              restart_upon_convergence=True, **CPU)
        assert i1.converged and i2.converged
        assert v2.shape[1] < v1.shape[1] or v2.shape[1] < 20
        assert true_residual(a, v2, t2, b) < 1e-3

    def test_restart_iterations(self, rng):
        a, b = tri(rng, 20)
        a = a - 3.0 * np.eye(20)
        v, t, info = rt.solve(a, b, tol=1e-3, restart_iterations=10,
                              expand=1, restart_upon_convergence=False,
                              **CPU)
        assert info.converged
        assert v.shape[1] < 20
        thr = 1e-3 * float(np.linalg.norm(b) ** 2)
        assert true_residual(a, v, t, b) < 1.5 * thr

    def test_restart_from_solution(self, rng):
        a, b = tri(rng, 20)
        v1, _, i1 = rt.solve(a, b, tol=1e-8, **CPU)
        a2 = a.copy()
        a2[19, 19] = 4.0
        v2, t2, i2 = rt.solve(a2, b, tol=1e-8, space=v1,
                              restart_upon_convergence=True, **CPU)
        assert i1.converged and i2.converged
        assert true_residual(a2, v2, t2, b) < 1e-3

    def test_warm_restart_data(self, rng):
        a, b = tri(rng)
        _, _, i1 = rt.solve(a, b, tol=1e-6, **CPU)
        v2, t2, i2 = rt.solve(a, b, tol=1e-6, restart_data=i1.restart_data,
                              **CPU)
        assert i2.converged and i2.iter <= i1.iter
        assert true_residual(a, v2, t2, b) < 1e-3


class TestKnownAnswer:
    def test_2x2_epetra_mirror(self):
        a = np.array([[0.0, 1.0], [-5.0, -5.0]])
        v, t, info = rt.solve(a, -np.eye(2), tol=1e-12, expand=2,
                              restart_upon_convergence=False, **CPU)
        assert info.converged
        x = (v @ t @ v.T).numpy()
        assert np.allclose(x, [[0.62, -0.5], [-0.5, 0.6]], atol=1e-12)

    def test_scalar(self):
        v, t, info = rt.solve(np.array([[2.0]]), np.array([[-4.0]]),
                              tol=1e-10, restart_upon_convergence=False,
                              **CPU)
        assert info.converged
        assert abs(float(v[0, 0]) ** 2 * float(t[0, 0]) + 4.0) < 1e-10

    def test_nan_abort(self, rng):
        b = rng.uniform(-1, 1, (4, 1))
        _, _, info = rt.solve(np.zeros((4, 4)), b, maxit=10, **CPU)
        assert info.status in (-1, -2)


class TestGeneralized:
    def test_diagonal_mass(self, rng):
        a, b = tri(rng, 20)
        md = rng.uniform(0.5, 1.5, 20)
        v, t, info = rt.solve(a, b, rt.DiagonalOperator(md, **CPU),
                              tol=1e-6, **CPU)
        assert info.converged
        assert true_residual(a, v, t, b, np.diag(md)) < 1e-4

    def test_m_orthogonalization(self, rng):
        a, b = tri(rng, 20)
        md = rng.uniform(0.5, 1.5, 20)
        v, t, info = rt.solve(a, b, rt.DiagonalOperator(md, **CPU),
                              tol=1e-6, ortho="M", **CPU)
        assert info.converged
        v = v.numpy()
        assert np.allclose(v.T @ np.diag(md) @ v, np.eye(v.shape[1]),
                           atol=1e-8)
        assert true_residual(a, v, t, b, np.diag(md)) < 1e-4

    def test_dia_laplacian_with_mass(self, rng):
        from rails_tpu_torch.models.problems import laplacian2_sparse

        lap = laplacian2_sparse(12)
        md = rng.uniform(0.5, 1.5, 144)
        b = rng.uniform(0, 1, (144, 4))
        aop = rt.sparse_from_scipy(lap, dtype=torch.float64,
                                   is_symmetric=True, **CPU)
        v, t, info = rt.solve(aop, b, rt.DiagonalOperator(md, **CPU),
                              tol=1e-6, expand=4, **CPU)
        assert info.converged
        r = true_residual(lap.toarray(), v, t, b, np.diag(md))
        assert r < 1e-5 * np.linalg.norm(b.T @ b, 2)

    @pytest.mark.parametrize("fast", [True, False])
    def test_per_column_append(self, rng, fast):
        a, b = tri(rng, 20)
        v, t, info = rt.solve(a - 2 * np.eye(20), b, tol=1e-6,
                              fast_orthogonalization=fast, **CPU)
        assert info.converged
        assert true_residual(a - 2 * np.eye(20), v, t, b) < 1e-4

    def test_float32(self, rng):
        a, b = tri(rng, 20)
        v, t, info = rt.solve(a - 3 * np.eye(20), b, tol=1e-4,
                              dtype=torch.float32, **CPU)
        assert info.converged and v.dtype == torch.float32
        assert true_residual(a - 3 * np.eye(20), v, t, b) < 1e-3


class TestRegressions:
    def test_r0sq_follows_b(self, rng):
        """The JAX package once cached ||B||^2 across solves and declared
        phantom convergence after B shrank 1000x.  The port recomputes
        r0sq from the B of each solver."""
        a, b = tri(rng, 24)
        a = a - 2.0 * np.eye(24)
        _, _, i1 = rt.solve(a, b, tol=1e-6, **CPU)
        b3 = b * 1e-3
        v, t, i3 = rt.solve(a, b3, tol=1e-6, **CPU)
        assert i3.converged and i3.iter == i1.iter
        r0 = float(np.linalg.norm(b3.T @ b3, 2))
        assert true_residual(a, v, t, b3) / r0 < 1e-4

    def test_m_presence_reaches_first_gram_block(self, rng):
        """The JAX package once dropped M from the first Gram block when a
        cached engine crossed M presence.  Solving without, then with, M
        must give the generalized residual of the second equation."""
        a, b = tri(rng, 24)
        a = a - 2.0 * np.eye(24)
        v, t, info = rt.solve(a, b, tol=1e-8, **CPU)
        assert info.converged and true_residual(a, v, t, b) < 1e-6
        md = rng.uniform(0.5, 1.5, 24)
        v2, t2, i2 = rt.solve(a, b, rt.DiagonalOperator(md, **CPU),
                              tol=1e-8, **CPU)
        assert i2.converged
        assert true_residual(a, v2, t2, b, m=np.diag(md)) < 1e-6

    def test_state_invariants(self, rng):
        """Masked-state invariants after every iteration: active columns
        orthonormal, buffers beyond k exactly zero, AV and VAV matching
        their definitions for the blocks already updated."""
        a, b = tri(rng, 24)
        solver = LyapunovSolver(a, b, tol=1e-8, **CPU)
        with torch.no_grad():
            st, ctx = solver._init_state(24)
            for _ in range(12):
                solver._iterate(st, ctx)
                k = st.k
                kdone = st.w_start if st.n_new > 0 else k
                v = st.V.numpy()
                assert np.allclose(v[:, :k].T @ v[:, :k], np.eye(k),
                                   atol=1e-12)
                assert np.all(v[:, k:] == 0.0)
                vav = st.VAV.numpy()
                assert np.all(vav[k:, :] == 0.0) and np.all(vav[:, k:] == 0)
                av = st.AV.numpy()[:, :kdone]
                assert np.allclose(av, a @ v[:, :kdone], atol=1e-12)
                assert np.allclose(vav[:kdone, :kdone],
                                   v[:, :kdone].T @ a @ v[:, :kdone],
                                   atol=1e-11)
                if st.done:
                    break

    def test_capacity_ladder_grows(self, rng, monkeypatch):
        """The (m, Kb) buffers start small and grow on the ladder
        (solver.py:466-473): Kb doubles, rounded to 8, up to cap_kb."""
        from rails_tpu_torch.models.problems import laplacian2_sparse

        grown = []
        orig = LyapunovSolver._grow_state

        def spy(st, kb_new):
            grown.append((st.VAV.shape[0], kb_new, st.k))
            orig(st, kb_new)

        monkeypatch.setattr(LyapunovSolver, "_grow_state",
                            staticmethod(spy))
        lap = laplacian2_sparse(16)
        b = rng.uniform(0, 1, (256, 4))
        v, t, info = rt.solve(
            rt.sparse_from_scipy(lap, dtype=torch.float64, **CPU), b,
            tol=1e-9, expand=4, **CPU)
        assert info.converged
        assert grown, "the capacity never grew"
        for kb_old, kb_new, k in grown:
            assert kb_new == min(_round_up(2 * kb_old, 8), kb_new)
            assert k + 2 * 4 > kb_old - 4  # the resize rule fired


class TestNotPortedYet:
    def test_compiled_matches_eager(self, rng):
        """compiled=True is ported (core/engine.py): on the CPU it runs
        the recorded iteration eagerly and converges to the eager path's
        iteration count and solution."""
        a, b = tri(rng)
        v0, t0, i0 = rt.solve(a, b, tol=1e-6, **CPU)
        v1, t1, i1 = rt.solve(a, b, tol=1e-6, compiled=True, **CPU)
        assert i1.converged and i1.iter == i0.iter
        assert v1.shape == v0.shape
        assert true_residual(a, v1, t1, b) < 1e-4
        x0, x1 = v0 @ t0 @ v0.T, v1 @ t1 @ v1.T
        assert (x1 - x0).abs().max().item() < 1e-10

    def test_compensated_raises(self, rng):
        # compiled=True with compensated precision: the same iteration
        # count and solution as the eager compensated solve
        a, b = tri(rng)
        v, t, info = rt.solve(a, b, tol=1e-6, precision="compensated",
                              **CPU)
        assert info.converged and true_residual(a, v, t, b) < 1e-4
        v1, t1, i1 = rt.solve(a, b, tol=1e-6, precision="compensated",
                              compiled=True, **CPU)
        assert i1.converged and i1.iter == info.iter
        assert true_residual(a, v1, t1, b) < 1e-4
        x0, x1 = v @ t @ v.T, v1 @ t1 @ v1.T
        assert (x1 - x0).abs().max().item() < 1e-10

    def test_scipy_input_goes_through_dia(self, rng):
        a, b = tri(rng)
        v, t, info = rt.solve(sp.csr_matrix(a), b, tol=1e-6, **CPU)
        assert info.converged and true_residual(a, v, t, b) < 1e-4
