"""The port's refined driver (``refine.py``) against the JAX package's.

- ``residual_factor`` on the same (V, T, B): U2 S2 U2' equal to the JAX
  package's to 1e-10 relative (Frobenius, float64) and ||R0||_2 to 1e-12
  relative.  Both compress in float64 numpy on the host; what differs is
  the error-free apply of A and M on each side (exact to O(eps^2)).
- ``solve_refined`` at float64 fed the JAX package's draws: the same
  number of stages and the same iterations in each stage.  Each stage is
  a fresh ``LyapunovSolver``, so the JAX key chain restarts from
  ``PRNGKey(seed)`` at every stage's initial draw.
- The float32 run of the JAX bench's accuracy phase at its CPU size
  (bench.py::phase_accuracy, n = 1024 tridiagonal, ``precision=
  'compensated'``): float64 true residual <= 1.1e-8 in both packages
  (the bench's ``acc_target_met`` rule).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu import refine as jr
from rails_tpu.core.solver import LyapunovSolver as JaxSolver
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
import rails_tpu_torch as rt
from rails_tpu_torch import refine as tr
from test_torch_parity import JaxDraws
from test_torch_parity import jax_sign_fixed  # noqa: F401  (fixture)

torch.set_num_threads(1)


def tridiag(rng, n, p):
    """bench.py::phase_accuracy's problem: a stable tridiagonal with
    entries on a 1/1024 grid (exact in float32), B U[-1, 1) in float32."""
    q = lambda x: np.round(x * 1024) / 1024  # noqa: E731
    main = q(-2.0 - rng.uniform(0, 1, n))
    up = q(0.4 * rng.uniform(-1, 1, n - 1))
    lo = q(0.4 * rng.uniform(-1, 1, n - 1))
    a = sp.diags([lo, main, up], [-1, 0, 1]).tocsr()
    return a, np.asarray(rng.uniform(-1, 1, (n, p)), np.float32)


def true_rel(a, v, t, b, md=None):
    """||A X M + M X A' + B B'||_2 / ||B'B||_2 in float64, densely."""
    v = np.asarray(v, np.float64)
    x = v @ np.asarray(t, np.float64) @ v.T
    ad = a.toarray()
    m = np.eye(a.shape[0]) if md is None else np.diag(md)
    b = np.asarray(b, np.float64)
    r = ad @ x @ m + m @ x @ ad.T + b @ b.T
    return np.linalg.norm(r, 2) / np.linalg.norm(b.T @ b, 2)


class StageDraws(JaxDraws):
    """The JAX key chain, restarted at each stage's initial draw."""

    def __call__(self, kind, shape, dtype, device):
        if kind == "init_uniform":
            self.__init__(4634)
        return super().__call__(kind, shape, dtype, device)


def test_cholqr2_matches(rng):
    u = rng.uniform(-1, 1, (300, 12))
    qj, rj = jr.cholqr2(jnp.asarray(u))
    qt, rtt = tr.cholqr2(torch.from_numpy(u))
    assert np.abs(qt.T.numpy() @ qt.numpy() - np.eye(12)).max() < 1e-12
    assert np.abs(qt.numpy() @ rtt.numpy() - u).max() < 1e-12
    assert np.abs(qt.numpy() - np.asarray(qj)).max() < 1e-10


@pytest.mark.parametrize("with_m", [False, True])
def test_residual_factor_matches(rng, with_m):
    n = 256
    a, b32 = tridiag(rng, n, 3)
    md = (0.5 + np.floor(rng.uniform(0, 64, n)) / 64).astype(np.float32) \
        if with_m else None
    aj = jax_sparse(a, fmt="dia", dtype=jnp.float32)
    mj = None if md is None else rails_tpu.DiagonalOperator(jnp.asarray(md))
    s1 = JaxSolver(aj, jnp.asarray(b32), mj, tol=1e-5, dtype=jnp.float32,
                   maxit=100, expand=3)
    v0, t0, _ = s1.solve()
    uj, sj, ej, rj = jr.residual_factor(s1.A, s1.M, jnp.asarray(b32), None,
                                        v0, t0)
    at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float32,
                              device="cpu")
    mt = None if md is None else rt.DiagonalOperator(torch.from_numpy(md),
                                                     device="cpu")
    ut, st, et, rtn = tr.residual_factor(
        at, mt, torch.from_numpy(b32), None,
        torch.from_numpy(np.array(v0)), torch.from_numpy(np.array(t0)))
    assert ut.dtype == torch.float32 and st.dtype == torch.float32
    cj = np.asarray(uj, np.float64) @ np.asarray(sj, np.float64) \
        @ np.asarray(uj, np.float64).T
    ct = ut.double().numpy() @ st.double().numpy() @ ut.double().numpy().T
    assert np.linalg.norm(ct - cj) <= 1e-10 * np.linalg.norm(cj)
    assert abs(rtn - rj) <= 1e-12 * rj
    assert et <= 1e-6 * rj and ej <= 1e-6 * rj


def test_solve_refined_f64_same_stages(rng, jax_sign_fixed):
    n = 256
    a, b32 = tridiag(rng, n, 3)
    b = b32.astype(np.float64)
    aj = jax_sparse(a, fmt="dia", dtype=jnp.float64)
    vj, tj, ij = jr.solve_refined(aj, jnp.asarray(b), tol=1e-8,
                                  dtype=jnp.float64, maxit=100, expand=3)
    at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                              device="cpu")
    vt, tt, it = rt.solve_refined(at, torch.from_numpy(b), tol=1e-8,
                                  dtype=torch.float64, maxit=100, expand=3,
                                  device="cpu", draws=StageDraws(4634))
    assert len(ij.stages) >= 2
    assert [s.iter for s in it.stages] == [s.iter for s in ij.stages]
    assert it.converged and ij.converged and it.iter == ij.iter
    assert isinstance(it, rt.RefineInfo)
    assert vt.shape == vj.shape and tt.shape == tj.shape
    # T is block-diagonal over the stages, with the same blocks
    assert np.array_equal(tt.numpy() == 0, np.asarray(tj) == 0)
    assert true_rel(a, vt.numpy(), tt.numpy(), b) <= 2e-8


def test_f32_reaches_1e8_in_both(rng):
    """bench.py::phase_accuracy at its CPU size (n = 1024, B (n, 4))."""
    n = 1024
    rng0 = np.random.default_rng(0)
    a, b32 = tridiag(rng0, n, 4)
    kw = dict(tol=1e-8, maxit=100, expand=4, precision="compensated")
    aj = jax_sparse(a, fmt="dia", dtype=jnp.float32, is_hurwitz=True)
    vj, tj, ij = jr.solve_refined(aj, jnp.asarray(b32), dtype=jnp.float32,
                                  **kw)
    at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float32,
                              is_hurwitz=True, device="cpu")
    vt, tt, it = rt.solve_refined(at, torch.from_numpy(b32), device="cpu",
                                  **kw)
    assert vt.dtype == torch.float32 and it.converged and ij.converged
    assert true_rel(a, vj, tj, b32) <= 1.1e-8
    assert true_rel(a, vt.numpy(), tt.numpy(), b32) <= 1.1e-8
    # the refinement does work a single float32 solve cannot
    assert len(it.stages) >= 2


def test_compiled_still_raises(rng):
    """solve_refined(compiled=True) runs every stage through the
    recorded iteration and reaches the case's 1e-8 target (true
    residual at most 1.1e-8, the JAX bench's acc_target_met), with the
    eager run's stage iteration counts."""
    a, b32 = tridiag(rng, 64, 2)
    at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float32,
                              device="cpu")
    kw = dict(tol=1e-8, maxit=100, expand=2, precision="compensated",
              device="cpu")
    ve, te, ie = rt.solve_refined(at, torch.from_numpy(b32), **kw)
    vc, tc, ic = rt.solve_refined(at, torch.from_numpy(b32), compiled=True,
                                  **kw)
    assert ic.converged and ie.converged
    assert [s.iter for s in ic.stages] == [s.iter for s in ie.stages]
    assert all(s.engine is not None for s in ic.stages)
    assert true_rel(a, vc.numpy(), tc.numpy(), b32) <= 1.1e-8
