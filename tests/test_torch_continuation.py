"""The port's ``ContinuationSolver`` against the JAX package's.

Three steps of bench.py::phase_continuation's Jacobian family (the 2D
Laplacian with its diagonal shifted by -theta, theta = 0, 0.05, 0.1) at
side 32, float64, M = diag(U[0.5, 1.5]), B (n, 8), fed the JAX package's
draws (each step is a fresh ``LyapunovSolver``, so the key chain restarts
at every step): the same iteration count at every step, warm steps
faster than the cold one.  Before each warm step the port carries the
JAX package's carried basis: the trailing directions of a solution at
tol 1e-4 are fixed only to about the tolerance (the two packages' 60
carried columns span subspaces 5e-5 apart after the cold step), and a
warm step started from bases that far apart can end one iteration
earlier or later, so the comparison is made step by step.  ``_truncate_basis`` on
the same (V, T) keeps the same span in both packages (projector
difference <= 1e-10: the eigenvector signs may differ, the span may not),
and ``save``/``load`` round-trip, across the two packages too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu.continuation import ContinuationSolver as JaxCont
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
import rails_tpu_torch as rt
from test_torch_parity import JaxDraws
from test_torch_parity import jax_sign_fixed  # noqa: F401  (fixture)

torch.set_num_threads(1)

SIDE = 32
OPTS = dict(tol=1e-4, expand=6, restart_size=120, reduced_size=60,
            maxit=200)


def jacobian(theta, side=SIDE):
    return (sp.kron(sp.eye(side), sp.diags([1.0, -4.0 - theta, 1.0],
                                           [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()


def problem():
    n = SIDE * SIDE
    rng = np.random.default_rng(0)
    return rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, (n, 8))


def _projector(v):
    v = np.asarray(v, np.float64)
    return v @ v.T


def test_three_steps_same_iterations(jax_sign_fixed):
    md, b = problem()
    jc = JaxCont(jnp.asarray(b), rails_tpu.DiagonalOperator(jnp.asarray(md)),
                 dtype=jnp.float64, **OPTS)
    draws = JaxDraws(4634)
    tc = rt.ContinuationSolver(
        torch.from_numpy(b), rt.DiagonalOperator(torch.from_numpy(md),
                                                 device="cpu"),
        device="cpu", draws=draws, dtype=torch.float64, **OPTS)
    iters = []
    for theta in (0.0, 0.05, 0.1):
        a = jacobian(theta)
        if theta > 0:
            assert tuple(tc._prev_space.shape) == jc._prev_space.shape
            tc._prev_space = torch.from_numpy(np.array(jc._prev_space))
        _, _, ij = jc.step(jax_sparse(a, fmt="dia", dtype=jnp.float64,
                                      is_symmetric=True))
        draws.__init__(4634)
        vt, tt, it = tc.step(rt.sparse_from_scipy(
            a, fmt="dia", dtype=torch.float64, is_symmetric=True,
            device="cpu"))
        assert it.converged and ij.converged
        assert it.iter == ij.iter
        assert tc._prev_space.shape == np.asarray(jc._prev_space).shape
        iters.append(it.iter)
    assert max(iters[1:]) < iters[0]
    assert [h.iter for h in tc.history] == iters


def test_truncate_basis_same_span(rng):
    md, b = problem()
    v, t, _ = rails_tpu.solve(
        jax_sparse(jacobian(0.0), fmt="dia", dtype=jnp.float64,
                   is_symmetric=True), jnp.asarray(b),
        rails_tpu.DiagonalOperator(jnp.asarray(md)), dtype=jnp.float64,
        tol=1e-6, expand=6, restart_size=120, reduced_size=60, maxit=200)
    k = v.shape[1]
    assert k > 20
    for keep in (20, k - 3, k + 5):
        pj = JaxCont._truncate_basis(v, t, keep)
        pt = rt.ContinuationSolver._truncate_basis(
            torch.from_numpy(np.array(v)), torch.from_numpy(np.array(t)),
            keep)
        assert pt.shape == pj.shape == (v.shape[0], min(k, keep))
        assert np.abs(_projector(pt.numpy()) - _projector(pj)).max() \
            <= 1e-10


def test_save_load_round_trip(tmp_path):
    md, b = problem()
    tc = rt.ContinuationSolver(
        torch.from_numpy(b), rt.DiagonalOperator(torch.from_numpy(md),
                                                 device="cpu"),
        device="cpu", dtype=torch.float64, **OPTS)
    with pytest.raises(ValueError, match="nothing to save"):
        tc.save(str(tmp_path / "none"))
    _, _, info0 = tc.step(rt.sparse_from_scipy(
        jacobian(0.0), fmt="dia", dtype=torch.float64, is_symmetric=True,
        device="cpu"))
    path = str(tmp_path / "cont_checkpoint")   # no suffix on purpose
    tc.save(path)
    # a fresh port solver and the JAX package's both read it back
    t2 = rt.ContinuationSolver(
        torch.from_numpy(b), rt.DiagonalOperator(torch.from_numpy(md),
                                                 device="cpu"),
        device="cpu", dtype=torch.float64, **OPTS)
    t2.load(path)
    assert torch.equal(t2._prev_space, tc._prev_space)
    jc = JaxCont(jnp.asarray(b), dtype=jnp.float64, **OPTS)
    jc.load(path)
    assert np.array_equal(jc._prev_space, tc._prev_space.numpy())
    # and the JAX package's file is read by the port
    jpath = str(tmp_path / "jax_checkpoint")
    jc.save(jpath)
    t2.load(jpath)
    assert np.array_equal(t2._prev_space.numpy(), jc._prev_space)
    _, _, info1 = t2.step(rt.sparse_from_scipy(
        jacobian(0.05), fmt="dia", dtype=torch.float64, is_symmetric=True,
        device="cpu"))
    assert info1.converged and info1.iter < info0.iter


def test_mesh_raises():
    """One process over more than one distinct device is refused by
    design (one device: tests/test_torch_mesh.py; one process per card:
    tests/test_torch_multihost.py)."""
    with pytest.raises(NotImplementedError, match="one process per card"):
        rt.ContinuationSolver(np.ones((4, 1)), mesh=rt.make_mesh(
            devices=["cpu", "meta"]))
