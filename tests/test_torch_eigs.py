"""The port's eigensolvers against the JAX package's, at float64 on the
CPU.

The two draw their random directions from other generators (the port a
``torch.Generator``, the JAX package ``jax.random.PRNGKey(0)``), so they
take other Krylov paths and are held to their converged eigenvalues, not
iterate by iterate.  A pair converged to a residual ||A v - lambda v|| <=
tol |lambda_max| has an eigenvalue error of at most that residual (and of
its square over the gap for a symmetric operator), so the values agree to
the stated tol times |lambda_max|.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

from rails_tpu.eigs import eigs as jax_eigs
from rails_tpu.eigs import eigs_general as jax_eigs_general
from rails_tpu.operators import DenseOperator as JaxDense
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
from rails_tpu_torch.eigs import EigsConvergenceWarning, eigs, eigs_general
from rails_tpu_torch.models.problems import laplacian2_sparse
from rails_tpu_torch.operators import DenseOperator
from rails_tpu_torch.sparse.formats import sparse_from_scipy

torch.set_num_threads(1)


def _pair(a):
    return JaxDense(jnp.asarray(a)), DenseOperator(torch.from_numpy(a),
                                                   device="cpu")


def _sorted(ev):
    """By modulus (rounded, so a conjugate pair ties), then imaginary
    part: the order of a pair's members is roundoff's choice."""
    ev = np.asarray(ev)
    return ev[np.lexsort((np.imag(ev), -np.round(np.abs(ev), 6)))]


class TestEigs:
    @pytest.mark.parametrize("num,block_size", [(6, 1), (4, 2)])
    def test_laplacian_matches_jax(self, num, block_size):
        lap = laplacian2_sparse(16)
        opj = jax_sparse(lap, dtype=jnp.float64)
        opt = sparse_from_scipy(lap, dtype=torch.float64, device="cpu")
        ej, _, ij = jax_eigs(opj, num=num, tol=1e-8, block_size=block_size,
                             return_info=True)
        et, vt, it = eigs(opt, num=num, tol=1e-8, block_size=block_size,
                          return_info=True)
        assert it.converged and ij.converged and it.n_converged == num
        scale = abs(float(ej[0]))
        assert np.abs(et.numpy() - np.asarray(ej)).max() <= 1e-8 * scale
        r = lap @ vt.numpy() - vt.numpy() * et.numpy()[None, :]
        assert np.linalg.norm(r, axis=0).max() <= 1e-8 * scale

    def test_multiplicity_with_blocks(self, rng):
        # a triple dominant eigenvalue: block Lanczos of size 3 finds all
        # three copies
        n = 300
        q, _ = np.linalg.qr(rng.uniform(-1, 1, (n, n)))
        d = np.concatenate([[3.0, 3.0, 3.0], rng.uniform(-1, 1, n - 3)])
        a = (q * d) @ q.T
        opj, opt = _pair(0.5 * (a + a.T))
        ej, _ = jax_eigs(opj, num=3, tol=1e-8, block_size=3)
        et, _ = eigs(opt, num=3, tol=1e-8, block_size=3)
        assert np.allclose(et.numpy(), 3.0, atol=1e-8)
        assert np.allclose(et.numpy(), np.asarray(ej), atol=1e-8)

    def test_drop_tol(self):
        # rank-3 operator: the zero eigenvalues are dropped
        rng = np.random.default_rng(1)
        v = np.linalg.qr(rng.uniform(-1, 1, (100, 3)))[0]
        a = (v * [4.0, 2.0, 1.0]) @ v.T
        opj, opt = _pair(a)
        ej, _ = jax_eigs(opj, num=6, tol=1e-10, drop_tol=1e-8)
        et, vt = eigs(opt, num=6, tol=1e-10, drop_tol=1e-8)
        assert et.shape == (3,) and vt.shape == (100, 3)
        assert np.allclose(et.numpy(), np.asarray(ej), atol=1e-10)

    def test_unconverged_warns_and_mesh_raises(self, rng):
        a = rng.uniform(-1, 1, (200, 200))
        _, opt = _pair(a + a.T)
        with pytest.warns(EigsConvergenceWarning):
            _, _, info = eigs(opt, num=6, tol=1e-14, max_restarts=1,
                              subspace=10, return_info=True)
        assert not info.converged and info.residuals.shape == (6,)
        # a mesh over more than one distinct device is not ported
        from rails_tpu_torch.parallel.mesh import make_mesh
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            eigs(opt, num=2, mesh=make_mesh(devices=["cpu", "meta"]))

    def test_generator_is_used(self, rng):
        a = rng.uniform(-1, 1, (80, 80))
        _, opt = _pair(a + a.T)
        with pytest.warns(EigsConvergenceWarning):
            e1, _ = eigs(opt, num=2, max_restarts=1, subspace=6,
                         generator=torch.Generator().manual_seed(1))
            e2, _ = eigs(opt, num=2, max_restarts=1, subspace=6,
                         generator=torch.Generator().manual_seed(1))
        assert torch.equal(e1, e2)


class TestEigsGeneral:
    def test_complex_pairs(self):
        n = 300
        a = np.diag(np.linspace(-1.0, 1.0, n))
        a[0:2, 0:2] = [[0.5, 3.0], [-3.0, 0.5]]
        a[2:4, 2:4] = [[0.3, 2.0], [-2.0, 0.3]]
        opj, opt = _pair(a)
        ej, _, ij = jax_eigs_general(opj, num=4, tol=1e-8, return_info=True)
        et, vt, it = eigs_general(opt, num=4, tol=1e-8, return_info=True)
        assert it.converged and ij.converged
        want = _sorted([0.5 + 3j, 0.5 - 3j, 0.3 + 2j, 0.3 - 2j])
        assert np.abs(_sorted(et.numpy()) - want).max() <= 1e-7
        lam_max = abs(0.5 + 3j)
        # each within tol |lambda_max| of the truth
        assert np.abs(_sorted(et.numpy()) - _sorted(ej)).max() \
            <= 2e-8 * lam_max
        r = a @ vt.numpy() - vt.numpy() * et.numpy()[None, :]
        assert np.linalg.norm(r, axis=0).max() <= 1e-8 * lam_max

    def test_nonsymmetric_sparse_matches_jax(self):
        # a convection-diffusion stencil
        side = 12
        n = side * side
        a = (laplacian2_sparse(side)
             + 0.3 * sp.diags([1.0, -1.0], [1, -1], (n, n))).tocsr()
        opj = jax_sparse(a, dtype=jnp.float64)
        opt = sparse_from_scipy(a, dtype=torch.float64, device="cpu")
        # num=4 holds two whole conjugate pairs
        ej, _ = jax_eigs_general(opj, num=4, tol=1e-9, max_restarts=200)
        et, _ = eigs_general(opt, num=4, tol=1e-9, max_restarts=200)
        scale = abs(complex(np.asarray(ej)[0]))
        assert np.abs(_sorted(et.numpy()) - _sorted(ej)).max() \
            <= 1e-7 * scale

    def test_block_multiplicity(self, rng):
        n = 200
        b = np.diag(np.concatenate([[2.0, 2.0, 2.0],
                                    rng.uniform(-1.2, 1.2, n - 3)]))
        b[0:3, 3:] = rng.uniform(-0.3, 0.3, (3, n - 3))
        q, _ = np.linalg.qr(rng.uniform(-1, 1, (n, n)))
        _, opt = _pair(q @ b @ q.T)
        et, vt, info = eigs_general(opt, num=3, tol=1e-8, block_size=3,
                                    max_restarts=150, return_info=True)
        assert info.converged
        assert np.allclose(et.numpy(), 2.0, atol=1e-6)
        assert np.linalg.matrix_rank(vt.numpy(), tol=1e-6) == 3
