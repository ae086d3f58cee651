"""``solve(compiled=True)`` on a Schur reduction whose A11 solve runs on
the host, and with an ``inv_a`` that the expansion applies, against the
JAX package's ``solve(compiled=True)``; the singular-M check on a dense
M.

The problem is examples/distributed_schur.py's index-1 DAE (n = 240, a
third of M's diagonal zeroed, B zero in those rows), reduced by each
package's ``schur_reduce`` at float64, solved to tol 1e-8.  The JAX
package runs its host solves through ``jax.pure_callback``; the port
runs them as host steps of its recorded iteration
(``core/engine.py::host_call``), which on the CPU are plain calls.  The
port takes the JAX package's draws, and both fix the Lanczos
eigenvector signs (tests/test_torch_parity.py says why).

Held: the same iteration count and status, and V T V' within 1e-6 of
the JAX solution relative to its largest entry (the two runs differ in
the last bits of every BLAS call, amplified over the 41-82 iterations;
the measured gaps are below 1e-9).

The iterative A11 case runs in tests/test_torch_schur_compiled_iterative.py
(the slowest on the CPU; the suite's workers take a file each).  Tests
marked ``cuda`` run on the card: each compiled case against the
eager solver at the compiled path's full capacity, iteration for
iteration, and the host steps per iteration that ``info.engine``
reports.
"""

import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu.schur import schur_reduce as jax_schur
import rails_tpu_torch as rt
from rails_tpu_torch.core.options import SingularMassMatrixWarning
from rails_tpu_torch.core.solver import LyapunovSolver
from rails_tpu_torch.utils.host_blas import single_thread_blas

from test_torch_parity import (  # noqa: F401  (jax_sign_fixed: fixture)
    JaxDraws, jax_sign_fixed)

torch.set_num_threads(1)

CPU = {"device": "cpu"}
TOL = 1e-8


@pytest.fixture(autouse=True, scope="module")
def one_blas_thread():
    """One OpenBLAS thread for this file's tests: both packages call
    LAPACK's zgees at k up to 160 each iteration (the projected Schur
    solve), and the suite runs in several workers at once, where each
    call's default thread per core oversubscribes the cores."""
    with single_thread_blas():
        yield


def dae(n=240):
    """examples/distributed_schur.py's DAE, from default_rng(0)."""
    rng = np.random.default_rng(0)
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = sp.csr_matrix(a - 3.0 * np.eye(n))
    md = rng.uniform(0.5, 1.5, n)
    md[rng.permutation(n)[: n // 3]] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[md == 0] = 0.0
    return a, sp.diags(md).tocsr(), b


# (a11_solver, sinv method for inv_a or None); the iterative A11 case,
# the slowest on the CPU, is in test_torch_schur_compiled_iterative.py
CASES = [("dense_lu", None), ("native_lu", None), ("iterative", None),
         ("dense_lu", "dense_lu"), ("dense_lu", "native_lu")]
IDS = ["a11_dense_lu", "a11_native_lu", "a11_iterative", "inv_a_dense_lu",
       "inv_a_native_lu"]
CPU_CASES = [c for c, i in zip(CASES, IDS) if i != "a11_iterative"]
CPU_IDS = [i for i in IDS if i != "a11_iterative"]


def options(sinv, red):
    if sinv is None:
        return {}
    return {"inv_a": red.sinv(sinv), "projection_method": 2.2}


def compiled_matches_jax(a11, sinv):
    a, m, b = dae()
    rj = jax_schur(a, m, b, a11_solver=a11, dtype=jnp.float64)
    vj, tj, ij = rails_tpu.solve(rj.operator, jnp.asarray(rj.bs), rj.ms,
                                 tol=TOL, compiled=True, dtype=jnp.float64,
                                 **options(sinv, rj))
    rp = rt.schur_reduce(a, m, b, a11_solver=a11, dtype=torch.float64,
                         **CPU)
    vp, tp, ip = rt.solve(rp.operator, rp.bs, rp.ms, tol=TOL, compiled=True,
                          draws=JaxDraws(4634), **CPU, **options(sinv, rp))
    assert ip.iter == ij.iter
    assert ip.status == ij.status == 0
    xj = np.asarray(vj) @ np.asarray(tj) @ np.asarray(vj).T
    xp = vp.numpy() @ tp.numpy() @ vp.numpy().T
    assert np.abs(xp - xj).max() <= 1e-6 * np.abs(xj).max()
    sources = ip.engine["host_step_sources"]
    assert ("A" in sources) == (a11 != "dense_lu")
    assert ("inv_a" in sources) == (sinv is not None)


@pytest.mark.parametrize("a11,sinv", CPU_CASES, ids=CPU_IDS)
def test_compiled_matches_jax(jax_sign_fixed, a11, sinv):
    compiled_matches_jax(a11, sinv)


class TestGeneralSingularM:
    """tests/test_options_wired.py::TestGeneralSingularM on the port."""

    def _problem(self, n=16):
        a = -2.0 * np.eye(n) + 0.3 * np.eye(n, k=1)
        b = np.ones((n, 1))
        return a, b

    def test_singular_nondiagonal_m_warns(self):
        n = 16
        a, b = self._problem(n)
        m = sp.diags([0.3, 1.0, 0.3], [-1, 0, 1], (n, n)).tolil()
        m[n - 1, :] = 0.0  # exactly singular, non-diagonal
        mop = rt.sparse_from_scipy(m.tocsr(), fmt="ell", **CPU)
        with pytest.warns(SingularMassMatrixWarning):
            LyapunovSolver(a, b, mop, **CPU)

    def test_nonsingular_nondiagonal_m_silent(self):
        n = 16
        a, b = self._problem(n)
        m = sp.diags([0.3, 2.0, 0.3], [-1, 0, 1], (n, n)).tocsr()
        mop = rt.sparse_from_scipy(m, fmt="dia", **CPU)
        with warnings.catch_warnings():
            warnings.simplefilter("error", SingularMassMatrixWarning)
            LyapunovSolver(a, b, mop, **CPU)

    def test_singular_dense_m_warns(self):
        n = 16
        a, b = self._problem(n)
        m = np.eye(n)
        m[0, 0] = 0.0
        with pytest.warns(SingularMassMatrixWarning):
            LyapunovSolver(a, b, rt.DenseOperator(m, **CPU), **CPU)


def test_large_dense_m_skip_is_narrated(capsys):
    """A dense M above 4096 rows is not copied to the host for the check:
    the skip is printed at verbosity > 0, as in the JAX package
    (a zero M, so a check that ran would warn)."""
    n = 4100
    m = torch.zeros((n, n), dtype=torch.float64)
    with warnings.catch_warnings():
        warnings.simplefilter("error", SingularMassMatrixWarning)
        LyapunovSolver(-torch.eye(n, dtype=torch.float64),
                       np.ones((n, 1)), rt.DenseOperator(m, **CPU),
                       verbosity=1, **CPU)
    assert "skipping singular-M condest check" in capsys.readouterr().out


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture has no CPU mode")
    return torch.device("cuda")


@pytest.fixture
def full_capacity(monkeypatch):
    """The eager solver with its state at the compiled path's full
    capacity from the first iteration (its arithmetic, shape for shape);
    returns a switch."""
    init = LyapunovSolver._init_state
    on = [False]

    def grown(self, m, *args, **kwargs):
        st, ctx = init(self, m, *args, **kwargs)
        if on[0]:
            self._grow_state(st, ctx.cap_kb)
            ctx.set_kb(ctx.cap_kb, m)
        return st, ctx

    monkeypatch.setattr(LyapunovSolver, "_init_state", grown)
    return on


@pytest.mark.cuda
def test_compiled_equals_full_capacity_eager_on_card(cuda_device,
                                                     full_capacity):
    """Each case compiled on the card (its host steps between graph
    segments) against the eager run at full capacity: the same
    iterations and status, V T V' within 1e-10; the host steps per
    iteration above the dense_lu case's, which has none of its own."""
    a, m, b = dae()
    per_iter = {}
    for (a11, sinv), name in zip(CASES, IDS):
        red = rt.schur_reduce(a, m, b, a11_solver=a11, dtype=torch.float64)
        runs = []
        for compiled in (False, True):
            full_capacity[0] = not compiled
            v, t, info = rt.solve(red.operator, red.bs, red.ms, tol=TOL,
                                  compiled=compiled, **options(sinv, red))
            runs.append((v.cpu().numpy(), t.cpu().numpy(), info))
        (ve, te, ie), (vc, tc, ic) = runs
        assert ic.iter == ie.iter and ic.status == ie.status == 0, name
        xe, xc = ve @ te @ ve.T, vc @ tc @ vc.T
        assert np.abs(xc - xe).max() <= 1e-10 * np.abs(xe).max(), name
        assert ic.engine["captured"], name
        per_iter[name] = ic.engine["host_steps_per_iter"]
    for name in IDS[1:]:
        assert per_iter[name] > per_iter["a11_dense_lu"], per_iter


def test_engine_cache_never_replays_another_reductions_lu(rng):
    """Two reductions of DAEs of one shape, native_lu, one engine cache:
    each S operator's apply (and with it its reduction's LU) is part of
    the engine key by identity, so the second solve gets an engine of
    its own and the solution a fresh solver gives.  ``clone_tree``
    shares a tensor-free object such as the LU rather than copying its
    host handle."""
    from rails_tpu_torch.core.engine import clone_tree
    from rails_tpu_torch.native.host_lib import NativeSparseLU

    def reduction(seed):
        a, m, b = dae(60)
        a = a + sp.diags(np.random.default_rng(seed).uniform(-0.5, 0.5, 60))
        return rt.schur_reduce(a, m, b, a11_solver="native_lu",
                               dtype=torch.float64, **CPU)

    cache = {}
    reds = [reduction(1), reduction(2)]
    outs = []
    for red in reds:
        v, t, info = LyapunovSolver(red.operator, red.bs, red.ms, tol=TOL,
                                    engine_cache=cache, **CPU).solve(
                                        compiled=True)
        outs.append((v @ t @ v.T, info.iter))
    assert len(cache) == 2
    v, t, info = LyapunovSolver(reds[1].operator, reds[1].bs, reds[1].ms,
                                tol=TOL, **CPU).solve(compiled=True)
    assert info.iter == outs[1][1]
    assert torch.equal(v @ t @ v.T, outs[1][0])

    op = reds[0].operator
    assert clone_tree(op) is op                 # no tensor of its own
    op.lu = NativeSparseLU(reds[0]._a11_scipy)
    op.payload = torch.ones(3)
    twin = clone_tree(op)
    assert twin is not op and twin.payload is not op.payload
    assert twin.lu is op.lu
