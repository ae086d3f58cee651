"""The port's hub split (``rails_tpu_torch/sparse/hub.py``) against scipy
and the JAX package's (``rails_tpu/sparse/hub.py``), at float64 on the
CPU; tests/test_sparse.py:624-716 ported.

Matrices: tests/test_sparse.py's superhub construction (a banded bulk
plus a few hub rows and their half-weight partner columns) and a
Barabasi-Albert graph.  Tolerances: the apply to 1e-11 absolute against
scipy (the JAX tests' bound) and to 1e-14 of the largest entry against
the JAX operator (the same products in another order); the split itself
(hub indices, the dense block, the ELL payloads) equal bit for bit.  The
solve on a hub operator goes through both packages draw for draw
(the ``draws`` hook); its tolerances are stated at the test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
import rails_tpu_torch
import test_sparse
from rails_tpu.sparse.hub import hub_operator as jax_hub_operator
from rails_tpu_torch import interop
from rails_tpu_torch.sparse.ell_spmm import ell_spmm
from rails_tpu_torch.sparse.hub import (
    HubSplitOperator, hub_coverage, hub_operator)

from test_torch_parity import (  # noqa: F401  (jax_sign_fixed: fixture)
    JaxDraws, jax_sign_fixed)

torch.set_num_threads(1)

_superhub = test_sparse.TestHubSplit._superhub


def _port(a, **kw):
    return hub_operator(a, dtype=torch.float64, device="cpu", **kw)


def _x(rng, m, s):
    x = rng.uniform(-1, 1, (m, s))
    return x, torch.from_numpy(x)


def test_matches_scipy(rng):
    a = _superhub(rng)
    op = _port(a, max_hubs=16, degree_factor=6.0)
    assert op.hub_idx.shape[0] > 0 and not op.is_symmetric
    assert op.bwd is not None
    x, xt = _x(rng, a.shape[0], 5)
    np.testing.assert_allclose(op.matmat(xt).numpy(), a @ x, atol=1e-11)
    np.testing.assert_allclose(op.rmatmat(xt).numpy(), a.T @ x, atol=1e-11)
    # a vector, and the dense form
    np.testing.assert_allclose(op.matmat(xt[:, 0]).numpy(), a @ x[:, 0],
                               atol=1e-11)
    np.testing.assert_allclose(op.to_dense().numpy(), a.toarray(),
                               atol=1e-14)


def test_symmetric_reuses_split(rng):
    a = _superhub(rng)
    a = (a + a.T).tocsr()
    op = _port(a, max_hubs=16, degree_factor=6.0)
    assert op.is_symmetric and op.bwd is None
    x, xt = _x(rng, a.shape[0], 3)
    np.testing.assert_allclose(op.rmatmat(xt).numpy(), a.T @ x, atol=1e-11)


def test_ba_coverage_is_sqrt_bounded(rng):
    """Pure Barabasi-Albert: the hub coverage of a small hub set is
    ~sqrt(h/m) (tests/test_sparse.py:693-716), and the port's number is
    the JAX package's."""
    from rails_tpu.sparse.hub import hub_coverage as jax_hub_coverage

    m, k = 4096, 4
    targets = list(range(k))
    ends = []
    for v in range(k, m):
        picks = rng.choice(targets, k, replace=False)
        for u in picks:
            ends += [v, u]
        targets += [v] * k + list(picks)
    e = np.asarray(ends).reshape(-1, 2)
    a = sp.coo_matrix((np.ones(len(e)), (e[:, 0], e[:, 1])),
                      shape=(m, m)).tocsr()
    a = a + a.T
    cov = hub_coverage(a, 128)
    # sqrt(w/m) ~ 0.18 at w=128/m=4096; allow the finite-size bump
    assert cov < 0.45, cov
    assert cov == jax_hub_coverage(a, 128)


@pytest.mark.parametrize("sym", [False, True])
@pytest.mark.parametrize("max_hubs", [16, 3])
def test_split_equals_jax(rng, sym, max_hubs):
    """The same hubs (above 6x the median degree, at most ``max_hubs`` of
    the highest degree, sorted), the same dense block and ELL payloads,
    in both directions; the same apply."""
    a = _superhub(rng)
    if sym:
        a = (a + a.T).tocsr()
    kw = dict(max_hubs=max_hubs, degree_factor=6.0)
    oj = jax_hub_operator(a, dtype=jnp.float64, **kw)
    ot = _port(a, **kw)
    assert ot.is_symmetric == oj.is_symmetric
    assert (ot.bwd is None) == (oj.bwd is None)
    pairs = [(ot, oj)] + ([] if oj.bwd is None else [(ot.bwd, oj.bwd)])
    for pt, pj in pairs:
        assert pt.shape == pj.shape
        assert np.array_equal(pt.hub_idx.numpy(), np.asarray(pj.hub_idx))
        assert np.array_equal(pt.d.numpy(), np.asarray(pj.d))
        for et, ej in ((pt.rest, pj.rest), (pt.hubcol, pj.hubcol)):
            assert et.shape == ej.shape
            assert np.array_equal(et.indices.numpy(), np.asarray(ej.indices))
            assert np.array_equal(et.values.numpy(), np.asarray(ej.values))
    assert len(ot.hub_idx) == min(max_hubs, 8)
    x, xt = _x(rng, a.shape[0], 4)
    for name in ("matmat", "rmatmat"):
        yj = np.asarray(getattr(oj, name)(jnp.asarray(x)))
        yt = getattr(ot, name)(xt).numpy()
        assert np.abs(yt - yj).max() <= 1e-14 * np.abs(yj).max()


def _jax_fields(op):
    def ell(e):
        return None if e is None else {
            "indices": np.asarray(e.indices), "values": np.asarray(e.values),
            "shape": e.shape}

    return {"rest": ell(op.rest), "hubcol": ell(op.hubcol),
            "hub_idx": np.asarray(op.hub_idx),
            "d": None if op.d is None else np.asarray(op.d),
            "shape": op.shape}


def test_hub_payload_reproduces_jax_apply(rng):
    a = _superhub(rng)
    oj = jax_hub_operator(a, max_hubs=16, degree_factor=6.0,
                          dtype=jnp.float64)
    f = _jax_fields(oj)
    ot = interop.hub_payload(f["rest"], f["hubcol"], f["hub_idx"], f["d"],
                             f["shape"], bwd=_jax_fields(oj.bwd),
                             is_symmetric=oj.is_symmetric, nnz=oj.nnz,
                             device="cpu")
    assert isinstance(ot, HubSplitOperator) and ot.nnz == a.nnz
    assert ot.payload_dtype == torch.float64
    x, xt = _x(rng, a.shape[0], 3)
    for name in ("matmat", "rmatmat"):
        yj = np.asarray(getattr(oj, name)(jnp.asarray(x)))
        yt = getattr(ot, name)(xt).numpy()
        assert np.abs(yt - yj).max() <= 1e-14 * np.abs(yj).max()


def test_errors_and_casts(rng):
    a = _superhub(rng)
    with pytest.raises(ValueError, match="square"):
        _port(a[:, :900])
    with pytest.raises(ValueError, match="exceeds dense_cap"):
        _port(a, max_hubs=16, degree_factor=6.0, dense_cap=1000)
    op = _port(a, max_hubs=16, degree_factor=6.0)
    op32 = op.astype(torch.float32)
    assert op32.payload_dtype == torch.float32
    assert op32.d.dtype == op32.bwd.d.dtype == torch.float32
    assert op.astype(torch.float64) is op and op.to("cpu") is op
    x, xt = _x(rng, a.shape[0], 2)
    y = op32.matmat(xt.float()).double().numpy()
    assert np.abs(y - a @ x).max() <= 1e-5 * np.abs(a @ x).max()
    # no hubs: the bulk alone
    bulk = _port(test_sparse.TestEllSpmmKernel._banded_random(
        rng, 256, 4, 16))
    assert bulk.d is None and bulk.hub_idx.numel() == 0


def _hub_problem(rng):
    """tests/test_sparse.py:668-691's problem: the superhub matrix at
    m = 512, symmetrised, its diagonal set to -(row abs-sum) - 1."""
    a = _superhub(rng, m=512, n_hubs=4, hub_deg=80)
    a = (a + a.T).tolil()
    a.setdiag(a.diagonal() - np.abs(a).sum(axis=1).A1 - 1.0)
    a = a.tocsr()
    b = rng.uniform(0, 1, (512, 2))
    return (a, b, jax_hub_operator(a, max_hubs=8, degree_factor=6.0,
                                   dtype=jnp.float64),
            _port(a, max_hubs=8, degree_factor=6.0))


def _solve_both(oj, ot, b, **opts):
    vj, tj, ij = rails_tpu.solve(oj, jnp.asarray(b), dtype=jnp.float64,
                                 **opts)
    vt, tt, it = rails_tpu_torch.solve(
        ot, interop.rhs(b, device="cpu"), dtype=torch.float64,
        device="cpu", draws=JaxDraws(4634), **opts)
    return (np.asarray(vj), np.asarray(tj), ij), (vt.numpy(), tt.numpy(),
                                                  it)


@pytest.mark.parametrize("maxit", [8, 150])
def test_solver_on_hub_operator_matches_jax(rng, jax_sign_fixed, maxit):
    """The solver on the symmetric hub-split A through both packages,
    draw for draw, at tol 1e-6.

    Through iteration 8 the two runs agree to roundoff (V T V' to 1e-12).
    Iteration 9 adds a nearly dependent pair of candidates (the smallest
    eigenvalue of T drops from 1.9e-6 to 4.9e-10), which turns the
    roundoff into a 3e-7 drift - with every operator format, the plain
    ELL and dense ones too (tests/test_torch_parity.py's docstring
    records the same step on its problems).  From there the two packages
    take 28 or 29 iterations, by the format: the full run is held to
    status 0 in both, iteration counts within one, and the true residual
    below 1e-5 (tests/test_sparse.py:687)."""
    a, b, oj, ot = _hub_problem(rng)
    jr, pr = _solve_both(oj, ot, b, tol=1e-6, maxit=maxit)
    (vj, tj, ij), (vt, tt, it) = jr, pr
    xj, xt = vj @ tj @ vj.T, vt @ tt @ vt.T
    if maxit == 8:
        assert ij.iter == it.iter == 8 and vt.shape == vj.shape
        np.testing.assert_allclose(it.resvec, ij.resvec, rtol=1e-12)
        assert np.linalg.norm(xt - xj) <= 1e-12 * np.linalg.norm(xj)
        return
    assert ij.status == it.status == 0
    assert abs(it.iter - ij.iter) <= 1
    r0 = np.linalg.norm(b.T @ b, 2)
    for x in (xj, xt):
        r = a @ x + x @ a.T + b @ b.T
        assert np.linalg.norm(r, 2) / r0 < 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ELL kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.float64, 1e-12)])
def test_apply_on_card(rng, cuda_device, dtype, tol):
    """The card's apply (two ELL-kernel launches and one GEMM) against
    the CPU's plain path on the same split, both directions."""
    a = _superhub(rng)
    op = hub_operator(a, max_hubs=16, degree_factor=6.0, dtype=dtype,
                      device=cuda_device)
    cpu = op.to("cpu")
    x = torch.from_numpy(rng.uniform(-1, 1, (a.shape[0], 8))).to(dtype)
    for name in ("matmat", "rmatmat"):
        before = ell_spmm.launches
        y = getattr(op, name)(x.to(cuda_device))
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 2
        ref = getattr(cpu, name)(x)
        assert (y.cpu() - ref).abs().max().item() <= \
            tol * ref.abs().max().item()
