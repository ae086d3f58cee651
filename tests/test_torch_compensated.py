"""The port's compensated reductions (``utils/compensated.py``), its
error-free applies ``matmat2`` and ``precision='compensated'`` against the
JAX package.

- ``two_sum``/``two_prod``: the pair (s, e) of an error-free transform is
  unique, so the two packages must agree bit for bit.
- ``dot2``: the port within 2 eps32 relative of a float64 oracle (the
  compensated dot's error is eps plus a cond * eps^2 term; measured at
  most 0.5 eps32 here, correctly rounded).  The JAX package is held to
  8 eps32: XLA's CPU compiler rewrites the transform's arithmetic, and
  it measured up to 7.0 eps32 on (900, 4) x (900,) blocks.
- ``gram2``: within 2 eps32 relative of a float64 oracle in both packages,
  on integer-valued inputs whose chunk products are exact in float32 and
  whose totals are not: the chunk products are plain float32 by design,
  so what is compensated, and tested, is the cross-chunk reduction.
- ``matmat2`` of DIA, ELL, HYB, diagonal and identity operators: hi + lo
  within 1e-12 relative of the float64 product of the float32 payload, in
  both packages.
- ``precision='compensated'`` at float64: the same run as the JAX
  package's, draw for draw (tests/test_torch_parity.py's tolerances).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
from rails_tpu.utils import compensated as jc
from rails_tpu_torch import operators as to
from rails_tpu_torch.models.problems import laplacian2_sparse
from rails_tpu_torch.sparse.formats import sparse_from_scipy
from rails_tpu_torch.utils import compensated as tc
from test_torch_ell import banded_random, lap_with_couplings
from test_torch_parity import (  # noqa: F401  (jax_sign_fixed: fixture)
    assert_same_run, jax_sign_fixed, run_both)

torch.set_num_threads(1)

EPS32 = float(np.finfo(np.float32).eps)


def _wide_range(rng, shape, dtype):
    """Values over many binades, both signs."""
    return (rng.uniform(-1, 1, shape)
            * 2.0 ** rng.integers(-20, 20, shape)).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_eft_bit_equal(rng, dtype):
    a = _wide_range(rng, 4000, dtype)
    b = _wide_range(rng, 4000, dtype)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((jc.two_sum, tc.two_sum), (jc.two_prod, tc.two_prod)):
        js, je = jf(jnp.asarray(a), jnp.asarray(b))
        ts, te = tf(ta, tb)
        assert np.array_equal(ts.numpy(), np.asarray(js))
        assert np.array_equal(te.numpy(), np.asarray(je))
    # error-free: hi + lo is the exact result (checked in higher precision)
    s, e = tc.two_sum(ta, tb)
    if dtype == np.float32:
        assert np.array_equal(s.double().numpy() + e.double().numpy(),
                              a.astype(np.float64) + b.astype(np.float64))
        p, e = tc.two_prod(ta, tb)
        assert np.array_equal(p.double().numpy() + e.double().numpy(),
                              a.astype(np.float64) * b.astype(np.float64))


@pytest.mark.parametrize("shape", [((1000,), (1000,)), ((700, 3), (700, 2)),
                                   ((900, 4), (900,))])
def test_dot2_within_2eps(rng, shape):
    x = rng.uniform(-1, 1, shape[0]).astype(np.float32)
    y = rng.uniform(-1, 1, shape[1]).astype(np.float32)
    ref = x.astype(np.float64).T @ y.astype(np.float64)
    for got, bound in (
            (np.asarray(jc.dot2(jnp.asarray(x), jnp.asarray(y), 256)), 8),
            (tc.dot2(torch.from_numpy(x), torch.from_numpy(y), 256).numpy(),
             2)):
        assert got.dtype == np.float32 and got.shape == np.shape(ref)
        err = np.abs(got.astype(np.float64) - ref)
        assert np.all(err <= bound * EPS32 * np.abs(ref))


def test_gram2_within_2eps(rng):
    m = 1000
    # chunk sums of 16 products stay below 2^24 (exact in float32)
    x = rng.integers(0, 1001, (m, 5)).astype(np.float32)
    w = rng.integers(0, 1001, (m, 3)).astype(np.float32)
    ref = x.astype(np.float64).T @ w.astype(np.float64)
    assert np.abs(ref).min() > 2.0 ** 24  # plain float32 would round
    tj = jc.gram2(jnp.asarray(x), jnp.asarray(w), chunk=16)
    tt = tc.gram2(torch.from_numpy(x), torch.from_numpy(w), chunk=16)
    for got in (np.asarray(tj), tt.numpy()):
        assert got.dtype == np.float32 and got.shape == (5, 3)
        assert np.all(np.abs(got.astype(np.float64) - ref)
                      <= 2 * EPS32 * np.abs(ref))
    hi, lo = tc.gram2_pair(torch.from_numpy(x), torch.from_numpy(w), 16)
    assert np.array_equal(hi.double().numpy() + lo.double().numpy(), ref)


def test_sum2_and_zero_columns(rng):
    x = np.array([1.0, 1e8, 1.0, -1e8] * 50, np.float32)
    assert float(tc.sum2(torch.from_numpy(x))) == float(
        jc.sum2(jnp.asarray(x))) == 100.0
    a = rng.uniform(-1, 1, (300, 4)).astype(np.float32)
    a[:, 2:] = 0.0
    g = tc.gram2(torch.from_numpy(a), torch.from_numpy(a), chunk=64)
    assert torch.all(g[2:, :] == 0) and torch.all(g[:, 2:] == 0)


def _ops(rng):
    """(name, scipy matrix, fmt) of the matmat2 cases: the f32-rounded
    values are what both packages store."""
    return [
        ("dia", laplacian2_sparse(20) + sp.diags(
            rng.uniform(-0.3, 0.3, 399), 1, (400, 400)), "dia"),
        ("ell", banded_random(rng, 700, 6, 50, n=500, empty_rows=30),
         "ell"),
        ("hyb", lap_with_couplings(rng, 16, 40), "hyb"),
    ]


@pytest.mark.parametrize("case", [0, 1, 2])
def test_matmat2_sparse(rng, case):
    name, a, fmt = _ops(rng)[case]
    a = a.tocsr().astype(np.float32).astype(np.float64)
    aj = jax_sparse(a, fmt=fmt, dtype=jnp.float32)
    at = sparse_from_scipy(a, fmt=fmt, dtype=torch.float32, device="cpu")
    assert at.format == aj.format == name
    x = rng.uniform(-1, 1, (a.shape[1], 5)).astype(np.float32)
    ref = a @ x.astype(np.float64)
    hj, lj = aj.matmat2(jnp.asarray(x))
    ht, lt = at.matmat2(torch.from_numpy(x))
    scale = np.abs(ref).max()
    for hi, lo in ((hj, lj), (ht.numpy(), lt.numpy())):
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert np.abs(got - ref).max() <= 1e-12 * scale
    h1, l1 = at.matmat2(torch.from_numpy(x[:, 0]))
    assert np.abs(h1.double().numpy() + l1.double().numpy()
                  - ref[:, 0]).max() <= 1e-12 * scale


def test_matmat2_diagonal_identity(rng):
    d = rng.uniform(0.5, 1.5, 300).astype(np.float32)
    x = rng.uniform(-1, 1, (300, 4)).astype(np.float32)
    ref = d.astype(np.float64)[:, None] * x.astype(np.float64)
    hj, lj = rails_tpu.DiagonalOperator(jnp.asarray(d)).matmat2(
        jnp.asarray(x))
    ht, lt = to.DiagonalOperator(torch.from_numpy(d),
                                 device="cpu").matmat2(torch.from_numpy(x))
    for hi, lo in ((hj, lj), (ht.numpy(), lt.numpy())):
        got = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()
    hi, lo = to.IdentityOperator(300).matmat2(torch.from_numpy(x))
    assert torch.equal(hi, torch.from_numpy(x)) and not lo.any()


@pytest.mark.parametrize("problem", ["generalized", "nonsymmetric"])
def test_compensated_solve_parity_f64(rng, jax_sign_fixed, problem):
    """Compensated precision at float64 on tests/test_torch_parity.py's
    problems: the phase_solve problem at n=256 (eigh route) and the
    untagged convection-diffusion stencil with M (schur route); the same
    iterations, status, rank and mvps as the JAX package."""
    if problem == "generalized":
        side = 16
        n = side * side
        md = rng.uniform(0.5, 1.5, n)
        b = rng.uniform(0, 1, (n, 8))
        jr, pr, _ = run_both(laplacian2_sparse(side), b, md,
                             {"is_symmetric": True}, tol=1e-4, expand=6,
                             restart_size=120, reduced_size=60, maxit=200,
                             precision="compensated")
    else:
        side = 8
        n = side * side
        a = laplacian2_sparse(side) \
            + 0.3 * sp.diags([1.0, -1.0], [1, -1], (n, n)) \
            + 0.2 * sp.diags([1.0, -1.0], [side, -side], (n, n))
        md = rng.uniform(0.5, 1.5, n)
        b = rng.uniform(0, 1, (n, 2))
        jr, pr, _ = run_both(a.tocsr(), b, md, {}, tol=1e-4, expand=2,
                             maxit=100, precision="compensated")
    assert jr[2].iter >= 5
    assert_same_run(jr, pr)
