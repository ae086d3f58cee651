"""The port's C++ host library (``rails_tpu_torch/native/``) against the
JAX package's (``rails_tpu/native/host_lib.py``), on the CPU.

Both compile the same C++ source, so the MatrixMarket reader gives equal
matrices and the sparse LU equal solves; the LU is held to 1e-14
relative (the two libraries are built with other flags), the Schur
operator with ``a11_solver="native_lu"`` to 1e-10 of the largest entry
of the JAX package's result (tests/test_schur_path.py:31-46's tolerance)
and ``sinv(method="native_lu")`` to 1e-12.  The port's library is built
under ``build/rails_tpu_torch/``; the JAX package's tracked library is
never rewritten.
"""

import hashlib
import os

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.io
import scipy.sparse as sp
import torch

from rails_tpu.native import host_lib as jax_host
from rails_tpu.schur import schur_reduce as jax_schur
from rails_tpu_torch import _build
from rails_tpu_torch import io as rio
from rails_tpu_torch.native import host_lib
from rails_tpu_torch.schur import schur_reduce

from test_torch_schur import laplacian_dae, small_dae

torch.set_num_threads(1)

JAX_LIB = os.path.join(os.path.dirname(jax_host.__file__),
                       "librails_host.so")


def _digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def _matrix(rng, kind):
    a = sp.random(60, 45, density=0.1, random_state=7, format="csr")
    if kind == "symmetric":
        a = sp.random(50, 50, density=0.1, random_state=8)
        a = (a + a.T).tocsr()
    elif kind == "integer":
        a.data = rng.integers(-9, 10, a.nnz).astype(np.int64)
    elif kind == "pattern":
        a.data[:] = 1.0
    return a


@pytest.mark.parametrize("kind", ["general", "symmetric", "integer",
                                  "pattern"])
def test_reader_matches_jax(rng, tmp_path, kind):
    a = _matrix(rng, kind)
    path = str(tmp_path / "a.mtx")
    field = {"integer": "integer", "pattern": "pattern"}.get(kind)
    scipy.io.mmwrite(path, a, field=field,
                     symmetry="symmetric" if kind == "symmetric" else None)
    with open(path) as f:
        assert kind in f.readline()
    got = host_lib.read_matrix_market(path)
    ref = jax_host.read_matrix_market(path)
    assert sp.isspmatrix_csr(got) and got.shape == ref.shape
    assert (got != ref).nnz == 0
    assert np.array_equal(got.toarray(), a.toarray().astype(np.float64))
    assert (rio.read_matrix_market(path) != ref).nnz == 0


def test_reader_declines_array_format(rng, tmp_path):
    """Array files (the CLI's V.mtx and T.mtx): the C reader declines,
    and ``io.read_matrix_market`` reads them with scipy."""
    path = str(tmp_path / "v.mtx")
    v = rng.uniform(-1, 1, (7, 3))
    scipy.io.mmwrite(path, v)
    assert host_lib.read_matrix_market(path) is None
    assert jax_host.read_matrix_market(path) is None
    assert np.array_equal(rio.read_matrix_market(path), v)


@pytest.mark.parametrize("trans", [False, True])
@pytest.mark.parametrize("nrhs", [None, 1, 5])
def test_lu_matches_jax(rng, trans, nrhs):
    """A random sparse matrix with a weak diagonal, so that the partial
    pivoting swaps rows; one right-hand side as (n,) or (n, 1), and
    several."""
    n = 400
    a = (sp.random(n, n, density=0.01, random_state=3)
         + sp.diags(rng.uniform(0.01, 0.1, n))).tocsr()
    b = rng.uniform(-1, 1, (n,) if nrhs is None else (n, nrhs))
    b0 = b.copy()
    xt = host_lib.NativeSparseLU(a).solve(b, trans=trans)
    assert np.array_equal(b, b0)   # b is left as it was
    # (the JAX package's solve overwrites a one-column float64 b: a copy)
    xj = jax_host.NativeSparseLU(a).solve(b.copy(), trans=trans)
    assert xt.shape == b.shape
    assert np.abs(xt - xj).max() <= 1e-14 * np.abs(xj).max()
    op = a.T if trans else a
    assert np.abs(op @ xt - b).max() <= 1e-10 * np.abs(b).max()


def test_library_is_built_under_build_dir():
    before = _digest(JAX_LIB)
    path = _build.build_host()
    assert path.parent == _build.BUILD_DIR
    assert path.parts[-3:-1] == ("build", "rails_tpu_torch")
    assert path.name.startswith("librails_host-")
    assert host_lib.library() is _build.load_host()
    assert not list((_build.PKG_DIR / "native").glob("*.so"))
    assert _digest(JAX_LIB) == before


def test_failed_build_raises_with_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "librails_host.cpp"
    bad.write_text("int broken( {\n")
    monkeypatch.setattr(_build, "HOST_SOURCE", bad)
    with pytest.raises(RuntimeError, match="host library build failed"
                       "(.|\\n)*error"):
        _build.build_host()
    out = _build._target(bad, _build.HOST_FLAGS)
    assert not list(out.parent.glob(out.stem + "*"))


def _rel(yt, yj):
    yt = yt.detach().numpy() if isinstance(yt, torch.Tensor) else yt
    yj = np.asarray(yj)
    assert yt.shape == yj.shape
    return np.abs(yt - yj).max() / np.abs(yj).max()


@pytest.mark.parametrize("problem", ["small_dae", "lap_16"])
def test_native_schur_operator_matches_jax(rng, problem):
    if problem == "small_dae":
        a, md, b = small_dae(rng)
    else:
        a, md, b = laplacian_dae(16)
    red_j = jax_schur(a, md, b, dtype=jnp.float64, a11_solver="native_lu")
    red_t = schur_reduce(a, md, b, dtype=torch.float64, device="cpu",
                         a11_solver="native_lu")
    assert red_t.a11_solver_kind == "native_lu"
    x = rng.uniform(-1, 1, (red_t.n2, 3))
    xt = torch.from_numpy(x)
    assert _rel(red_t.operator.matmat(xt),
                red_j.operator.matmat(jnp.asarray(x))) <= 1e-10
    assert _rel(red_t.operator.rmatmat(xt),
                red_j.operator.rmatmat(jnp.asarray(x))) <= 1e-10
    # the full-space transforms go through the same A11 solves
    xf = rng.uniform(-1, 1, (red_t.n, 2))
    assert _rel(red_t.restrict(torch.from_numpy(xf)),
                red_j.restrict(jnp.asarray(xf))) <= 1e-10
    res, res_t = red_t.a11_residual_check()
    assert res <= 1e-12 and res_t <= 1e-12


def test_native_sinv_matches_jax(rng):
    a, md, b = small_dae(rng)
    red_j = jax_schur(a, md, b, dtype=jnp.float64)
    red_t = schur_reduce(a, md, b, dtype=torch.float64, device="cpu")
    x = rng.uniform(-1, 1, (red_t.n2, 2))
    yj = red_j.sinv(method="native_lu")(jnp.asarray(x))
    yt = red_t.sinv(method="native_lu")(torch.from_numpy(x))
    assert _rel(yt, yj) <= 1e-12
    y1 = red_t.sinv(method="native_lu")(torch.from_numpy(x[:, 0]))
    assert _rel(y1, np.asarray(yj)[:, 0]) <= 1e-12


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the native solve's round trip")
    return torch.device("cuda")


@pytest.mark.cuda
def test_native_schur_apply_on_card(cuda_device):
    """The S apply with ``native_lu`` on the card (A11 solved on the host
    in each apply) against ``dense_lu`` on the card, both directions."""
    a, md, b = laplacian_dae(24)
    red_n = schur_reduce(a, md, b, dtype=torch.float64, device=cuda_device,
                         a11_solver="native_lu")
    red_d = schur_reduce(a, md, b, dtype=torch.float64, device=cuda_device)
    x = torch.rand(red_n.n2, 8, dtype=torch.float64, device=cuda_device)
    for name in ("matmat", "rmatmat"):
        yn = getattr(red_n.operator, name)(x)
        yd = getattr(red_d.operator, name)(x)
        assert yn.device.type == "cuda"
        assert _rel(yn.cpu(), yd.cpu().numpy()) <= 1e-10
