"""The port's dense projected Lyapunov solvers against the JAX package's.

Random stable problems (k = 2..40) built with numpy from a seed go
through ``rails_tpu.linalg.dense_lyap.lyap`` and the port's ``lyap`` at
float64, for every method and for no E, an SPD E and a general E.  The
two solutions must agree to 1e-10 relative in the Frobenius norm.  The
port's schur method factors in the real Schur form (dgees) and solves by
the real trsyl, on the host, on every device; the JAX package takes
LAPACK's complex Schur (zgees) on the CPU.  The two are held to 1e-11
relative up to k = 160, the projected size of the CLI's Schur path.  The
real route is also held on complex pairs (2 x 2 blocks in its
quasi-triangular factor), at k = 1, 2 and 3, in the solver's padded
layout and with every kind of E, against the Kronecker oracle up to
k = 20 and the JAX package above, and at float32 to the bound the
complex route it replaced reached; each time in real arithmetic of the
input's precision in its LAPACK calls (a spy on their dtypes), in
``lyap`` and in the solver's projected solves.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import scipy.sparse as sp
import torch

from rails_tpu.eigs import eigs_general as jax_eigs_general
from rails_tpu.linalg.dense_lyap import lyap as jax_lyap
from rails_tpu.operators import DenseOperator as JaxDense
import rails_tpu_torch as rt
from rails_tpu_torch.eigs import _small_eig
from rails_tpu_torch.linalg.dense_lyap import lyap, lyap_residual
from rails_tpu_torch.models.problems import laplacian2_sparse

# one intra-op thread: the suite runs in several worker processes at once,
# and small ops with many threads each oversubscribe the cores
torch.set_num_threads(1)

# (method, E kind): eigh needs a symmetric reduced A, so no general E
CASES = [("eigh", None), ("eigh", "spd"),
         ("schur", None), ("schur", "spd"), ("schur", "general"),
         ("sign", None), ("sign", "spd"), ("sign", "general"),
         ("kron", None), ("kron", "spd"), ("kron", "general")]


def stable_problem(rng, k, method, e_kind):
    a = rng.uniform(-1, 1, (k, k))
    if method == "eigh":
        a = 0.5 * (a + a.T)
    a = a - (np.max(np.real(np.linalg.eigvals(a))) + 0.5) * np.eye(k)
    b = rng.uniform(-1, 1, (k, 3))
    c = b @ b.T
    e = None
    if e_kind == "spd":
        q, _ = np.linalg.qr(rng.standard_normal((k, k)))
        e = q @ np.diag(rng.uniform(0.5, 2.0, k)) @ q.T
    elif e_kind == "general":
        e = np.eye(k) + 0.3 * rng.uniform(-1, 1, (k, k)) / np.sqrt(k)
    return a, c, e


@pytest.mark.parametrize("k", [2, 13, 40])
@pytest.mark.parametrize("method,e_kind", CASES)
def test_lyap_matches_jax(rng, method, e_kind, k):
    a, c, e = stable_problem(rng, k, method, e_kind)
    kw = dict(method=method)
    if e_kind is not None:
        kw["e_kind"] = e_kind
    xj = np.asarray(jax_lyap(jnp.asarray(a), jnp.asarray(c),
                             None if e is None else jnp.asarray(e), **kw))
    t = torch.from_numpy
    xt = lyap(t(a), t(c), None if e is None else t(e), **kw).numpy()
    assert np.linalg.norm(xt - xj) <= 1e-10 * np.linalg.norm(xj)
    res = float(lyap_residual(t(a), t(xt), t(c), None if e is None
                              else t(e)))
    assert res <= 1e-9 * np.linalg.norm(c)


@pytest.mark.parametrize("dtype,atol", [("float64", 1e-14),
                                        ("float32", 1e-6)])
def test_known_answer_2x2(dtype, atol):
    # the reference's SLICOT shim test (SlicotWrapper_test.cpp:7-38)
    dtype = getattr(torch, dtype)
    a = torch.tensor([[0.0, 1.0], [-5.0, -5.0]], dtype=dtype)
    x = lyap(a, torch.eye(2, dtype=dtype), method="schur")
    assert x.dtype == dtype
    assert np.allclose(x.numpy(), [[0.62, -0.5], [-0.5, 0.6]], atol=atol)


@pytest.mark.parametrize("k", [2, 13, 40, 96, 160])
def test_schur_matches_jax(rng, k):
    """The real Schur route against the JAX package's zgees and
    back-substitution on the CPU."""
    a, c, _ = stable_problem(rng, k, "schur", None)
    xj = np.asarray(jax_lyap(jnp.asarray(a), jnp.asarray(c),
                             method="schur"))
    t = torch.from_numpy
    xt = lyap(t(a), t(c), method="schur").numpy()
    assert np.linalg.norm(xt - xj) <= 1e-11 * np.linalg.norm(xj)


class LapackSpy:
    """Records what the port hands LAPACK: the dtype and output form of
    each Schur factor, the (quasi-)triangular factors it got back, and
    the type prefix of each trsyl it asked for ('d', 's'; 'z' or 'c'
    would be complex arithmetic)."""

    def __init__(self, monkeypatch):
        self.schur, self.t, self.trsyl = [], [], []
        schur, funcs = scipy.linalg.schur, scipy.linalg.get_lapack_funcs

        def spy_schur(a, *args, **kw):
            self.schur.append((a.dtype, kw.get("output")))
            t, u = schur(a, *args, **kw)
            self.t.append(t)
            return t, u

        def spy_funcs(names, arrays=(), *args, **kw):
            fn = funcs(names, arrays, *args, **kw)
            if names == "trsyl":
                self.trsyl.append(fn.typecode)
            return fn

        monkeypatch.setattr(scipy.linalg, "schur", spy_schur)
        monkeypatch.setattr(scipy.linalg, "get_lapack_funcs", spy_funcs)


def _padded(a, c, e, kb):
    """The solver's projected layout (``core/solver.py::_projected_t``):
    the active k x k block inside a kb x kb buffer whose inactive
    diagonal is ``a_pad``, beyond the active spectral radius; C zero and
    E the identity there."""
    k = a.shape[0]
    a_pad = -(np.max(np.sum(np.abs(a), axis=1)) + 1.0)
    ap = a_pad * np.eye(kb)
    ap[:k, :k] = a
    cp = np.zeros((kb, kb))
    cp[:k, :k] = c
    ep = None
    if e is not None:
        ep = np.eye(kb)
        ep[:k, :k] = e
    return ap, cp, ep


@pytest.mark.parametrize("k", [1, 2, 3])
def test_schur_edge_sizes(rng, monkeypatch, k):
    """The real route at its smallest sizes, against the Kronecker
    oracle: k = 1 (a 1 x 1 trsyl), k = 2 with one complex pair (a lone
    2 x 2 block) and k = 3 (a pair beside a real eigenvalue), each in a
    random orthogonal basis."""
    d = np.array([[-1.0, 3.0, 0.0], [-2.0, -1.0, 0.0], [0.0, 0.0, -0.5]])
    d = d[:k, :k] if k != 1 else d[2:, 2:]
    q, _ = np.linalg.qr(rng.standard_normal((k, k)))
    a = q @ d @ q.T
    b = rng.uniform(-1, 1, (k, 2))
    c = b @ b.T
    t = torch.from_numpy
    x_ref = lyap(t(a), t(c), method="kron").numpy()
    spy = LapackSpy(monkeypatch)
    x = lyap(t(a), t(c), method="schur").numpy()
    assert np.linalg.norm(x - x_ref) <= 1e-12 * np.linalg.norm(x_ref)
    assert spy.schur == [(np.float64, "real")]
    assert spy.trsyl == ["d"]
    assert np.any(np.diag(spy.t[0], -1) != 0) == (k > 1)


@pytest.mark.parametrize("e_kind", [None, "spd", "general"])
@pytest.mark.parametrize("k,kb", [(13, None), (20, None), (96, None),
                                  (160, None), (80, 184), (167, 184)])
def test_host_route_real_schur(rng, monkeypatch, e_kind, k, kb):
    """The real Schur route on real matrices with complex pairs, so that
    its factor has 2 x 2 blocks, square or in the solver's padded layout
    (k = 80 and k = 167, the largest active k of the CLI's Schur path,
    in 184), with no E, an SPD E and a general E
    (``refine_generalized``'s repeated solves).  Held to 1e-11 relative
    against the Kronecker oracle up to k = 20 and the JAX package above,
    as ``test_schur_matches_jax`` holds it."""
    a, c, e = stable_problem(rng, k, "schur", e_kind)
    if kb is not None:
        a, c, e = _padded(a, c, e, kb)
    kw = {} if e_kind is None else {"e_kind": e_kind}
    t = torch.from_numpy
    e_t = None if e is None else t(e)
    if k <= 20:
        x_ref = lyap(t(a), t(c), e_t, method="kron", **kw).numpy()
    else:
        x_ref = np.asarray(jax_lyap(jnp.asarray(a), jnp.asarray(c),
                                    None if e is None else jnp.asarray(e),
                                    method="schur", **kw))
    spy = LapackSpy(monkeypatch)
    x = lyap(t(a), t(c), e_t, method="schur", **kw).numpy()
    assert np.linalg.norm(x - x_ref) <= 1e-11 * np.linalg.norm(x_ref)
    assert spy.schur == [(np.float64, "real")]
    assert np.any(np.diag(spy.t[0], -1) != 0)   # 2 x 2 blocks
    assert spy.trsyl == ["d"]


@pytest.mark.parametrize("k", [13, 96, 160])
def test_host_route_float32(rng, monkeypatch, k):
    """At float32 (the f32 control's path) the real route in single
    precision (sgees, strsyl) against the float64 solution of the same
    problem.  The complex route it replaced (cgees, ctrsyl) reached
    2.8e-7, 3.6e-7 and 3.8e-7 relative at k = 13, 96 and 160 here; 4e-7
    is that bound."""
    a, c, _ = stable_problem(rng, k, "schur", None)
    t = torch.from_numpy
    x64 = lyap(t(a), t(c), method="schur").numpy()
    spy = LapackSpy(monkeypatch)
    x = lyap(t(a).float(), t(c).float(), method="schur")
    assert x.dtype == torch.float32
    assert spy.schur == [(np.float32, "real")]
    assert spy.trsyl == ["s"]
    x = x.double().numpy()
    assert np.linalg.norm(x - x64) <= 4e-7 * np.linalg.norm(x64)


def _stencil(side):
    """``test_torch_parity.py::test_nonsymmetric_untagged_dia``'s
    convection-diffusion stencil: a 2-D Laplacian with skew terms."""
    n = side * side
    return (laplacian2_sparse(side)
            + 0.3 * sp.diags([1.0, -1.0], [1, -1], (n, n))
            + 0.2 * sp.diags([1.0, -1.0], [side, -side], (n, n))).tocsr()


@pytest.mark.parametrize("m_kind", ["no_m", "diag_m"])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_solver_general_a_takes_real_lapack(rng, monkeypatch, dtype,
                                            m_kind):
    """An eager solve on an untagged non-symmetric operator converges
    with one real Schur factor in the solve's dtype per projected solve,
    and only real trsyl calls."""
    dtype = getattr(torch, dtype)
    side = 8
    n = side * side
    a = rt.sparse_from_scipy(_stencil(side), fmt="dia", dtype=dtype,
                             device="cpu")
    m = None
    if m_kind == "diag_m":
        m = rt.DiagonalOperator(torch.as_tensor(
            rng.uniform(0.5, 1.5, n), dtype=dtype), device="cpu")
    b = torch.as_tensor(rng.uniform(0, 1, (n, 2)), dtype=dtype)
    spy = LapackSpy(monkeypatch)
    _, _, info = rt.LyapunovSolver(a, b, m, device="cpu", tol=1e-4,
                                   expand=2, maxit=100).solve()
    assert info.converged and info.iter >= 5
    real = np.float64 if dtype == torch.float64 else np.float32
    assert spy.schur == [(real, "real")] * info.iter
    assert set(spy.trsyl) == {"d" if dtype == torch.float64 else "s"}


@pytest.mark.parametrize("k", [5, 24, 61])
def test_small_eig_matches_jax_eigs_general(rng, k):
    """``eigs``' small eigenproblem on a nonsymmetric matrix (complex
    pairs, and a real eigenvalue beside them at odd k): its eigenvalues
    against the JAX package's ``eigs_general`` on the whole space
    (subspace = k, so both are exact) to 1e-10 relative, and each pair's
    residual to 1e-10."""
    a = rng.uniform(-1, 1, (k, k))
    lam, vec = _small_eig(torch.from_numpy(a).to(torch.complex128))
    lam, vec = lam.numpy(), vec.numpy()
    ej = np.asarray(jax_eigs_general(JaxDense(jnp.asarray(a)), num=k,
                                     subspace=k, tol=1e-10)[0])
    scale = np.abs(ej).max()
    for e in ej:   # every JAX eigenvalue has its port counterpart
        assert np.abs(lam - e).min() <= 1e-10 * scale
    r = a @ vec - vec * lam[None, :]
    assert np.linalg.norm(r, axis=0).max() <= 1e-10 * scale


def test_small_eig_complex64(rng, monkeypatch):
    """The same at single precision: cgees on the host, the eigenvalues
    complex64 and within 1e-5 relative of the complex128 ones."""
    a = torch.from_numpy(rng.uniform(-1, 1, (24, 24)))
    lam128, _ = _small_eig(a.to(torch.complex128))
    spy = LapackSpy(monkeypatch)
    lam64, _ = _small_eig(a.to(torch.complex64))
    assert lam64.dtype == torch.complex64
    assert spy.schur == [(np.complex64, "complex")]
    lam64, lam128 = lam64.numpy(), lam128.numpy()
    scale = np.abs(lam128).max()
    for e in lam128:
        assert np.abs(lam64 - e).min() <= 1e-5 * scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
def test_card_schur_matches_cpu(rng, monkeypatch, cuda_device):
    """A CUDA tensor takes the same real route as a CPU tensor (dgees and
    dtrsyl on the host, by the spy) and gets the same X back on the card,
    k = 96."""
    a, c, _ = stable_problem(rng, 96, "schur", None)
    t = torch.from_numpy
    x_cpu = lyap(t(a), t(c), method="schur").numpy()
    spy = LapackSpy(monkeypatch)
    x_card = lyap(t(a).to(cuda_device), t(c).to(cuda_device),
                  method="schur")
    assert x_card.device.type == "cuda"
    assert spy.schur == [(np.float64, "real")]
    assert spy.trsyl == ["d"]
    x_card = x_card.cpu().numpy()
    assert np.linalg.norm(x_card - x_cpu) <= 1e-10 * np.linalg.norm(x_cpu)
