"""The port's dense projected Lyapunov solvers against the JAX package's.

Random stable problems (k = 2..40) built with numpy from a seed go
through ``rails_tpu.linalg.dense_lyap.lyap`` and the port's ``lyap`` at
float64, for every method and for no E, an SPD E and a general E.  The
two solutions must agree to 1e-10 relative in the Frobenius norm.  On the
CPU both packages take LAPACK's complex Schur (zgees) for the schur
method, then the same back-substitution: held to 1e-12 relative up to
k = 160, the projected size of the CLI's Schur path.  The port's other
routes (``_schur_route``): "host" (the real Schur form by dgees and the
real trsyl for the whole Bartels-Stewart step, on the host; the card's
route) to 1e-11, and "qr" (the port's own shifted-QR Schur,
``complex_schur``) to 1e-10.  The "host" route is also held on complex
pairs (2 x 2 blocks in its quasi-triangular factor), in the solver's
padded layout and with every kind of E, against the Kronecker oracle up
to k = 20 and the JAX package above, and at float32 to the bound the
complex route it replaced reached; each time in real arithmetic of the
input's precision in its LAPACK calls (a spy on their dtypes).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.linalg
import torch

from rails_tpu.eigs import eigs_general as jax_eigs_general
from rails_tpu.linalg.dense_lyap import lyap as jax_lyap
from rails_tpu.operators import DenseOperator as JaxDense
from rails_tpu_torch.eigs import _small_eig
from rails_tpu_torch.linalg import dense_lyap
from rails_tpu_torch.linalg.dense_lyap import lyap, lyap_residual
from rails_tpu_torch.linalg.schur_qr import complex_schur, hessenberg

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


def test_known_answer_2x2():
    # the reference's SLICOT shim test (SlicotWrapper_test.cpp:7-38)
    a = torch.tensor([[0.0, 1.0], [-5.0, -5.0]], dtype=torch.float64)
    x = lyap(a, torch.eye(2, dtype=torch.float64), method="schur")
    assert np.allclose(x.numpy(), [[0.62, -0.5], [-0.5, 0.6]], atol=1e-14)


@pytest.mark.parametrize("n", [1, 2, 3, 8, 30])
def test_complex_schur(rng, n):
    a = torch.from_numpy(rng.uniform(-1, 1, (n, n))).to(torch.complex128)
    t, u = complex_schur(a)
    t, u, a = t.numpy(), u.numpy(), a.numpy()
    assert np.allclose(np.tril(t, -1), 0, atol=0)
    assert np.allclose(u @ u.conj().T, np.eye(n), atol=1e-12)
    assert np.allclose(u @ t @ u.conj().T, a, atol=1e-11)


def test_hessenberg(rng):
    a = torch.from_numpy(rng.uniform(-1, 1, (12, 12)))
    h, q = hessenberg(a)
    h, q = h.numpy(), q.numpy()
    assert np.allclose(q @ h @ q.T, a.numpy(), atol=1e-12)
    assert np.allclose(np.tril(h, -2), 0, atol=1e-12)


def _jax_and_port(rng, k, route):
    a, c, _ = stable_problem(rng, k, "schur", None)
    xj = np.asarray(jax_lyap(jnp.asarray(a), jnp.asarray(c),
                             method="schur"))
    t = torch.from_numpy
    xt = lyap(t(a), t(c), method="schur", _schur_route=route).numpy()
    return a, c, xj, xt


@pytest.mark.parametrize("k", [2, 13, 40, 96, 160])
def test_lapack_route_matches_jax(rng, k):
    """The CPU route (no route given): zgees on the host, the JAX
    package's back-substitution."""
    a, c, xj, xt = _jax_and_port(rng, k, None)
    assert dense_lyap.schur_route(torch.from_numpy(a)) == "lapack"
    assert np.linalg.norm(xt - xj) <= 1e-12 * np.linalg.norm(xj)


@pytest.mark.parametrize("route,tol", [("host", 1e-11), ("qr", 1e-10)])
@pytest.mark.parametrize("k", [13, 96])
def test_other_routes_match_jax(rng, route, tol, k):
    """The card's route (trsyl on the host) and the QR sweeps, reached
    through the private route argument, on the CPU."""
    _, _, xj, xt = _jax_and_port(rng, k, route)
    assert np.linalg.norm(xt - xj) <= tol * np.linalg.norm(xj)


class LapackSpy:
    """Records what the "host" route hands LAPACK: the dtype and output
    form of each Schur factor, the quasi-triangular factors it got back,
    and the type prefix of each trsyl it asked for ('d', 's'; 'z' or
    'c' would be complex arithmetic)."""

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


@pytest.mark.parametrize("e_kind", [None, "spd", "general"])
@pytest.mark.parametrize("k,kb", [(13, None), (20, None), (96, None),
                                  (160, None), (80, 184)])
def test_host_route_real_schur(rng, monkeypatch, e_kind, k, kb):
    """The card's route on CPU tensors: real matrices with complex
    pairs, so that its real Schur factor has 2 x 2 blocks, square or in
    the solver's padded layout (k = 80 active in 184), with no E, an SPD
    E and a general E (``refine_generalized``'s repeated solves).  Held
    to 1e-11 relative against the Kronecker oracle up to k = 20 and the
    JAX package above, as the route is held in
    ``test_other_routes_match_jax``."""
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
    x = lyap(t(a), t(c), e_t, method="schur", _schur_route="host",
             **kw).numpy()
    assert np.linalg.norm(x - x_ref) <= 1e-11 * np.linalg.norm(x_ref)
    assert spy.schur == [(np.float64, "real")]
    assert np.any(np.diag(spy.t[0], -1) != 0)   # 2 x 2 blocks
    assert spy.trsyl == ["d"]


@pytest.mark.parametrize("k", [13, 96, 160])
def test_host_route_float32(rng, monkeypatch, k):
    """At float32 (the f32 control's path) the "host" route in real
    single precision (sgees, strsyl) against the float64 solution of the
    same problem.  Before the route took the real Schur form, its
    complex one (cgees, ctrsyl) reached 2.8e-7, 3.6e-7 and 3.8e-7
    relative at k = 13, 96 and 160 here; 4e-7 is that bound."""
    a, c, _ = stable_problem(rng, k, "schur", None)
    t = torch.from_numpy
    x64 = lyap(t(a), t(c), method="schur").numpy()
    spy = LapackSpy(monkeypatch)
    x = lyap(t(a).float(), t(c).float(), method="schur",
             _schur_route="host")
    assert x.dtype == torch.float32
    assert spy.schur == [(np.float32, "real")]
    assert spy.trsyl == ["s"]
    x = x.double().numpy()
    assert np.linalg.norm(x - x64) <= 4e-7 * np.linalg.norm(x64)


def test_route_rule_and_unknown_route():
    a = torch.eye(3, dtype=torch.float64)
    assert dense_lyap.schur_route(a, "qr") == "qr"
    assert dense_lyap.CARD_SCHUR_ROUTE in dense_lyap.SCHUR_ROUTES
    with pytest.raises(ValueError, match="Schur route"):
        lyap(-a, a, method="schur", _schur_route="zgees")


@pytest.mark.parametrize("route", [None, "qr"])
def test_small_eig_matches_jax_eigs_general(rng, route):
    """``eigs``' small eigenproblem on a nonsymmetric matrix (complex
    pairs): its eigenvalues against the JAX package's ``eigs_general`` on
    the whole space (subspace = k, so both are exact) to 1e-10 relative,
    and each pair's residual to 1e-10."""
    k = 24
    a = rng.uniform(-1, 1, (k, k))
    lam, vec = _small_eig(torch.from_numpy(a).to(torch.complex128), route)
    lam, vec = lam.numpy(), vec.numpy()
    ej = np.asarray(jax_eigs_general(JaxDense(jnp.asarray(a)), num=k,
                                     subspace=k, tol=1e-10)[0])
    scale = np.abs(ej).max()
    for e in ej:   # every JAX eigenvalue has its port counterpart
        assert np.abs(lam - e).min() <= 1e-10 * scale
    r = a @ vec - vec * lam[None, :]
    assert np.linalg.norm(r, axis=0).max() <= 1e-10 * scale


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the card's Schur route")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("route", [None, "lapack", "host", "qr"])
def test_card_route_matches_cpu_lapack(rng, cuda_device, route):
    """The card's Schur routes (None: ``CARD_SCHUR_ROUTE``) against the
    CPU's LAPACK route on the same matrix, k = 96."""
    a, c, _ = stable_problem(rng, 96, "schur", None)
    t = torch.from_numpy
    x_cpu = lyap(t(a), t(c), method="schur").numpy()
    x_card = lyap(t(a).to(cuda_device), t(c).to(cuda_device),
                  method="schur", _schur_route=route)
    assert x_card.device.type == "cuda"
    x_card = x_card.cpu().numpy()
    assert np.linalg.norm(x_card - x_cpu) <= 1e-10 * np.linalg.norm(x_cpu)
