"""The port's dense projected Lyapunov solvers against the JAX package's.

Random stable problems (k = 2..40) built with numpy from a seed go
through ``rails_tpu.linalg.dense_lyap.lyap`` and the port's ``lyap`` at
float64, for every method and for no E, an SPD E and a general E.  The
two solutions must agree to 1e-10 relative in the Frobenius norm.  On the
CPU both packages take LAPACK's complex Schur (zgees) for the schur
method, then the same back-substitution: held to 1e-12 relative up to
k = 160, the projected size of the CLI's Schur path.  The port's other
routes (``_schur_route``): "host" (zgees and LAPACK's trsyl for the
whole Bartels-Stewart step, on the host; the card's route) to 1e-11, and
"qr" (the port's own shifted-QR Schur, ``complex_schur``) to 1e-10.
"""

import jax.numpy as jnp
import numpy as np
import pytest
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
