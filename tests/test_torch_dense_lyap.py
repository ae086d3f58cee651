"""The port's dense projected Lyapunov solvers against the JAX package's.

Random stable problems (k = 2..40) built with numpy from a seed go
through ``rails_tpu.linalg.dense_lyap.lyap`` and the port's ``lyap`` at
float64, for every method and for no E, an SPD E and a general E.  The
two solutions must agree to 1e-10 relative in the Frobenius norm.  The
schur method takes different routes (LAPACK's Schur in the JAX package
on the CPU, the port's own shifted-QR Schur), so the agreement also
checks the port's Schur decomposition.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from rails_tpu.linalg.dense_lyap import lyap as jax_lyap
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
