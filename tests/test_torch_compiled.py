"""``solve(compiled=True)`` of the port against the JAX package's
``solve(compiled=True)`` on the CPU, and its engine cache.

On the CPU the port's compiled path runs its recorded iteration
(``LyapunovSolver._build_iterate``) eagerly on the device state, with the
state at full capacity from the start, as the JAX package's
``while_loop`` engine runs it.  The port takes the JAX package's draws
through its ``draws`` hook (a ``(timevec_chunk, m)`` buffer filled before
each chunk); the eigenvector signs of the Lanczos tridiagonal are fixed
in both (tests/test_torch_parity.py explains why).

Tolerances: both packages run the same arithmetic in another order, so
the solutions agree to roundoff amplified by the Lanczos warm start;
V T V' is held to 1e-10 in the max norm on these n = 20-24 problems,
where the measured gaps are below 1e-13.

Tests marked ``cuda`` run on the card: capture and replay against the
same iteration run eagerly there, bit for bit, and the registered
generator's draws moving on across replays.
"""

from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
import rails_tpu.core.solver as jax_solver_mod
import rails_tpu_torch as rt
from rails_tpu_torch.core import engine as engine_mod
from rails_tpu_torch.core.solver import LyapunovSolver
from rails_tpu_torch.models.problems import tridiagonal_problem

from test_torch_parity import JaxDraws, _Proxy, _jax_eigh_sign_fixed

torch.set_num_threads(1)

CPU = {"device": "cpu"}


@pytest.fixture
def jax_sign_fixed(monkeypatch):
    monkeypatch.setattr(jax_solver_mod, "jnp", _Proxy(
        jnp, linalg=_Proxy(jnp.linalg, eigh=_jax_eigh_sign_fixed)))


def xx(v, t):
    v, t = np.asarray(v), np.asarray(t)
    return v @ t @ v.T


def true_rel(a, v, t, b, m=None):
    x = xx(v, t)
    m = np.eye(a.shape[0]) if m is None else m
    r = a @ x @ m.T + m @ x @ a.T + b @ b.T
    return np.linalg.norm(r, 2) / np.linalg.norm(b.T @ b, 2)


def three_runs(a, b, m=None, tags=None, **opts):
    """The JAX package compiled, the port eager and the port compiled,
    the port with the JAX package's draws.  ``tags``: operator tags for
    A (they pick the projected solve's route), else the dense array
    (the schur route)."""
    mj = None if m is None else rails_tpu.DiagonalOperator(
        jnp.asarray(np.diag(m)))
    aj = jnp.asarray(a) if tags is None else rails_tpu.DenseOperator(
        jnp.asarray(a), **tags)
    vj, tj, ij = rails_tpu.solve(aj, jnp.asarray(b), mj, compiled=True,
                                 **opts)
    runs = [(np.asarray(vj), np.asarray(tj), ij)]
    for compiled in (False, True):
        mt = None if m is None else rt.DiagonalOperator(np.diag(m), **CPU)
        at = a if tags is None else rt.DenseOperator(a, **tags, **CPU)
        v, t, i = rt.solve(at, b, mt, compiled=compiled,
                           draws=JaxDraws(4634), **CPU, **opts)
        runs.append((v.numpy(), t.numpy(), i))
    return runs


def assert_same(runs, status=0):
    (vj, tj, ij), *port = runs
    for v, t, i in port:
        assert i.iter == ij.iter and i.status == ij.status == status
        assert v.shape == vj.shape
        assert np.abs(xx(v, t) - xx(vj, tj)).max() <= 1e-10


@pytest.mark.parametrize("precision", ["standard", "compensated"])
def test_tridiagonal_matches_jax(rng, jax_sign_fixed, precision):
    """tests/test_solver.py:193-199's problem at float64."""
    a, b = tridiagonal_problem(rng)
    runs = three_runs(a, b, tol=1e-6, precision=precision)
    assert_same(runs)
    assert runs[2][2].engine["iterations"] == runs[2][2].iter


@pytest.mark.parametrize("case", ["restart", "no_restart_upon_convergence",
                                  "mass", "maxit", "eigh_route",
                                  "sign_route"])
def test_variants_match_jax(rng, jax_sign_fixed, case):
    """A run with restarts (every 5 iterations), one without the
    post-convergence restart, one with M, one stopped at maxit (status
    -1), and the projected solve's eigh (symmetric A) and sign (Hurwitz
    A) routes through the recorded iteration's dense calls."""
    a, b = tridiagonal_problem(rng, 24)
    m, status, tags = None, 0, None
    opts = dict(tol=1e-8)
    if case == "eigh_route":
        a, tags = 0.5 * (a + a.T) - 3.0 * np.eye(24), {"is_symmetric": True}
    elif case == "sign_route":
        a, tags = a - 3.0 * np.eye(24), {"is_hurwitz": True}
    elif case == "restart":
        opts.update(restart_iterations=5)
    elif case == "no_restart_upon_convergence":
        opts.update(restart_upon_convergence=False)
    elif case == "mass":
        m = np.diag(rng.uniform(0.5, 1.5, 24))
    elif case == "maxit":
        opts.update(tol=1e-14, maxit=3)
        status = -1
    runs = three_runs(a, b, m, tags, **opts)
    assert_same(runs, status)
    if status == 0:
        assert true_rel(a, *runs[2][:2], b, m) < 1e-6


@pytest.mark.parametrize("chunk", [1, 8, 0])
def test_timevec_chunk_same_solution(rng, chunk):
    """The chunk only sets where the host reads: V and T are the same
    bits, and ``progress`` is called once per chunk."""
    a, b = tridiagonal_problem(rng)
    ref_v, ref_t, ref = rt.solve(a, b, tol=1e-8, compiled=True,
                                 timevec_chunk=5, **CPU)
    calls = []
    v, t, info = rt.solve(a, b, tol=1e-8, compiled=True,
                          timevec_chunk=chunk,
                          progress=lambda *c: calls.append(c), **CPU)
    assert torch.equal(v, ref_v) and torch.equal(t, ref_t)
    assert info.iter == ref.iter
    chunks = 1 if chunk <= 0 else -(-info.iter // chunk)
    assert len(calls) == chunks
    assert calls[-1][0] == info.iter
    assert len(info.timevec) == len(info.resvec)
    assert np.all(np.diff(info.timevec) >= 0)


def test_shared_cache_survives_b_change(rng):
    """tests/test_solver.py:290-308 in the port: r0sq, B and the
    operator payload ride in the engine's buffers, so a second solve
    through the same cache with a 1e-3 smaller B (and a new A) converges
    to its own true residual."""
    a, b = tridiagonal_problem(rng, 24, shift=-2.0)
    cache = {}
    v, t, info = LyapunovSolver(a, b, tol=1e-6, engine_cache=cache,
                                **CPU).solve(compiled=True)
    assert info.converged and true_rel(a, v, t, b) < 1e-5
    a2, b2 = a + 0.1 * np.eye(24), b * 1e-3
    v2, t2, info2 = LyapunovSolver(a2, b2, tol=1e-6, engine_cache=cache,
                                   **CPU).solve(compiled=True)
    assert len(cache) == 1
    assert info2.converged
    assert true_rel(a2, v2, t2, b2) < 1e-5


def test_nullspace_shape_is_keyed(rng):
    """The JAX key records only whether there is a nullspace
    (rails_tpu/core/solver.py:333); the port's records its shape, so
    deflation spaces of one and of two columns get an engine each."""
    n = 24
    a, b = tridiagonal_problem(rng, n, shift=-2.0)
    q = np.linalg.qr(rng.uniform(-1, 1, (n, 2)))[0]
    cache = {}
    for cols in (1, 2, 1):
        p = np.eye(n) - q[:, :cols] @ q[:, :cols].T
        v, t, info = LyapunovSolver(p @ a @ p, p @ b, tol=1e-8,
                                    nullspace=q[:, :cols],
                                    engine_cache=cache,
                                    **CPU).solve(compiled=True)
        assert info.converged
        assert np.linalg.norm(q[:, :cols].T @ v.numpy()) < 1e-10
    assert len(cache) == 2
    shapes = sorted(tuple(e.ctx.nullspace.shape) for e in cache.values())
    assert shapes == [(n, 1), (n, 2)]


def test_shared_cache_survives_m_presence_change(rng):
    """tests/test_solver.py:310-330 in the port: M present and M absent
    through one cache are two engines, each right."""
    n = 24
    a, b = tridiagonal_problem(rng, n, shift=-2.0)
    cache = {}
    v, t, info = LyapunovSolver(a, b, tol=1e-8, engine_cache=cache,
                                **CPU).solve(compiled=True)
    assert info.converged and true_rel(a, v, t, b) < 1e-6
    md = rng.uniform(0.5, 1.5, n)
    v2, t2, info2 = LyapunovSolver(
        a, b, rt.DiagonalOperator(md, **CPU), tol=1e-8,
        engine_cache=cache, **CPU).solve(compiled=True)
    assert info2.converged
    assert true_rel(a, v2, t2, b, np.diag(md)) < 1e-6
    assert len(cache) == 2


def test_continuation_shares_engines_across_steps(rng):
    """tests/test_solver.py:268-288 in the port: a cold and two warm
    compiled steps.  The JAX package's cache holds [2, 4, 4] engines
    (an init and a while_loop engine for the cold and for the warm
    trace); the port initialises eagerly, so it holds one recorded
    iteration per trace: [1, 2, 2].  The third step adds nothing."""
    n = 24
    a, b = tridiagonal_problem(rng, n, shift=-2.0)
    cont = rt.ContinuationSolver(b, tol=1e-6, reduced_size=6, **CPU)
    sizes = []
    for theta in (0.0, 0.05, 0.1):
        a_theta = a + theta * np.eye(n)
        v, t, info = cont.step(a_theta, compiled=True)
        assert info.converged
        assert true_rel(a_theta, v, t, b) < 1e-5
        sizes.append(len(cont._engine_cache))
    assert sizes == [1, 2, 2], sizes
    assert [i.iter for i in cont.history][1] < cont.history[0].iter


def test_structure_keys_operator_format(rng):
    """Two DIA operators with other offsets, and an ELL one, are three
    structures; a new payload with the same offsets is the same one."""
    from rails_tpu_torch.core.engine import structure

    lap = sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (50, 50)).tocsr()
    wide = sp.diags([1.0, -4.0, 1.0], [-7, 0, 7], (50, 50)).tocsr()
    ops = [rt.sparse_from_scipy(x, fmt=f, dtype=torch.float64, **CPU)
           for x, f in ((lap, "dia"), (2.0 * lap, "dia"), (wide, "dia"),
                        (lap, "ell"))]
    sig = [structure(op) for op in ops]
    assert sig[0] == sig[1]
    assert len({sig[0], sig[2], sig[3]}) == 3


class _StubRecorder:
    """A recorder as ``host_call`` sees it while a capture is under way:
    logs each host step's function and runs it."""

    capturing = True

    def __init__(self):
        self.steps = []

    def host(self, fn, *args, name=None):
        self.steps.append(fn)
        engine_mod._ACTIVE = None   # as Recorder.host: nested calls plain
        try:
            return fn(*args)
        finally:
            engine_mod._ACTIVE = self


def test_host_call_goes_through_the_active_recorder(monkeypatch):
    """``engine.host_call`` is a plain call when nothing records, and a
    host step of the recorder whose capture is under way; inside a host
    step (the recorder's own ``host`` running ``fn``) a nested
    ``host_call`` is a plain call again.  No card is needed: the
    recorder's segment boundaries are stubbed out."""
    x = torch.arange(6.0).reshape(3, 2)
    calls = []

    def fn(y):
        calls.append(engine_mod._ACTIVE)
        return 2 * y

    assert engine_mod._ACTIVE is None
    assert torch.equal(engine_mod.host_call(fn, x), 2 * x)
    stub = _StubRecorder()
    monkeypatch.setattr(engine_mod, "_ACTIVE", stub)
    assert torch.equal(engine_mod.host_call(fn, x), 2 * x)
    assert stub.steps == [fn]
    stub.capturing = False      # a recorder that is not capturing
    engine_mod.host_call(fn, x)
    assert stub.steps == [fn]

    # the real Recorder.host with its graph boundaries stubbed: one host
    # node, its output a static copy, the nested call plain
    rec = engine_mod.Recorder(SimpleNamespace(
        stats=engine_mod.EngineStats()))
    rec.capturing, rec._prog, rec._exec = True, [[]], [True]
    monkeypatch.setattr(rec, "_end", lambda: None)
    monkeypatch.setattr(rec, "_begin", lambda: None)
    monkeypatch.setattr(engine_mod, "_ACTIVE", rec)

    def outer(y):
        return engine_mod.host_call(fn, y) + 1

    calls.clear()
    out = engine_mod.host_call(outer, x)
    assert torch.equal(out, 2 * x + 1)
    assert calls == [None]                  # nested: plain, no recorder
    (node,) = rec._prog[0]
    assert isinstance(node, engine_mod._Host) and node.fn is outer
    assert node.outs[0] is out and node.args[0] is x
    assert rec.engine.stats.host_steps == 1
    assert engine_mod._ACTIVE is rec


def test_host_steps_routed_through_host_call(monkeypatch, rng):
    """A compiled solve on a Schur reduction with a native_lu A11 and an
    ``inv_a`` the expansion applies: every A11 solve of an S apply and
    every ``inv_a`` call reach ``host_call`` (the CPU runs them under a
    stub recorder), and ``info.engine`` names both sources."""
    n = 60
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = sp.csr_matrix(a - 3.0 * np.eye(n))
    md = rng.uniform(0.5, 1.5, n)
    md[rng.permutation(n)[:n // 3]] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[md == 0] = 0.0
    red = rt.schur_reduce(a, sp.diags(md), b, a11_solver="native_lu",
                          dtype=torch.float64, **CPU)
    inv_a = red.sinv("native_lu")
    applies = [0]
    op = red.operator
    fn = op.fn

    def counted(x):
        applies[0] += 1
        return fn(x)

    op.fn = counted
    expansions = [0]
    block = LyapunovSolver._expansion_block

    def counted_block(self, *args):
        expansions[0] += 1
        return block(self, *args)

    monkeypatch.setattr(LyapunovSolver, "_expansion_block", counted_block)
    stub = _StubRecorder()
    monkeypatch.setattr(engine_mod, "_ACTIVE", stub)
    v, t, info = rt.solve(op, red.bs, red.ms, tol=1e-8, inv_a=inv_a,
                          projection_method=2.2, compiled=True, **CPU)
    assert info.status == 0
    # one A11 solve per S apply (the initial space's and each Gram
    # update's), and one for the initial space's inv_a(B), which the
    # solver calls directly before any recording; sinv's own host_call
    # inside an inv_a host step is plain, so it adds no step
    a11 = [f for f in stub.steps if f is not inv_a]
    assert len(a11) == applies[0] + 1 and applies[0] > info.iter
    assert stub.steps.count(inv_a) == expansions[0] > 0
    assert info.engine["host_step_sources"] == {
        "A": "the A11 solve of native_lu", "inv_a": "the expansion's inv_a"}


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture has no CPU mode")
    return torch.device("cuda")


def card_problem(fmt, side=32):
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    b = rng.uniform(0, 1, (n, 4))
    a = rt.sparse_from_scipy(laplacian2_sparse(side), fmt=fmt,
                             dtype=torch.float64, is_symmetric=True,
                             device="cuda")
    return a, b


@pytest.mark.cuda
@pytest.mark.parametrize("fmt", ["dia", "ell"])
def test_replay_bit_equal_to_eager_on_card(cuda_device, monkeypatch, fmt):
    """The recorded and replayed iteration against the same iteration
    run eagerly on the card (``engine.CAPTURE = False``): the same bits,
    and the kernel launched on every A apply."""
    from rails_tpu_torch.sparse import ell_spmm, spmm

    a, b = card_problem(fmt)
    kernel = spmm.dia_spmm if fmt == "dia" else ell_spmm.ell_spmm
    opts = dict(tol=1e-4, expand=4, restart_size=40, reduced_size=20,
                maxit=500, timevec_chunk=4)
    out = []
    for capture in (False, True):
        monkeypatch.setattr(engine_mod, "CAPTURE", capture)
        before = kernel.launches
        v, t, info = rt.solve(a, b, compiled=True, **opts)
        torch.cuda.synchronize()
        out.append((v, t, info, kernel.launches - before))
    (v0, t0, i0, n0), (v1, t1, i1, n1) = out
    assert i1.engine["captured"] and not i0.engine["captured"]
    assert i0.iter == i1.iter and i1.converged
    assert torch.equal(v0, v1) and torch.equal(t0, t1)
    assert n0 == n1 > 0


@pytest.mark.cuda
def test_generator_moves_on_across_replays(cuda_device):
    """The solver's generator is registered with the recorded graphs, so
    each replay draws new Lanczos numbers: the replayed solve (chunks of
    2, recorded at iteration 2) follows the eager path's residual
    history, drawn from the same seed, through its first 8 iterations
    (a replay that repeated its captured numbers would leave it at the
    third); the two paths differ only in rounding there."""
    a, b = card_problem("dia")
    opts = dict(tol=1e-6, expand=4, maxit=500)
    v, t, info = LyapunovSolver(a, b, timevec_chunk=2,
                                **opts).solve(compiled=True)
    ve, te, ie = LyapunovSolver(a, b, **opts).solve()
    assert info.engine["captured"] and info.iter > 8
    np.testing.assert_allclose(info.resvec[:8], ie.resvec[:8], rtol=1e-8)
    assert info.converged and ie.converged
