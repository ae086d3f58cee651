"""The CPU self-check of the benchmark's yardstick: the problem builders
and the generator, the float64 host checks, the roofline arithmetic, the
trace's interval arithmetic and the probe's accounting, at tiny sizes.

    python3 -m pytest bench_torch/test_selfcheck.py -q
"""

import hashlib
import json
from pathlib import Path

import numpy as np
import pytest
import scipy.linalg as sla
import torch

from bench_torch import generator, roofline
from bench_torch.probe import Probe
from bench_torch.reference import checks, problems
from bench_torch.trace import Trace

LAPLACE = {"family": "laplacian2", "side": 6, "base_seed": 0,
           "m_diag": {"low": 0.5, "high": 1.5},
           "rhs": {"columns": 3, "low": 0.0, "high": 1.0}}
DAE = dict(LAPLACE, m_diag={"low": 0.5, "high": 1.5, "zero_one_in": 3})
ROOT = Path(__file__).resolve().parent.parent


def test_laplacian2_is_the_five_point_stencil():
    side = 5
    a = problems.operator({"family": "laplacian2", "side": side}).toarray()
    t = np.diag(-4.0 * np.ones(side)) + np.diag(np.ones(side - 1), 1) \
        + np.diag(np.ones(side - 1), -1)
    s = np.diag(np.ones(side - 1), 1) + np.diag(np.ones(side - 1), -1)
    np.testing.assert_array_equal(
        a, np.kron(np.eye(side), t) + np.kron(s, np.eye(side)))


# sha256 of A's CSR arrays for each configuration of BENCHMARK.json at its
# own side, taken when A was built in reference/problems.py itself: a
# family's file builds the same A bit for bit
CSR_DIGESTS = {
    "laplace2d": {
        "indptr": "9f3e9e4b0c3d060ee99b3c08ee35dd3ef6ac44d40a05fcde28710dc2f83742d8",
        "indices": "d43ca3af48b3e38243d937e79378f5797f260aa8d927408eff94a9c1078f2e98",
        "data": "c2c9f1e06e97bbf2cc01213cbff6d94971ea233f1ca5e55dbe8d502fff95b2d4"},
    "dae_index1": {
        "indptr": "710eb39d8106993c3b3b1988836b8736d74b903b897a94d9f1d91b01499d4da2",
        "indices": "3c665adec529d644035044d8ba452331bef4ec624846928ad29e528e9fbbb897",
        "data": "566e80e0fd217681ccafd6e63e63cbff19b5788e1efa6be97e22db4604d9a4ca"},
}


@pytest.mark.parametrize("name", sorted(CSR_DIGESTS))
def test_operator_of_each_configuration_is_unchanged(name):
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    conf = {c["name"]: c for c in bench["configs"]}[name]
    a = problems.operator(json.loads((ROOT / conf["file"]).read_text()))
    assert a.format == "csr" and a.dtype == np.float64
    got = {k: hashlib.sha256(getattr(a, k).tobytes()).hexdigest()
           for k in CSR_DIGESTS[name]}
    assert got == CSR_DIGESTS[name]


def test_unknown_family_exits_naming_the_families_present():
    with pytest.raises(SystemExit, match="laplacian2"):
        problems.operator({"family": "no_such_family", "side": 4})


def test_generator_fresh_equation_per_request_same_sequence_per_seed():
    p1 = generator.problem(DAE, "cpu")
    p2 = generator.problem(DAE, "cpu")
    np.testing.assert_array_equal(p1.md, p2.md)
    assert p1.singular.sum() == p1.n // 3
    assert np.all((p1.md[~p1.singular] >= 0.5) & (p1.md[~p1.singular] < 1.5))
    big = 2 ** 40 + 3   # seeds beyond 32 bits
    b = generator.rhs(p1, big, 0, "cpu")
    assert torch.equal(b, generator.rhs(p2, big, 0, "cpu"))
    assert b.shape == (36, 3) and b.dtype == torch.float64
    assert torch.all(b[torch.as_tensor(p1.singular)] == 0)
    # another request: another equation
    nxt = generator.rhs(p1, big, 1, "cpu")
    assert (b @ b.T - nxt @ nxt.T).abs().max() > 0.1
    # another seed: the same equation, other bytes
    other = generator.rhs(p1, big + 1, 0, "cpu")
    assert not torch.equal(b, other)
    torch.testing.assert_close(b @ b.T, other @ other.T, rtol=0, atol=1e-14)
    q = generator.rotation(5, big, 7)
    torch.testing.assert_close(q.T @ q, torch.eye(5, dtype=q.dtype))
    assert not generator.problem(LAPLACE, "cpu").singular.any()
    other_base = generator.problem(dict(LAPLACE, base_seed=1), "cpu")
    assert not generator.rhs(other_base, big, 0, "cpu").equal(
        generator.rhs(generator.problem(LAPLACE, "cpu"), big, 0, "cpu"))


def _exact(n=12, p=2, seed=0):
    """A stable symmetric A, M = I, and the exact X of A X + X A + B B'
    = 0, as V T V' with V the identity."""
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((n, n))
    a = -(q @ q.T) / n - np.eye(n)
    b = rng.uniform(0, 1, (n, p))
    x = sla.solve_continuous_lyapunov(a, -b @ b.T)
    return a, b, np.eye(n), x


def test_residual_checks_reach_float64_and_see_float32():
    a, b, v, t = _exact()
    av, mv = a @ v, v
    assert checks.true_residual(av, mv, b, t, 1) < 1e-13
    assert checks.galerkin(av, mv, b, v, t) < 1e-13
    t32 = t.astype(np.float32).astype(np.float64)
    assert checks.galerkin(av, mv, b, v, t32) > 1e-9
    assert checks.true_residual(av, mv, b, 2 * t, 1) > 0.1
    assert checks.rel_gap(av, av) == 0.0
    assert 1e-9 < checks.rel_gap(av.astype(np.float32), av) < 1e-6


def test_schur_host_matches_the_dense_reduction():
    prob = generator.problem(dict(DAE, base_seed=7), "cpu")
    host = checks.SchurHost(prob.a, prob.md)
    a = prob.a.toarray()
    i1, i2 = host.i1, host.i2
    s = a[np.ix_(i2, i2)] - a[np.ix_(i2, i1)] @ np.linalg.solve(
        a[np.ix_(i1, i1)], a[np.ix_(i1, i2)])
    v = np.linalg.qr(np.random.default_rng(1).standard_normal(
        (len(i2), 4)))[0]
    np.testing.assert_allclose(host.s_apply(v), s @ v, atol=1e-12)
    t = np.diag([3.0, 2.0, 1.0, 0.5])
    x22 = v @ t @ v.T
    a11inv_a12 = np.linalg.solve(a[np.ix_(i1, i1)], a[np.ix_(i1, i2)])
    x = np.zeros_like(a)
    x[np.ix_(i2, i2)] = x22
    x[np.ix_(i1, i2)] = -a11inv_a12 @ x22
    x[np.ix_(i2, i1)] = -x22 @ a11inv_a12.T
    x[np.ix_(i1, i1)] = a11inv_a12 @ x22 @ a11inv_a12.T
    lam = np.linalg.eigvalsh(x)
    lead = lam[np.argmax(np.abs(lam))]
    assert abs(host.leading_eigenvalue(v, t, 3) - lead) < 1e-10 * abs(lead)


def test_dia_and_ell_work():
    # 4 x 4 tridiagonal: 10 terms; data 3 x 4, x and y 4 x 2, f64
    nbytes, ops = roofline.dia_work(4, 4, (-1, 0, 1), 2, 8)
    assert nbytes == (12 + 8 + 8) * 8 + 12 and ops == 2 * 10 * 2
    # the n = 65,536 solve's apply at s = 8, f64
    nbytes, ops = roofline.dia_work(65536, 65536, (-256, -1, 0, 1, 256),
                                    8, 8)
    assert nbytes == (5 * 65536 + 2 * 65536 * 8) * 8 + 20
    assert ops == 2 * 8 * (5 * 65536 - 2 - 2 * 256)
    nbytes, ops = roofline.ell_work(6, 5, 3, 2, 4)
    assert nbytes == 3 * 6 * 8 + (10 + 12) * 4 and ops == 2 * 3 * 6 * 2
    pk = roofline.peaks("NVIDIA H100 80GB HBM3")
    t = roofline.least_seconds(3.35e9, 0, "float64", pk)
    assert t == pytest.approx(1e-3)
    assert roofline.share_pct([(3.35e9, 0, "float64")], 2e-3, pk) == \
        pytest.approx(50.0)
    assert roofline.share_pct([(1, 0, "float64")], 1.0, None) is None
    assert roofline.peaks("some other card") is None


def _trace(device, host, window=(0, 100)):
    t = Trace.__new__(Trace)
    t.window = window
    t.device = sorted(device)
    t.host = sorted(host)
    t._starts = [h[0] for h in t.host]
    return t


def test_trace_union_and_gaps():
    t = _trace([(10, 30, "k1"), (20, 40, "k2"), (60, 70, "k1")],
               [(0, 100, "outer", "op"), (40, 60, "aten::eigh", "op"),
                (45, 55, "cudaStreamSynchronize", "rt")])
    assert t.busy_s == pytest.approx(40e-9)
    assert t.window_s == pytest.approx(100e-9)
    assert t.kernel(("k1",)) == (2, pytest.approx(30e-9))
    br = t.breakdown()
    assert br["device_ops"][0] == ["k1", pytest.approx(30e-9)]
    gaps = dict((k, v) for k, v in br["idle_gaps"])
    assert gaps["aten::eigh"] == pytest.approx(20e-9)
    assert gaps["outer"] == pytest.approx(40e-9)   # [0, 10) and [70, 100)


def test_probe_counts_replays_at_the_captured_shape():
    p = Probe("nowhere.at.all", "f", lambda *a: (1, 1, "float64"))
    p.install()
    assert not p.installed
    p.calls = [(100, 1, "float64", True, None),      # captured in set-up
               (10, 1, "float64", False, "window")]  # an eager call
    assert p.works_in("window", 3) == [(10, 1, "float64")] + \
        [(100, 1, "float64")] * 2
    p.calls.append((200, 1, "float64", True, None))  # two captured shapes
    assert p.works_in("window", 3) is None
    assert p.works_in("window", 1) == [(10, 1, "float64")]
    assert p.works_in("window", 0) is None
