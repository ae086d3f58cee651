"""The port's distributed Schur operator, ``pad_system`` and the CLI's
``--distributed`` against the JAX package's, on the CPU.

The JAX package runs on the eight virtual CPU devices of
``tests/conftest.py``, the port on eight ``cpu`` shards in one process
(the CLI: the one CPU device its ``--device cpu`` names).  Tolerances:

- ``pad_system``: equal arrays (the same scipy operations);
- the distributed Schur operator's applies at float64: 1e-12 of max|y|
  (a scatter-add and an LU solve of a 16 x 16 block in another order);
- the CLIs: both solve to tol 1e-10 and run their eigensolvers to
  1e-12, so their solutions agree to about 1e-10 of ||X|| and the
  eigenvalue tables to 1e-6 of each eigenvalue.  The JAX CLI pads the
  Schur problem's dynamic rows to its 8-device mesh; the padded rows'
  solution block is zero, so the tables are the same.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu.cli as jax_cli
from rails_tpu.models import make_problem as jax_make
from rails_tpu.parallel import mesh as jax_mesh
from rails_tpu.parallel import schur_dist as jax_sd
from rails_tpu.schur import schur_reduce as jax_schur_reduce
import rails_tpu_torch as rt
from rails_tpu_torch import cli
from rails_tpu_torch import io as tio
from rails_tpu_torch.models import make_problem
from rails_tpu_torch.parallel.halo_ell import HaloEllOperator
from rails_tpu_torch.parallel.mesh import make_mesh
from rails_tpu_torch.parallel.schur_dist import (
    DistributedSchurOperator, distribute_schur, pad_system)
from test_torch_cli import _table

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh.make_mesh(8), make_mesh(devices=["cpu"] * 8)


def graft_dae(nd=8):
    """``__graft_entry__.py``'s distributed-Schur DAE: n = 8 nd, 2 nd
    rows of M zero (n2 = 6 nd), B zero in them."""
    n = nd * 8
    rng = np.random.default_rng(2)
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.3)
    a = sp.csr_matrix(a - 4.0 * np.eye(n))
    md = rng.uniform(0.5, 1.5, n)
    md[rng.permutation(n)[:nd * 2]] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[md == 0] = 0.0
    return a, sp.diags(md).tocsr(), b


def dae_problem(n, n1, seed=0, p=2):
    """tests/test_schur_dist.py's random index-1 DAE."""
    rng = np.random.default_rng(seed)
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.25)
    a = sp.csr_matrix(a - 3.0 * np.eye(n))
    md = rng.uniform(0.5, 1.5, n)
    md[rng.permutation(n)[:n1]] = 0.0
    b = rng.uniform(-1, 1, (n, p))
    b[md == 0] = 0.0
    return a, sp.diags(md).tocsr(), b


def _port_reduce(a, m, b, **kw):
    return rt.schur_reduce(a, m, b, dtype=torch.float64, device="cpu", **kw)


class TestPadSystem:
    def test_matches_jax(self):
        a, m, b = dae_problem(71, 30, seed=3)
        aj, mj, bj, pj = jax_sd.pad_system(a, m, b, 8)
        at, mt, bt, pt = pad_system(a, m, b, 8)
        assert pt == pj > 0
        assert abs(at - aj).max() == 0 and abs(mt - mj).max() == 0
        assert np.array_equal(bt, bj)
        assert pad_system(a, m, b, 1)[3] == 0

    def test_follows_singular_tol(self):
        """Diagonal entries of M at 1e-10 count as singular under
        singular_tol=1e-8: the padding follows the reduction's split (the
        JAX package's pad_system hard-codes 1e-12)."""
        a, m, b = dae_problem(40, 10, seed=1)
        md = m.diagonal().copy()
        md[np.flatnonzero(md)[:3]] = 1e-10
        m = sp.diags(md).tocsr()
        a_p, m_p, b_p, pad = pad_system(a, m, b, 8, singular_tol=1e-8)
        red = _port_reduce(a_p, m_p, b_p, singular_tol=1e-8)
        assert red.n2 % 8 == 0 and red.n2 == 27 + pad
        assert pad_system(a, m, b, 8)[3] == jax_sd.pad_system(a, m, b, 8)[3]


class TestDistributedSchur:
    def test_applies_match_jax(self, meshes):
        mj, mt = meshes
        a, m, b = graft_dae()
        red_j = jax_schur_reduce(a, m, b)
        red_t = _port_reduce(a, m, b)
        assert red_t.n2 == red_j.n2 == 48
        op_j = jax_sd.distribute_schur(red_j, mj)
        op_t = distribute_schur(red_t, mt)
        assert isinstance(op_t, DistributedSchurOperator)
        assert type(op_t.a22).__name__ == type(op_j.a22).__name__
        x = np.random.default_rng(1).uniform(-1, 1, (48, 5))
        for name in ("matmat", "rmatmat"):
            yj = np.asarray(jax.jit(lambda o, v, f=name: getattr(o, f)(v))(
                op_j, jnp.asarray(x)))
            yt = getattr(op_t, name)(torch.from_numpy(x)).numpy()
            yh = getattr(red_t.operator, name)(torch.from_numpy(x)).numpy()
            scale = np.abs(yj).max()
            assert np.abs(yt - yj).max() <= 1e-12 * scale, name
            assert np.abs(yt - yh).max() <= 1e-12 * scale, name
        op32 = op_t.astype(torch.float32)
        assert op32.payload_dtype == torch.float32
        assert op32.lu.dtype == torch.float32 and op_t.astype(
            torch.float64) is op_t
        assert rt.LyapunovSolver(op_t, red_t.bs, red_t.ms, mesh=mt,
                                 dtype=torch.float64).A is op_t

    def test_errors_match_jax(self, meshes):
        mj, mt = meshes
        a, m, b = dae_problem(71, 30, seed=3)
        red_j, red_t = jax_schur_reduce(a, m, b), _port_reduce(a, m, b)
        assert red_t.n2 % 8
        with pytest.raises(ValueError, match="pad the system"):
            jax_sd.distribute_schur(red_j, mj)
        with pytest.raises(ValueError, match="pad the system"):
            distribute_schur(red_t, mt)
        a, m, b = graft_dae()
        red_j = jax_schur_reduce(a, m, b, a11_solver="iterative")
        red_t = _port_reduce(a, m, b, a11_solver="iterative")
        with pytest.raises(ValueError, match="dense-LU"):
            jax_sd.distribute_schur(red_j, mj)
        with pytest.raises(ValueError, match="dense-LU"):
            distribute_schur(red_t, mt)

    def test_no_singular_part_is_sharded_a22(self, meshes):
        _, mt = meshes
        n = 64
        rng = np.random.default_rng(5)
        a = sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (n, n)).tocsr()
        red = _port_reduce(a, sp.diags(rng.uniform(0.5, 1.5, n)).tocsr(),
                           rng.uniform(0, 1, (n, 1)), fmt="ell")
        assert red.n1 == 0
        assert isinstance(distribute_schur(red, mt), HaloEllOperator)

    def test_solve_on_mesh(self, meshes):
        """The solver on the distributed operator converges where the
        unsharded Schur operator does, to the same X."""
        _, mt = meshes
        a, m, b = graft_dae()
        red = _port_reduce(a, m, b)
        kw = dict(dtype=torch.float64, tol=1e-8, expand=2, device="cpu")
        v1, t1, i1 = rt.LyapunovSolver(distribute_schur(red, mt), red.bs,
                                       red.ms, mesh=mt, **kw).solve()
        v2, t2, i2 = rt.LyapunovSolver(red.operator, red.bs, red.ms,
                                       **kw).solve()
        assert i1.converged and i2.converged
        x1, x2 = (v1 @ t1 @ v1.T).numpy(), (v2 @ t2 @ v2.T).numpy()
        assert np.linalg.norm(x1 - x2) <= 1e-7 * np.linalg.norm(x2)


PARAMS = {"Lyapunov Solver": {"Tolerance": 1e-10, "Maximum iterations": 300},
          "Eigenvalue Solver": {"Number of Eigenvalues": 6,
                                "Convergence Tolerance": 1e-12}}


@pytest.fixture
def params(tmp_path):
    p = tmp_path / "params.json"
    p.write_text(json.dumps(PARAMS))
    return str(p)


def _run_both(kind, tmp_path, params, capsys, fmt=None):
    for d, maker in (("port", make_problem), ("jax", jax_make)):
        maker.make(kind, str(tmp_path / d))
    extra = [] if fmt is None else ["--fmt", fmt]
    assert cli.main([str(tmp_path / "port"), "--device", "cpu", "--x64",
                     "--distributed", "--params", params] + extra) == 0
    out_t = capsys.readouterr().out
    assert jax_cli.main([str(tmp_path / "jax"), "--platform", "cpu",
                         "--x64", "--distributed", "--params", params]
                        + extra) == 0
    out_j = capsys.readouterr().out
    tt, tj = _table(out_t), _table(out_j)
    assert tt.shape == tj.shape == (6, 2)
    assert np.all(np.abs(tt - tj) <= 1e-6 * np.abs(tj)), (tt, tj)
    assert "Solver converged" in out_t
    return out_t, out_j


class TestCliDistributed:
    def test_schur_path_matches_jax(self, tmp_path, params, capsys):
        out_t, out_j = _run_both("dae", tmp_path, params, capsys)
        assert "Distributed run: 1 processes, 1 global devices" in out_t
        for out in (out_t, out_j):
            assert "Distributed operator: DistributedSchurOperator" in out
        assert "Padded system with 5 decoupled rows" in out_j

    @pytest.mark.parametrize("fmt", ["ell", "dia"])
    def test_direct_path_matches_jax(self, tmp_path, params, capsys, fmt):
        out_t, _ = _run_both("laplace", tmp_path, params, capsys, fmt)
        name = {"ell": "HaloEllOperator", "dia": "HaloDiaOperator"}[fmt]
        assert f"Distributed operator: {name}" in out_t
        v = tio.read_matrix_market(str(tmp_path / "port" / "V.mtx"))
        assert v.shape[0] == 64

    def test_nondiagonal_m_exits_in_both(self, tmp_path):
        for d, maker in (("port", make_problem), ("jax", jax_make)):
            maker.make("laplace", str(tmp_path / d))
            m = sp.diags([0.1, 1.0, 0.1], [-1, 0, 1], (64, 64)).tocsr()
            tio.write_matrix_market(str(tmp_path / d / "M.mtx"), m)
        with pytest.raises(SystemExit, match="diagonal mass"):
            cli.main([str(tmp_path / "port"), "--device", "cpu", "--x64",
                      "--distributed"])
        with pytest.raises(SystemExit, match="diagonal mass"):
            jax_cli.main([str(tmp_path / "jax"), "--platform", "cpu",
                          "--x64", "--distributed"])

    def test_more_processes_raise(self, tmp_path, params, capsys):
        """Two processes no longer raise: the CLI's distributed Schur path
        on two gloo processes on the CPU gives a DistributedSchurOperator
        on each and the one-process run's eigenvalue table (both solve to
        tol 1e-10: 1e-6 of each eigenvalue, as against the JAX CLI)."""
        from test_torch_multihost import _free_port, run_workers

        make_problem.make("dae", str(tmp_path / "d"))
        coordinator = f"127.0.0.1:{_free_port()}"
        outs = run_workers(
            ["-m", "rails_tpu_torch.cli"],
            lambda pid: [str(tmp_path / "d"), "--device", "cpu", "--x64",
                         "--params", params, "--distributed",
                         "--num-processes", "2", "--process-id", str(pid),
                         "--coordinator", coordinator], 2)
        for rc, out, err in outs:
            assert rc == 0, f"rc={rc}\nstdout:{out}\nstderr:{err}"
            assert "Distributed operator: DistributedSchurOperator" in out
        capsys.readouterr()
        assert cli.main([str(tmp_path / "d"), "--device", "cpu", "--x64",
                         "--params", params, "--distributed"]) == 0
        one = _table(capsys.readouterr().out)
        for _, out, _ in outs:
            tt = _table(out)
            assert tt.shape == one.shape == (6, 2)
            assert np.all(np.abs(tt - one) <= 1e-6 * np.abs(one))
