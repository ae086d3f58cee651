"""The port's CLI, io, config, reorder and make_problem against the JAX
package's, on the CPU.

Both CLIs run the reference's main-program path on ``make_problem
--kind dae`` (n = 64) in temporary directories.  Their solves draw other
random numbers (the port from a ``torch.Generator``, the JAX package from
``jax.random``) and each stops at a relative residual below tol = 1e-4,
so their solutions X agree to about that tolerance relative to ||X||,
and so do the eigenvalues of the full-space solution operator (Weyl:
an eigenvalue moves by at most ||dX||).  The tables are held to 1e-3 of
the leading eigenvalue, row by row.
"""

import dataclasses
import json
import os
import re

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu.cli as jax_cli
from rails_tpu import config as jax_config
from rails_tpu import io as jax_io
from rails_tpu.models import make_problem as jax_make
from rails_tpu.sparse import reorder as jax_reorder
from rails_tpu_torch import cli, config, io
from rails_tpu_torch.models import make_problem
from rails_tpu_torch.sparse import reorder

torch.set_num_threads(1)

_ROW = re.compile(r"^\s*(\S+)\s+(\S+)\s*$")


def _table(out):
    """The (eigenvalue, eigenvalue/trace) rows after the table header."""
    lines = out.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "eigenvalue/trace" in ln) + 1
    rows = []
    for ln in lines[start:]:
        mt = _ROW.match(ln)
        if not mt:
            break
        rows.append((float(mt.group(1)), float(mt.group(2))))
    return np.array(rows)


def _iterations(out):
    return int(re.search(r"Solver converged in (\d+) iterations",
                         out).group(1))


@pytest.fixture
def dae_dir(tmp_path):
    make_problem.make("dae", str(tmp_path / "port"))
    jax_make.make("dae", str(tmp_path / "jax"))
    return tmp_path


class TestCli:
    def test_both_clis_agree(self, dae_dir, capsys):
        assert cli.main([str(dae_dir / "port"), "--device", "cpu",
                         "--x64"]) == 0
        out_t = capsys.readouterr().out
        assert jax_cli.main([str(dae_dir / "jax"), "--platform", "cpu",
                             "--x64"]) == 0
        out_j = capsys.readouterr().out
        assert _iterations(out_t) > 0 and _iterations(out_j) > 0
        tt, tj = _table(out_t), _table(out_j)
        assert tt.shape == tj.shape == (10, 2)
        lam1 = tj[0, 0]
        assert np.abs(tt[:, 0] - tj[:, 0]).max() <= 1e-3 * lam1
        assert np.abs(tt[:, 1] - tj[:, 1]).max() <= 1e-3
        for scope in ("Driver/schur", "Driver/eigenvalues", "Solver/iterate"):
            assert scope in out_t
        v = io.read_matrix_market(str(dae_dir / "port" / "V.mtx"))
        t = io.read_matrix_market(str(dae_dir / "port" / "T.mtx"))
        assert v.shape[1] == t.shape[0] == t.shape[1]

    def test_only_eigenvalues_reloads(self, dae_dir, capsys):
        d = str(dae_dir / "port")
        cli.main([d, "--device", "cpu", "--x64", "--num-eigenvalues", "4"])
        first = _table(capsys.readouterr().out)
        cli.main([d, "--device", "cpu", "--x64", "--num-eigenvalues", "4",
                  "--only-eigenvalues"])
        out = capsys.readouterr().out
        assert "Reloading V.mtx / T.mtx" in out
        assert np.abs(_table(out) - first).max() <= 1e-12 * first[0, 0]

    def test_params_and_reorder(self, dae_dir, capsys, tmp_path):
        p = tmp_path / "p.json"
        p.write_text(json.dumps({
            "Lyapunov Solver": {"Tolerance": 1e-6, "Expand size": 1},
            "Eigenvalue Solver": {"Number of Eigenvalues": 3}}))
        assert cli.main([str(dae_dir / "port"), "--device", "cpu", "--x64",
                         "--params", str(p), "--reorder", "rcm"]) == 0
        out = capsys.readouterr().out
        assert "RCM reordering: bandwidth" in out
        res = float(re.search(r"relative residual (\S+),", out).group(1))
        assert res <= 1e-6
        assert _table(out).shape == (3, 2)

    def test_distributed_raises(self, dae_dir):
        """--distributed --num-processes 2 runs: two gloo processes on the
        CPU (no longer a refusal; four processes:
        tests/test_torch_multihost_cli.py), both converged in as many
        iterations, with equal eigenvalue tables."""
        from test_torch_multihost import _free_port, run_workers

        coordinator = f"127.0.0.1:{_free_port()}"
        outs = run_workers(
            ["-m", "rails_tpu_torch.cli"],
            lambda pid: [str(dae_dir / "port"), "--device", "cpu", "--x64",
                         "--distributed", "--num-processes", "2",
                         "--process-id", str(pid), "--coordinator",
                         coordinator], 2)
        for rc, out, err in outs:
            assert rc == 0, f"rc={rc}\nstdout:{out}\nstderr:{err}"
            assert "Distributed run: 2 processes, 2 shards, backend gloo" \
                in out
            assert "Solver converged" in out
        its = {re.search(r"converged in (\d+) iterations", o).group(1)
               for _, o, _ in outs}
        assert len(its) == 1
        np.testing.assert_array_equal(_table(outs[0][1]), _table(outs[1][1]))


class TestIo:
    def test_matrix_market_roundtrips(self, rng, tmp_path):
        a = sp.random(30, 20, density=0.2, random_state=3, format="csr")
        d = rng.uniform(-1, 1, (7, 3))
        io.write_matrix_market(str(tmp_path / "A"), a)  # no suffix
        io.write_matrix_market(str(tmp_path / "D.mtx"), torch.from_numpy(d))
        jax_io.write_matrix_market(str(tmp_path / "J.mtx"), a)
        assert abs(io.read_matrix_market(str(tmp_path / "A")) - a).max() == 0
        assert np.array_equal(io.read_matrix_market(str(tmp_path / "D.mtx")),
                              d)
        assert abs(io.read_matrix_market(str(tmp_path / "J.mtx"))
                   - jax_io.read_matrix_market(str(tmp_path / "A"))).max() \
            == 0

    def test_restart_data_roundtrip(self, rng, tmp_path):
        rd = {"V": torch.from_numpy(rng.uniform(size=(5, 2))),
              "AV": rng.uniform(size=(5, 2)), "VAV": np.eye(2)}
        io.save_restart_data(str(tmp_path / "rd"), rd)
        back = jax_io.load_restart_data(str(tmp_path / "rd"))
        assert np.array_equal(back["V"], rd["V"].numpy())
        assert np.array_equal(io.load_restart_data(str(tmp_path / "rd"))
                              ["AV"], rd["AV"])

    def test_border_matches_jax(self, rng):
        n = 6 * 70
        a = sp.random(n, n, density=0.01, random_state=1, format="csr")
        m = sp.diags(rng.uniform(0.5, 1.5, n))
        b = rng.uniform(size=(n, 1))
        w = io.moc_border(n)
        assert np.array_equal(w, jax_io.moc_border(n))
        for x, y in zip(io.add_border(a, m, b, w),
                        jax_io.add_border(a, m, b, w)):
            diff = x - y
            assert abs(diff).max() == 0

    def test_moc_problem(self):
        if not os.path.isdir(io.REFERENCE_DATAERIK):
            pytest.skip("the DataErik files are not in the repository")
        a, m, b = io.load_moc_problem()
        assert a.shape == m.shape and b.shape == (a.shape[0], 1)

    @pytest.mark.parametrize("kind", ["dae", "laplace"])
    def test_make_problem_matches_jax(self, tmp_path, kind):
        make_problem.make(kind, str(tmp_path / "t"), n=36)
        jax_make.make(kind, str(tmp_path / "j"), n=36)
        for name in ("A.mtx", "B.mtx", "M.mtx"):
            x = io.read_matrix_market(str(tmp_path / "t" / name))
            y = io.read_matrix_market(str(tmp_path / "j" / name))
            assert abs(x - y).max() == 0


XML = """<ParameterList name="main">
  <ParameterList name="Lyapunov Solver">
    <Parameter name="Maximum iterations" type="int" value="321"/>
    <Parameter name="TOLERANCE" type="double" value="1e-6"/>
    <Parameter name="expand size" type="int" value="4"/>
    <Parameter name="Restart size" type="int" value="90"/>
    <Parameter name="Reduced size" type="int" value="45"/>
    <Parameter name="Minimize solution space" type="bool" value="true"/>
    <Parameter name="verbosity" type="int" value="0"/>
  </ParameterList>
  <ParameterList name="Eigenvalue Solver">
    <Parameter name="Number of Eigenvalues" type="int" value="7"/>
  </ParameterList>
</ParameterList>
"""


class TestConfig:
    def _fields(self, opts):
        return {k: v for k, v in dataclasses.asdict(opts).items()
                if k != "dtype"}

    def test_xml_and_json_give_same_options(self, tmp_path):
        (tmp_path / "p.xml").write_text(XML)
        params = config.load_xml_parameters(str(tmp_path / "p.xml"))
        (tmp_path / "p.json").write_text(json.dumps(params))
        from_json = config.load_json_parameters(str(tmp_path / "p.json"))
        jparams = jax_config.load_xml_parameters(str(tmp_path / "p.xml"))
        ot = config.solver_options_from_params(
            params.sublist("Lyapunov Solver"))
        oj = jax_config.solver_options_from_params(
            jparams.sublist("Lyapunov Solver"))
        assert (ot.maxit, ot.tol, ot.expand, ot.restart_size,
                ot.reduced_size, ot.restart_upon_convergence) == \
            (321, 1e-6, 4, 90, 45, True)
        assert self._fields(ot) == self._fields(
            config.solver_options_from_params(
                from_json.sublist("Lyapunov Solver")))
        common = set(self._fields(ot)) & set(dataclasses.asdict(oj))
        assert {k: self._fields(ot)[k] for k in common} == \
            {k: dataclasses.asdict(oj)[k] for k in common}
        assert params.sublist("eigenvalue solver").get(
            "number of eigenvalues") == 7

    def test_overrides_and_bad_file(self, tmp_path):
        opts = config.solver_options_from_params(
            config.ParameterList({"Tolerance": 1e-3}), tol=1e-5, maxit=7.0)
        assert opts.tol == 1e-5 and opts.maxit == 7
        (tmp_path / "bad.xml").write_text("<Other/>")
        with pytest.raises(ValueError, match="ParameterList"):
            config.load_xml_parameters(str(tmp_path / "bad.xml"))


def test_rcm_matches_jax(rng):
    n = 200
    a = sp.random(n, n, density=0.02, random_state=5, format="csr") \
        + sp.eye(n)
    perm = reorder.rcm_permutation(a)
    assert np.array_equal(perm, jax_reorder.rcm_permutation(a))
    assert reorder.bandwidth(a[perm][:, perm]) < reorder.bandwidth(a)
    assert reorder.n_diagonals(a) == jax_reorder.n_diagonals(a)
    b = rng.uniform(size=(n, 2))
    for x, y in zip(reorder.permute_system(a, sp.eye(n), b, perm),
                    jax_reorder.permute_system(a, sp.eye(n), b, perm)):
        assert abs(x - y).max() == 0
