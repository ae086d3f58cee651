"""The port's CLI across processes: ``python -m rails_tpu_torch.cli
--distributed --num-processes 4 --device cpu`` (four gloo processes on
the CPU), the counterpart of tests/test_multihost.py's two-process CLI
tests (:23, :133), held against the JAX package's CLI run with
``--distributed`` in this process on the eight-device CPU mesh of
tests/conftest.py.

Each rank prints the eigenvalue table from replicated eigenvalues, so the
tables agree across ranks to 1e-12; against the JAX package's the leading
three agree to 1e-5 (test_multihost.py:201's bound).  Only rank 0 writes
V.mtx and T.mtx, gathered from every rank's rows.
"""

import json
import os
import re

import numpy as np
import pytest

from test_torch_multihost import _free_port, run_workers

# solve tolerances: the leading eigenvalues of the port's and the JAX
# package's solutions (other draws) agree to a few 1e-7 at 1e-5 on the
# Laplacian, and need 1e-6 on the DAE to stay inside 1e-5
TOL = {"laplace": 1e-5, "dae": 1e-6}


def params(kind):
    return {"Lyapunov Solver": {"Tolerance": TOL[kind],
                                "Maximum iterations": 400},
            "Eigenvalue Solver": {"Number of Eigenvalues": 4,
                                  "Convergence Tolerance": 1e-10}}


def table(text):
    lines = text.splitlines()
    start = next(i for i, ln in enumerate(lines)
                 if "eigenvalue/trace" in ln) + 1
    rows = []
    for ln in lines[start:]:
        parts = ln.split()
        if len(parts) != 2:
            break
        rows.append(float(parts[0]))
    return np.array(rows)


def iterations(text):
    return int(re.search(r"converged in (\d+) iterations", text).group(1))


def run_cli(directory, nproc, extra=()):
    """The port's CLI on ``nproc`` processes; asserts every rank exits 0
    and returns their standard outputs."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = run_workers(
        ["-m", "rails_tpu_torch.cli"],
        lambda pid: [str(directory), "--device", "cpu", "--x64",
                     "--params", str(directory / "params.json"),
                     "--distributed", "--coordinator", coordinator,
                     "--num-processes", str(nproc), "--process-id",
                     str(pid), *extra], nproc)
    for rc, out, err in outs:
        assert rc == 0, f"cli failed rc={rc}\nstdout:{out}\nstderr:{err}"
    return [o[1] for o in outs]


def jax_cli_run(directory, capsys):
    import rails_tpu.cli as jax_cli

    capsys.readouterr()
    assert jax_cli.main([str(directory), "--platform", "cpu", "--x64",
                         "--params", str(directory / "params.json"),
                         "--distributed"]) == 0
    return capsys.readouterr().out


def _problem(tmp_path, kind, n):
    from rails_tpu_torch.models import make_problem

    for sub in ("port", "jax"):
        d = tmp_path / sub
        make_problem.make(kind, str(d), n=n)
        (d / "params.json").write_text(json.dumps(params(kind)))
    return tmp_path / "port", tmp_path / "jax"


def check_ranks(outs, operator, nproc):
    for out in outs:
        assert (f"Distributed run: {nproc} processes, {nproc} shards, "
                f"backend gloo, device cpu") in out
        assert f"Distributed operator: {operator}" in out
        assert "Solver converged" in out
    assert len({iterations(o) for o in outs}) == 1
    writers = [o for o in outs if "Wrote V.mtx and T.mtx" in o]
    assert len(writers) == 1 and writers[0] is outs[0]
    t0 = table(outs[0])
    for out in outs[1:]:
        np.testing.assert_allclose(table(out), t0, rtol=1e-12)
    return t0


@pytest.mark.timeout(300)
def test_four_process_cli_laplace(tmp_path, capsys):
    """n = 1024 Laplacian, the direct path: the operator the JAX CLI
    picks for the same input, iterations equal across ranks, rank 0 the
    only writer, V.mtx the whole n rows, and the eigenvalue tables (eigs
    over the row-local V) equal across ranks and to the JAX CLI's."""
    port, jax_dir = _problem(tmp_path, "laplace", 1024)
    outs = run_cli(port, 4)
    out_j = jax_cli_run(jax_dir, capsys)
    op_j = re.search(r"Distributed operator: (\w+)", out_j).group(1)
    t0 = check_ranks(outs, op_j, 4)
    from rails_tpu_torch import io as tio

    v = tio.read_matrix_market(str(port / "V.mtx"))
    assert v.shape[0] == 1024
    np.testing.assert_allclose(t0[:3], table(out_j)[:3], rtol=1e-5)


@pytest.mark.timeout(300)
def test_four_process_cli_dae(tmp_path, capsys):
    """The n = 96 DAE, the distributed Schur path on 4 processes: a
    DistributedSchurOperator, iterations equal across ranks and to the
    one-process port CLI's, the tables equal across ranks and to the JAX
    CLI's."""
    from rails_tpu_torch import cli

    port, jax_dir = _problem(tmp_path, "dae", 96)
    outs = run_cli(port, 4)
    t0 = check_ranks(outs, "DistributedSchurOperator", 4)
    capsys.readouterr()
    assert cli.main([str(port), "--device", "cpu", "--x64", "--params",
                     str(port / "params.json"), "--distributed"]) == 0
    out_1 = capsys.readouterr().out
    assert iterations(out_1) == iterations(outs[0])
    out_j = jax_cli_run(jax_dir, capsys)
    np.testing.assert_allclose(t0[:3], table(out_j)[:3], rtol=1e-5)
    np.testing.assert_allclose(t0, table(out_1), rtol=1e-8)
