"""Requests through the reference driver's program,
``rails_tpu_torch.cli.main([dir, "--x64", "--params", p])``: MatrixMarket
in, the Schur reduction, the solve, V.mtx / T.mtx out, the eigenvalues
of the full-space solution operator and the trace.

Set-up writes A.mtx, M.mtx and the parameter file (``solver`` and
``eigen`` of the traffic file, as the "Lyapunov Solver" and "Eigenvalue
Solver" sublists) into a directory under the run's temporary directory
and runs one warm-up request.  Each request gets its own directory with
A.mtx and M.mtx linked in and its own B.mtx, written before its clock
starts; the program's standard output is kept, and its timer scopes
(``Driver/*``, ``Solver/*``: the CLI turns them on) are read right after.

The check, after the window, in float64 on the host, with A11 by scipy's
splu: the reduced equation's true residual and Galerkin residual for the
V.mtx and T.mtx that the request wrote, and the gap between the leading
eigenvalue in its table and scipy's ``eigsh`` on the full-space
solution operator.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import tempfile
import time

import numpy as np
import scipy.io
import scipy.sparse as sp
import torch
from scipy.sparse.linalg import ArpackError

from bench_torch import generator
from bench_torch.reference import checks

_SOLVED = re.compile(r"Solver (converged|did not converge) in (\d+) "
                     r"iterations, relative residual (\S+), space size "
                     r"(\d+)")


def setup(cell) -> dict:
    import importlib

    cli = importlib.import_module("rails_tpu_torch.cli")
    timer = importlib.import_module("rails_tpu_torch.timer")

    prob = generator.problem(cell.config, cell.device)
    root = tempfile.mkdtemp(prefix="bench_cli_")
    scipy.io.mmwrite(os.path.join(root, "A.mtx"), prob.a)
    scipy.io.mmwrite(os.path.join(root, "M.mtx"), sp.diags(prob.md).tocsr())
    params = os.path.join(root, "params.json")
    with open(params, "w") as f:
        json.dump({"Lyapunov Solver": cell.traffic["solver"],
                   "Eigenvalue Solver": cell.traffic["eigen"]}, f)
    args = ["--params", params, "--device", cell.device]
    if cell.dtype == "float64":
        args.append("--x64")
    state = {"cell": cell, "prob": prob, "root": root, "args": args,
             "program": {"cli": cli, "timer": timer}}
    request(state, generator.WARMUP)
    return state


def request(state, i: int) -> dict:
    cell, pg, root = state["cell"], state["program"], state["root"]
    d = os.path.join(root, f"r{i}")
    os.makedirs(d)
    for name in ("A.mtx", "M.mtx"):
        os.symlink(os.path.join(root, name), os.path.join(d, name))
    b = generator.rhs(state["prob"], cell.seed, i, cell.device)
    scipy.io.mmwrite(os.path.join(d, "B.mtx"),
                     sp.csr_matrix(b.cpu().numpy()))
    buf = io.StringIO()
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = pg["cli"].main([d, *state["args"]])
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    scopes = {"/".join(k): (p.total, p.calls)
              for k, p in pg["timer"].get_profiles().items()}
    text = buf.getvalue()
    m = _SOLVED.search(text)
    lines = text.splitlines()
    head = [j for j, ln in enumerate(lines) if "eigenvalue/trace" in ln]
    lam = float(lines[head[0] + 1].split()[0]) if head else None
    ok = rc == 0 and m is not None and m.group(1) == "converged" \
        and lam is not None
    return {"index": i, "wall": wall, "ok": ok, "dir": d,
            "iters": int(m.group(2)) if m else 0,
            "res": float(m.group(3)) if m else None,
            "lambda1": lam, "scopes": scopes}


def free(state) -> None:
    state["program"] = None


def check(state, records, cell) -> dict:
    prob = state["prob"]
    out = {"true_res": None, "galerkin": None, "eig_gap": None}
    try:
        if not records:
            return out
        host = checks.SchurHost(prob.a, prob.md)
        worst = dict.fromkeys(out, 0.0)
        for rec in records:
            seed = generator.stream_seed(cell.seed, "check", rec["index"])
            b2 = generator.rhs(prob, cell.seed, rec["index"],
                               "cpu").numpy()[host.i2]
            try:
                v = np.asarray(scipy.io.mmread(os.path.join(rec["dir"],
                                                            "V.mtx")))
                t = np.asarray(scipy.io.mmread(os.path.join(rec["dir"],
                                                            "T.mtx")))
            except (OSError, ValueError):   # no answer: every number fails
                return dict.fromkeys(out, float("inf"))
            sv, mv = host.s_apply(v), host.m22(v)
            try:
                lam = host.leading_eigenvalue(v, t, seed)
            except ArpackError:   # a zero solution operator, say
                lam = float("nan")
            got = {"true_res": checks.true_residual(sv, mv, b2, t, seed),
                   "galerkin": checks.galerkin(sv, mv, b2, v, t),
                   "eig_gap": abs(rec["lambda1"] - lam) / abs(lam)}
            for k, x in got.items():
                worst[k] = checks.worse(worst[k], x)
        return worst
    finally:
        shutil.rmtree(state["root"], ignore_errors=True)
