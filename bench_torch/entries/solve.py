"""Requests through ``LyapunovSolver(A, B, M).solve(compiled=...)``.

The traffic file gives ``compiled``, ``dtype`` and the solver's
``options``; the configuration, A's ``format`` and the distributions of
M and B.  Set-up builds A and M once and runs one warm-up request, which
on the card records the engine of this key (``maxit`` is part of it) in
the ``engine_cache`` that every request shares.  Each request draws its
own B and builds its own solver, as a caller with a new right-hand side
does.

The check, after the window, in float64 on the host: each request's
status, the true residual, the Galerkin residual ||V'RV|| / ||V'BB'V||
of the returned V and T, and the gap between the solver's stored A V
(what the SpMM kernel produced, at the cell's dtype) and A V in float64.
"""

from __future__ import annotations

import time

import torch

from bench_torch import generator
from bench_torch.reference import checks


def setup(cell) -> dict:
    import rails_tpu_torch as rt

    cfg, tr = cell.config, cell.traffic
    dtype = getattr(torch, cell.dtype)
    prob = generator.problem(cfg, cell.device)
    aop = rt.sparse_from_scipy(prob.a, fmt=cfg["format"], dtype=dtype,
                               device=cell.device, is_symmetric=True)
    mop = rt.DiagonalOperator(
        torch.as_tensor(prob.md, dtype=dtype, device=cell.device),
        device=cell.device)
    state = {"cell": cell, "prob": prob, "dtype": dtype,
             "program": {"rt": rt, "A": aop, "M": mop, "cache": {}}}
    request(state, generator.WARMUP)
    return state


def request(state, i: int) -> dict:
    cell, pg = state["cell"], state["program"]
    b = generator.rhs(state["prob"], cell.seed, i,
                      cell.device).to(state["dtype"])
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    solver = pg["rt"].LyapunovSolver(
        pg["A"], b, pg["M"], device=cell.device, dtype=state["dtype"],
        engine_cache=pg["cache"], **cell.traffic["options"])
    v, t, info = solver.solve(compiled=bool(cell.traffic["compiled"]))
    if cell.device.startswith("cuda"):
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return {"index": i, "wall": wall, "ok": info.status == 0,
            "iters": info.iter, "status": info.status, "res": info.res,
            "engine": info.engine, "V": v.cpu(), "T": t.cpu(),
            "AV": info.restart_data["AV"].cpu()}


def free(state) -> None:
    state["program"] = None


def check(state, records, cell) -> dict:
    prob = state["prob"]
    out = {"true_res": None, "galerkin": None, "av_gap": None}
    if not records:
        return out
    worst = dict.fromkeys(out, 0.0)
    for rec in records:
        b = generator.rhs(prob, cell.seed, rec["index"], "cpu").numpy()
        v = rec["V"].double().numpy()
        t = rec["T"].double().numpy()
        av = prob.a @ v
        mv = prob.md[:, None] * v
        got = {"true_res": checks.true_residual(
                   av, mv, b, t, generator.stream_seed(
                       cell.seed, "check", rec["index"])),
               "galerkin": checks.galerkin(av, mv, b, v, t),
               "av_gap": checks.rel_gap(rec["AV"].double().numpy(), av)}
        for k, x in got.items():
            worst[k] = checks.worse(worst[k], x)
    return worst
