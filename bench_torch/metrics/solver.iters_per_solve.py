"""Solver iterations per request over the window's completed requests:
``SolveInfo.iter``, or the CLI's "Solver converged in N iterations" line
(the host loop, ``core/solver.py``)."""


def read(ctx):
    its = [r["iters"] for r in ctx.records]
    return sum(its) / len(its) if its else None
