"""The projected dense solve (`linalg/dense_lyap.py`, the solver's
`_project_solve`): the `Solver/project_solve` timer scope's seconds over
its calls (one per iteration), in ms, summed over the window's requests.
The program's timer synchronises the device at both ends of a scope; the
CLI turns the scopes on.  Nothing to read where no request has the
scope."""

from bench_torch import scopes


def read(ctx):
    return scopes.ms(ctx.records, "Solver/project_solve", "call")
