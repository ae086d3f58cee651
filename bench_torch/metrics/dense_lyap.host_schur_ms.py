"""The projected dense solve's host Schur route (``linalg/dense_lyap.py``):
the host duration of the ``DenseLyap/host_schur`` spans (each zgees, and
each trsyl solve with its round trip) in ms per traced iteration (one
``Solver/iterate`` per eager iteration).  Nothing to read where the trace
holds no such span."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(ctx.trace, "host_s",
                                  ("DenseLyap/host_schur",))
