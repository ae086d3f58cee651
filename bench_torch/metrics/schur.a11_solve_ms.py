"""The Schur reduction's A11 solve inside each apply of S (``schur.py``;
the dense LU's triangular solves in the CLI): the device time of the
activity launched inside the ``Schur/a11_solve`` spans, in ms per traced
iteration (one ``Solver/iterate`` per eager iteration).  Nothing to read
where the trace holds no such span."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(ctx.trace, "device_s", ("Schur/a11_solve",))
