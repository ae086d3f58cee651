"""How often the eager loop solves the projected equation on its active
block (``core/solver.py::_projected_t``): the ``Solver/active_block``
spans over the traced iterations.  The recorded engine keeps the padded
buffer and opens none.  Nothing to read where the trace holds no
iteration or no such span (a version that solves on the padded buffer
everywhere)."""

from bench_torch import spans


def read(ctx):
    if ctx.trace is None:
        return None
    s = spans.Spans.of(ctx.trace)
    n, block = s.iterations(), s.count(("Solver/active_block",))
    return block / n if n and block else None
