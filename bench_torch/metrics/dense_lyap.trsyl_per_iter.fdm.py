"""Round trips of the projected solve's "host" route per iteration
(``linalg/dense_lyap.py``): the ``DenseLyap/host_schur/trsyl`` spans over
the traced iterations, one per solve with the factor, the refinement's
included.  Nothing to read where the trace holds no iteration or no
such span."""

from bench_torch import spans


def read(ctx):
    if ctx.trace is None:
        return None
    s = spans.Spans.of(ctx.trace)
    n, trsyl = s.iterations(), s.count(("DenseLyap/host_schur/trsyl",))
    return trsyl / n if n and trsyl else None
