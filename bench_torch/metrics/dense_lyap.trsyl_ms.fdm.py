"""The projected solve's Bartels-Stewart step on the host
(``linalg/dense_lyap.py``, the card's "host" route): the host time of the
``DenseLyap/host_schur/trsyl`` spans (the right-hand side to the host,
trsyl, the solution back), in ms per traced iteration.  Nothing to read
where the trace holds no such span."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(ctx.trace, "host_s",
                                  ("DenseLyap/host_schur/trsyl",))
