"""The projected solve's complex Schur factor on the host
(``linalg/dense_lyap.py``, the card's "host" route): the host time of the
``DenseLyap/host_schur/zgees`` spans (zgees and the matrix's copy from
the device), in ms per traced iteration.  Nothing to read where the
trace holds no such span (S symmetric, or a program without it)."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(ctx.trace, "host_s",
                                  ("DenseLyap/host_schur/zgees",))
