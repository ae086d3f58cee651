"""The Schur reduction (`schur.py`): the `Driver/schur` timer scope's
seconds per request, in ms. The program's timer synchronises the device
at both ends of a scope; the CLI turns the scopes on.  Nothing to read
where no request has the scope."""

from bench_torch import scopes


def read(ctx):
    return scopes.ms(ctx.records, "Driver/schur", "request")
