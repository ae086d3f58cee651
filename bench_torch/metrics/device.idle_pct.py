"""The share of the traced window in which no device activity ran:
100 (1 - busy / window), busy the union of the kernels', copies' and
sets' intervals in the trace."""


def read(ctx):
    t = ctx.trace
    if t is None or t.window_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
