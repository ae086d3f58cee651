"""The engine's host steps and reads (``core/engine.py``): the device's
idle time inside the ``Engine/host/<phase>.<fn>``, ``Engine/switch`` and
``Engine/read`` spans, in ms per traced iteration (one ``Engine/switch``
per replayed iteration): for each span name its median idle per span
times its spans, so that a rare stall of the host inside one span does
not move the reading.  Nothing to read where the trace holds none of
these spans."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(
        ctx.trace, "idle_median_s",
        ("Engine/host", "Engine/switch", "Engine/read"))
