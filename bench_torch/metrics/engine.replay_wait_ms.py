"""The engine's graph replays (``core/engine.py``): the device's idle
time inside the ``Engine/replay/<phases>`` spans (the host launching a
recorded graph segment while the device has nothing to run), in ms per
traced iteration (one ``Engine/switch`` per replayed iteration).
Nothing to read where the trace holds no replay span."""

from bench_torch import spans


def read(ctx):
    return spans.per_iteration_ms(ctx.trace, "idle_s", ("Engine/replay",))
