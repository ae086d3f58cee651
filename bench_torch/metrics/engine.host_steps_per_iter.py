"""Host steps per iteration of ``solve(compiled=True)`` (the engine,
``core/engine.py``): ``info.engine``'s host steps over its iterations,
summed over the window's requests.  Nothing to read where no request
ran the engine."""


def read(ctx):
    engines = [r["engine"] for r in ctx.records if r.get("engine")]
    iters = sum(e["iterations"] for e in engines)
    return sum(e["host_steps"] for e in engines) / iters if iters else None
