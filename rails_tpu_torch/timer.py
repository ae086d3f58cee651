"""Accumulating wall-clock profiler - the reference Timer subsystem
(src/Timer.{hpp,cpp}) with the JAX package's API:

    with timer("Solver", "iterate"):
        ...
    save_profiles()

PyTorch launches CUDA work asynchronously, so a host clock around a
scope measures only the enqueue.  When profiling is on, ``timer``
therefore synchronises every initialised CUDA device at both ends of a
scope: a scope's time is then the device's time for it plus the host's.
The synchronisation is itself a cost (it drains the queue, so the host
can no longer run ahead), which is why profiling is off by default and
the scope then costs one flag test.

Spans: ``span(*name)`` marks a range on the profiler's clock.  While a
``torch.profiler`` session collects, it opens a
``torch.profiler.record_function("/".join(name))`` range, which lands in
the trace beside the device activity, on the same clock; otherwise it
costs one test of the flag the profiler sets, and returns a context that
does nothing.  A span never synchronises, so it may sit inside a CUDA
graph capture.  Every ``timer`` scope is also a span of the same name.
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import torch
from torch.autograd import profiler as _autograd_profiler

__all__ = ["timer", "span", "enable_profiling", "disable_profiling",
           "save_profiles", "reset_profiles", "get_profiles"]

_lock = threading.Lock()
_enabled = False
_NO_SPAN = contextlib.nullcontext()


@dataclass
class Profile:
    name: Tuple[str, ...]
    calls: int = 0
    total: float = 0.0

    @property
    def per_call(self) -> float:
        return self.total / self.calls if self.calls else 0.0


_profiles: Dict[Tuple[str, ...], Profile] = {}


def enable_profiling():
    global _enabled
    _enabled = True


def disable_profiling():
    global _enabled
    _enabled = False


def reset_profiles():
    with _lock:
        _profiles.clear()


def get_profiles():
    return dict(_profiles)


def _sync():
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()


def span(*name: str):
    """A profiler range named ``"/".join(name)`` while ``torch.profiler``
    collects, else a context that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _NO_SPAN
    return torch.profiler.record_function("/".join(name))


@contextlib.contextmanager
def timer(*name: str):
    """RAII-scope accumulating timer (RAILS_FUNCTION_TIMER /
    RAILS_START_TIMER+RAILS_END_TIMER equivalent); also a span of the
    same name, which covers what the timer times."""
    if not _enabled:
        with span(*name):
            yield
        return
    _sync()
    with span(*name):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _sync()
            dt = time.perf_counter() - t0
            with _lock:
                prof = _profiles.get(name)
                if prof is None:
                    prof = _profiles[name] = Profile(name)
                prof.calls += 1
                prof.total += dt


def save_profiles(prefix: str = "", stream=None) -> str:
    """Print the profile table (RAILS_SAVE_PROFILES equivalent,
    src/Timer.cpp:54-99)."""
    import sys

    stream = stream or sys.stdout
    lines = [f"{'Class/Name':<48}{'Total':>12}{'PerCall':>12}{'Calls':>8}"]
    for key in sorted(_profiles):
        p = _profiles[key]
        label = "/".join(key)
        if prefix:
            label = f"{prefix}{label}"
        lines.append(
            f"{label:<48}{p.total:>12.4f}{p.per_call:>12.6f}{p.calls:>8}")
    out = "\n".join(lines)
    print(out, file=stream)
    return out
