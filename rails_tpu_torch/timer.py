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
"""

from __future__ import annotations

import contextlib
import threading
import time
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

__all__ = ["timer", "enable_profiling", "disable_profiling",
           "save_profiles", "reset_profiles", "get_profiles"]

_lock = threading.Lock()
_enabled = False


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


@contextlib.contextmanager
def timer(*name: str):
    """RAII-scope accumulating timer (RAILS_FUNCTION_TIMER /
    RAILS_START_TIMER+RAILS_END_TIMER equivalent)."""
    if not _enabled:
        yield
        return
    _sync()
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
