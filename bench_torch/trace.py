"""The device trace of a ``--trace 1`` run, read from ``torch.profiler``.

The profiler records CPU ops and CUDA activity (kernels, copies, sets,
also those launched by replayed CUDA graphs) over the traced window, the
span of a ``bench.window`` annotation.  From it:

- ``busy_s``: the union of the device activity's intervals inside the
  window, so overlapping launches count once;
- ``kernel(names)``: the launches and device seconds of the kernels whose
  names contain one of ``names``;
- ``breakdown``: the device operations that took most time, and the
  idle gaps summed by what the host was doing in them (the innermost
  CPU op or annotation over the gap's middle, else the CUDA runtime
  call, else "python").
"""

from __future__ import annotations

import bisect
import re
from collections import defaultdict

import torch

WINDOW = "bench.window"
# CUDA runtime and driver calls (cudaLaunchKernel, cuLaunchKernel, ...)
_RUNTIME = re.compile(r"^(cuda|cu[A-Z])")


def _on_device(e) -> bool:
    return str(e.device_type()).endswith("CUDA")


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self._prof = profile(activities=acts)
        self._ann = None
        self.window = None          # (start_ns, end_ns)
        self.device = []            # (start_ns, end_ns, name)
        self.host = []              # (start_ns, end_ns, name, "op" | "rt")
        self._starts = []

    def __enter__(self):
        self._prof.__enter__()
        self._ann = torch.profiler.record_function(WINDOW)
        self._ann.__enter__()
        return self

    def __exit__(self, *exc):
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self._ann.__exit__(*exc)
        self._prof.__exit__(*exc)
        if exc[0] is None:
            self._read()
        return False

    def _read(self):
        for e in self._prof.profiler.kineto_results.events():
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            name = e.name()
            if _on_device(e):
                # the device side's copies of annotations are no work
                if name != WINDOW and not getattr(
                        e, "is_user_annotation", lambda: False)():
                    self.device.append((t0, t1, name))
                continue
            if name == WINDOW:
                self.window = (t0, t1)
            else:
                self.host.append((t0, t1, name, "rt" if _RUNTIME.match(name)
                                  else "op"))
        if self.window is None:
            raise RuntimeError("the trace lost its window annotation")
        w0, w1 = self.window
        self.device = sorted((max(a, w0), min(b, w1), n)
                             for a, b, n in self.device if b > w0 and a < w1)
        self.host.sort()
        self._starts = [h[0] for h in self.host]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-9

    def _merged(self):
        out = []
        for a, b, _ in self.device:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self._merged()) * 1e-9

    def kernel(self, names):
        """(launches, device seconds) of the kernels whose name contains
        one of ``names``."""
        n, ns = 0, 0
        for a, b, name in self.device:
            if any(k in name for k in names):
                n += 1
                ns += b - a
        return n, ns * 1e-9

    def _host_at(self, t: int) -> str:
        """What the host was doing at ``t``: the innermost CPU op or
        annotation over it, else the runtime call, else "python"."""
        i = bisect.bisect_right(self._starts, t)
        best = {}
        for j in range(i - 1, max(-1, i - 4000), -1):
            a, b, name, kind = self.host[j]
            if b >= t:
                best.setdefault(kind, name)
            if len(best) == 2:
                break
        return best.get("op") or best.get("rt") or "python"

    def breakdown(self, top: int = 10) -> dict:
        ops = defaultdict(int)
        for a, b, name in self.device:
            ops[name[:160]] += b - a
        gaps = defaultdict(int)
        w0, w1 = self.window
        edge = w0
        for a, b in self._merged() + [[w1, w1]]:
            if a > edge:
                gaps[self._host_at((a + edge) // 2)[:160]] += a - edge
            edge = max(edge, b)

        def ranked(d):
            return [[k, v * 1e-9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:top]]

        return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}
