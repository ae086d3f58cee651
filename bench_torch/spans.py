"""The program's spans in a ``--trace 1`` run, against the device trace.

The program marks its layers with ``rails_tpu_torch.timer.span``: a
``torch.profiler.record_function`` range, recorded on the host on the
profiler's clock, the clock of the CUDA activity that ``trace.Trace``
reads (``Driver/main``, ``Solver/lanczos``, ``Engine/replay/<phases>``,
``Engine/host/<phase>.<fn>``, ``DenseLyap/host_schur``,
``Schur/a11_solve``, ...).  From the same profiler:

- ``host_s(names)``: the host time of the spans, summed;
- ``idle_s(names)``: the device's idle time inside the spans: the union
  of their intervals less ``Trace``'s merged busy intervals;
- ``idle_median_s(names)``: for each span name, the median idle inside
  one span times the number of spans, summed: ``idle_s`` without the
  rare span in which the host stalled, each name still weighed by how
  often it runs;
- ``device_s(names)``: the device time of the activity launched inside
  the spans, the union of its intervals.  A kernel, copy or set is tied
  to the CUDA runtime call that launched it by the profiler's
  correlation id (a replayed graph's kernels to its ``cudaGraphLaunch``),
  and counts where that call started inside one of the spans;
- ``iterations()``: the solver iterations the trace holds: one
  ``Engine/switch`` per replayed iteration, one ``Solver/iterate`` per
  eager one.

``names`` are span names; each also takes the spans below it
(``Engine/host`` takes ``Engine/host/project_solve.eigh``).  Where the
program has no spans (a version without them) every sum is 0 and
``iterations()`` is 0, so a reader returns None.
"""

from __future__ import annotations

import bisect
import statistics

from bench_torch.trace import _RUNTIME, WINDOW, _on_device


def _under(name: str, names) -> bool:
    return any(name == n or name.startswith(n + "/") for n in names)


def _union(intervals):
    """Sorted disjoint [a, b] covering the intervals."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        elif b > a:
            out.append([a, b])
    return out


def _length(intervals) -> int:
    return sum(b - a for a, b in intervals)


def _overlap(xs, ys) -> int:
    """The length that two sorted disjoint interval lists share."""
    i = j = total = 0
    while i < len(xs) and j < len(ys):
        a = max(xs[i][0], ys[j][0])
        b = min(xs[i][1], ys[j][1])
        if b > a:
            total += b - a
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


class Spans:
    """Spans and device activity in nanoseconds on the profiler's clock.

    ``window``: (start, end); ``busy``: the device's busy intervals,
    merged; ``spans``: (start, end, name) of the program's spans;
    ``launches``: runtime call's correlation id -> its start; ``activity``:
    (start, end, correlation ids, name) of each device activity, the ids
    to try in turn."""

    def __init__(self, window, busy, spans, launches, activity):
        w0, w1 = window
        self.window = window
        self.busy = _union((max(a, w0), min(b, w1)) for a, b in busy)
        self.spans = [(max(a, w0), min(b, w1), n) for a, b, n in spans
                      if b > w0 and a < w1]
        self.launches = launches
        self.activity = activity
        self._busy_cum = None

    @classmethod
    def of(cls, trace) -> "Spans":
        """From a ``trace.Trace`` after its window; kept on it, so the
        metrics of one run read the profiler once."""
        got = getattr(trace, "_program_spans", None)
        if got is None:
            got = cls.from_events(
                trace._prof.profiler.kineto_results.events(),
                trace.window, trace._merged())
            trace._program_spans = got
        return got

    @classmethod
    def from_events(cls, events, window=None, busy=None) -> "Spans":
        """From a profiler's events (``kineto_results.events()``).
        ``window``: where None, the ``bench.window`` annotation or else
        all events; ``busy``: where None, the union of the device
        activity."""
        spans, launches, activity, seen = [], {}, [], []
        for e in events:
            t0 = e.start_ns()
            t1 = t0 + e.duration_ns()
            name = e.name()
            seen.append((t0, t1))
            if _on_device(e):
                if name != WINDOW and not getattr(
                        e, "is_user_annotation", lambda: False)():
                    activity.append((t0, t1, (e.correlation_id(),
                                              e.linked_correlation_id()),
                                     name))
            elif name == WINDOW:
                window = window or (t0, t1)
            elif _RUNTIME.match(name):
                launches[e.correlation_id()] = t0
            elif "/" in name:
                spans.append((t0, t1, name))
        if window is None:
            window = (min((a for a, _ in seen), default=0),
                      max((b for _, b in seen), default=0))
        if busy is None:
            busy = [(a, b) for a, b, *_ in activity]
        return cls(window, busy, spans, launches, activity)

    # ---- readings ----------------------------------------------------
    def _intervals(self, names):
        return _union((a, b) for a, b, n in self.spans if _under(n, names))

    def count(self, names) -> int:
        return sum(1 for *_, n in self.spans if _under(n, names))

    def host_s(self, names) -> float:
        return 1e-9 * sum(b - a for a, b, n in self.spans
                          if _under(n, names))

    def idle_s(self, names) -> float:
        ivs = self._intervals(names)
        return 1e-9 * (_length(ivs) - _overlap(ivs, self.busy))

    def _busy_before(self, t) -> int:
        """The device's busy time before ``t`` in the window."""
        if self._busy_cum is None:
            cum = [0]
            for a, b in self.busy:
                cum.append(cum[-1] + b - a)
            self._busy_cum = ([a for a, _ in self.busy], cum)
        starts, cum = self._busy_cum
        i = bisect.bisect_right(starts, t) - 1
        if i < 0:
            return 0
        a, b = self.busy[i]
        return cum[i] + min(t, b) - a

    def idle_median_s(self, names) -> float:
        by_name, end = {}, None
        for a, b, n in sorted((s for s in self.spans if _under(s[2], names)),
                              key=lambda s: (s[0], -s[1])):
            if end is not None and b <= end:
                continue        # inside a span counted already
            end = b
            idle = (b - a) - (self._busy_before(b) - self._busy_before(a))
            by_name.setdefault(n, []).append(idle)
        return 1e-9 * sum(statistics.median(v) * len(v)
                          for v in by_name.values())

    def launched(self, names) -> list:
        """The device activity whose launching call started inside the
        spans ``names``."""
        ivs = self._intervals(names)
        starts = [a for a, _ in ivs]
        out = []
        for act in self.activity:
            t = next((self.launches[c] for c in act[2]
                      if c in self.launches), None)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            if i >= 0 and t < ivs[i][1]:
                out.append(act)
        return out

    def device_s(self, names) -> float:
        w0, w1 = self.window
        return 1e-9 * _length(_union(
            (max(a, w0), min(b, w1)) for a, b, *_ in self.launched(names)))

    def iterations(self) -> int:
        return self.count(("Engine/switch", "Solver/iterate"))


def per_iteration_ms(trace, reading, names):
    """``reading`` (``"idle_s"``, ``"idle_median_s"``, ``"device_s"``,
    ``"host_s"``) of the spans ``names`` over the trace's iterations, in
    ms; None where the trace holds no iteration or no such span."""
    if trace is None:
        return None
    s = Spans.of(trace)
    n = s.iterations()
    if n == 0 or s.count(names) == 0:
        return None
    return 1e3 * getattr(s, reading)(names) / n
