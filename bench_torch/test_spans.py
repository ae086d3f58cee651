"""``spans.py``'s arithmetic on synthetic events: idle time inside nested
spans, its per-name median, device activity tied to its launch by
correlation id, and the per-iteration bases.

    python3 -m pytest bench_torch/test_spans.py -q
"""

from types import SimpleNamespace

import pytest

from bench_torch import spans
from bench_torch.spans import Spans


class Event:
    """The fields of a profiler event that ``Spans.from_events`` reads."""

    def __init__(self, name, t0, t1, device=False, corr=0, linked=0,
                 annotation=False):
        self._v = (name, t0, t1, device, corr, linked, annotation)

    def name(self):
        return self._v[0]

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2] - self._v[1]

    def device_type(self):
        return "DeviceType.CUDA" if self._v[3] else "DeviceType.CPU"

    def correlation_id(self):
        return self._v[4]

    def linked_correlation_id(self):
        return self._v[5]

    def is_user_annotation(self):
        return self._v[6]


def test_idle_inside_nested_spans_counts_once():
    """Nested spans under one name cover their union once; the busy
    intervals are taken out of it, and clipped to the window."""
    s = Spans(window=(0, 100), busy=[(10, 20), (50, 60), (90, 130)],
              spans=[(0, 100, "Solver/iterate"),
                     (5, 30, "Engine/host/project_solve.eigh"),
                     (12, 18, "Engine/host/lanczos.a11_solve"),
                     (55, 70, "Engine/replay/lanczos"),
                     (85, 120, "Engine/read")],
              launches={}, activity=[])
    assert s.idle_s(["Engine/host"]) * 1e9 == pytest.approx(25 - 10)
    assert s.host_s(["Engine/host"]) * 1e9 == pytest.approx(25 + 6)
    assert s.count(["Engine/host"]) == 2
    # the read is clipped to the window: (85, 100) less (90, 100)
    assert s.idle_s(["Engine/read"]) * 1e9 == pytest.approx(5)
    assert s.idle_s(["Engine/replay"]) * 1e9 == pytest.approx(10)
    # the whole iteration: the window less every busy interval in it
    assert s.idle_s(["Solver/iterate"]) * 1e9 == pytest.approx(100 - 30)


def test_idle_median_drops_a_stall_keeps_each_names_rate():
    """Per name, the median idle of one span times its spans: a stall in
    one span leaves the reading; a name that runs less often weighs by
    its count; a span inside another of the names counts in the outer."""
    busy = [(10 * i + 5, 10 * (i + 1)) for i in range(10)]
    eigh = [(10 * i, 10 * i + 8, "Engine/host/project_solve.eigh")
            for i in range(9)] + [(90, 98 + 500, "Engine/host/"
                                  "project_solve.eigh")]
    restart = [(1000, 1003, "Engine/host/restart.eigh"),
               (2000, 2003, "Engine/host/restart.eigh")]
    inner = [(20, 21, "Engine/host/lanczos.eigh")]
    s = Spans(window=(0, 3000), busy=busy, spans=eigh + restart + inner,
              launches={}, activity=[])
    # eigh: 5 idle in each (8 long, 3 busy), the last 503; restart 3 each
    assert s.idle_s(["Engine/host"]) * 1e9 == pytest.approx(
        9 * 5 + 503 + 2 * 3)
    assert s.idle_median_s(["Engine/host"]) * 1e9 == pytest.approx(
        10 * 5 + 2 * 3)
    assert s.idle_median_s(["Engine/replay"]) == 0.0
    # clipped to the window, and busy before any span counts nowhere
    t = Spans(window=(0, 20), busy=[(0, 3), (12, 30)], launches={},
              activity=[], spans=[(2, 6, "Engine/switch"),
                                  (10, 40, "Engine/switch")])
    assert t.idle_median_s(["Engine/switch"]) * 1e9 == pytest.approx(
        ((6 - 2 - 1) + (20 - 10 - 8)) / 2 * 2)


def test_names_match_whole_path_components():
    s = Spans(window=(0, 10), busy=[], spans=[
        (0, 1, "Engine/host/x"), (1, 2, "Engine/hostile"),
        (2, 3, "Engine/host")], launches={}, activity=[])
    assert s.count(["Engine/host"]) == 2
    assert s.count(["Engine"]) == 3


def test_device_time_follows_the_launch_by_correlation():
    """Activity counts where its launching call started inside a span,
    wherever it ran; overlapping activity counts once; an id the
    launches do not know is tried next (the linked id)."""
    s = Spans(window=(0, 1000), busy=[],
              spans=[(10, 20, "Schur/a11_solve"),
                     (100, 110, "Schur/a11_solve")],
              launches={7: 12, 8: 40, 9: 105, 11: 19},
              activity=[(300, 350, (7, 0), "a"),   # launched in the first
                        (340, 360, (0, 11), "b"),  # linked id, overlaps
                        (400, 420, (8, 0), "c"),   # launched outside
                        (500, 530, (9, 0), "d"),   # in the second
                        (600, 700, (42, 0), "e")])  # no known launch
    assert [a[3] for a in s.launched(["Schur/a11_solve"])] == ["a", "b", "d"]
    assert s.device_s(["Schur/a11_solve"]) * 1e9 == pytest.approx(60 + 30)
    assert s.device_s(["Driver/main"]) == 0.0


def test_replayed_kernels_match_their_graph_launch():
    """Every kernel of one graph replay carries the correlation id of its
    ``cudaGraphLaunch``, so all of them go to the replay span."""
    events = [
        Event("bench.window", 0, 1000),
        Event("Engine/replay/project_solve+lanczos", 100, 200),
        Event("cudaGraphLaunch", 110, 190, corr=5),
        Event("Engine/switch", 200, 260),
        Event("cudaMemcpyAsync", 210, 220, corr=6),
        Event("dia_direct_kernel", 195, 230, device=True, corr=5),
        Event("gemv2T_kernel", 230, 250, device=True, corr=5),
        Event("Memcpy DtoH", 250, 255, device=True, corr=6),
        Event("Engine/replay/project_solve+lanczos", 100, 200, device=True,
              annotation=True)]
    s = Spans.from_events(events)
    assert s.window == (0, 1000)
    assert [a[3] for a in s.launched(["Engine/replay"])] == [
        "dia_direct_kernel", "gemv2T_kernel"]
    assert s.device_s(["Engine/replay"]) * 1e9 == pytest.approx(55)
    assert s.device_s(["Engine/switch"]) * 1e9 == pytest.approx(5)
    # the device annotation is no work: busy is the three activities
    assert s.busy == [[195, 255]]
    assert s.idle_s(["Engine/replay"]) * 1e9 == pytest.approx(95)
    assert s.idle_s(["Engine/switch"]) * 1e9 == pytest.approx(5)


def _trace(s):
    return SimpleNamespace(_program_spans=s)


def test_per_iteration_bases():
    """One ``Engine/switch`` per replayed iteration and one
    ``Solver/iterate`` per eager one; None without iterations or without
    the spans read."""
    replayed = Spans(window=(0, 100), busy=[], launches={}, activity=[],
                     spans=[(10 * i, 10 * i + 4, "Engine/replay/lanczos")
                            for i in range(4)]
                     + [(10 * i + 4, 10 * i + 6, "Engine/switch")
                        for i in range(4)])
    assert replayed.iterations() == 4
    assert spans.per_iteration_ms(_trace(replayed), "idle_s",
                                  ["Engine/replay"]) == pytest.approx(
        1e3 * 16e-9 / 4)
    eager = Spans(window=(0, 100), busy=[(0, 100)], launches={},
                  activity=[], spans=[(0, 50, "Solver/iterate"),
                                      (50, 100, "Solver/iterate"),
                                      (10, 30, "DenseLyap/host_schur")])
    assert eager.iterations() == 2
    assert spans.per_iteration_ms(_trace(eager), "host_s",
                                  ["DenseLyap/host_schur"]) == pytest.approx(
        1e3 * 20e-9 / 2)
    assert spans.per_iteration_ms(_trace(eager), "idle_s",
                                  ["Engine/replay"]) is None
    none = Spans(window=(0, 100), busy=[], launches={}, activity=[],
                 spans=[(0, 10, "Engine/replay/lanczos")])
    assert spans.per_iteration_ms(_trace(none), "idle_s",
                                  ["Engine/replay"]) is None
    assert spans.per_iteration_ms(None, "idle_s", ["Engine/replay"]) is None
