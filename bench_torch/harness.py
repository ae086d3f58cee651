"""One run of one cell: set-up, the measured window, the traced window,
the reference's check after the window, and the result's line.

Everything a cell needs is found by name (``README.md``): its entry in
``BENCHMARK.json``, the configuration's file, ``traffic/<traffic>.json``,
``entries/<entry>.py`` (the call the traffic drives), ``limits/<cell>.
json`` (the limits of the numbers that decide ``correct``) and, for each
per-layer metric of the cell, ``metrics/<metric>.py``.

The window is a closed loop with one caller: request i starts when
request i - 1 has completed.  Its clock runs from the request's call
into the program to its completion (the device synchronised); drawing
the request's inputs comes before, keeping its outputs for the check
after, outside the clock.  The window ends with the request in flight
when the clock passes ``seconds``.  An end-to-end metric's name before
its first dot says what it measures (``solve_s.cli`` is ``solve_s``,
reported in the cells it names).
"""

from __future__ import annotations

import gc
import importlib
import importlib.util
import json
import math
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from types import SimpleNamespace

import torch

from bench_torch import roofline
from bench_torch.trace import Trace

BENCH_DIR = Path(__file__).resolve().parent
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    limits: dict
    seed: int
    device: str = "cuda"
    chips: int = 1
    end_to_end: list = field(default_factory=list)
    per_layer: list = field(default_factory=list)
    dtype: str = ""

    def __post_init__(self):
        self.dtype = self.dtype or self.traffic["dtype"]


def _load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _for_cell(metrics, name):
    return [m for m in metrics if name in m.get("workloads", [name])]


def load_cell(workload: str, seed: int, device: str = "cuda") -> Cell:
    bench = _load_json(ROOT / "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json "
                         f"(it has {sorted(cells)})")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    return Cell(
        name=workload, config=_load_json(ROOT / conf["file"]),
        traffic=_load_json(BENCH_DIR / "traffic" / f"{w['traffic']}.json"),
        limits=_load_json(BENCH_DIR / "limits" / f"{workload}.json"),
        seed=seed, device=device, chips=int(w["chips"]),
        end_to_end=_for_cell(bench["end_to_end"], workload),
        per_layer=_for_cell(bench["per_layer"], workload))


def entry_of(cell: Cell):
    return importlib.import_module(f"bench_torch.entries.{cell.traffic['entry']}")


def reader(metric: str):
    """The module ``metrics/<metric>.py`` (names hold dots, so by path)."""
    path = BENCH_DIR / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.metrics.{metric.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def sync(device: str) -> None:
    if str(device).startswith("cuda"):
        torch.cuda.synchronize()


# ---- the end-to-end metrics, from the window's records -------------------
def _solve_s(w):
    return w.clock / len(w.records), "s"


def _iter_ms(w):
    return 1e3 * w.clock / sum(r["iters"] for r in w.records), "ms"


def _peak_mem_gb(w):
    return w.peak_bytes / 1e9, "GB"


def _setup_s(w):
    return w.setup_s, "s"


END_TO_END = {"solve_s": _solve_s, "iter_ms": _iter_ms,
              "peak_mem_gb": _peak_mem_gb, "setup_s": _setup_s}


def _window(cell: Cell, entry, state, seconds: float, trace: bool,
            probes: dict, log) -> SimpleNamespace:
    """The measured window; with ``trace`` its first ``trace_requests``
    requests under the profiler."""
    w = SimpleNamespace(records=[], clock=0.0, attempted=0, failed=0,
                        trace=None, peak_bytes=0)
    n_traced = int(cell.traffic.get("trace_requests", 1))
    tracer = None
    i = 0
    while w.clock < seconds:
        if trace and i == 0:
            tracer = Trace().__enter__()
            for p in probes.values():
                p.tag = "window"
        t0 = time.perf_counter()
        w.attempted += 1
        try:
            rec = entry.request(state, i)
        except Exception:   # a request that raises counts as failed
            traceback.print_exc(file=log)
            rec = None
        if rec is None or not rec["ok"]:
            w.failed += 1
        if rec is None:
            sync(cell.device)
            w.clock += time.perf_counter() - t0
        else:
            w.clock += rec["wall"]
            w.records.append(rec)
            print(f"request {i} wall_s {rec['wall']:.4f} iters "
                  f"{rec['iters']} ok {rec['ok']}", file=log)
        i += 1
        if tracer is not None and (i == n_traced or w.clock >= seconds):
            tracer.__exit__(None, None, None)
            w.trace, tracer = tracer, None
            for p in probes.values():
                p.tag = None
    if cell.device.startswith("cuda"):
        w.peak_bytes = torch.cuda.max_memory_allocated()
    return w


def _judge(cell: Cell, w, readings: dict, log):
    """(correct, check): each number of the cell's limits file, and the
    failed requests (limit 0), beside its limit."""
    limits = {k: v["limit"] for k, v in cell.limits.items()}
    limits["failed_requests"] = 0
    readings["failed_requests"] = w.failed
    check = {}
    correct = w.attempted > 0 and bool(w.records)
    for k, limit in limits.items():
        v = readings.get(k)
        correct = correct and v is not None and v <= limit   # NaN fails
        print(f"check {k} {v!r} limit {limit!r}", file=log)
        # JSON has no NaN or infinity: a number that is not finite is null
        check[k] = {"value": v if v is None or math.isfinite(v) else None,
                    "limit": limit}
    return correct, check


def run_cell(cell: Cell, seconds: float, trace: bool, t_start: float,
             log=sys.stderr):
    """Runs ``cell``; returns the result's line (a dict whose last key is
    ``check``) and every reading of the reference's check, compared or
    not.  ``t_start``: the process's start on ``perf_counter``."""
    readers = {m["name"]: reader(m["name"]) for m in cell.per_layer} \
        if trace else {}
    probes = {name: mod.probe(cell) for name, mod in readers.items()
              if hasattr(mod, "probe")}
    for p in probes.values():
        p.install()
    cuda = cell.device.startswith("cuda")
    entry = entry_of(cell)
    try:
        state = entry.setup(cell)
        gc.collect()
        sync(cell.device)
        setup_s = time.perf_counter() - t_start
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        w = _window(cell, entry, state, seconds, trace, probes, log)
        w.setup_s = setup_s
        metrics = {}
        if trace and w.records:
            card = torch.cuda.get_device_name() if cuda else "cpu"
            # the peaks assume the card's full power; its limit beside them
            print(f"trace window_s {w.trace.window_s:.3f} device_events "
                  f"{len(w.trace.device)} host_events {len(w.trace.host)} "
                  f"at {time.perf_counter() - t_start:.1f} s; {card} power "
                  f"limit {roofline.power_limit_w()} W", file=log)
            ctx = SimpleNamespace(cell=cell, records=w.records,
                                  trace=w.trace, probes=probes,
                                  peaks=roofline.peaks(card))
            for m in cell.per_layer:
                value = readers[m["name"]].read(ctx)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        elif w.records:
            for m in cell.end_to_end:
                value, unit = END_TO_END[m["name"].split(".")[0]](w)
                metrics[m["name"]] = {"value": value, "unit": unit}
    finally:
        for p in probes.values():
            p.remove()
    entry.free(state)
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    # the reference, after the window, the peak read and the state freed
    readings = entry.check(state, w.records, cell)
    correct, check = _judge(cell, w, readings, log)
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name() if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": w.peak_bytes}
    out = {"correct": bool(correct), "attempted": w.attempted,
           "failed": w.failed, "metrics": metrics, "device": dev}
    if trace and w.trace is not None:
        dev["busy_s"] = w.trace.busy_s
        dev["window_s"] = w.trace.window_s
        out["breakdown"] = w.trace.breakdown()
    out["check"] = check
    return out, readings
