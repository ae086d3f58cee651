#!/usr/bin/env python3
"""The readings that the limits of ``correct`` are set from, on the card.

    python3 bench_torch/control.py --workload <name> --seconds <s> \\
        --sound <seed,...> --control <seed,...> --early-stop <seed,...>

In one process, for each ``--sound`` seed a run of the cell as the
benchmark runs it, and for each ``--control`` seed a run of the control:
the same cell with the program's own path one precision below the one
the traffic states, at the traffic's ``control_dtype`` (float32 for
float64: the solver's dtype, the CLI without ``--x64``).  For each
``--early-stop`` seed, a run with the fault of a solver that stops early
and reports converged (``early_stop``): it reads the upper end of the
true residual's limit, which the control does not separate in the CLI
cell.  Each run is a short window at the cell's own load; one JSON line
per run gives the numbers compared and ``correct`` under the committed
limits.  The benchmark's own runs never run the control or the fault.
"""

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
EARLY_STOP = 30.0   # how many times the planted fault loosens the tolerance


@contextlib.contextmanager
def early_stop(factor: float = EARLY_STOP):
    """Plants, under the timed path, a solver that stops ``factor`` times
    short of its tolerance and reports converged, as a broken or
    loosened residual estimate would."""
    from rails_tpu_torch.core.solver import LyapunovSolver

    init = LyapunovSolver.__init__

    def loosened(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.options.tol *= factor

    LyapunovSolver.__init__ = loosened
    try:
        yield
    finally:
        LyapunovSolver.__init__ = init


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--sound", default="")
    ap.add_argument("--control", default="")
    ap.add_argument("--early-stop", default="")
    args = ap.parse_args(argv)
    sys.path[0] = str(ROOT)

    import torch

    from bench_torch import harness

    if not torch.cuda.is_available():
        print("the control runs on a CUDA card", file=sys.stderr)
        return 2
    runs = [("sound", int(s)) for s in args.sound.split(",") if s] + \
        [("control", int(s)) for s in args.control.split(",") if s] + \
        [("early_stop", int(s)) for s in args.early_stop.split(",") if s]
    for kind, seed in runs:
        cell = harness.load_cell(args.workload, seed)
        if kind == "control":
            cell.dtype = cell.traffic["control_dtype"]
        t0 = time.perf_counter()
        fault = early_stop() if kind == "early_stop" \
            else contextlib.nullcontext()
        with contextlib.redirect_stdout(sys.stderr), fault:
            out, readings = harness.run_cell(cell, args.seconds, False, t0)
        print(json.dumps({"workload": cell.name, "kind": kind, "seed": seed,
                          "dtype": cell.dtype, "correct": out["correct"],
                          "attempted": out["attempted"],
                          "readings": readings, "check": out["check"],
                          "metrics": out["metrics"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
