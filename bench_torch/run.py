#!/usr/bin/env python3
"""The benchmark of rails_tpu_torch: one run of one cell on one CUDA card.

    python3 bench_torch/run.py --workload <name> --seed <n> \\
        --seconds <s> --trace <0|1>

Builds the cell's problem from the seed, warms up its shapes (set-up),
runs its requests back to back for ``--seconds``, checks what they
returned against the plain reference, and prints one JSON line as the
last line of standard output (everything else goes to standard error).
``--trace 1`` runs the same window under ``torch.profiler`` and reports
the cell's per-layer metrics in place of its end-to-end ones.

Without a CUDA card, or with fewer than the cell asks for, it exits
with code 2 and prints no result.  It never imports jax, the JAX package
``rails_tpu`` or the JAX bench; an attempt raises ImportError.  The
program's kernels build into ``build/rails_tpu_torch/`` and any other
kernel cache goes to ``build/bench_torch/``, both in this checkout.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import contextlib  # noqa: E402
import importlib.abc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
REFUSED = ("jax", "jaxlib", "rails_tpu", "bench", "benchmarks")


class _Refuse(importlib.abc.MetaPathFinder):
    """Refuses the JAX side of the repository, whoever asks for it."""

    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in REFUSED:
            raise ImportError(f"the port's benchmark does not import {name}")
        return None


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    loaded = [m for m in sys.modules if m.split(".")[0] in REFUSED]
    if loaded:
        print(f"refused modules already loaded: {loaded}", file=sys.stderr)
        return 2
    sys.meta_path.insert(0, _Refuse())
    if sys.path and Path(sys.path[0]).resolve() == ROOT / "bench_torch":
        sys.path[0] = str(ROOT)
    elif str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    cache = ROOT / "build" / "bench_torch"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)

    import torch

    from bench_torch import harness

    cell = harness.load_cell(args.workload, args.seed)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s); this machine "
              f"has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    with contextlib.redirect_stdout(sys.stderr):
        out, _ = harness.run_cell(cell, args.seconds, bool(args.trace),
                               T_START)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
