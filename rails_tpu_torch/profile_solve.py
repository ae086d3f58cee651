"""Where a solve's device time goes: torch.profiler over a window of the
n=65536 float64 solve (the JAX bench's phase_scale problem, solved
plainly at float64), on one CUDA card.

    python3 -m rails_tpu_torch.profile_solve [--iters 60] [--compiled]

Runs a warm-up solve, then one unprofiled and one profiled solve of
``--iters`` iterations (maxit) - with ``--compiled`` through
``solve(compiled=True)``, the recorded iteration replayed (one engine
cache across the three solves, so only the warm-up records) - and
prints one JSON line: the card, the
unprofiled wall per iteration, the device's busy time per iteration (the
sum of the device-side events' times), the idle share they imply against
the unprofiled wall, and the top kernels and top host-side ops by device
time.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch


def _problem(side: int):
    import rails_tpu_torch as rt
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    lap = laplacian2_sparse(side)
    md = rng.uniform(0.5, 1.5, n).astype(np.float32).astype(np.float64)
    b = rng.uniform(0, 1, (n, 8)).astype(np.float32).astype(np.float64)
    aop = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                               is_symmetric=True)
    mop = rt.DiagonalOperator(torch.from_numpy(md).cuda())
    return aop, mop, b


def _device_us(evt) -> float:
    for name in ("self_device_time_total", "self_cuda_time_total"):
        v = getattr(evt, name, None)
        if v is not None:
            return float(v)
    return 0.0


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=60)
    ap.add_argument("--side", type=int, default=256)
    ap.add_argument("--compiled", action="store_true")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    import rails_tpu_torch as rt
    from torch.profiler import ProfilerActivity, profile

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    aop, mop, b = _problem(args.side)
    opts = dict(tol=1e-4, expand=8, restart_size=160, reduced_size=80,
                dtype=torch.float64)

    cache = {}

    def solve(maxit):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # maxit is part of the engine key: the warm-up records it too
        _, _, info = rt.LyapunovSolver(
            aop, b, mop, maxit=maxit, engine_cache=cache,
            **opts).solve(compiled=args.compiled)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, info.iter

    solve(20)  # warm-up: kernel build, cuBLAS / cuSOLVER handles
    if args.compiled:
        solve(args.iters)   # records the engine of this maxit
    wall, iters = solve(args.iters)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        wall_prof, _ = solve(args.iters)
    # device-side events (kernels, copies) carry the busy time; host-side
    # ops (aten::*) carry the device time of the kernels they launched,
    # so each kind is summed and ranked on its own
    kernels, ops = [], []
    for e in prof.key_averages():
        if _device_us(e) > 0:
            on_device = str(getattr(e, "device_type", "")).endswith("CUDA")
            (kernels if on_device else ops).append(e)
    busy_us = sum(_device_us(e) for e in kernels)

    def top(events):
        events = sorted(events, key=_device_us, reverse=True)[:12]
        return [{"name": e.key[:90], "calls": e.count,
                 "device_us": _device_us(e),
                 "share_of_busy": _device_us(e) / busy_us if busy_us
                 else None} for e in events]

    print(json.dumps({
        "nvidia_smi": smi, "n": args.side ** 2, "iters": iters,
        "compiled": args.compiled,
        "wall_s": wall, "ms_per_iter": wall / iters * 1e3,
        "profiled_wall_s": wall_prof,
        "device_busy_ms_per_iter": busy_us / iters / 1e3,
        "device_idle_share": 1.0 - busy_us / 1e6 / wall if busy_us
        else None,
        "top_kernels": top(kernels), "top_ops": top(ops)}), flush=True)


if __name__ == "__main__":
    main()
