#!/usr/bin/env python3
"""Drive rails_tpu_torch's main path on one CUDA card and check it.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the script
exits nonzero and never prints the last line):

1. env      - the card (nvidia-smi name and power limit), torch and CUDA
              versions, the precision flags.
2. build    - compile every csrc/*.cu kernel (one nvcc each, in
              parallel); build seconds and the -Xptxas -v lines.
3. compare  - the DIA SpMM kernel against its plain PyTorch version on
              the card at float32 and float64: the solve stencil
              (m=65536, offsets 0, +-1, +-256) at s = 1, 6, 8, 16, an
              asymmetric stencil at an odd size, a rectangular matrix and
              the JAX bench's spmm geometry (side 1536, s=16).  max|dy| <=
              1e-5 max|y| at float32, 1e-12 max|y| at float64.
4. timing   - CUDA-event times of the kernel, the plain version and
              torch.sparse.mm on a CSR copy (a yardstick only), each
              averaged over many launches that rotate through enough
              input copies to find them outside the 50 MB L2; beside the
              bound: the larger of bytes / 3.35 TB/s and flops / peak.
5. solve_f32 - the JAX bench's phase_solve problem, n=4096 float32.
6. solve_f64 - the JAX bench's phase_scale problem, n=65536, solved
              plainly at float64 (the real size), then a profiled rerun of
              its first 200 iterations split into the solver's phases.
              Each solve must converge with an f64 true residual (factored
              power iteration on the host) <= 2 tol, and must have
              launched the kernel.

Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

import importlib
import json
import math
import subprocess
import sys
import time
import warnings

import numpy as np

HBM_BYTES_PER_S = 3.35e12   # H100 SXM, NVIDIA data sheet
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside tensor cores
TOL = {"float32": 1e-5, "float64": 1e-12}


def emit(obj):
    print(json.dumps(obj), flush=True)


def nvidia_smi_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def random_dia(torch, m, n, offsets, dtype, gen):
    from rails_tpu_torch.sparse.formats import DiaMatrix

    data = torch.rand((len(offsets), m), generator=gen, device="cuda",
                      dtype=dtype) * 2 - 1
    return DiaMatrix(data, offsets, (m, n))


def random_x(torch, n, s, dtype, gen):
    return torch.rand((n, s), generator=gen, device="cuda",
                      dtype=dtype) * 2 - 1


def dia_work(dia, s, itemsize):
    """Bytes the product must move (data, offsets and x read once, y
    written once) and the flops of the terms this matrix has."""
    m, n = dia.shape
    d = len(dia.offsets)
    nbytes = (d * m + n * s + m * s) * itemsize + 4 * d
    terms = sum(max(0, min(m, n - o) - max(0, -o)) for o in dia.offsets)
    return nbytes, 2 * terms * s


def bound_ms(nbytes, flops, dtype_name):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / PEAK_FLOPS[dtype_name]
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def time_ms(torch, fn, arg_sets, reps, backlog=True):
    """Mean ms per call over ``reps`` calls after warm-up, rotating
    through ``arg_sets``, timed with CUDA events.  With ``backlog`` the
    card first sleeps long enough for the host to queue every call, so
    the events time the device's work alone and not the host's pace of
    launching; without it, the time per call of a back-to-back stream
    (the Python wrapper included)."""
    for args in arg_sets[:2]:
        fn(*args)
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    if backlog:
        # 200 us per call at up to 2 GHz: far above the host's ~30 us
        torch.cuda._sleep(int(reps * 200e-6 * 2e9))
    e0.record()
    for r in range(reps):
        fn(*arg_sets[r % len(arg_sets)])
    e1.record()
    e1.synchronize()
    return e0.elapsed_time(e1) / reps


def csr_of(torch, dia):
    from rails_tpu_torch.sparse.formats import payload_to_scipy

    c = payload_to_scipy(dia)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.from_numpy(c.indptr.astype(np.int64)),
            torch.from_numpy(c.indices.astype(np.int64)),
            torch.from_numpy(c.data), size=dia.shape,
            dtype=dia.data.dtype, device="cuda")


def compare_case(torch, spmm, m, n, offsets, s, dtype, gen):
    dia = random_dia(torch, m, n, offsets, dtype, gen)
    x = random_x(torch, n, s, dtype, gen)
    y = spmm.dia_spmm(dia, x)
    torch.cuda.synchronize()
    ref = spmm.dia_spmm_reference(dia, x)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    name = str(dtype).replace("torch.", "")
    ok = err <= TOL[name] * scale
    row = {"m": m, "n": n, "offsets": list(offsets), "s": s, "dtype": name,
           "max_abs_err": err, "max_abs_y": scale, "ok": ok}
    if not ok:
        raise AssertionError(f"dia_spmm disagrees with its plain version: "
                             f"{row}")
    return row


def timing_case(torch, spmm, label, m, offsets, s, dtype, gen, reps):
    name = str(dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=dtype).element_size()
    probe = random_dia(torch, m, m, offsets, dtype, gen)
    nbytes, flops = dia_work(probe, s, itemsize)
    per_set = nbytes + m * s * itemsize  # + the plain version's zeros
    n_sets = max(1, min(16, math.ceil(128e6 / per_set)))
    sets = [(random_dia(torch, m, m, offsets, dtype, gen),
             random_x(torch, m, s, dtype, gen)) for _ in range(n_sets)]
    y = spmm.dia_spmm(*sets[0])
    ref = spmm.dia_spmm_reference(*sets[0])
    err = (y - ref).abs().max().item()
    if err > TOL[name] * ref.abs().max().item():
        raise AssertionError(f"dia_spmm disagrees at {label}: {err}")
    k_ms = time_ms(torch, spmm.dia_spmm, sets, reps)
    call_ms = time_ms(torch, spmm.dia_spmm, sets, reps, backlog=False)
    p_ms = time_ms(torch, spmm.dia_spmm_reference, sets,
                   max(3, reps // 10))
    lib_sets = [(csr_of(torch, dia), x) for dia, x in sets]
    l_ms = time_ms(torch, torch.sparse.mm, lib_sets, max(3, reps // 4))
    b_ms, b_by = bound_ms(nbytes, flops, name)
    return {"case": label, "m": m, "d": len(offsets), "s": s,
            "dtype": name, "input_copies": n_sets, "max_abs_err": err,
            "ms": k_ms, "us": k_ms * 1e3, "call_ms": call_ms,
            "plain_ms": p_ms,
            "library_ms": l_ms, "bound_ms": b_ms, "bound_by": b_by,
            "bytes": nbytes, "flops": flops,
            "bound_share": b_ms / k_ms}


def true_residual(lap, md, b, v, t, rng):
    """||A X M + M X A' + B B'||_2 / ||B'B||_2 in float64 on the host, by
    power iteration on the factored residual (bench.py:829-851)."""
    v64 = v.detach().cpu().double().numpy()
    t64 = t.detach().cpu().double().numpy()
    av = lap @ v64
    mv = md[:, None] * v64

    def r_apply(x):
        return b @ (b.T @ x) + av @ (t64 @ (mv.T @ x)) \
            + mv @ (t64 @ (av.T @ x))

    x = rng.standard_normal((lap.shape[0], 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(60):
        y = r_apply(x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            break
        x = y / lam
    return lam / np.linalg.norm(b.T @ b, 2)


def run_solve(torch, rt, spmm, label, side, dtype, opts, rounded_inputs):
    """Build the bench problem (DIA Laplacian, M = diag(U[0.5, 1.5]), B
    (n, 8) U[0, 1) from default_rng(0)) and solve it through the public
    entry points; counts reset just before the solve, read just after."""
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    lap = laplacian2_sparse(side)
    md = rng.uniform(0.5, 1.5, n)
    b = rng.uniform(0, 1, (n, 8))
    if rounded_inputs:  # phase_scale builds M and B at float32
        md = md.astype(np.float32).astype(np.float64)
        b = b.astype(np.float32).astype(np.float64)
    aop = rt.sparse_from_scipy(lap, fmt="dia", dtype=dtype,
                               is_symmetric=True)
    mop = rt.DiagonalOperator(torch.from_numpy(md).to("cuda", dtype))
    solver = rt.LyapunovSolver(aop, b, mop, dtype=dtype, **opts)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.dia_spmm.launches = 0
    t0 = time.perf_counter()
    v, t, info = solver.solve(
        progress=lambda it, wall, res: walls.append(wall))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm.dia_spmm.launches
    half = len(walls) // 2
    per_it = (walls[-1] - walls[half]) / max(1, len(walls) - 1 - half)
    res_true = true_residual(lap, md, b, v, t, rng)
    out = {"phase": label, "n": n, "dtype": str(dtype).replace("torch.", ""),
           "iters": info.iter, "res": info.res, "converged": info.converged,
           "status": info.status, "rank": int(v.shape[1]),
           "wall_s": wall, "s_per_iter_second_half": per_it,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dia_spmm_launches": launches, "mvps": info.mvps,
           "res_true_f64": res_true, "tol": opts["tol"]}
    if not info.converged:
        raise AssertionError(f"{label} did not converge: {out}")
    if res_true > 2 * opts["tol"]:
        raise AssertionError(f"{label} true residual above 2 tol: {out}")
    if launches <= 0:
        raise AssertionError(f"{label} never launched dia_spmm: {out}")
    return out, (lap, md, b, aop, mop, solver)


def main():
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    import rails_tpu_torch as rt
    from rails_tpu_torch import _build
    from rails_tpu_torch.sparse import spmm
    from rails_tpu_torch.utils.dtypes import full_precision, precision_flags

    # ---- 1. env
    t0 = time.perf_counter()
    smi = nvidia_smi_line()
    with full_precision():
        flags = precision_flags()
    emit({"phase": "env", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "device_count": torch.cuda.device_count(),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "python": sys.version.split()[0], "precision_flags": flags,
          "wall_s": time.perf_counter() - t0})

    # ---- 2. build
    t0 = time.perf_counter()
    report = _build.build_all()
    emit({"phase": "build", "kernels": report,
          "wall_s": time.perf_counter() - t0})

    gen = torch.Generator("cuda").manual_seed(0)
    f32, f64 = torch.float32, torch.float64

    # ---- 3. compare
    t0 = time.perf_counter()
    rows = []
    for dtype in (f32, f64):
        for s in (1, 6, 8, 16):
            rows.append(compare_case(torch, spmm, 65536, 65536,
                                     (-256, -1, 0, 1, 256), s, dtype, gen))
        rows.append(compare_case(torch, spmm, 1100, 1100,
                                 (-40, -1, 0, 2, 33), 3, dtype, gen))
        rows.append(compare_case(torch, spmm, 50000, 30000,
                                 (-7000, -3, 0, 5, 20000), 4, dtype, gen))
        rows.append(compare_case(torch, spmm, 1536 * 1536, 1536 * 1536,
                                 (-1536, -1, 0, 1, 1536), 16, dtype, gen))
    emit({"phase": "compare", "cases": rows, "all_ok": True,
          "wall_s": time.perf_counter() - t0})
    slice_err = next(r["max_abs_err"] for r in rows
                     if r["m"] == 65536 and r["s"] == 8
                     and r["dtype"] == "float64")

    # ---- 4. timing
    t0 = time.perf_counter()
    timings = [
        timing_case(torch, spmm, "slice f64 n=65536 s=8", 65536,
                    (-256, -1, 0, 1, 256), 8, f64, gen, 400),
        timing_case(torch, spmm, "solve f32 n=4096 s=6", 4096,
                    (-64, -1, 0, 1, 64), 6, f32, gen, 400),
        timing_case(torch, spmm, "bench f32 side=1536 s=16", 1536 * 1536,
                    (-1536, -1, 0, 1, 1536), 16, f32, gen, 50),
    ]
    emit({"phase": "timing", "cases": timings, "smi": smi,
          "wall_s": time.perf_counter() - t0})

    # ---- 5. solve f32, n=4096 (phase_solve)
    t0 = time.perf_counter()
    opts32 = dict(tol=1e-4, expand=6, restart_size=120, reduced_size=60,
                  maxit=200)
    run_solve(torch, rt, spmm, "solve_f32_warmup", 64, f32, opts32, False)
    out32, _ = run_solve(torch, rt, spmm, "solve_f32", 64, f32, opts32,
                         False)
    out32.update({"bench_r05_iters": 120, "phase_wall_s":
                  time.perf_counter() - t0})
    emit(out32)

    # ---- 6. solve f64, n=65536 (phase_scale geometry, plain f64)
    t0 = time.perf_counter()
    opts64 = dict(tol=1e-4, expand=8, restart_size=160, reduced_size=80,
                  maxit=3000)
    out64, prob = run_solve(torch, rt, spmm, "solve_f64", 256, f64, opts64,
                            True)
    main_launches = out64["dia_spmm_launches"]
    out64.update({"jax_cpu_f64_iters": 742,
                  "phase_wall_s": time.perf_counter() - t0})
    emit(out64)

    # where the time goes: the first 200 iterations again, with the
    # solver's timer on (it synchronises the card at each scope's ends)
    t0 = time.perf_counter()
    _, _, b64, aop, mop, _ = prob
    # the module (the package's name ``timer`` is the scope function)
    tmod = importlib.import_module("rails_tpu_torch.timer")

    tmod.reset_profiles()
    tmod.enable_profiling()
    try:
        opts_prof = dict(opts64, maxit=200)
        rt.LyapunovSolver(aop, b64, mop, dtype=f64,
                          **opts_prof).solve()
    finally:
        tmod.disable_profiling()
    split = {"/".join(k): {"total_s": p.total, "calls": p.calls}
             for k, p in sorted(tmod.get_profiles().items())}
    emit({"phase": "solve_f64_split", "iters": 200, "scopes": split,
          "wall_s": time.perf_counter() - t0})

    # ---- the kernel table, the card, and the last line
    slice_t = timings[0]
    emit({"kernels": [{
        "name": "dia_spmm", "route": "cuda",
        "source": "rails_tpu_torch/csrc/dia_spmm.cu",
        "replaces": "rails_tpu/sparse/spmm.py:75",
        "launches": main_launches, "max_abs_err": slice_err,
        "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
        "bound_ms": slice_t["bound_ms"], "bound_by": slice_t["bound_by"],
        "library_ms": slice_t["library_ms"]}],
        "total_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
