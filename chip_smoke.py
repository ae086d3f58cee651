#!/usr/bin/env python3
"""Drive rails_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the script
exits nonzero and never prints the last line):

1. env      - the card (nvidia-smi name and power limit), torch and CUDA
              versions, the precision flags.
2. build    - compile every csrc/*.cu kernel (one nvcc each, in
              parallel); build seconds and the -Xptxas -v lines.
3. compare  - each kernel against its plain PyTorch version on the card
              at float32 and float64, max|dy| <= 1e-5 max|y| at float32,
              1e-12 max|y| at float64.  DIA SpMM: the solve stencil
              (m=65536, offsets 0, +-1, +-256) at s = 1, 6, 8, 16, an
              asymmetric stencil at an odd size, a rectangular matrix and
              the JAX bench's spmm geometry (side 1536, s=16).  ELL SpMM
              (compare_ell): the JAX bench's ELL geometry (m=2^21, L=8,
              band +-64, s=16), the side-256 Laplacian DAE's A22, A12 and
              A21 at s = 1, 8, 16, and a rectangular matrix with empty
              rows at m = 1111, s = 3; one HYB apply (the DAE's A11 under
              'auto') against its plain version.
4. timing   - CUDA-event times of each kernel, its plain version and
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
              launched the DIA kernel.
7. cli_schur - the reference's main-program path through the port's CLI: the
              side-256 Laplacian DAE (n=65536, a third of M's diagonal
              zero) written as A.mtx/B.mtx/M.mtx, then
              ``rails_tpu_torch.cli.main([dir, "--x64", "--params", p])``:
              Schur reduction (A12/A21/A22 in ELL, A11 by dense LU), the
              solve on (S, M22, Bs), V.mtx/T.mtx, the eigenvalues of the
              full-space solution operator and the trace.  It must
              converge with an f64 true residual of the reduced equation
              (host, A11 by scipy splu) <= 2 tol, write V/T and read them
              back equal, agree with scipy's eigsh on the leading
              eigenvalue to 1e-6, and launch the ELL kernel.

Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.
"""

import contextlib
import importlib
import io
import json
import math
import os
import re
import subprocess
import sys
import tempfile
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


def csr_of(torch, payload):
    """A CUDA CSR copy of a DIA or ELL payload, for torch.sparse.mm."""
    from rails_tpu_torch.sparse.formats import payload_to_scipy

    c = payload_to_scipy(payload)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.from_numpy(c.indptr.astype(np.int64)),
            torch.from_numpy(c.indices.astype(np.int64)),
            torch.from_numpy(c.data), size=payload.shape, device="cuda")


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


def n_copies(per_set):
    """Input copies to rotate through so that together they exceed the
    50 MB L2 (at least 128 MB), at most 16."""
    return max(1, min(16, math.ceil(128e6 / per_set)))


def time_kernel(torch, label, kernel, plain, sets, nbytes, flops, name,
                reps):
    """Check ``kernel`` against ``plain`` on the first set, then time the
    kernel (device time and time per call), the plain version and
    torch.sparse.mm on CSR copies, beside the bound."""
    y = kernel(*sets[0])
    ref = plain(*sets[0])
    err = (y - ref).abs().max().item()
    if err > TOL[name] * ref.abs().max().item():
        raise AssertionError(f"{kernel.__name__} disagrees at {label}: "
                             f"{err}")
    k_ms = time_ms(torch, kernel, sets, reps)
    call_ms = time_ms(torch, kernel, sets, reps, backlog=False)
    p_ms = time_ms(torch, plain, sets, max(3, reps // 10))
    lib_sets = [(csr_of(torch, payload), x) for payload, x in sets]
    l_ms = time_ms(torch, torch.sparse.mm, lib_sets, max(3, reps // 4))
    b_ms, b_by = bound_ms(nbytes, flops, name)
    return {"case": label, "dtype": name, "input_copies": len(sets),
            "max_abs_err": err, "ms": k_ms, "us": k_ms * 1e3,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "bound_share": b_ms / k_ms}


def timing_case(torch, spmm, label, m, offsets, s, dtype, gen, reps):
    name = str(dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=dtype).element_size()
    probe = random_dia(torch, m, m, offsets, dtype, gen)
    nbytes, flops = dia_work(probe, s, itemsize)
    # + m * s: the plain version's zeros
    sets = [(random_dia(torch, m, m, offsets, dtype, gen),
             random_x(torch, m, s, dtype, gen))
            for _ in range(n_copies(nbytes + m * s * itemsize))]
    row = time_kernel(torch, label, spmm.dia_spmm, spmm.dia_spmm_reference,
                      sets, nbytes, flops, name, reps)
    row.update({"m": m, "d": len(offsets), "s": s})
    return row


def factored_residual(av, mv, b, t64, rng):
    """||AV T MV' + MV T AV' + B B'||_2 / ||B'B||_2 in float64 on the host,
    by power iteration on the factored residual (bench.py:829-851)."""
    def r_apply(x):
        return b @ (b.T @ x) + av @ (t64 @ (mv.T @ x)) \
            + mv @ (t64 @ (av.T @ x))

    x = rng.standard_normal((av.shape[0], 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(60):
        y = r_apply(x)
        lam = float(np.linalg.norm(y))
        if lam == 0.0:
            break
        x = y / lam
    return lam / np.linalg.norm(b.T @ b, 2)


def true_residual(lap, md, b, v, t, rng):
    """||A X M + M X A' + B B'||_2 / ||B'B||_2 for X = V T V'."""
    v64 = v.detach().cpu().double().numpy()
    t64 = t.detach().cpu().double().numpy()
    return factored_residual(lap @ v64, md[:, None] * v64, b, t64, rng)


def laplacian_dae(side):
    """The Laplacian DAE from default_rng(0), drawn in this order: M =
    diag(U[0.5, 1.5]) with a random third of its diagonal zeroed
    (rng.permutation(n)[:n//3]), then B (n, 8) U[0, 1), zero in the
    singular rows."""
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, n)
    md[rng.permutation(n)[: n // 3]] = 0.0
    b = rng.uniform(0, 1, (n, 8))
    b[md == 0] = 0.0
    return laplacian2_sparse(side), md, b


def schur_blocks(a, md):
    """The index split of schur.py and the four blocks, on the host."""
    i1 = np.flatnonzero(np.abs(md) < 1e-12)
    i2 = np.flatnonzero(np.abs(md) >= 1e-12)
    blocks = {"A11": a[i1][:, i1], "A12": a[i1][:, i2],
              "A21": a[i2][:, i1], "A22": a[i2][:, i2]}
    return i1, i2, {k: v.tocsr() for k, v in blocks.items()}


def banded_ell(m, n, ell_l, band, empty_rows, seed):
    """L random column picks per row within +-band of the scaled
    diagonal (bench.py:271's ELL geometry when m = n, band = 64), values
    U[-0.2, 0.2); ``empty_rows`` rows of a random choice emptied."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    base = np.arange(m)
    idx = np.clip(base[:, None] * (n / m)
                  + rng.integers(-band, band + 1, (m, ell_l)), 0, n - 1)
    val = rng.uniform(-1, 1, (m, ell_l)) * 0.2
    if empty_rows:
        val[rng.permutation(m)[:empty_rows]] = 0.0
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, ell_l),
                                     idx.ravel().astype(np.int64))),
                      shape=(m, n)).tocsr()
    a.eliminate_zeros()
    return a


def ell_work(ell, s, itemsize):
    """Bytes the ELL product must move (indices at 4 bytes and values
    read once, x read once, y written once) and its 2 L m s flops - the
    TPU kernel's CostEstimate (ell_spmm.py:412-416)."""
    m, n = ell.shape
    ell_l = ell.indices.shape[1]
    return (ell_l * m * (4 + itemsize) + n * s * itemsize
            + m * s * itemsize), 2 * ell_l * m * s


def compare_ell_case(torch, em, label, op, s, gen):
    """``op`` (a SparseOperator on the card): its ELL payload through the
    kernel against the plain version."""
    dtype = op.payload_dtype
    x = random_x(torch, op.shape[1], s, dtype, gen)
    y = em.ell_spmm(op.fwd, x)
    torch.cuda.synchronize()
    ref = em.ell_spmm_reference(op.fwd, x)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    name = str(dtype).replace("torch.", "")
    row = {"case": label, "m": op.shape[0], "n": op.shape[1],
           "L": int(op.fwd.indices.shape[1]), "s": s, "dtype": name,
           "max_abs_err": err, "max_abs_y": scale,
           "ok": err <= TOL[name] * scale}
    if not row["ok"]:
        raise AssertionError(f"ell_spmm disagrees with its plain version: "
                             f"{row}")
    return row


def timing_ell_case(torch, em, label, op, s, gen, reps):
    """Times of ``op``'s ELL product, rotating through copies of its
    payload and of x."""
    from rails_tpu_torch.sparse.formats import EllMatrix

    dtype = op.payload_dtype
    name = str(dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = ell_work(op.fwd, s, itemsize)
    sets = [(EllMatrix(op.fwd.indices.clone(), op.fwd.values.clone(),
                       op.shape),
             random_x(torch, op.shape[1], s, dtype, gen))
            for _ in range(n_copies(nbytes + op.shape[0] * s * itemsize))]
    row = time_kernel(torch, label, em.ell_spmm, em.ell_spmm_reference,
                      sets, nbytes, flops, name, reps)
    row.update({"m": op.shape[0], "n": op.shape[1],
                "L": int(op.fwd.indices.shape[1]), "s": s})
    return row


def host_schur(a, md, b, v, t):
    """The reduced equation and the full-space solution operator on the
    host in float64, A11 by scipy's splu: returns (f64 true residual of
    S X M22 + M22 X S' + Bs Bs' for X = V T V', the leading eigenvalue of
    X_full by eigsh)."""
    import scipy.sparse.linalg as spla

    i1, i2, blk = schur_blocks(a, md)
    lu = spla.splu(blk["A11"].tocsc())
    a12 = blk["A12"]
    sv = blk["A22"] @ v - blk["A21"] @ lu.solve(a12 @ v)
    res = factored_residual(sv, md[i2][:, None] * v, b[i2], t,
                            np.random.default_rng(1))

    def x22(y):
        return v @ (t @ (v.T @ y))

    def xfull(x):
        x = np.asarray(x, np.float64).ravel()
        x22x = x22(x[i2])
        x12x = -lu.solve(a12 @ x22x)
        x21x = -x22(a12.T @ lu.solve(x[i1], trans="T"))
        x11x = -lu.solve(a12 @ x21x)
        out = np.empty(a.shape[0])
        out[i1] = x11x + x12x
        out[i2] = x22x + x21x
        return out

    op = spla.LinearOperator(a.shape, matvec=xfull, dtype=np.float64)
    lam = spla.eigsh(op, k=1, which="LM", tol=1e-12,
                     v0=np.random.default_rng(2).standard_normal(
                         a.shape[0]), return_eigenvectors=False)
    return res, float(lam[0])


def run_cli_schur(torch, spmm, em, tol):
    """The reference's main-program path through the port's CLI on the side-256
    Laplacian DAE at float64; counts reset just before ``cli.main``, read
    just after."""
    import scipy.sparse as sp

    from rails_tpu_torch import cli
    from rails_tpu_torch import io as rio

    tmod = importlib.import_module("rails_tpu_torch.timer")
    a, md, b = laplacian_dae(256)
    params = {"Lyapunov Solver": {"Tolerance": tol,
                                  "Maximum iterations": 3000,
                                  "Expand size": 8, "Restart size": 160,
                                  "Reduced size": 80}}
    written = {}
    write = rio.write_matrix_market

    def recording_write(path, arr, comment=""):
        # what the CLI hands to the writer, to hold the files against
        written[os.path.basename(path)] = arr.detach().cpu().numpy()
        write(path, arr, comment)

    with tempfile.TemporaryDirectory() as d:
        write(os.path.join(d, "A.mtx"), a)
        write(os.path.join(d, "M.mtx"), sp.diags(md).tocsr())
        write(os.path.join(d, "B.mtx"), sp.csr_matrix(b))
        p = os.path.join(d, "params.json")
        with open(p, "w") as f:
            json.dump(params, f)
        buf = io.StringIO()
        rio.write_matrix_market = recording_write
        try:
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            spmm.dia_spmm.launches = 0
            em.ell_spmm.launches = 0
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(buf):
                rc = cli.main([d, "--x64", "--params", p])
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            ell_launches = em.ell_spmm.launches
            dia_launches = spmm.dia_spmm.launches
        finally:
            rio.write_matrix_market = write
        peak = torch.cuda.max_memory_allocated()
        v = rio.read_matrix_market(os.path.join(d, "V.mtx"))
        t = rio.read_matrix_market(os.path.join(d, "T.mtx"))
    text = buf.getvalue()
    mt = re.search(r"Solver (converged|did not converge) in (\d+) "
                   r"iterations, relative residual (\S+), space size "
                   r"(\d+)", text)
    lines = text.splitlines()
    head = next(i for i, ln in enumerate(lines) if "eigenvalue/trace" in ln)
    table = []
    for ln in lines[head + 1:]:
        parts = ln.split()
        if len(parts) != 2:
            break
        table.append([float(parts[0]), float(parts[1])])
    scopes = {"/".join(k): {"total_s": pr.total, "calls": pr.calls}
              for k, pr in sorted(tmod.get_profiles().items())}
    res_true, lam_host = host_schur(a, md, b, v, t)
    iters = int(mt.group(2))
    lam_cli = table[0][0]
    out = {"phase": "cli_schur", "n": a.shape[0], "n1": int((md == 0).sum()),
           "n2": int((md != 0).sum()), "dtype": "float64", "rc": rc,
           "converged": mt.group(1) == "converged", "iters": iters,
           "res": float(mt.group(3)), "rank": int(mt.group(4)),
           "wall_s": wall, "s_per_iter": wall / max(iters, 1),
           "max_memory_allocated": peak, "ell_spmm_launches": ell_launches,
           "ell_launches_per_iter": ell_launches / max(iters, 1),
           "dia_spmm_launches": dia_launches, "res_true_f64": res_true,
           "tol": tol,
           "vt_read_back_equal": bool(
               np.array_equal(written.get("V.mtx"), v)
               and np.array_equal(written.get("T.mtx"), t)),
           "lambda1_cli": lam_cli, "lambda1_eigsh": lam_host,
           "lambda1_rel_diff": abs(lam_cli - lam_host) / abs(lam_host),
           "eig_table": table, "scopes": scopes,
           "project_solve_share": scopes.get("Solver/project_solve", {})
           .get("total_s", 0.0) / wall}
    if rc != 0 or not out["converged"]:
        raise AssertionError(f"cli_schur did not converge: {out}")
    if res_true > 2 * tol:
        raise AssertionError(f"cli_schur true residual above 2 tol: {out}")
    if not out["vt_read_back_equal"]:
        raise AssertionError(f"cli_schur V.mtx/T.mtx differ from the "
                             f"solution: {out}")
    if out["lambda1_rel_diff"] > 1e-6:
        raise AssertionError(f"cli_schur leading eigenvalue disagrees with "
                             f"eigsh: {out}")
    if ell_launches <= 0:
        raise AssertionError(f"cli_schur never launched ell_spmm: {out}")
    return out


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
    from rails_tpu_torch.sparse import ell_spmm as em
    from rails_tpu_torch.sparse import spmm
    from rails_tpu_torch.sparse.formats import sparse_from_scipy
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

    # ---- 3b. compare the ELL kernel (and one HYB apply)
    t0 = time.perf_counter()
    dae_a, dae_md, _ = laplacian_dae(256)
    _, _, blocks = schur_blocks(dae_a, dae_md)
    ell_ops = {name: sparse_from_scipy(blocks[name], fmt="ell", dtype=f64)
               for name in ("A22", "A12", "A21")}
    ell_ops["bench"] = sparse_from_scipy(
        banded_ell(1 << 21, 1 << 21, 8, 64, 0, seed=0), fmt="ell",
        dtype=f64)
    ell_ops["odd"] = sparse_from_scipy(
        banded_ell(1111, 700, 6, 40, 150, seed=1), fmt="ell", dtype=f64)
    ell_rows = []
    for dtype in (f32, f64):
        for name in ("A22", "A12", "A21"):
            for s in (1, 8, 16):
                ell_rows.append(compare_ell_case(
                    torch, em, f"slice {name}", ell_ops[name].astype(dtype),
                    s, gen))
        ell_rows.append(compare_ell_case(
            torch, em, "bench", ell_ops["bench"].astype(dtype), 16, gen))
        ell_rows.append(compare_ell_case(
            torch, em, "odd: rectangular, empty rows",
            ell_ops["odd"].astype(dtype), 3, gen))
    hyb = sparse_from_scipy(blocks["A11"], dtype=f64)
    if hyb.format != "hyb":
        raise AssertionError(f"the DAE's A11 resolved to {hyb.format}, "
                             f"not hyb")
    xh = random_x(torch, hyb.shape[1], 8, f64, gen)
    yh = hyb.matmat(xh)
    torch.cuda.synchronize()
    rh = hyb.fwd.matmat(xh)
    hyb_row = {"case": "hyb A11 (side-256 DAE)", "m": hyb.shape[0],
               "dia_offsets": len(hyb.fwd.dia.offsets),
               "ell_L": int(hyb.fwd.ell.indices.shape[1]), "s": 8,
               "dtype": "float64",
               "max_abs_err": (yh - rh).abs().max().item(),
               "max_abs_y": rh.abs().max().item()}
    if hyb_row["max_abs_err"] > TOL["float64"] * hyb_row["max_abs_y"]:
        raise AssertionError(f"HYB apply disagrees: {hyb_row}")
    emit({"phase": "compare_ell", "cases": ell_rows, "hyb": hyb_row,
          "all_ok": True, "wall_s": time.perf_counter() - t0})
    ell_slice_err = next(r["max_abs_err"] for r in ell_rows
                         if r["case"] == "slice A22" and r["s"] == 8
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

    # ---- 4b. timing of the ELL kernel
    t0 = time.perf_counter()
    ell_timings = [
        timing_ell_case(torch, em, "slice A22 f64 s=8", ell_ops["A22"], 8,
                        gen, 400),
        timing_ell_case(torch, em, "bench f32 m=2^21 L=8 s=16",
                        ell_ops["bench"].astype(f32), 16, gen, 50),
    ]
    del ell_ops
    emit({"phase": "timing_ell", "cases": ell_timings, "smi": smi,
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

    # ---- 7. the reference's main-program Schur path through the CLI
    t0 = time.perf_counter()
    out_cli = run_cli_schur(torch, spmm, em, 1e-4)
    out_cli.update({"phase_wall_s": time.perf_counter() - t0})
    emit(out_cli)

    # ---- the kernel table, the card, and the last line
    slice_t = timings[0]
    ell_t = ell_timings[0]
    emit({"kernels": [{
        "name": "dia_spmm", "route": "cuda",
        "source": "rails_tpu_torch/csrc/dia_spmm.cu",
        "replaces": "rails_tpu/sparse/spmm.py:75",
        "launches": main_launches, "max_abs_err": slice_err,
        "ms": slice_t["ms"], "plain_ms": slice_t["plain_ms"],
        "bound_ms": slice_t["bound_ms"], "bound_by": slice_t["bound_by"],
        "library_ms": slice_t["library_ms"]}, {
        "name": "ell_spmm", "route": "cuda",
        "source": "rails_tpu_torch/csrc/ell_spmm.cu",
        "replaces": "rails_tpu/sparse/ell_spmm.py:344",
        "launches": out_cli["ell_spmm_launches"],
        "max_abs_err": ell_slice_err,
        "ms": ell_t["ms"], "plain_ms": ell_t["plain_ms"],
        "bound_ms": ell_t["bound_ms"], "bound_by": ell_t["bound_by"],
        "library_ms": ell_t["library_ms"]}],
        "total_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
