#!/usr/bin/env python3
"""Drive rails_tpu_torch's main paths on one CUDA card and check them.

    python3 chip_smoke.py

Phases, each printing one JSON line (any failure raises, so the script
exits nonzero and never prints the last line):

1. env      - the card (nvidia-smi name and power limit), torch and CUDA
              versions, the precision flags.
2. build    - compile every csrc/*.cu kernel (one nvcc each, in
              parallel); build seconds and the -Xptxas -v lines; then the
              C++ host library (native/librails_host.cpp, g++) and its
              build seconds.
3. compare  - each kernel against its plain PyTorch version on the card
              at float32 and float64, max|dy| <= 1e-5 max|y| at float32,
              1e-12 max|y| at float64.  DIA SpMM: the solve stencil
              (m=65536, offsets 0, +-1, +-256) at s = 1, 6, 8, 16, an
              asymmetric stencil at an odd size, a rectangular matrix,
              the JAX bench's spmm geometry (side 1536, s=16), the solve
              stencil at m = 4097 (data rows off 16 bytes) and a 3-D
              7-point stencil (side 40: +-1, +-40, +-1600), each through
              the branch its plan picks and, where both can run, the
              other one too, the two bit-equal; each row gives the plan
              (branch and why, R, segments, bytes per stage, stages,
              grid).  ELL SpMM
              (compare_ell): the JAX bench's ELL geometry (m=2^21, L=8,
              band +-64, s=16), the side-256 Laplacian DAE's A22, A12 and
              A21 at s = 1, 8, 16, and a rectangular matrix with empty
              rows at m = 1111, s = 3; one HYB apply (the DAE's A11 under
              'auto') against its plain version.  Each ELL row gives the
              kernel's plan from the payload, computed on the host: the
              share of row tiles whose x window is staged in shared
              memory, the lane width, column tile and shared bytes.
4. timing   - CUDA-event times of each kernel, its plain version and
              torch.sparse.mm on a CSR copy (a yardstick only), each
              averaged over many launches that rotate through enough
              input copies to find them outside the 50 MB L2; beside the
              bound: the larger of bytes / 3.35 TB/s and flops / peak,
              and the launch floor (torch.cuda._sleep(1) timed the same
              way).  DIA: the solve shapes, the bench geometry and
              refined_scale's (n = 65,536, s = 8, f32), each with its
              plan, and for n = 65,536 (f64 and f32) also ``l2_ms``, the
              time with the inputs resident in L2 (one set, as in the
              solver).  ELL: A22 (f64,
              s = 8), the bench geometry (s = 16), the continuation
              shape (f32, s = 200) and an interior shard of mesh_ell
              (m_loc 4,096 over 4,352 columns, f64, s = 8), with their
              staged shares.
5. solve_f32 - the JAX bench's phase_solve problem, n=4096 float32.
6. solve_f64 - the JAX bench's phase_scale problem, n=65536, solved
              plainly at float64 (the real size), then a profiled rerun of
              its first 200 iterations split into the solver's phases.
              Each solve must converge with an f64 true residual (factored
              power iteration on the host) <= 2 tol, and must have
              launched the DIA kernel.
7. cli_schur - the reference's main-program path through the port's CLI: the
              side-192 Laplacian DAE (n=36864, a third of M's diagonal
              zero) written as A.mtx/B.mtx/M.mtx, then
              ``rails_tpu_torch.cli.main([dir, "--x64", "--params", p])``:
              Schur reduction (A12/A21/A22 in ELL, A11 by dense LU), the
              solve on (S, M22, Bs), S tagged symmetric (A is, and the A11
              solve is direct) so that the projected solve takes the eigh
              route (the CLI's "Projected solver: eigh (S symmetric)",
              checked), V.mtx/T.mtx, the eigenvalues of the
              full-space solution operator and the trace.  It must
              converge with an f64 true residual of the reduced equation
              (host, A11 by scipy splu) <= 2 tol, write V/T and read them
              back equal, agree with scipy's eigsh on the leading
              eigenvalue to 1e-6, and launch the ELL kernel.
8. compare_wide - the dense-window kernel against its plain version on
              the card (max|dy| <= 1e-5 max|y|), and both against the
              exact float64 ELL product within the JAX tests' bounds
              (8e-5 max|y| at 3 passes, 5e-7 at 6): the continuation
              Jacobian (side 128) at s = 8, 192, 200, 256, 300 and 3 and 6
              passes; the JAX bench's ELL geometry at s = 192 (its 6-pass
              planes must be refused by the 4 GB cap); a rectangular
              matrix with empty rows, window built at min_s = 1, at
              s = 1, 3, 8 and 67; a band of +-900 (w = 2048) at s = 200;
              one apply through the operator's dispatch.
9. timing_wide - the wide kernel's times beside its bound (bytes over
              3.35 TB/s or its operations over the bf16 peak), its plain
              version, the ELL kernel on the same payload and s, and
              torch.sparse.mm: the continuation shape at s = 200 (6
              passes, as continuation_wide runs it, and 3) and the
              bench geometry at s = 192 and 256 (3 passes).
10. refined_acc - bench.py::phase_accuracy at n = 8192: the single
              float32 solve, then solve_refined with compensated
              reductions to a float64 true residual <= 1.1e-8.
11. refined_scale - bench.py::phase_scale at n = 65536: solve_refined,
              float32, compensated, converged with an f64 true residual
              <= 2 tol; the wall split into stage solves and the host's
              residual compression.
12. continuation_wide - three steps of bench.py::phase_continuation's
              Jacobian family at side 128 in ELL with the dense-window
              payload, float32, compensated: every step converged with an
              f64 true residual <= 2 tol, warm steps faster than the cold
              one, each entering with >= 192 carried columns and
              launching the wide kernel.

13. compare_halo - the halo kernel (#3) against its plain version on the
              card, max|dy| <= 1e-5 max|y| at float32, 1e-12 max|y| at
              float64, its offsets by value (as the mesh apply passes
              them) and from the device array, the two bit-equal: the
              solve stencil (m=65536, offsets 0, +-1, +-256)
              cut into 4 shards on cuda:0 at s = 1, 6, 8, 16 - an interior
              shard, both boundary shards, and a one-sided stencil with an
              empty halo; the JAX bench's mesh geometry (side 1536, s=16,
              f32) at 4 shards; one whole HaloDiaOperator apply at 4 shards
              against the DIA kernel's unsharded apply (max|dy|, and
              whether it is exactly 0 at float64).
14. timing_halo - the halo kernel's times per shard launch at the mesh
              solve's shard (m_loc=16384, spans 256, s=8, f64) and the
              bench mesh geometry's shard (m_loc=589824, spans 1536, s=16,
              f32), beside its plain version, torch.sparse.mm on a CSR copy
              of the shard's (m_loc x ext) operator, the bound and the
              launch floor;
              halo_overhead_vs_plain: HaloDiaOperator.matmat at 1 and 4
              shards over the DIA kernel's apply (bench geometry), and
              HaloEllOperator.matmat at 4 shards over the ELL kernel's
              apply (m=2^20, L=8, band +-64, s=16, f32).
15. mesh_solve - the slice's main path: solve_f64's problem through
              LyapunovSolver(mesh=make_mesh(devices=["cuda:0"] * 4)): A a
              HaloDiaOperator, converged with an f64 true residual <= 2 tol,
              4 halo-kernel launches per A apply and no DIA-kernel launch,
              iterations equal to solve_f64's (or within 1%).
16. mesh_ell - the continuation Jacobian (theta 0, side 128) in ELL at
              f64, on the 4-shard mesh and unsharded: a HaloEllOperator,
              both converged with true residual <= 2 tol, iterations equal
              (or within 1%), 4 ELL launches per apply on the mesh.
17. mesh_schur - (a) distribute_schur on cli_schur's DAE (side 192) at 4
              shards, matmat and rmatmat at s=8 against the reduction's
              operator to 1e-12 relative; (b) the CLI's --distributed on a
              side-96 DAE: "Distributed operator: DistributedSchurOperator",
              converged with true residual <= 2 tol, V/T read back equal,
              leading eigenvalue equal to eigsh's to 1e-6; S is tagged
              symmetric, so it takes eigh, and (b) again with
              projected_solver "schur" drives the Schur route on the mesh
              (``schur_route_run``), held to the same checks.
18. schur_lapack - the projected Schur solve on the projected matrices
              of cli_schur run with projected_solver "schur" (phase 7
              takes eigh) at k = 48, 96, 160 and the largest k: the real
              Schur factor (dgees) and the real trsyl on the host, each
              timed with its k x k round trip, X within 1e-8 of scipy's
              solve_continuous_lyapunov of the same matrices in f64 on
              the host; cli_schur's iterations, wall, project_solve
              share, true residual and eigenvalue (phase 7 run here
              when it was skipped).
19. schur_native - on cli_schur's DAE, schur_reduce with
              a11_solver="native_lu" (the C++ sparse LU, A11 solved on the
              host in each apply) against "dense_lu": S and S' applies
              within 1e-10, their times, each reduction's wall and device
              memory; sinv(method="native_lu") against the dense sinv on
              the side-96 DAE; the CLI's three MatrixMarket reads with the
              native reader and with scipy, equal.
20. hub      - bench.py::phase_hub's matrix at its TPU size (m = 2^19, 64
              hubs of degree 4096, s = 16, float32): the hub split's apply
              against scipy in float64 (<= 1e-5 relative, both
              directions), 2 ELL-kernel launches per apply, its time
              beside torch.sparse.mm on the same CSR, its bound and its
              three parts (bulk ELL, hub-column ELL, D GEMM with its
              index_add); then a solve on a hub operator at solve_f64's
              size (m = 65,536, 16 hubs of degree 2048, f64, tol 1e-4):
              status 0, true residual <= 2 tol, 2 ELL launches per A
              apply.

21. compiled_solve - solve_f64's and solve_f32's problems through
              ``solve(compiled=True)``: the iteration recorded into CUDA
              graphs and replayed (core/engine.py), each beside the
              eager run of phases 5-6: iterations and status both ways
              (within 1%), the f64 true residual <= 2 tol, wall and s per
              iteration both ways, graph segments, host reads and kernel
              launches per iteration, capture seconds, peak memory; the
              graph check (one DIA apply and one ELL apply captured and
              replayed, equal to the eager launch and within the
              kernel's tolerance of the plain version); kernel #1 at
              solve_f64's shape through both branches, back to back from
              the host and from one graph.
22. compiled_mesh - mesh_solve (phase 15) through the recorded
              iteration, beside the eager run.
23. compiled_refined - refined_scale (phase 11), every stage through
              the recorded iteration, beside the eager run.
24. compiled_continuation - continuation_wide (phase 12) with
              compiled steps through one engine cache: its size after
              each step ([1, 2, 2]: the cold and the warm engines), no
              capture on the third step.
25. compiled_schur - cli_schur's side-192 DAE reduced with
              a11_solver="native_lu" and solved through
              ``solve(compiled=True)`` at cli_schur's parameters: the host
              A11 solve of each S apply a host step between graph
              segments (``engine.host_call``), held against the eager
              solver at full capacity on the same reduction: iterations
              and status both ways (equal, or within 1%), the f64 true
              residual of the reduced equation <= 2 tol (S through scipy
              splu of A11), wall and s per iteration both ways, graph
              segments, host steps and switch reads per iteration, ELL
              launches per iteration, capture seconds, peak memory, and
              cli_schur's eager dense_lu wall beside it; then the same
              with projected_solver "schur" (S is tagged symmetric, so the
              first case's projected solve is an eigh host step; this one
              is the ``host_schur`` host step); then the same for
              inv_a=red.sinv("native_lu") with projection_method 2.2 on
              the side-96 DAE.  Each case reports its projected solver
              and its host-step sources.
26. examples - examples/continuation_sequence_torch.py and
              examples/distributed_schur_torch.py on the card as
              subprocesses: exit 0, warm steps and the resumed step below
              the cold count, the distributed count equal to the
              single-controller one, true residual < 1e-7, "ok".
27. continuation_full_capacity - continuation_wide's eager steps with
              the state at full capacity, each step's iterations beside
              the eager (ladder) and compiled counts (phase 24).
28. multiprocess - the row mesh across processes: this script started
              again as worker processes (``--worker``), every one on
              cuda:0 with backend gloo (NCCL refuses two ranks on one
              card), each checked to exit 0.  Under ``--only`` first two
              one-process runs of phase 15 with B scaled by 1 +- 1e-15:
              the iteration count's spread under rounding
              (``MP_ITER_BAND``).  (a)
              mesh_solve's problem (phase 15) on 2 processes (4 took
              240 s) of one shard each: per rank the
              iterations, status, wall, s per iteration, collectives and
              host-staged bytes per iteration, kernel #3's launches (one
              per A apply) and kernel #3 on the rank's shard, its halos
              from the neighbouring ranks, against its plain version; on
              rank 0 the gathered V's f64 true residual <= 2 tol; the
              first 10 residual estimates within 1e-8 of phase 15's and
              the count within 15% of it; the costs of one collective
              (the backend's round, a device sync, the staged whole).
              (b) the CLI's
              --distributed --num-processes 2 on mesh_schur (b)'s DAE:
              DistributedSchurOperator, iterations equal across ranks and
              within 15% of phase 17 (b)'s, the eigenvalue table within
              1e-6 of its leading eigenvalue, rank 0 alone writing V/T,
              kernel #4's launches per rank.  (c) (a) over NCCL, one card
              per rank, where the cards reach the rank count; else one
              line saying why it was not run.
29. multiprocess_compiled - ``solve(compiled=True)`` across processes:
              the capture audit's two collective rows (an NCCL
              all-gather captures, a staged gloo one does not); then
              MP_RANKS ``--worker compiled`` processes on cuda:0 over
              gloo, the row collectives host steps of the recording:
              (a) mesh_solve's problem for 60 iterations compiled and
              eager at full capacity, the same bits per rank; (b) the
              problem compiled to tol: iterations, wall, s per
              iteration, collectives and host-staged bytes per
              iteration, kernel #3's launches per rank and #3 on the
              rank's shard against its plain version, T and info the
              same bits on every rank, rank 0's gathered V's f64 true
              residual <= 2 tol, the first 10 residual estimates within
              1e-8 of phase 22's compiled run and the count within 15%
              of it, phase 28 (a)'s eager wall beside it; (c) mesh_schur
              (b)'s side-96 DAE through ``distribute_schur`` compiled,
              iterations within 15% of the one-process compiled run on
              the same reduction, kernel #4's launches per rank, the
              reduced equation's true residual <= 2 tol; (d) a one-rank
              NCCL group on cuda:0 (``--worker nccl1``): the problem
              compiled (the collectives captured, none a host step, the
              program's host steps those of phase 22's) and eager at
              full capacity, the same bits; (e) (a)-(c) over NCCL, one
              card per rank, where the cards reach the rank count; else
              one line saying why it was not run.

Then the kernel table as one JSON line, the nvidia-smi line, and last
{"ok": true, "device": {...}}.  ``--only`` runs env, build and the named
phases of 8-29 and stops there (no kernel table, no last line); a
compiled phase then runs its eager counterpart itself.
"""

import contextlib
import dataclasses
import gc
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
# the eager runs' lines that the compiled phases (21-24) compare with,
# filled by the phases that run them
EAGER = {}
# the compiled runs that phase 27 compares with, filled by phase 24, and
# phase 29's one-process references, filled by phase 22
COMPILED = {}
# phase 28 (a)'s line, which phase 29 (b) prints its wall beside
MULTIPROCESS = {}
PEAK_FLOPS = {"float32": 67e12, "float64": 34e12}  # outside tensor cores
PEAK_BF16_FLOPS = 989e12    # dense bf16 on the tensor cores
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


def bound_ms(nbytes, flops, dtype_name, peak=None):
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = flops / (PEAK_FLOPS[dtype_name] if peak is None else peak)
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


def launch_floor_ms(torch, reps=400):
    """The per-launch floor: ``torch.cuda._sleep(1)`` (a kernel that spins
    for one cycle) timed as ``time_ms`` times a kernel, with its backlog -
    what the card takes per launch of a kernel that does no work."""
    return time_ms(torch, torch.cuda._sleep, [(1,)], reps)


def ell_staging(em, ell, s, itemsize):
    """The ELL kernel's plan for ``ell`` at s columns (x and y aligned),
    computed on the host from the payload's row-tile windows: the share
    of row tiles whose window of x is staged in shared memory, the lane
    width, the column tile and the shared bytes per block for the window
    and for the slots."""
    from rails_tpu_torch.sparse.tiling import vector_width

    p = em.ell_plan(ell.window_rows, ell.indices.shape[1], s, itemsize,
                    vector_width(s, itemsize, 0))
    return {"staged_share": p.staged_share, "vec": p.vec,
            "col_tile": p.col_tile, "col_tiles": p.col_tiles,
            "window_bytes": p.window_bytes, "slot_bytes": p.slot_bytes}


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
    """Kernel #1 against its plain version through the branch its plan
    picks and, where the case allows both branches, through the other
    one forced by the plan too; the two must agree bit for bit."""
    dia = random_dia(torch, m, n, offsets, dtype, gen)
    x = random_x(torch, n, s, dtype, gen)
    y = spmm.dia_spmm(dia, x)
    plan = spmm.launch_plan(dia, x)
    y_other = None
    if plan.stageable:
        y_other = spmm.dia_spmm(dia, x, plan=spmm.dia_plan(
            offsets, m, n, s, x.element_size(), plan.vec,
            branch="direct" if plan.staged else "staged",
            sms=spmm._sm_count(x.device)))
    torch.cuda.synchronize()
    ref = spmm.dia_spmm_reference(dia, x)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    name = str(dtype).replace("torch.", "")
    ok = err <= TOL[name] * scale
    row = {"m": m, "n": n, "offsets": list(offsets), "s": s, "dtype": name,
           "max_abs_err": err, "max_abs_y": scale, "ok": ok,
           "plan": plan.summary()}
    if y_other is not None:
        row["other_branch_max_abs_err"] = (y_other - ref).abs().max().item()
        row["branches_equal"] = bool(torch.equal(y, y_other))
        ok = ok and row["branches_equal"] \
            and row["other_branch_max_abs_err"] <= TOL[name] * scale
    if not ok:
        raise AssertionError(f"dia_spmm disagrees with its plain version "
                             f"or across its branches: {row}")
    return row


def n_copies(per_set):
    """Input copies to rotate through so that together they exceed the
    50 MB L2 (at least 128 MB), at most 16."""
    return max(1, min(16, math.ceil(128e6 / per_set)))


def time_kernel(torch, label, kernel, plain, sets, nbytes, flops, name,
                reps, lib_sets=None, peak=None):
    """Check ``kernel`` against ``plain`` on the first set, then time the
    kernel (device time and time per call), the plain version and
    torch.sparse.mm on CSR copies (of each set's payload, unless
    ``lib_sets`` are given), beside the bound (``peak``: the operations'
    peak rate, default the dtype's outside the tensor cores)."""
    y = kernel(*sets[0])
    ref = plain(*sets[0])
    err = (y - ref).abs().max().item()
    if err > TOL[name] * ref.abs().max().item():
        raise AssertionError(f"{kernel.__name__} disagrees at {label}: "
                             f"{err}")
    k_ms = time_ms(torch, kernel, sets, reps)
    call_ms = time_ms(torch, kernel, sets, reps, backlog=False)
    p_ms = time_ms(torch, plain, sets, max(3, reps // 10))
    if lib_sets is None:
        lib_sets = [(csr_of(torch, payload), x) for payload, x in sets]
    l_ms = time_ms(torch, torch.sparse.mm, lib_sets, max(3, reps // 4))
    b_ms, b_by = bound_ms(nbytes, flops, name, peak)
    return {"case": label, "dtype": name, "input_copies": len(sets),
            "max_abs_err": err, "ms": k_ms, "us": k_ms * 1e3,
            "call_ms": call_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bound_ms": b_ms, "bound_by": b_by, "bytes": nbytes,
            "flops": flops, "bound_share": b_ms / k_ms}


def timing_case(torch, spmm, label, m, offsets, s, dtype, gen, reps,
                l2=False):
    """Kernel #1's times (``time_kernel``) and its plan; with ``l2`` also
    ``l2_ms``: the time with one input set, no rotation, so the payload
    and x stay in the 50 MB L2 as they do in the solver; where both
    branches can run, the other one's time too (forced by the plan)."""
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
    plan = spmm.launch_plan(*sets[0])
    row.update({"m": m, "d": len(offsets), "s": s, "plan": plan.summary()})
    if l2:
        row["l2_ms"] = time_ms(torch, spmm.dia_spmm, sets[:1], reps)
    if plan.stageable:
        other = spmm.dia_plan(offsets, m, m, s, itemsize, plan.vec,
                              branch="direct" if plan.staged else "staged",
                              sms=spmm._sm_count(sets[0][1].device))

        def forced(dia, x):
            return spmm.dia_spmm(dia, x, plan=other)

        row["other_branch"] = {"staged": other.staged, "rows": other.rows,
                               "ms": time_ms(torch, forced, sets, reps)}
    return row


def factored_residual(av, mv, b, t64, rng, iters=60):
    """||AV T MV' + MV T AV' + B B'||_2 / ||B'B||_2 in float64 on the host,
    by ``iters`` steps of power iteration on the factored residual
    (bench.py:829-851)."""
    def r_apply(x):
        return b @ (b.T @ x) + av @ (t64 @ (mv.T @ x)) \
            + mv @ (t64 @ (av.T @ x))

    x = rng.standard_normal((av.shape[0], 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(iters):
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
           "ok": err <= TOL[name] * scale,
           **ell_staging(em, op.fwd, s, x.element_size())}
    if not row["ok"]:
        raise AssertionError(f"ell_spmm disagrees with its plain version: "
                             f"{row}")
    return row


def timing_ell_case(torch, em, label, ell, s, gen, reps, floor):
    """Times of the ELL payload ``ell``'s product, rotating through copies
    of the payload and of x, beside the launch floor and the share of row
    tiles the kernel stages."""
    from rails_tpu_torch.sparse.formats import EllMatrix

    dtype = ell.values.dtype
    name = str(dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=dtype).element_size()
    nbytes, flops = ell_work(ell, s, itemsize)
    m, n = ell.shape
    sets = [(EllMatrix(ell.indices.clone(), ell.values.clone(), ell.shape),
             random_x(torch, n, s, dtype, gen))
            for _ in range(n_copies(nbytes + m * s * itemsize))]
    row = time_kernel(torch, label, em.ell_spmm, em.ell_spmm_reference,
                      sets, nbytes, flops, name, reps)
    row.update({"m": m, "n": n, "L": int(ell.indices.shape[1]), "s": s,
                "launch_floor_ms": floor,
                **ell_staging(em, ell, s, itemsize)})
    return row


def schur_residual(blk, lu, m2, b2, v, t):
    """f64 true residual of S X M22 + M22 X S' + Bs Bs' for X = V T V'
    (numpy V and T), S applied on the host with A11 by ``lu`` (scipy's
    splu), M22 = diag(m2), Bs = b2 (zero in the singular rows)."""
    sv = blk["A22"] @ v - blk["A21"] @ lu.solve(blk["A12"] @ v)
    return factored_residual(sv, m2[:, None] * v, b2, t,
                             np.random.default_rng(1))


def host_schur(a, md, b, v, t):
    """The reduced equation and the full-space solution operator on the
    host in float64, A11 by scipy's splu: returns (f64 true residual of
    S X M22 + M22 X S' + Bs Bs' for X = V T V', the leading eigenvalue of
    X_full by eigsh)."""
    import scipy.sparse.linalg as spla

    i1, i2, blk = schur_blocks(a, md)
    lu = spla.splu(blk["A11"].tocsc())
    a12 = blk["A12"]
    res = schur_residual(blk, lu, md[i2], b[i2], v, t)

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


CLI_SIDE = 192   # n = 36,864; side 256 (n = 65,536) ran 220-320 s
SCHUR_KS = (48, 96, 160)   # active sizes whose projected matrices are timed


@contextlib.contextmanager
def capture_projected(store):
    """Record in ``store`` the projected matrices (A_t, C_t) that the
    solver hands to ``lyap`` for the schur route: at the first iteration
    whose active size k reaches each of ``SCHUR_KS`` (keyed by it), and
    at the largest k reached ("max"), each as (k, a, c)."""
    from rails_tpu_torch.core import solver as smod
    from rails_tpu_torch.linalg import dense_lyap

    project_solve, lyap = smod.LyapunovSolver._project_solve, dense_lyap.lyap
    k_now = [0]

    def recording_project_solve(self, st, ctx):
        k_now[0] = st.k
        return project_solve(self, st, ctx)

    def recording_lyap(a, c, *args, **kw):
        k = k_now[0]
        if kw.get("method") == "schur":
            for target in SCHUR_KS:
                if k >= target and target not in store:
                    store[target] = (k, a.clone(), c.clone())
            if k > store.get("max", (0,))[0]:
                store["max"] = (k, a.clone(), c.clone())
        return lyap(a, c, *args, **kw)

    smod.LyapunovSolver._project_solve = recording_project_solve
    dense_lyap.lyap = recording_lyap
    try:
        yield store
    finally:
        smod.LyapunovSolver._project_solve = project_solve
        dense_lyap.lyap = lyap


def run_cli_schur(torch, spmm, em, tol, side=CLI_SIDE, extra=(),
                  label="cli_schur", capture=None, solver=None):
    """The reference's main-program path through the port's CLI on the
    side-``side`` Laplacian DAE at float64 (``extra``: more CLI flags);
    counts reset just before ``cli.main``, read just after.  With a dict
    ``capture``, the projected matrices of the schur route are recorded
    there (``capture_projected``).  ``solver``: more options of the
    "Lyapunov Solver" sublist.  Raises unless the CLI prints the
    projected solver asked for there, and otherwise eigh (A is
    symmetric and the A11 solve dense LU, so S is tagged symmetric)."""
    import scipy.sparse as sp

    from rails_tpu_torch import cli
    from rails_tpu_torch import io as rio

    tmod = importlib.import_module("rails_tpu_torch.timer")
    a, md, b = laplacian_dae(side)
    params = {"Lyapunov Solver": {"Tolerance": tol,
                                  "Maximum iterations": 3000,
                                  "Expand size": 8, "Restart size": 160,
                                  "Reduced size": 80, **(solver or {})}}
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
            with contextlib.redirect_stdout(buf), (
                    contextlib.nullcontext() if capture is None
                    else capture_projected(capture)):
                rc = cli.main([d, "--x64", "--params", p, *extra])
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
    out = {"phase": label, "n": a.shape[0], "n1": int((md == 0).sum()),
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
    mt = re.search(r"Distributed operator: (\w+)", text)
    out["distributed_operator"] = mt.group(1) if mt else None
    mt = re.search(r"Projected solver: (\w+) \(S (symmetric|not "
                   r"symmetric)\)", text)
    route = (solver or {}).get("projected_solver", "eigh")
    out.update({"projected_solver": mt and mt.group(1),
                "s_symmetric": mt and mt.group(2) == "symmetric"})
    if out["projected_solver"] != route or not out["s_symmetric"]:
        raise AssertionError(f"{label}: the CLI did not print the "
                             f"projected solver {route} with S symmetric: "
                             f"{out}")
    if rc != 0 or not out["converged"]:
        raise AssertionError(f"{label} did not converge: {out}")
    if res_true > 2 * tol:
        raise AssertionError(f"{label} true residual above 2 tol: {out}")
    if not out["vt_read_back_equal"]:
        raise AssertionError(f"{label} V.mtx/T.mtx differ from the "
                             f"solution: {out}")
    if out["lambda1_rel_diff"] > 1e-6:
        raise AssertionError(f"{label} leading eigenvalue disagrees with "
                             f"eigsh: {out}")
    if ell_launches <= 0:
        raise AssertionError(f"{label} never launched ell_spmm: {out}")
    return out


def count_applies(op):
    """Count ``op``'s matmat and rmatmat calls (instance attributes that
    shadow the methods, for this run only); returns the counter."""
    n = [0]

    def counted(fn):
        def call(x):
            n[0] += 1
            return fn(x)
        return call

    op.matmat, op.rmatmat = counted(op.matmat), counted(op.rmatmat)
    return n


def run_solve(torch, rt, spmm, label, side, dtype, opts, rounded_inputs,
              mesh=None, compiled=False, b_scale=1.0):
    """Build the bench problem (DIA Laplacian, M = diag(U[0.5, 1.5]), B
    (n, 8) U[0, 1) from default_rng(0)) and solve it through the public
    entry points (on ``mesh`` when given: ``LyapunovSolver(mesh=...)``);
    counts reset just before the solve, read just after.  ``compiled``:
    ``solve(compiled=True)``, the line then carries the engine's costs
    (``compiled_stats``) and A's applies are not wrapped (the engine
    clones the operator)."""
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    lap = laplacian2_sparse(side)
    md = rng.uniform(0.5, 1.5, n)
    b = rng.uniform(0, 1, (n, 8))
    if rounded_inputs:  # phase_scale builds M and B at float32
        md = md.astype(np.float32).astype(np.float64)
        b = b.astype(np.float32).astype(np.float64)
    b = b * b_scale   # phase 28's rounding control
    aop = rt.sparse_from_scipy(lap, fmt="dia", dtype=dtype,
                               is_symmetric=True)
    mop = rt.DiagonalOperator(torch.from_numpy(md).to("cuda", dtype))
    solver = rt.LyapunovSolver(aop, b, mop, dtype=dtype, mesh=mesh, **opts)
    applies = [None] if compiled else count_applies(solver.A)
    walls = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    spmm.dia_spmm.launches = 0
    spmm.dia_spmm_halo.launches = 0
    t0 = time.perf_counter()
    v, t, info = solver.solve(
        compiled=compiled, progress=lambda it, wall, res: walls.append(wall))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = spmm.dia_spmm.launches
    halo_launches = spmm.dia_spmm_halo.launches
    half = len(walls) // 2
    per_it = (walls[-1] - walls[half]) / max(1, len(walls) - 1 - half)
    res_true = true_residual(lap, md, b, v, t, rng)
    out = {"phase": label, "n": n, "dtype": str(dtype).replace("torch.", ""),
           "iters": info.iter, "res": info.res, "converged": info.converged,
           "status": info.status, "rank": int(v.shape[1]),
           "wall_s": wall, "s_per_iter_second_half": per_it,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dia_spmm_launches": launches, "mvps": info.mvps,
           "res_true_f64": res_true, "tol": opts["tol"],
           "resvec_head": [float(r) for r in info.resvec[:RESVEC_HEAD]],
           "operator": type(solver.A).__name__, "a_applies": applies[0],
           "dia_spmm_halo_launches": halo_launches, "compiled": compiled}
    if compiled:
        out.update(compiled_stats(info))
    if not info.converged:
        raise AssertionError(f"{label} did not converge: {out}")
    if res_true > 2 * opts["tol"]:
        raise AssertionError(f"{label} true residual above 2 tol: {out}")
    if mesh is None and launches <= 0:
        raise AssertionError(f"{label} never launched dia_spmm: {out}")
    if mesh is not None and compiled and (
            out["operator"] != "HaloDiaOperator" or launches != 0
            or halo_launches <= 0 or halo_launches % mesh.size):
        raise AssertionError(f"{label}: the mesh's A applies did not go "
                             f"through {mesh.size} halo-kernel launches "
                             f"each and no DIA-kernel launch: {out}")
    if mesh is not None and not compiled and (
            out["operator"] != "HaloDiaOperator" or launches != 0
            or applies[0] <= 0 or halo_launches != mesh.size * applies[0]):
        raise AssertionError(f"{label}: the mesh's A applies did not go "
                             f"through {mesh.size} halo-kernel launches "
                             f"each and no DIA-kernel launch: {out}")
    return out, (lap, md, b, aop, mop, solver)


def continuation_jacobian(side, theta):
    """bench.py::phase_continuation's Jacobian family (:620-630): the 2D
    Laplacian with its diagonal shifted by -theta."""
    import scipy.sparse as sp

    return (sp.kron(sp.eye(side), sp.diags([1.0, -4.0 - theta, 1.0],
                                           [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()


WIDE_BOUND = {3: 8e-5, 6: 5e-7}   # tests/test_sparse.py:549, 568


def compare_wide_case(torch, wm, em, label, ell, wide, s, gen):
    """The wide kernel against its plain version (1e-5 max|y|), and both
    against the exact float64 product of the float32 ELL payload (the
    JAX tests' bounds for the number of passes)."""
    from rails_tpu_torch.sparse.formats import EllMatrix

    x = random_x(torch, ell.shape[1], s, torch.float32, gen)
    y = wm.wide_spmm(wide, x)
    torch.cuda.synchronize()
    ref = wm.wide_spmm_reference(wide, x)
    exact = em.ell_spmm_reference(
        EllMatrix(ell.indices, ell.values.double(), ell.shape), x.double())
    scale = ref.abs().max().item()
    escale = exact.abs().max().item()
    row = {"case": label, "m": ell.shape[0], "n": ell.shape[1],
           "w": wide.w, "passes": wide.passes, "s": s,
           "max_abs_err": (y - ref).abs().max().item(), "max_abs_y": scale,
           "kernel_vs_exact": (y.double() - exact).abs().max().item(),
           "plain_vs_exact": (ref.double() - exact).abs().max().item(),
           "max_abs_exact": escale}
    bound = WIDE_BOUND[wide.passes]
    row["ok"] = (row["max_abs_err"] <= 1e-5 * scale
                 and row["kernel_vs_exact"] <= bound * escale
                 and row["plain_vs_exact"] <= bound * escale)
    if not row["ok"]:
        raise AssertionError(f"wide_spmm disagrees: {row}")
    return row


def timing_wide_case(torch, wm, em, label, ell, wide, s, gen, reps):
    """Times of the wide kernel at ``s`` columns beside its bound (bytes
    over 3.35 TB/s or its bf16 operations over 989 TFLOP/s), its plain
    version, the ELL kernel on the same payload and torch.sparse.mm,
    rotating through copies of the payloads and of x."""
    from rails_tpu_torch.sparse.formats import EllMatrix
    from rails_tpu_torch.sparse.wide_spmm import WideWindow

    nbytes, flops = wm.wide_work(wide, s)
    ell_bytes, ell_flops = ell_work(ell, s, 4)
    copies = n_copies(nbytes + ell_bytes)

    def clone_wide(wd):
        return WideWindow(wd.c0.clone(), wd.p_hi.clone(), wd.p_lo.clone(),
                          None if wd.p3 is None else wd.p3.clone(), wd.w,
                          wd.shape, wd.min_s)

    trips = [(wide if i == 0 else clone_wide(wide),
              EllMatrix(ell.indices.clone(), ell.values.clone(), ell.shape),
              random_x(torch, ell.shape[1], s, torch.float32, gen))
             for i in range(copies)]
    sets = [(wd, x) for wd, _, x in trips]
    row = time_kernel(torch, label, wm.wide_spmm, wm.wide_spmm_reference,
                      sets, nbytes, flops, "float32", reps,
                      lib_sets=[(csr_of(torch, e), x) for _, e, x in trips],
                      peak=PEAK_BF16_FLOPS)
    ell_sets = [(e, x) for _, e, x in trips]
    ell_ms = time_ms(torch, em.ell_spmm, ell_sets, reps)
    ell_b_ms, ell_b_by = bound_ms(ell_bytes, ell_flops, "float32")
    row["ell_staging"] = ell_staging(em, ell, s, 4)
    row.update({"m": ell.shape[0], "n": ell.shape[1], "w": wide.w,
                "passes": wide.passes, "s": s, "ell_ms": ell_ms,
                "ell_bound_ms": ell_b_ms, "ell_bound_by": ell_b_by,
                "wide_over_ell": row["ms"] / ell_ms})
    return row


def run_refined_acc(torch, rt, spmm):
    """bench.py::phase_accuracy (:467-591) at its real size: the n = 8192
    stable tridiagonal from default_rng(0) in DIA (is_hurwitz, so the
    projected solves take the sign route), B (n, 4) float32; first the
    single float32 solve (its true residual recorded, not checked), then
    solve_refined with compensated reductions, whose float64 true
    residual must reach 1.1e-8 (the bench's acc_target_met rule)."""
    import scipy.sparse as sp

    n = 8192
    rng = np.random.default_rng(0)
    q = lambda x: np.round(x * 1024) / 1024  # noqa: E731  exact in f32
    main = q(-2.0 - rng.uniform(0, 1, n))
    up = q(0.4 * rng.uniform(-1, 1, n - 1))
    lo = q(0.4 * rng.uniform(-1, 1, n - 1))
    a_sp = sp.diags([lo, main, up], [-1, 0, 1]).tocsr()
    b32 = np.asarray(rng.uniform(-1, 1, (n, 4)), np.float32)
    b64 = b32.astype(np.float64)
    aop = rt.sparse_from_scipy(a_sp, fmt="dia", dtype=torch.float32,
                               is_hurwitz=True)
    kw = dict(tol=1e-8, dtype=torch.float32, maxit=100, expand=4)

    def true_rel(v, t):
        v64 = v.detach().cpu().double().numpy()
        t64 = t.detach().cpu().double().numpy()
        return factored_residual(a_sp @ v64, v64, b64, t64, rng, 200)

    out = {"phase": "refined_acc", "n": n, "tol": 1e-8, "dtype": "float32"}
    for label, fn, extra in (("single", rt.solve, {}),
                             ("refined", rt.solve_refined,
                              {"precision": "compensated"})):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spmm.dia_spmm.launches = 0
        t0 = time.perf_counter()
        v, t, info = fn(aop, b32, **kw, **extra)
        torch.cuda.synchronize()
        out.update({f"{label}_wall_s": time.perf_counter() - t0,
                    f"{label}_dia_spmm_launches": spmm.dia_spmm.launches,
                    f"{label}_max_memory_allocated":
                        torch.cuda.max_memory_allocated(),
                    f"{label}_iters": info.iter,
                    f"{label}_res_est": float(info.res),
                    f"{label}_converged": bool(info.converged),
                    f"{label}_rank": int(v.shape[1]),
                    f"{label}_res_true_f64": true_rel(v, t)})
    out.update({"refined_stages": len(info.stages),
                "refined_stage_iters": [s.iter for s in info.stages],
                "bench_r05_refined_res_true_tpu": 7.53145e-09,
                "target_met": bool(out["refined_res_true_f64"] <= 1.1e-8)})
    if not out["target_met"]:
        raise AssertionError(f"refined_acc missed 1.1e-8: {out}")
    if out["refined_dia_spmm_launches"] <= 0:
        raise AssertionError(f"refined_acc never launched dia_spmm: {out}")
    return out


def run_refined_scale(torch, rt, spmm, refine_mod, compiled=False):
    """bench.py::phase_scale (:782-810) at its real size: the side-256
    Laplacian (n = 65536) in DIA, M = diag(U[0.5, 1.5]), B (n, 8) float32,
    solve_refined with compensated reductions to tol 1e-4.  It must
    converge with a float64 true residual <= 2 tol.  The wall is split
    into the stage solves and the host's residual compression
    (``residual_factor``, timed by wrapping it for this run)."""
    from rails_tpu_torch.models.problems import laplacian2_sparse

    side, tol = 256, 1e-4
    n = side * side
    rng = np.random.default_rng(0)
    lap = laplacian2_sparse(side)
    md = rng.uniform(0.5, 1.5, n).astype(np.float32)
    b32 = np.asarray(rng.uniform(0, 1, (n, 8)), np.float32)
    aop = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float32,
                               is_symmetric=True)
    mop = rt.DiagonalOperator(torch.from_numpy(md).to("cuda"))
    factor_s = []
    factor = refine_mod.residual_factor

    def timed_factor(*args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = factor(*args, **kwargs)
        factor_s.append(time.perf_counter() - t0)
        return res

    stage_walls = []

    def progress(it, wall, res):
        # each stage's clock starts at 0
        if not stage_walls or wall < stage_walls[-1]:
            stage_walls.append(wall)
        stage_walls[-1] = wall

    refine_mod.residual_factor = timed_factor
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        spmm.dia_spmm.launches = 0
        t0 = time.perf_counter()
        v, t, info = rt.solve_refined(
            aop, b32, mop, tol=tol, stage_tol=5e-3, dtype=torch.float32,
            maxit=1500, expand=8, restart_size=160, reduced_size=80,
            timevec_chunk=50, precision="compensated", progress=progress,
            compiled=compiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        refine_mod.residual_factor = factor
    launches = spmm.dia_spmm.launches
    res_true = true_residual(lap, md.astype(np.float64),
                             b32.astype(np.float64), v, t, rng)
    out = {"phase": "refined_scale", "n": n, "tol": tol, "dtype": "float32",
           "converged": bool(info.converged), "res_est": float(info.res),
           "stages": len(info.stages),
           "stage_iters": [s.iter for s in info.stages], "iters": info.iter,
           "bench_r05_iters_tpu": 746, "rank": int(v.shape[1]),
           "bench_r05_rank_tpu": 199, "wall_s": wall,
           "stage_solve_walls_s": stage_walls,
           "residual_factor_walls_s": factor_s,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "dia_spmm_launches": launches, "res_true_f64": res_true,
           "compiled": compiled}
    if compiled:
        out["stage_engines"] = [compiled_stats(st) for st in info.stages]
    if not out["converged"]:
        raise AssertionError(f"refined_scale did not converge: {out}")
    if res_true > 2 * tol:
        raise AssertionError(f"refined_scale true residual above 2 tol: "
                             f"{out}")
    if launches <= 0:
        raise AssertionError(f"refined_scale never launched dia_spmm: {out}")
    return out


CONT_SIDE = 128          # n = 16384, four times the JAX bench's n
# 6 passes: with 3 (about 1.5e-5 relative per apply) the first warm
# step's Gram block carried enough error that its f64 true residual
# ended at 3.5e-4 against a Lanczos estimate of 9.6e-5 (tol 1e-4)
CONT_WIDE_PASSES = 6


def run_continuation_wide(torch, rt, em, wm, compiled=False):
    """bench.py::phase_continuation (:594-664) at side 128: the Jacobians
    theta = 0, 0.05, 0.1 in ELL with the dense-window payload, float32,
    M and B as at :617-618, through ContinuationSolver with compensated
    reductions.  Counts are set to 0 just before the first step and read
    after each.  Every step must converge with a float64 true residual
    <= 2 tol; the warm steps must take fewer iterations than the cold one
    on average, enter with >= 192 carried columns and launch wide_spmm."""
    side, tol = CONT_SIDE, 1e-4
    n = side * side
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, n).astype(np.float32)
    b32 = rng.uniform(0, 1, (n, 8)).astype(np.float32)
    # restart_tolerance 0: restarts keep reduced_size columns, not only
    # the eigenvalues of T above 1e-3 tol relative (rank 54 here), so the
    # carried basis holds 200 columns and a warm step's first Gram block
    # applies A to that many, the wide kernel's dispatch width
    cont = rt.ContinuationSolver(
        b32, rt.DiagonalOperator(torch.from_numpy(md).to("cuda")), tol=tol,
        dtype=torch.float32, expand=6, restart_size=400, reduced_size=200,
        restart_tolerance=0.0, maxit=1000, precision="compensated")
    steps = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    wm.wide_spmm.launches = 0
    em.ell_spmm.launches = 0
    for theta in (0.0, 0.05, 0.1):
        a = continuation_jacobian(side, theta)
        aop = rt.sparse_from_scipy(a, fmt="ell", wide_s=True,
                                   wide_passes=CONT_WIDE_PASSES,
                                   is_symmetric=True, dtype=torch.float32)
        if aop.fwd.wide is None:
            raise AssertionError("continuation Jacobian has no wide window")
        k0 = 0 if cont._prev_space is None else int(cont._prev_space.shape[1])
        w0, e0 = wm.wide_spmm.launches, em.ell_spmm.launches
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        v, t, info = cont.step(aop, compiled=compiled)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        if compiled:
            steps.append(dict(compiled_stats(info),
                              engine_cache_size=len(cont._engine_cache)))
        else:
            steps.append({})
        steps[-1].update({
            "theta": theta, "k0": k0, "iters": info.iter,
            "converged": bool(info.converged), "res_est": float(info.res),
            "rank": int(v.shape[1]), "wall_s": wall,
            "wide_spmm_launches": wm.wide_spmm.launches - w0,
            "ell_spmm_launches": em.ell_spmm.launches - e0,
            "res_true_f64": true_residual(a, md.astype(np.float64),
                                          b32.astype(np.float64), v, t,
                                          rng)})
    warm = steps[1:]
    out = {"phase": "continuation_wide", "n": n, "tol": tol,
           "dtype": "float32", "wide_passes": CONT_WIDE_PASSES,
           "steps": steps, "cold_iters": steps[0]["iters"],
           "warm_iters_mean": sum(s["iters"] for s in warm) / len(warm),
           "cold_wall_s": steps[0]["wall_s"],
           "warm_wall_mean_s": sum(s["wall_s"] for s in warm) / len(warm),
           "wide_spmm_launches": wm.wide_spmm.launches,
           "ell_spmm_launches": em.ell_spmm.launches,
           "max_memory_allocated": torch.cuda.max_memory_allocated(),
           "compiled": compiled}
    bad = [s for s in steps
           if not s["converged"] or s["res_true_f64"] > 2 * tol]
    if bad:
        raise AssertionError(f"continuation_wide step failed: {out}")
    if out["warm_iters_mean"] >= out["cold_iters"]:
        raise AssertionError(f"continuation_wide warm steps not faster: "
                             f"{out}")
    if any(s["k0"] < 192 or s["wide_spmm_launches"] < 1 for s in warm):
        raise AssertionError(f"continuation_wide warm step without a wide "
                             f"apply at >= 192 columns: {out}")
    if out["ell_spmm_launches"] <= 0:
        raise AssertionError(f"continuation_wide never launched ell_spmm: "
                             f"{out}")
    return out


def mesh_ell_shard(torch, rt):
    """An interior shard's ELL payload of mesh_ell (the continuation
    Jacobian at theta 0, side 128, f64, 4 shards): m_loc 4,096 rows over
    its halos and own rows (4,096 + 2 x 128 columns), L = 5."""
    from rails_tpu_torch.parallel.halo_ell import build_halo_ell

    op = rt.sparse_from_scipy(continuation_jacobian(CONT_SIDE, 0.0),
                              fmt="ell", dtype=torch.float64)
    h = build_halo_ell(op.fwd, rt.make_mesh(devices=["cuda:0"] * MESH_ND))
    return h.shards[1]


OPTS64 = dict(tol=1e-4, expand=8, restart_size=160, reduced_size=80,
              maxit=3000)   # solve_f64 and mesh_solve


def run_earlier_phases(torch, rt, spmm, em, smi, gen):
    """Phases 3-7 (the DIA and ELL kernels, the two solves, the CLI's
    Schur path), each emitting its line; returns, per kernel, its
    launches on the main path, its compare error and its timing row."""
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

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
        rows.append(compare_case(torch, spmm, 4097, 4097,
                                 (-256, -1, 0, 1, 256), 8, dtype, gen))
        rows.append(compare_case(torch, spmm, 40 ** 3, 40 ** 3,
                                 (-1600, -40, -1, 0, 1, 40, 1600), 8, dtype,
                                 gen))
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
    floor = launch_floor_ms(torch)
    timings = [
        timing_case(torch, spmm, "slice f64 n=65536 s=8", 65536,
                    (-256, -1, 0, 1, 256), 8, f64, gen, 400, l2=True),
        timing_case(torch, spmm, "solve f32 n=4096 s=6", 4096,
                    (-64, -1, 0, 1, 64), 6, f32, gen, 400),
        timing_case(torch, spmm, "bench f32 side=1536 s=16", 1536 * 1536,
                    (-1536, -1, 0, 1, 1536), 16, f32, gen, 50),
        timing_case(torch, spmm, "refined_scale f32 n=65536 s=8", 65536,
                    (-256, -1, 0, 1, 256), 8, f32, gen, 400, l2=True),
    ]
    for r in timings:
        r["launch_floor_ms"] = floor
    emit({"phase": "timing", "cases": timings, "launch_floor_ms": floor,
          "smi": smi, "wall_s": time.perf_counter() - t0})

    # ---- 4b. timing of the ELL kernel
    t0 = time.perf_counter()
    floor = launch_floor_ms(torch)
    ell_timings = [
        timing_ell_case(torch, em, "slice A22 f64 s=8",
                        ell_ops["A22"].fwd, 8, gen, 400, floor),
        timing_ell_case(torch, em, "bench f32 m=2^21 L=8 s=16",
                        ell_ops["bench"].astype(f32).fwd, 16, gen, 50,
                        floor),
        timing_ell_case(torch, em, "continuation f32 side 128 s=200",
                        sparse_from_scipy(continuation_jacobian(
                            CONT_SIDE, 0.05), fmt="ell", dtype=f32).fwd,
                        200, gen, 200, floor),
        timing_ell_case(torch, em, "mesh_ell shard f64 s=8",
                        mesh_ell_shard(torch, rt), 8, gen, 400, floor),
    ]
    del ell_ops
    emit({"phase": "timing_ell", "cases": ell_timings,
          "launch_floor_ms": floor, "smi": smi,
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
    EAGER["solve_f32"] = out32

    # ---- 6. solve f64, n=65536 (phase_scale geometry, plain f64)
    t0 = time.perf_counter()
    out64, prob = run_solve(torch, rt, spmm, "solve_f64", 256, f64, OPTS64,
                            True)
    main_launches = out64["dia_spmm_launches"]
    out64.update({"jax_cpu_f64_iters": 742,
                  "phase_wall_s": time.perf_counter() - t0})
    emit(out64)
    EAGER["solve_f64"] = out64

    # where the time goes: the first 200 iterations again, with the
    # solver's timer on (it synchronises the card at each scope's ends)
    t0 = time.perf_counter()
    _, _, b64, aop, mop, _ = prob
    # the module (the package's name ``timer`` is the scope function)
    tmod = importlib.import_module("rails_tpu_torch.timer")

    tmod.reset_profiles()
    tmod.enable_profiling()
    try:
        opts_prof = dict(OPTS64, maxit=200)
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
    out_cli["phase_wall_s"] = time.perf_counter() - t0
    emit(out_cli)
    EAGER["cli_schur"] = out_cli
    return {"dia": (main_launches, slice_err, timings[0]),
            "ell": (out_cli["ell_spmm_launches"], ell_slice_err,
                    ell_timings[0]),
            "solve_f64": out64}


def run_wide_phases(torch, rt, spmm, em, wm, refine_mod, smi, gen, only):
    """Phases 8-12 (this slice's: the dense-window kernel, the refined
    solves, the continuation run), each emitting its line, those not in
    ``only`` skipped (None: all).  Returns the wide kernel's launches on
    continuation_wide, its compare error and its timing row at the
    continuation shape (None for a phase that was skipped)."""
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

    def want(name):
        return only is None or name in only

    f32 = torch.float32
    cont = bench = None
    if want("compare_wide") or want("timing_wide"):
        # the continuation Jacobian (theta = 0.05: -4.05 needs the lo
        # plane) and the JAX bench's ELL geometry, float32 ELL on the card
        cont = sparse_from_scipy(continuation_jacobian(CONT_SIDE, 0.05),
                                 fmt="ell", dtype=f32).fwd
        bench = sparse_from_scipy(banded_ell(1 << 21, 1 << 21, 8, 64, 0,
                                             seed=0), fmt="ell",
                                  dtype=f32).fwd
        cont_w = {p: wm.build_wide_window(cont, passes=p) for p in (3, 6)}
        bench_w = wm.build_wide_window(bench, passes=3)

    # ---- 8. compare the wide kernel
    wide_err = None
    if want("compare_wide"):
        t0 = time.perf_counter()
        rows = []
        for passes in (3, 6):
            for s in (8, 192, 200, 256, 300):
                rows.append(compare_wide_case(
                    torch, wm, em, "continuation side 128", cont,
                    cont_w[passes], s, gen))
        wide_err = next(r["max_abs_err"] for r in rows
                        if r["s"] == 200 and r["passes"] == CONT_WIDE_PASSES)
        rows.append(compare_wide_case(torch, wm, em, "bench m=2^21 L=8",
                                      bench, bench_w, 192, gen))
        refused = wm.build_wide_window(bench, passes=6) is None
        if not refused:
            raise AssertionError("the bench geometry's 6-pass planes (4.8 "
                                 "GB) passed the 4 GB cap")
        odd = sparse_from_scipy(banded_ell(1111, 700, 6, 40, 150, seed=1),
                                fmt="ell", dtype=f32)
        for passes in (3, 6):
            odd_w = wm.build_wide_window(odd.fwd, passes=passes, min_s=1)
            for s in (1, 3, 8, 67):
                rows.append(compare_wide_case(
                    torch, wm, em, "odd: rectangular, empty rows", odd.fwd,
                    odd_w, s, gen))
        # the widest window the payload takes: w = 2048
        band = sparse_from_scipy(banded_ell(4096, 4096, 6, 900, 0, seed=2),
                                 fmt="ell", dtype=f32).fwd
        for passes in (3, 6):
            band_w = wm.build_wide_window(band, passes=passes)
            if band_w is None or band_w.w != 2048:
                raise AssertionError("the band-900 window is not 2048 wide")
            rows.append(compare_wide_case(torch, wm, em, "band 900, w=2048",
                                          band, band_w, 200, gen))
        # an apply through the operator dispatches to the kernel
        odd.fwd.wide = odd_w
        before = wm.wide_spmm.launches
        odd.matmat(random_x(torch, 700, 3, f32, gen))
        torch.cuda.synchronize()
        if wm.wide_spmm.launches != before + 1:
            raise AssertionError("a wide-eligible apply did not launch "
                                 "wide_spmm")
        emit({"phase": "compare_wide", "cases": rows, "all_ok": True,
              "bench_passes6_refused_by_cap": refused,
              "wall_s": time.perf_counter() - t0})

    # ---- 9. timing of the wide kernel beside the ELL kernel
    wide_t = None
    if want("timing_wide"):
        t0 = time.perf_counter()
        rows = [
            timing_wide_case(torch, wm, em, "continuation side 128 s=200",
                             cont, cont_w[CONT_WIDE_PASSES], 200, gen, 200),
            timing_wide_case(torch, wm, em, "continuation side 128 s=200",
                             cont, cont_w[3], 200, gen, 200),
            timing_wide_case(torch, wm, em, "bench m=2^21 L=8 s=192", bench,
                             bench_w, 192, gen, 10),
            timing_wide_case(torch, wm, em, "bench m=2^21 L=8 s=256", bench,
                             bench_w, 256, gen, 10),
        ]
        wide_t = rows[0]
        emit({"phase": "timing_wide", "cases": rows, "smi": smi,
              "wall_s": time.perf_counter() - t0})
    del cont, bench
    cont_w = bench_w = None
    torch.cuda.empty_cache()

    # ---- 10-12. refined solves and the continuation run
    if want("refined_acc"):
        t0 = time.perf_counter()
        out = run_refined_acc(torch, rt, spmm)
        out["phase_wall_s"] = time.perf_counter() - t0
        emit(out)
    if want("refined_scale"):
        t0 = time.perf_counter()
        out = run_refined_scale(torch, rt, spmm, refine_mod)
        out["phase_wall_s"] = time.perf_counter() - t0
        emit(out)
        EAGER["refined_scale"] = out
    launches = None
    if want("continuation_wide"):
        t0 = time.perf_counter()
        out = run_continuation_wide(torch, rt, em, wm)
        out["phase_wall_s"] = time.perf_counter() - t0
        launches = out["wide_spmm_launches"]
        emit(out)
        EAGER["continuation_wide"] = out
    return launches, wide_err, wide_t


MESH_ND = 4        # shards on cuda:0 in the mesh phases
MESH_CLI_SIDE = 96  # mesh_schur (b): n = 9,216


def halo_shard(torch, data, offsets, x, r, nd):
    """Shard r of ``nd`` of a global DIA product: (data_loc, offsets_t,
    x_loc, hl, hh), the halos copied from the neighbours' rows (zeros
    beyond the matrix, None for a 0 span)."""
    m, s = x.shape
    r0, r1 = r * (m // nd), (r + 1) * (m // nd)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))

    def halo(a, b):
        if b <= a:
            return None
        if a < 0 or b > m:
            return torch.zeros((b - a, s), dtype=x.dtype, device=x.device)
        return x[a:b].clone()

    offs = torch.tensor(offsets, dtype=torch.int32, device=x.device)
    return (data[:, r0:r1].contiguous(), offs, x[r0:r1], halo(r0 - lo, r0),
            halo(r1, r1 + hi))


def compare_halo_case(torch, spmm, label, args):
    """The halo kernel against its plain version on one shard's inputs,
    its offsets by value (as the mesh apply passes them) and from the
    device array; the two launches must agree bit for bit."""
    offsets = args[1].tolist()
    y = spmm.dia_spmm_halo(*args, offsets=offsets)
    y_dev = spmm.dia_spmm_halo(*args)
    torch.cuda.synchronize()
    ref = spmm.dia_spmm_halo_reference(*args)
    err = (y - ref).abs().max().item()
    scale = ref.abs().max().item()
    x_loc, hl, hh = args[2], args[3], args[4]
    name = str(x_loc.dtype).replace("torch.", "")
    row = {"case": label, "m_loc": x_loc.shape[0], "s": x_loc.shape[1],
           "offsets": offsets, "dtype": name,
           "span_lo": 0 if hl is None else hl.shape[0],
           "span_hi": 0 if hh is None else hh.shape[0],
           "max_abs_err": err, "max_abs_y": scale,
           "ok": err <= TOL[name] * scale,
           "offset_paths_equal": bool(torch.equal(y, y_dev))}
    if not row["ok"] or not row["offset_paths_equal"]:
        raise AssertionError(f"dia_spmm_halo disagrees with its plain "
                             f"version or across its offset paths: {row}")
    return row


def ext_csr(torch, data_loc, offsets, lo, ext):
    """A CUDA CSR copy of a shard's (m_loc x ext) operator on the extended
    operand [hl; x_loc; hh], for torch.sparse.mm."""
    import scipy.sparse as sp

    d = data_loc.detach().cpu().numpy()
    m_loc = d.shape[1]
    i = np.arange(m_loc)
    c = sp.coo_matrix(
        (d.ravel(), (np.tile(i, len(offsets)),
                     np.concatenate([i + lo + o for o in offsets]))),
        shape=(m_loc, ext)).tocsr()
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "CSR support is in beta"
        return torch.sparse_csr_tensor(
            torch.from_numpy(c.indptr.astype(np.int64)),
            torch.from_numpy(c.indices.astype(np.int64)),
            torch.from_numpy(c.data), size=(m_loc, ext), device="cuda")


def timing_halo_case(torch, spmm, label, m_loc, offsets, s, dtype, gen,
                     reps, floor):
    """The halo kernel's time per shard launch (its offsets by value, as
    the mesh apply passes them) beside its bound: (d m_loc + (span_lo +
    m_loc + span_hi) s + m_loc s) itemsize bytes over 3.35 TB/s against
    2 d m_loc s flops; the launch floor; its plain version;
    torch.sparse.mm on a CSR copy of the shard's (m_loc x ext)
    operator."""
    name = str(dtype).replace("torch.", "")
    itemsize = torch.empty((), dtype=dtype).element_size()
    d = len(offsets)
    lo, hi = max(0, -min(offsets)), max(0, max(offsets))
    ext = lo + m_loc + hi
    nbytes = (d * m_loc + ext * s + m_loc * s) * itemsize
    flops = 2 * d * m_loc * s
    offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
    sets = [(random_x(torch, d, m_loc, dtype, gen), offs,
             random_x(torch, m_loc, s, dtype, gen),
             random_x(torch, lo, s, dtype, gen),
             random_x(torch, hi, s, dtype, gen))
            for _ in range(n_copies(nbytes + m_loc * s * itemsize))]
    lib_sets = [(ext_csr(torch, st[0], offsets, lo, ext),
                 torch.cat([st[3], st[2], st[4]])) for st in sets]
    def dia_spmm_halo(*args):
        return spmm.dia_spmm_halo(*args, offsets=offsets)

    row = time_kernel(torch, label, dia_spmm_halo,
                      spmm.dia_spmm_halo_reference, sets, nbytes, flops,
                      name, reps, lib_sets=lib_sets)
    row.update({"m_loc": m_loc, "d": d, "span_lo": lo, "span_hi": hi,
                "s": s, "launch_floor_ms": floor})
    return row


def halo_overhead(torch, rt, spmm, em, gen, reps):
    """bench.py's halo_overhead_vs_plain (:872-874, 946-952) on the card:
    HaloDiaOperator.matmat at 1 and 4 shards over the DIA kernel's apply
    at the bench mesh geometry (side 1536, s=16, f32), and
    HaloEllOperator.matmat at 4 shards over the ELL kernel's apply at the
    bench's ELL geometry (:987-996: m=2^20, L=8, band +-64, s=16, f32);
    device times by CUDA events, x alone larger than the L2."""
    from rails_tpu_torch.parallel.halo_ell import HaloEllOperator
    from rails_tpu_torch.parallel.halo_spmm import HaloDiaOperator
    from rails_tpu_torch.parallel.sharded import shard_operator
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

    f32 = torch.float32
    side = 1536
    m = side * side
    dia = random_dia(torch, m, m, (-side, -1, 0, 1, side), f32, gen)
    x = random_x(torch, m, 16, f32, gen)
    y1 = spmm.dia_spmm(dia, x)
    out = {"dia_m": m, "s": 16, "dia_plain_kernel_ms": time_ms(
        torch, spmm.dia_spmm, [(dia, x)], reps)}
    for nd in (1, MESH_ND):
        h = HaloDiaOperator(dia, rt.make_mesh(devices=["cuda:0"] * nd))
        err = (h.matmat(x) - y1).abs().max().item()
        if err > TOL["float32"] * y1.abs().max().item():
            raise AssertionError(f"HaloDiaOperator at nd={nd} disagrees "
                                 f"with dia_spmm: {err}")
        ms = time_ms(torch, h.matmat, [(x,)], reps)
        out[f"dia_halo_nd{nd}_ms"] = ms
        out[f"halo_overhead_vs_plain_nd{nd}"] = \
            ms / out["dia_plain_kernel_ms"]
        del h
    del dia, x, y1
    op = sparse_from_scipy(banded_ell(1 << 20, 1 << 20, 8, 64, 0, seed=2),
                           fmt="ell", dtype=f32)
    h = shard_operator(op, rt.make_mesh(devices=["cuda:0"] * MESH_ND))
    if not isinstance(h, HaloEllOperator):
        raise AssertionError(f"the bench ELL geometry sharded to {type(h)}")
    x = random_x(torch, 1 << 20, 16, f32, gen)
    ye = em.ell_spmm(op.fwd, x)
    err = (h.matmat(x) - ye).abs().max().item()
    if err > TOL["float32"] * ye.abs().max().item():
        raise AssertionError(f"HaloEllOperator disagrees with ell_spmm: "
                             f"{err}")
    out["ell_m"] = 1 << 20
    out["ell_halo"] = [h.fwd.halo_lo, h.fwd.halo_hi]
    out["ell_plain_kernel_ms"] = time_ms(torch, em.ell_spmm, [(op.fwd, x)],
                                         reps)
    out[f"ell_halo_nd{MESH_ND}_ms"] = time_ms(torch, h.matmat, [(x,)], reps)
    out[f"ell_halo_overhead_vs_plain_nd{MESH_ND}"] = \
        out[f"ell_halo_nd{MESH_ND}_ms"] / out["ell_plain_kernel_ms"]
    return out


def run_mesh_ell(torch, rt, em, mesh):
    """bench.py:620-630's Jacobian at theta = 0, side 128 (n = 16,384), in
    ELL without wide planes at f64, M and B as at :617-618 (drawn at
    float32), tol 1e-4, expand 6, restart 120 -> 60 (bench.py:633-635),
    maxit 1000: on the mesh and unsharded, counts reset just before each
    solve and read just after."""
    side, tol = CONT_SIDE, 1e-4
    n = side * side
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, n).astype(np.float32).astype(np.float64)
    b = rng.uniform(0, 1, (n, 8)).astype(np.float32).astype(np.float64)
    a = continuation_jacobian(side, 0.0)
    runs = {}
    for label, msh in (("mesh", mesh), ("unsharded", None)):
        aop = rt.sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                                   is_symmetric=True)
        solver = rt.LyapunovSolver(
            aop, b, rt.DiagonalOperator(md, device="cuda"), mesh=msh,
            dtype=torch.float64, tol=tol, expand=6, restart_size=120,
            reduced_size=60, maxit=1000)
        applies = count_applies(solver.A)
        torch.cuda.synchronize()
        em.ell_spmm.launches = 0
        t0 = time.perf_counter()
        v, t, info = solver.solve()
        torch.cuda.synchronize()
        runs[label] = {
            "operator": type(solver.A).__name__, "iters": info.iter,
            "converged": bool(info.converged), "res_est": float(info.res),
            "rank": int(v.shape[1]), "wall_s": time.perf_counter() - t0,
            "a_applies": applies[0], "ell_spmm_launches": em.ell_spmm.launches,
            "res_true_f64": true_residual(a, md, b, v, t, rng)}
    mr, ur = runs["mesh"], runs["unsharded"]
    out = {"phase": "mesh_ell", "n": n, "tol": tol, "dtype": "float64",
           "shards": mesh.size, "runs": runs,
           "iters_equal": mr["iters"] == ur["iters"]}
    if mr["operator"] != "HaloEllOperator":
        raise AssertionError(f"mesh_ell: A is not a HaloEllOperator: {out}")
    if any(not r["converged"] or r["res_true_f64"] > 2 * tol
           for r in runs.values()):
        raise AssertionError(f"mesh_ell did not converge to 2 tol: {out}")
    if abs(mr["iters"] - ur["iters"]) > 0.01 * ur["iters"]:
        raise AssertionError(f"mesh_ell iterations differ by > 1%: {out}")
    if mr["a_applies"] <= 0 or \
            mr["ell_spmm_launches"] != mesh.size * mr["a_applies"]:
        raise AssertionError(f"mesh_ell: not {mesh.size} ELL launches per "
                             f"apply: {out}")
    return out


def run_schur_dist_apply(torch, rt, mesh, gen):
    """distribute_schur on cli_schur's DAE (side 192, n2 = 24,576, f64) at
    4 shards: matmat and rmatmat at s = 8 against the reduction's own
    operator, relative error <= 1e-12."""
    from rails_tpu_torch.parallel.schur_dist import (
        DistributedSchurOperator, distribute_schur)

    a, md, b = laplacian_dae(CLI_SIDE)
    t0 = time.perf_counter()
    red = rt.schur_reduce(a, md, b, dtype=torch.float64)
    op = distribute_schur(red, mesh)
    if not isinstance(op, DistributedSchurOperator):
        raise AssertionError(f"distribute_schur gave {type(op)}")
    x = random_x(torch, red.n2, 8, torch.float64, gen)
    rows = {}
    for name in ("matmat", "rmatmat"):
        y = getattr(op, name)(x)
        ref = getattr(red.operator, name)(x)
        rows[name] = (y - ref).abs().max().item() / ref.abs().max().item()
    torch.cuda.synchronize()
    out = {"case": "distribute_schur side 192", "n1": red.n1, "n2": red.n2,
           "shards": mesh.size, "a22": type(op.a22).__name__, "s": 8,
           "rel_err": rows, "wall_s": time.perf_counter() - t0}
    if max(rows.values()) > 1e-12:
        raise AssertionError(f"distribute_schur disagrees: {out}")
    return out


def run_mesh_phases(torch, rt, spmm, em, smi, gen, only, solve_f64):
    """Phases 13-17 (this slice's: kernel #3 and the mesh path), each
    emitting its line, those not in ``only`` skipped (None: all).
    ``solve_f64``: that phase's line, to hold mesh_solve against (run
    here when the earlier phases were skipped).  Returns kernel #3's
    launches on mesh_solve, its compare error and its timing row (None
    for a phase that was skipped)."""
    from rails_tpu_torch.parallel.halo_spmm import HaloDiaOperator

    def want(name):
        return only is None or name in only

    f32, f64 = torch.float32, torch.float64
    mesh = rt.make_mesh(devices=["cuda:0"] * MESH_ND)
    solve_offsets = (-256, -1, 0, 1, 256)

    # ---- 13. compare the halo kernel
    halo_err = None
    if want("compare_halo"):
        t0 = time.perf_counter()
        rows, applies = [], []
        for dtype in (f32, f64):
            data = random_x(torch, 5, 65536, dtype, gen)
            for s in (1, 6, 8, 16):
                x = random_x(torch, 65536, s, dtype, gen)
                for r, where in ((1, "interior"), (0, "first"),
                                 (MESH_ND - 1, "last")):
                    rows.append(compare_halo_case(
                        torch, spmm, f"solve stencil, {where} shard",
                        halo_shard(torch, data, solve_offsets, x, r,
                                   MESH_ND)))
                rows.append(compare_halo_case(
                    torch, spmm, "one-sided stencil, empty lower halo",
                    halo_shard(torch, data[:3], (0, 1, 256), x, 1,
                               MESH_ND)))
            for s in (8,):
                dia = random_dia(torch, 65536, 65536, solve_offsets, dtype,
                                 gen)
                x = random_x(torch, 65536, s, dtype, gen)
                y = HaloDiaOperator(dia, mesh).matmat(x)
                y1 = spmm.dia_spmm(dia, x)
                torch.cuda.synchronize()
                diff = (y - y1).abs().max().item()
                name = str(dtype).replace("torch.", "")
                applies.append({"case": "HaloDiaOperator apply vs dia_spmm",
                                "m": 65536, "shards": MESH_ND, "s": s,
                                "dtype": name, "max_abs_diff": diff,
                                "exactly_equal": diff == 0.0})
                if diff > TOL[name] * y1.abs().max().item():
                    raise AssertionError(f"HaloDiaOperator disagrees with "
                                         f"dia_spmm: {applies[-1]}")
        side = 1536
        m = side * side
        data = random_x(torch, 5, m, f32, gen)
        x = random_x(torch, m, 16, f32, gen)
        for r in range(MESH_ND):
            rows.append(compare_halo_case(
                torch, spmm, f"bench mesh geometry, shard {r}",
                halo_shard(torch, data, (-side, -1, 0, 1, side), x, r,
                           MESH_ND)))
        del data, x
        halo_err = next(r["max_abs_err"] for r in rows
                        if r["m_loc"] == 16384 and r["s"] == 8
                        and r["dtype"] == "float64"
                        and r["case"].endswith("interior shard"))
        emit({"phase": "compare_halo", "cases": rows, "applies": applies,
              "all_ok": True, "wall_s": time.perf_counter() - t0})

    # ---- 14. timing of the halo kernel, halo_overhead_vs_plain
    halo_t = None
    if want("timing_halo"):
        t0 = time.perf_counter()
        floor = launch_floor_ms(torch)
        rows = [
            timing_halo_case(torch, spmm, "mesh solve shard f64 s=8", 16384,
                             solve_offsets, 8, f64, gen, 400, floor),
            timing_halo_case(torch, spmm, "bench mesh shard f32 s=16",
                             589824, (-1536, -1, 0, 1, 1536), 16, f32, gen,
                             50, floor),
        ]
        halo_t = rows[0]
        overhead = halo_overhead(torch, rt, spmm, em, gen, 50)
        emit({"phase": "timing_halo", "cases": rows, "overhead": overhead,
              "launch_floor_ms": floor, "smi": smi,
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    # ---- 15. the main path: the n = 65,536 f64 solve on the mesh
    launches = None
    if want("mesh_solve"):
        t0 = time.perf_counter()
        if solve_f64 is None:
            solve_f64, _ = run_solve(torch, rt, spmm, "solve_f64", 256, f64,
                                     OPTS64, True)
        out, _ = run_solve(torch, rt, spmm, "mesh_solve", 256, f64, OPTS64,
                           True, mesh=mesh)
        launches = out["dia_spmm_halo_launches"]
        ref_iters = solve_f64["iters"]
        out.update({"shards": MESH_ND,
                    "halo_launches_per_apply": launches / out["a_applies"],
                    "solve_f64_iters": ref_iters,
                    "iters_equal": out["iters"] == ref_iters,
                    "solve_f64_wall_s": solve_f64["wall_s"],
                    "wall_over_solve_f64": out["wall_s"]
                    / solve_f64["wall_s"],
                    "phase_wall_s": time.perf_counter() - t0})
        if abs(out["iters"] - ref_iters) > 0.01 * ref_iters:
            raise AssertionError(f"mesh_solve iterations differ from "
                                 f"solve_f64's by > 1%: {out}")
        emit(out)
        EAGER["mesh_solve"] = out

    # ---- 16. the ELL halo path in a solve
    if want("mesh_ell"):
        t0 = time.perf_counter()
        out = run_mesh_ell(torch, rt, em, mesh)
        out["phase_wall_s"] = time.perf_counter() - t0
        emit(out)

    # ---- 17. the distributed Schur operator and the CLI's --distributed
    if want("mesh_schur"):
        t0 = time.perf_counter()
        apply_row = run_schur_dist_apply(torch, rt, mesh, gen)
        torch.cuda.empty_cache()
        out = run_cli_schur(torch, spmm, em, 1e-4, side=MESH_CLI_SIDE,
                            extra=("--distributed",), label="mesh_schur")
        # again with the Schur route asked for, so that it runs on the
        # mesh too (S is tagged symmetric: the run above, and phases
        # 28 (b) and 29 (c), take eigh)
        route = run_cli_schur(torch, spmm, em, 1e-4, side=MESH_CLI_SIDE,
                              extra=("--distributed",),
                              label="mesh_schur_projected_schur",
                              solver={"projected_solver": "schur"})
        for run in (out, route):
            if run["distributed_operator"] != "DistributedSchurOperator":
                raise AssertionError(
                    f"{run['phase']}: the CLI's distributed operator is "
                    f"{run['distributed_operator']}")
        out.update({"distribute_schur": apply_row,
                    "schur_route_run": {k: route[k] for k in (
                        "projected_solver", "iters", "wall_s",
                        "s_per_iter", "project_solve_share",
                        "res_true_f64", "lambda1_rel_diff")},
                    "phase_wall_s": time.perf_counter() - t0})
        emit(out)
        EAGER["mesh_schur"] = out
    return launches, halo_err, halo_t


@contextlib.contextmanager
def full_capacity():
    """The eager solver with its state grown to the full capacity cap_kb
    before the first iteration, as ``solve(compiled=True)`` holds it (the
    eager path grows on a ladder, e.g. 144 -> 184 columns in solve_f64):
    the same iteration at the same shapes, so the compiled run can be
    held to it iteration for iteration."""
    from rails_tpu_torch.core.solver import LyapunovSolver

    init = LyapunovSolver._init_state

    def grown(self, m, *args, **kwargs):
        st, ctx = init(self, m, *args, **kwargs)
        self._grow_state(st, ctx.cap_kb)
        ctx.set_kb(ctx.cap_kb, m)
        return st, ctx

    LyapunovSolver._init_state = grown
    try:
        yield
    finally:
        LyapunovSolver._init_state = init


def compiled_stats(info):
    """What a ``solve(compiled=True)`` cost the host, per iteration: graph
    segments replayed, host reads (eigh host steps, the schur route's
    round trip, the restart-or-expand switch), our kernels' launches;
    the capture seconds and the recorded program's shape."""
    e = info.engine
    return {"engine_iterations": e["iterations"],
            "segments_per_iter": e["segments_per_iter"],
            "host_steps_per_iter": e["host_steps_per_iter"],
            "host_reads_per_iter": e["host_reads_per_iter"],
            "launches_per_iter": e["launches_per_iter"],
            "capture_s": e["capture_s"], "captured": e["captured"],
            "program": e["program"]}


def compare_eager(label, eager, comp, res_tol, res_key="res_true_f64",
                  ladder=None):
    """One case of a compiled phase: the eager run's and the compiled
    run's lines side by side; raises unless both converged, the compiled
    true residual is within ``res_tol`` and the iterations agree within
    1%.  ``eager`` is the eager run at full capacity where one was made;
    ``ladder`` then is the plain eager run (its capacity on the ladder),
    reported beside them."""
    case = {"case": label,
            "iters": {"eager": eager["iters"], "compiled": comp["iters"]},
            "status": {"eager": eager.get("status", 0),
                       "compiled": comp.get("status", 0)},
            "res_true_f64": {"eager": eager[res_key],
                             "compiled": comp[res_key]},
            "wall_s": {"eager": eager["wall_s"], "compiled": comp["wall_s"]},
            "s_per_iter": {"eager": eager["wall_s"] / eager["iters"],
                           "compiled": comp["wall_s"] / comp["iters"]},
            "max_memory_allocated": {
                "eager": eager.get("max_memory_allocated"),
                "compiled": comp.get("max_memory_allocated")}}
    case["speedup"] = case["wall_s"]["eager"] / case["wall_s"]["compiled"]
    for k in ("segments_per_iter", "host_steps_per_iter",
              "host_reads_per_iter", "launches_per_iter", "capture_s",
              "program"):
        if k in comp:
            case[k] = comp[k]
    if ladder is not None:
        case["eager_ladder"] = {k: ladder.get(k) for k in (
            "iters", "status", "wall_s", res_key, "max_memory_allocated")}
        case["ladder_iters_within_1pct"] = \
            abs(comp["iters"] - ladder["iters"]) <= 0.01 * ladder["iters"]
        case["speedup_over_ladder"] = ladder["wall_s"] / comp["wall_s"]
    ei, ci = eager["iters"], comp["iters"]
    case["iters_within_1pct"] = abs(ci - ei) <= 0.01 * ei
    if not comp.get("converged", True) or comp[res_key] > res_tol:
        raise AssertionError(f"compiled {label} missed its residual: {case}")
    if not case["iters_within_1pct"]:
        raise AssertionError(f"compiled {label}: iterations differ from the "
                             f"eager run's by more than 1%: {case}")
    return case


def graph_check(torch, spmm, em, gen):
    """One DIA apply (solve_f64's shape) and one ELL apply (the
    continuation shape, f32, s = 8) captured into a CUDA graph and
    replayed: equal to the eager launch, within the kernels' tolerance
    of the plain versions, and one launch counted per replay by the
    engine's bookkeeping (the wrapper counts once at capture)."""
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

    rows = []
    dia = random_dia(torch, 65536, 65536, (-256, -1, 0, 1, 256),
                     torch.float64, gen)
    ell = sparse_from_scipy(continuation_jacobian(CONT_SIDE, 0.05),
                            fmt="ell", dtype=torch.float32).fwd
    for name, fn, plain, payload, x in (
            ("dia_spmm", spmm.dia_spmm, spmm.dia_spmm_reference, dia,
             random_x(torch, 65536, 8, torch.float64, gen)),
            ("ell_spmm", em.ell_spmm, em.ell_spmm_reference, ell,
             random_x(torch, ell.shape[1], 8, torch.float32, gen))):
        eager = fn(payload, x)
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(payload, x)                  # warm-up on the capture stream
        torch.cuda.current_stream().wait_stream(stream)
        torch.cuda.synchronize()
        g = torch.cuda.CUDAGraph()
        before = fn.launches
        with torch.cuda.graph(g, stream=stream):
            y = fn(payload, x)
        counted_at_capture = fn.launches - before
        for _ in range(3):
            g.replay()
        torch.cuda.synchronize()
        ref = plain(payload, x)
        dt = str(x.dtype).replace("torch.", "")
        row = {"kernel": name, "dtype": dt, "s": 8,
               "replay_equals_eager": bool(torch.equal(y, eager)),
               "max_abs_err_vs_plain": (y - ref).abs().max().item(),
               "max_abs_y": ref.abs().max().item(),
               "counted_at_capture": counted_at_capture}
        rows.append(row)
        if not row["replay_equals_eager"] or row["max_abs_err_vs_plain"] \
                > TOL[dt] * row["max_abs_y"]:
            raise AssertionError(f"graph replay of {name} disagrees: {row}")
    return rows


def dia_branches_in_graph(torch, spmm, gen, reps=200):
    """Kernel #1 at solve_f64's shape (m = 65,536, s = 8, f64; L2-resident,
    as in the solver), both branches: ms per launch back to back from
    the host and replayed from one CUDA graph of ``reps`` launches
    (PERF.md section 7: does a graph keep the staged branch's ring warm
    enough to win at 2 tiles per block?)."""
    offsets = (-256, -1, 0, 1, 256)
    dia = random_dia(torch, 65536, 65536, offsets, torch.float64, gen)
    x = random_x(torch, 65536, 8, torch.float64, gen)
    auto = spmm.launch_plan(dia, x)
    out = {"m": 65536, "s": 8, "dtype": "float64",
           "auto": "staged" if auto.staged else "direct"}
    for branch in ("direct", "staged"):
        plan = spmm.dia_plan(offsets, 65536, 65536, 8, 8, auto.vec,
                             aligned=True, sms=spmm._sm_count(x.device),
                             branch=branch)

        def launches():
            for _ in range(reps):
                spmm.dia_spmm(dia, x, plan=plan)

        launches()
        torch.cuda.synchronize()
        e0, e1 = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        e0.record()
        launches()
        e1.record()
        torch.cuda.synchronize()
        eager_ms = e0.elapsed_time(e1) / reps
        stream = torch.cuda.Stream()
        stream.wait_stream(torch.cuda.current_stream())
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g, stream=stream):
            launches()
        g.replay()
        torch.cuda.synchronize()
        e0.record()
        g.replay()
        e1.record()
        torch.cuda.synchronize()
        out[branch] = {"eager_ms": eager_ms,
                       "graph_ms": e0.elapsed_time(e1) / reps,
                       "staged": plan.staged, "why": plan.why,
                       "tiles": plan.tiles, "grid": plan.grid}
    return out


# the calls the recorded iteration puts inside its graph segments
CAPTURED_CALLS = ("cholesky_ex", "solve_ex", "inv_ex", "slogdet",
                  "solve_triangular", "argsort", "randn_registered",
                  "nccl_all_gather")


def capture_audit():
    """``python3 -m rails_tpu_torch.capture_audit`` (one process per
    call): which calls capture, what eigh and a restart rotation cost.
    Raises if a call the recorded iteration captures does not capture,
    or if the registered generator repeats its draws across replays."""
    proc = subprocess.run([sys.executable, "-m",
                           "rails_tpu_torch.capture_audit"],
                          capture_output=True, text=True, timeout=900)
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode or not lines:
        raise RuntimeError(f"capture_audit failed: {proc.stdout[-2000:]}"
                           f"{proc.stderr[-2000:]}")
    out = json.loads(lines[-1])
    rows = {r["call"]: r for r in out["calls"]}
    bad = [c for c in CAPTURED_CALLS if not rows[c].get("captured")]
    if bad or not rows["randn_registered"].get("replays_draw_anew"):
        raise AssertionError(f"calls of the recorded iteration do not "
                             f"capture: {bad}: {out}")
    return out


def run_compiled_phases(torch, rt, spmm, em, wm, refine_mod, gen, only,
                        eager):
    """Phases 21-24: ``solve(compiled=True)`` on the card, each beside
    the eager run of the same problem (``eager``: the earlier phases'
    lines; a phase runs its own eager counterpart when that phase was
    skipped), those not in ``only`` skipped (None: all)."""
    def want(name):
        return only is None or name in only

    f32, f64 = torch.float32, torch.float64
    opts32 = dict(tol=1e-4, expand=6, restart_size=120, reduced_size=60,
                  maxit=200)

    # ---- 21. compiled_solve: solve_f64's and solve_f32's problems
    compiled_f64 = None
    if want("compiled_solve") or want("compiled_mesh"):
        t0 = time.perf_counter()
        cases = []
        for label, side, dtype, opts, rounded in (
                ("solve_f64", 256, f64, OPTS64, True),
                ("solve_f32", 64, f32, opts32, False)):
            if not want("compiled_solve") and label != "solve_f64":
                continue
            ladder = eager.get(label)
            if ladder is None:
                ladder, _ = run_solve(torch, rt, spmm, label, side, dtype,
                                      opts, rounded)
            with full_capacity():
                full, _ = run_solve(torch, rt, spmm, f"{label}_full_capacity",
                                    side, dtype, opts, rounded)
            comp, _ = run_solve(torch, rt, spmm, f"compiled_{label}", side,
                                dtype, opts, rounded, compiled=True)
            case = compare_eager(label, full, comp, 2 * opts["tol"],
                                 ladder=ladder)
            case["dia_spmm_launches"] = {"eager": full["dia_spmm_launches"],
                                         "compiled":
                                             comp["dia_spmm_launches"]}
            cases.append(case)
            if label == "solve_f64":
                compiled_f64 = (full, comp)
    if want("compiled_solve"):
        emit({"phase": "compiled_solve", "cases": cases,
              "capture_audit": capture_audit(),
              "graph_check": graph_check(torch, spmm, em, gen),
              "dia_branches_in_graph": dia_branches_in_graph(torch, spmm,
                                                             gen),
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    # ---- 22. compiled_mesh: mesh_solve through the recorded iteration
    if want("compiled_mesh"):
        t0 = time.perf_counter()
        mesh = rt.make_mesh(devices=["cuda:0"] * MESH_ND)
        ladder = eager.get("mesh_solve")
        if ladder is None:
            ladder, _ = run_solve(torch, rt, spmm, "mesh_solve", 256, f64,
                                  OPTS64, True, mesh=mesh)
        comp, _ = run_solve(torch, rt, spmm, "compiled_mesh_solve", 256,
                            f64, OPTS64, True, mesh=mesh, compiled=True)
        COMPILED["mesh_solve"] = comp
        # held to the unsharded eager run at full capacity (the mesh
        # computes the unsharded arithmetic bit for bit, PR 4)
        full, comp_f64 = compiled_f64
        case = compare_eager("mesh_solve", full, comp, 2 * OPTS64["tol"],
                             ladder=ladder)
        case.update({
            "compiled_solve_f64_iters": comp_f64["iters"],
            "iters_equal_compiled_solve_f64":
                comp["iters"] == comp_f64["iters"],
            "dia_spmm_halo_launches": {
                "eager": ladder["dia_spmm_halo_launches"],
                "compiled": comp["dia_spmm_halo_launches"]}})
        emit({"phase": "compiled_mesh", "shards": MESH_ND, "cases": [case],
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    # ---- 23. compiled_refined: refined_scale, every stage recorded
    if want("compiled_refined"):
        t0 = time.perf_counter()
        ref = eager.get("refined_scale")
        if ref is None:
            ref = run_refined_scale(torch, rt, spmm, refine_mod)
        comp = run_refined_scale(torch, rt, spmm, refine_mod, compiled=True)
        case = compare_eager("refined_scale", ref, comp, 2 * comp["tol"])
        case.update({"stage_iters": {"eager": ref["stage_iters"],
                                     "compiled": comp["stage_iters"]},
                     "stage_engines": comp["stage_engines"],
                     "dia_spmm_launches": {
                         "eager": ref["dia_spmm_launches"],
                         "compiled": comp["dia_spmm_launches"]}})
        emit({"phase": "compiled_refined", "cases": [case],
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    # ---- 24. compiled_continuation: one engine cache across the steps
    if want("compiled_continuation"):
        t0 = time.perf_counter()
        ref = eager.get("continuation_wide")
        if ref is None:
            ref = eager["continuation_wide"] = run_continuation_wide(
                torch, rt, em, wm)
        comp = run_continuation_wide(torch, rt, em, wm, compiled=True)
        COMPILED["continuation_wide"] = comp
        steps = []
        for r, c in zip(ref["steps"], comp["steps"]):
            step = {k: c[k] for k in (
                "theta", "k0", "segments_per_iter", "host_reads_per_iter",
                "launches_per_iter", "capture_s", "captured",
                "engine_cache_size", "wide_spmm_launches",
                "ell_spmm_launches")}
            step.update({"iters": {"eager": r["iters"],
                                   "compiled": c["iters"]},
                         "converged": {"eager": r["converged"],
                                       "compiled": c["converged"]},
                         "res_true_f64": {"eager": r["res_true_f64"],
                                          "compiled": c["res_true_f64"]},
                         "wall_s": {"eager": r["wall_s"],
                                    "compiled": c["wall_s"]}})
            steps.append(step)
        sizes = [st["engine_cache_size"] for st in steps]
        out = {"phase": "compiled_continuation", "steps": steps,
               "engine_cache_sizes": sizes,
               "warm_step_recaptured": any(st["captured"]
                                           for st in steps[2:]),
               "max_memory_allocated": {
                   "eager": ref["max_memory_allocated"],
                   "compiled": comp["max_memory_allocated"]},
               "wall_s": time.perf_counter() - t0}
        if sizes != [1, 2, 2] or out["warm_step_recaptured"]:
            raise AssertionError(f"compiled_continuation: the third step "
                                 f"did not replay the second's engine: "
                                 f"{out}")
        emit(out)


# ----------------------------------------------------------------------
# phases 25-27: compiled=True with host steps in the operator and inv_a,
# the ported examples, the continuation's steps at full capacity
# ----------------------------------------------------------------------
CLI_OPTS = dict(tol=1e-4, expand=8, restart_size=160, reduced_size=80,
                maxit=3000)   # cli_schur's parameters (run_cli_schur)


def run_schur_solve(torch, rt, em, label, side, a11, compiled, sinv=None,
                    route="auto"):
    """The side-``side`` Laplacian DAE (``laplacian_dae``) reduced by
    ``schur_reduce(a11_solver=a11)`` at float64 and solved through
    ``rt.LyapunovSolver(red.operator, red.bs, red.ms).solve()`` with
    cli_schur's parameters, compiled or eager (``sinv``:
    ``inv_a=red.sinv(sinv)`` with projection_method 2.2; ``route``: the
    projected_solver option); counts reset just before the solve, read
    just after.  Raises unless it converged with the f64 true residual
    of the reduced equation (S through scipy's splu of A11) <= 2 tol and
    launched the ELL kernel."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    a, md, b = laplacian_dae(side)
    t0 = time.perf_counter()
    red = rt.schur_reduce(a, sp.diags(md).tocsr(), b, a11_solver=a11,
                          dtype=torch.float64)
    reduce_s = time.perf_counter() - t0
    kw = {} if sinv is None else {"inv_a": red.sinv(sinv),
                                  "projection_method": 2.2}
    solver = rt.LyapunovSolver(red.operator, red.bs, red.ms,
                               projected_solver=route, **CLI_OPTS, **kw)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    em.ell_spmm.launches = 0
    t0 = time.perf_counter()
    v, t, info = solver.solve(compiled=compiled)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = em.ell_spmm.launches
    peak = torch.cuda.max_memory_allocated()
    _, i2, blk = schur_blocks(a, md)
    lu = spla.splu(blk["A11"].tocsc())
    res_true = schur_residual(blk, lu, md[i2], b[i2],
                              v.detach().cpu().double().numpy(),
                              t.detach().cpu().double().numpy())
    out = {"case": label, "n": a.shape[0], "n1": red.n1, "n2": red.n2,
           "a11_solver": a11, "inv_a": sinv, "compiled": compiled,
           "s_symmetric": red.operator.is_symmetric,
           "projected_solver": solver._resolve_lyap_method()[0],
           "iters": info.iter, "status": info.status,
           "converged": info.status == 0, "res": info.res,
           "rank": int(v.shape[1]), "res_true_f64": res_true,
           "tol": CLI_OPTS["tol"], "wall_s": wall,
           "s_per_iter": wall / max(info.iter, 1), "reduce_s": reduce_s,
           "max_memory_allocated": peak, "ell_spmm_launches": launches,
           "ell_launches_per_iter": launches / max(info.iter, 1)}
    if compiled:
        out.update(compiled_stats(info))
        out["switch_reads_per_iter"] = \
            info.engine["switch_reads"] / max(info.iter, 1)
        out["host_step_sources"] = info.engine["host_step_sources"]
    if info.status != 0 or res_true > 2 * CLI_OPTS["tol"]:
        raise AssertionError(f"{label} did not converge to 2 tol: {out}")
    if launches <= 0:
        raise AssertionError(f"{label} never launched ell_spmm: {out}")
    return out


def run_example(name, timeout=300):
    """``python examples/<name>`` on the card as a subprocess of this
    script; raises unless it exits 0.  Returns (stdout, wall s)."""
    here = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable,
                           os.path.join(here, "examples", name)],
                          cwd=here, capture_output=True, text=True,
                          timeout=timeout)
    wall = time.perf_counter() - t0
    if proc.returncode:
        raise AssertionError(f"examples/{name} exited {proc.returncode}: "
                             f"{proc.stdout[-2000:]}{proc.stderr[-3000:]}")
    return proc.stdout, wall


def run_examples():
    """Phase 26: both ported examples on the card: the continuation's
    cold, warm and resumed counts (warm < cold), the Schur example's
    distributed and single-controller counts, its true residual and its
    ``ok``."""
    text, wall = run_example("continuation_sequence_torch.py")
    rows = [ln.split() for ln in text.splitlines()
            if re.match(r"^\s*\d+\.\d\d\s+\d+\s", ln)]
    steps = [{"theta": float(r[0]), "iters": int(r[1]),
              "res": float(r[2]), "wall_s": float(r[3].rstrip("s"))}
             for r in rows]
    mt = re.search(r"checkpoint: (\d+) iterations", text)
    cont = {"example": "continuation_sequence_torch.py", "steps": steps,
            "resumed_iters": int(mt.group(1)) if mt else None,
            "process_wall_s": wall}
    cold = steps[0]["iters"] if steps else None
    if len(steps) != 3 or cont["resumed_iters"] is None or any(
            s["iters"] >= cold for s in steps[1:]) \
            or cont["resumed_iters"] >= cold:
        raise AssertionError(f"continuation example: warm steps not "
                             f"faster than the cold one: {cont} {text}")
    text, wall = run_example("distributed_schur_torch.py")

    def grab(pattern, cast=int):
        mt = re.search(pattern, text)
        return cast(mt.group(1)) if mt else None

    schur = {"example": "distributed_schur_torch.py",
             "n1": grab(r"n1=(\d+)"), "n2": grab(r"n2=(\d+)"),
             "distributed_iters": grab(r"distributed solve: (\d+)"),
             "single_iters": grab(r"single-controller:\s+(\d+)"),
             "res_true": grab(r"true relative residual: (\S+)", float),
             "operator": grab(r"distributed operator: (\w+)", str),
             "ok": text.strip().splitlines()[-1] == "ok",
             "process_wall_s": wall}
    if not schur["ok"] or schur["distributed_iters"] != \
            schur["single_iters"] or not schur["res_true"] < 1e-7:
        raise AssertionError(f"distributed Schur example failed: {schur} "
                             f"{text}")
    return [cont, schur]


def run_slice_phases(torch, rt, em, wm, only, eager):
    """Phases 25-27, those not in ``only`` skipped (None: all).  Returns
    the ELL launches of phase 25's compiled native_lu solve (None when
    skipped)."""
    def want(name):
        return only is None or name in only

    launches = None
    # ---- 25. compiled_schur: native_lu's host A11 solves as host steps
    if want("compiled_schur"):
        t0 = time.perf_counter()
        cases = []
        for label, side, sinv, route in (
                ("native_lu", CLI_SIDE, None, "auto"),
                ("native_lu_projected_schur", CLI_SIDE, None, "schur"),
                ("inv_a_native_lu", MESH_CLI_SIDE, "native_lu", "auto")):
            with full_capacity():
                full = run_schur_solve(torch, rt, em, f"{label}_eager_full",
                                       side, "native_lu", False, sinv,
                                       route)
            comp = run_schur_solve(torch, rt, em, f"{label}_compiled", side,
                                   "native_lu", True, sinv, route)
            want_route = "eigh" if route == "auto" else route
            if not comp["s_symmetric"] or \
                    comp["projected_solver"] != want_route:
                raise AssertionError(f"compiled_schur {label}: S untagged "
                                     f"or not the {want_route} route: "
                                     f"{comp}")
            case = compare_eager(label, full, comp, 2 * CLI_OPTS["tol"])
            case.update({
                "side": side, "n": comp["n"], "n1": comp["n1"],
                "n2": comp["n2"], "projected_solver": comp["projected_solver"],
                "iters_equal": comp["iters"] == full["iters"],
                "switch_reads_per_iter": comp["switch_reads_per_iter"],
                "host_step_sources": comp["host_step_sources"],
                "ell_spmm_launches": {"eager": full["ell_spmm_launches"],
                                      "compiled": comp["ell_spmm_launches"]},
                "ell_launches_per_iter": {
                    "eager": full["ell_launches_per_iter"],
                    "compiled": comp["ell_launches_per_iter"]},
                "reduce_s": comp["reduce_s"]})
            if label == "native_lu":
                launches = comp["ell_spmm_launches"]
                cli = eager.get("cli_schur")
                if cli is not None:
                    case["cli_schur_dense_lu_eager"] = {
                        k: cli[k] for k in ("iters", "wall_s",
                                            "s_per_iter", "res_true_f64")}
                    case["speedup_over_cli_schur"] = \
                        cli["wall_s"] / comp["wall_s"]
            cases.append(case)
        emit({"phase": "compiled_schur", "cases": cases,
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()

    # ---- 26. examples: the two ported examples on the card
    if want("examples"):
        t0 = time.perf_counter()
        emit({"phase": "examples", "runs": run_examples(),
              "wall_s": time.perf_counter() - t0})

    # ---- 27. the continuation's steps at full capacity, eager
    if want("continuation_full_capacity"):
        t0 = time.perf_counter()
        ladder = eager.get("continuation_wide")
        if ladder is None:
            ladder = run_continuation_wide(torch, rt, em, wm)
        comp = COMPILED.get("continuation_wide")
        if comp is None:
            comp = run_continuation_wide(torch, rt, em, wm, compiled=True)
        with full_capacity():
            full = run_continuation_wide(torch, rt, em, wm)
        steps = [{"theta": c["theta"],
                  "iters": {"eager_ladder": e["iters"],
                            "eager_full_capacity": f["iters"],
                            "compiled": c["iters"]},
                  "res_true_f64": {"eager_full_capacity": f["res_true_f64"],
                                   "compiled": c["res_true_f64"]},
                  "wall_s": {"eager_full_capacity": f["wall_s"],
                             "compiled": c["wall_s"]},
                  "compiled_equals_full_capacity": c["iters"] == f["iters"]}
                 for e, f, c in zip(ladder["steps"], full["steps"],
                                    comp["steps"])]
        emit({"phase": "continuation_full_capacity", "steps": steps,
              "all_steps_equal": all(st["compiled_equals_full_capacity"]
                                     for st in steps),
              "wall_s": time.perf_counter() - t0})
        torch.cuda.empty_cache()
    return launches


# ---------------------------------------------------------------------------
# phase 28: the row mesh across processes (parallel/comm.py, multihost.py)
# ---------------------------------------------------------------------------
# (a): processes at mesh_solve's n, one shard each.  4 took 240.7 s on
# the H100 (770 iterations of 79 collectives, ~4 ms each with the
# compute: four processes' gloo rounds and syncs on one shared card),
# above the 150 s this phase allows itself, so 2 (PERF.md §6)
MP_RANKS = 2
MP_CLI_RANKS = 2      # (b): processes of the CLI's distributed Schur path
MP_TIMEOUT_S = 600    # a worker's limit; a collective's own limit is 300 s
# The iteration count moves with the rounding of the row sums: scaling
# mesh_solve's B by 1 +- 1e-15 moves the one-process count from 742 to
# 718 and 775, and the capacity ladder's padding moves it to 811
# (PERF.md §6).  So a run whose sums round otherwise (each rank sums its
# rows, then the ranks' partials) is held to the one-process run's
# residual history over its first RESVEC_HEAD iterations, where the
# trajectories have not yet parted, to MP_HISTORY_RTOL, and its count to
# within MP_ITER_BAND of the one-process count (the spread seen, -3.2% to
# +9.3%, with room); the spread is measured again under ``--only
# multiprocess`` (``rounding_spread``), and not in a whole run, which
# phase 29 would otherwise take past 650 s.
RESVEC_HEAD = 10
MP_HISTORY_RTOL = 1e-8
MP_ITER_BAND = 0.15


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def collective_costs(torch, comm, reps=200):
    """Mean µs of what one row reduction of the solve costs, on this
    rank: a small host tensor's allgather through the backend alone, a
    device sync after a small kernel alone, and the whole staged
    ``RowComm.allreduce`` of a small device tensor (the last two only on
    a card)."""
    from rails_tpu_torch.parallel.comm import RowComm

    dev = comm.device
    host = RowComm(comm.group, comm.rank, comm.world, "cpu", comm.backend)
    x = torch.ones(200, dtype=torch.float64)
    xd = x.to(dev)
    cases = {}
    if comm.backend == "gloo":
        cases["allgather_host_tensor"] = lambda: host.allreduce(x)
    if dev.type == "cuda":
        cases["sync_after_small_kernel"] = lambda: (xd * 2).sum().item()
        cases["staged_allreduce"] = lambda: comm.allreduce(xd).sum().item()
    out = {}
    saved = dataclasses.replace(comm.stats)
    for name, fn in cases.items():
        for _ in range(10):
            fn()
        comm.barrier()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out[name] = (time.perf_counter() - t0) / reps * 1e6
    comm.stats = saved
    return out


def mesh_solve_problem(torch, rt, dev, side=256):
    """mesh_solve's problem (phase 15) on ``dev``: (lap, md, b, A, M)."""
    from rails_tpu_torch.models.problems import laplacian2_sparse

    n = side * side
    rng = np.random.default_rng(0)
    lap = laplacian2_sparse(side)
    # phase_scale builds M and B at float32 (run_solve's rounded inputs)
    md = rng.uniform(0.5, 1.5, n).astype(np.float32).astype(np.float64)
    b = rng.uniform(0, 1, (n, 8)).astype(np.float32).astype(np.float64)
    aop = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                               is_symmetric=True, device=dev)
    mop = rt.DiagonalOperator(torch.from_numpy(md).to(dev, torch.float64),
                              device=dev)
    return lap, md, b, aop, mop


def halo_kernel_check(torch, spmm, solver, mesh, seed, dev):
    """Kernel #3 on this rank's shard (the solver's own payload), a
    random x of its rows and the halos from the neighbouring ranks
    (zeros at the mesh's ends), against its plain version: (max |dy|,
    max |y|)."""
    from rails_tpu_torch.parallel.halo_spmm import process_halos

    f64 = torch.float64
    shard = solver.A._fwd_shards[0]
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.rand((shard.data.shape[1], 8), generator=gen, dtype=f64,
                   device=dev)
    span = max(abs(o) for o in shard.offsets)
    hl, hh = process_halos(x, span, span, mesh)
    zeros = torch.zeros((span, 8), dtype=f64, device=dev)
    hl = zeros if hl is None else hl
    hh = zeros if hh is None else hh
    y = spmm.dia_spmm_halo(shard.data, shard.offsets_t, x, hl, hh,
                           offsets=shard.offsets)
    sync(torch, dev)
    ref = spmm.dia_spmm_halo_reference(shard.data, shard.offsets_t, x, hl,
                                       hh)
    return (y - ref).abs().max().item(), ref.abs().max().item()


def mp_solve_worker(coordinator, pid, nproc, out_path, device, backend,
                    side=256):
    """Phase 28 (a) in one worker process: mesh_solve's problem (phase 15)
    on the multi-process mesh, this rank one shard of it.  Counts reset
    just before ``solve()`` and read just after; then kernel #3 on this
    rank's shard, its halos from the neighbouring ranks, against its plain
    version; rank 0 holds the gathered V's f64 true residual.  Writes
    this rank's line as JSON to ``out_path``."""
    import torch

    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.sparse import spmm

    comm = multihost.initialize(coordinator, nproc, pid, device=device,
                                backend=backend, timeout_s=300)
    mesh = rt.make_mesh()
    dev = comm.device
    lap, md, b, aop, mop = mesh_solve_problem(torch, rt, dev, side)
    solver = rt.LyapunovSolver(aop, b, mop, dtype=torch.float64, mesh=mesh,
                               **OPTS64)
    applies = count_applies(solver.A)
    walls = []
    sync(torch, dev)
    calls0, bytes0, staged0 = (comm.stats.calls, comm.stats.bytes,
                               comm.stats.staged_bytes)
    spmm.dia_spmm.launches = 0
    spmm.dia_spmm_halo.launches = 0
    t0 = time.perf_counter()
    v, t, info = solver.solve(
        progress=lambda it, wall, res: walls.append(wall))
    sync(torch, dev)
    wall = time.perf_counter() - t0
    halo_launches = spmm.dia_spmm_halo.launches
    dia_launches = spmm.dia_spmm.launches
    iters = max(info.iter, 1)
    calls = comm.stats.calls - calls0
    sent = comm.stats.bytes - bytes0
    staged = comm.stats.staged_bytes - staged0
    half = len(walls) // 2
    per_it = (walls[-1] - walls[half]) / max(1, len(walls) - 1 - half)
    err, scale = halo_kernel_check(torch, spmm, solver, mesh, 100 + pid,
                                   dev)
    vfull = comm.gather_rows(v)
    costs = collective_costs(torch, comm)
    out = {"rank": pid, "processes": nproc, "backend": comm.backend,
           "device": str(dev), "shards": mesh.size,
           "local_rows": int(v.shape[0]), "iters": info.iter,
           "status": info.status, "res": info.res, "rank_v": int(v.shape[1]),
           "wall_s": wall, "s_per_iter": wall / iters,
           "s_per_iter_second_half": per_it,
           "collectives": calls, "collectives_per_iter": calls / iters,
           "bytes_sent_per_iter": sent / iters,
           "host_staged_bytes_per_iter": staged / iters,
           "a_applies": applies[0], "dia_spmm_halo_launches": halo_launches,
           "dia_spmm_launches": dia_launches,
           "halo_launches_per_apply": halo_launches / max(applies[0], 1),
           "halo_kernel_max_abs_err": err, "halo_kernel_max_abs_y": scale,
           "halo_kernel_ok": err <= TOL["float64"] * scale,
           "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
           if dev.type == "cuda" else None, "tol": OPTS64["tol"],
           "resvec_head": [float(r) for r in info.resvec[:RESVEC_HEAD]],
           "collective_costs_us": costs}
    if vfull is not None:
        out["res_true_f64"] = true_residual(lap, md, b, vfull, t,
                                            np.random.default_rng(0))
    multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def mp_cli_worker(coordinator, pid, nproc, out_path, directory):
    """Phase 28 (b) in one worker process: ``rails_tpu_torch.cli.main``
    with ``--distributed --num-processes`` on the DAE in ``directory``
    (the backend from ``RAILS_DIST_BACKEND``); kernel #4's launches
    counted from just before ``main`` to just after."""
    import torch

    from rails_tpu_torch import cli
    from rails_tpu_torch.sparse import ell_spmm as em

    buf = io.StringIO()
    em.ell_spmm.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = cli.main([directory, "--x64", "--params",
                       os.path.join(directory, "params.json"),
                       "--distributed", "--coordinator", coordinator,
                       "--num-processes", str(nproc), "--process-id",
                       str(pid)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = em.ell_spmm.launches
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
        table.append(float(parts[0]))

    def grab(pattern):
        mt2 = re.search(pattern, text)
        return mt2.group(1) if mt2 else None

    out = {"rank": pid, "rc": rc, "converged": mt.group(1) == "converged",
           "iters": int(mt.group(2)), "res": float(mt.group(3)),
           "rank_v": int(mt.group(4)), "wall_s": wall,
           "eig_table": table, "ell_spmm_launches": launches,
           "distributed_run": grab(r"(Distributed run: [^\n]*)"),
           "distributed_operator": grab(r"Distributed operator: (\w+)"),
           "collectives": grab(r"(Collectives: [^\n]*)"),
           "wrote_vt": "Wrote V.mtx and T.mtx" in text}
    with open(out_path, "w") as f:
        json.dump(out, f)


def worker_main(argv):
    """``chip_smoke.py --worker solve|cli|compiled|nccl1 COORDINATOR PID
    NPROC OUT ...``: one process of phase 28 (``run_multiprocess``) or
    phase 29 (``run_multiprocess_compiled``)."""
    kind, coordinator, pid, nproc, out_path, *rest = argv
    if kind in ("solve", "compiled"):
        device, backend = rest
        worker = mp_solve_worker if kind == "solve" else mpc_worker
        worker(coordinator, int(pid), int(nproc), out_path,
               None if device == "auto" else device, backend)
    elif kind == "cli":
        mp_cli_worker(coordinator, int(pid), int(nproc), out_path, rest[0])
    elif kind == "nccl1":
        mpc_nccl_worker(coordinator, out_path)
    else:
        raise SystemExit(f"unknown worker {kind!r}")


def start_workers(kind, nproc, out_dir, extra, env_extra=None,
                  timeout=MP_TIMEOUT_S):
    """Run ``nproc`` workers of this script and wait for all; raises
    unless every one exits 0 (any left are killed).  Returns their JSON
    lines."""
    coordinator = f"127.0.0.1:{free_port()}"
    env = dict(os.environ)
    env.update({"OMP_NUM_THREADS": "1", **(env_extra or {})})
    here = os.path.abspath(__file__)
    paths = [os.path.join(out_dir, f"{kind}.r{pid}.json")
             for pid in range(nproc)]
    procs = [subprocess.Popen(
        [sys.executable, here, "--worker", kind, coordinator, str(pid),
         str(nproc), paths[pid], *extra], cwd=os.path.dirname(here),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env)
        for pid in range(nproc)]
    results = []
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            results.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    bad = [(pid, rc, out[-1500:], err[-3000:])
           for pid, (rc, out, err) in enumerate(results) if rc != 0]
    if bad:
        raise AssertionError(f"multiprocess: {kind} workers failed "
                             f"(rank, rc, stdout, stderr): {bad}")
    lines = []
    for path in paths:
        with open(path) as f:
            lines.append(json.load(f))
    return lines


def mp_solve_summary(ranks, ref, label):
    """Phase 28 (a)'s line from its ranks' lines, held against phase 15's
    eager run ``ref``."""
    r0 = ranks[0]
    it = {r["iters"] for r in ranks}
    head = np.asarray(ref["resvec_head"])
    mine = np.asarray(r0["resvec_head"])[:head.size]
    out = {"case": label, "processes": r0["processes"],
           "backend": r0["backend"], "device": r0["device"],
           "shards": r0["shards"], "ranks": ranks, "iters": r0["iters"],
           "iters_equal_across_ranks": len(it) == 1,
           "resvec_head_max_rel_diff": float(
               np.max(np.abs(mine - head) / np.abs(head)))
           if mine.size == head.size else None,
           "res_true_f64": r0.get("res_true_f64"), "tol": r0["tol"],
           "wall_s": max(r["wall_s"] for r in ranks),
           "s_per_iter": max(r["s_per_iter"] for r in ranks),
           "collectives_per_iter": r0["collectives_per_iter"],
           "host_staged_bytes_per_iter": r0["host_staged_bytes_per_iter"],
           "mesh_solve_iters": ref["iters"],
           "mesh_solve_wall_s": ref["wall_s"]}
    out["wall_over_mesh_solve"] = out["wall_s"] / ref["wall_s"]
    faults = []
    if len(it) != 1 or any(r["status"] != 0 for r in ranks):
        faults.append("iterations or status differ across ranks, or not "
                      "converged")
    if out["resvec_head_max_rel_diff"] is None or \
            out["resvec_head_max_rel_diff"] > MP_HISTORY_RTOL:
        faults.append(f"the first {RESVEC_HEAD} residual estimates differ "
                      f"from mesh_solve's by more than {MP_HISTORY_RTOL}")
    if abs(out["iters"] - ref["iters"]) > MP_ITER_BAND * ref["iters"]:
        faults.append(f"iterations more than {MP_ITER_BAND:.0%} from "
                      f"mesh_solve's")
    if out["res_true_f64"] is None or out["res_true_f64"] > 2 * out["tol"]:
        faults.append("true residual above 2 tol")
    for r in ranks:
        if r["dia_spmm_launches"] != 0 or r["a_applies"] <= 0 or \
                r["dia_spmm_halo_launches"] != r["a_applies"]:
            faults.append(f"rank {r['rank']}: A's applies did not go "
                          f"through one halo-kernel launch each")
        if not r["halo_kernel_ok"]:
            faults.append(f"rank {r['rank']}: kernel #3 disagrees with its "
                          f"plain version on the rank's shard")
    if faults:
        raise AssertionError(f"multiprocess {label}: {faults}: {out}")
    return out


def run_multiprocess(torch, rt, spmm, em, only, eager):
    """Phase 28: (a) mesh_solve on MP_RANKS processes of cuda:0 over gloo;
    (b) the CLI's distributed Schur path on MP_CLI_RANKS processes; (c)
    (a) over NCCL where the cards reach the rank count.  Returns each
    rank's launches of kernels #3 (in (a)) and #4 (in (b)), or None when
    the phase is skipped."""
    if not (only is None or "multiprocess" in only):
        return None
    import scipy.sparse as sp

    from rails_tpu_torch import io as rio

    t_phase = time.perf_counter()
    mesh = rt.make_mesh(devices=["cuda:0"] * MESH_ND)
    ref = eager.get("mesh_solve")
    if ref is None:   # phase 15 was skipped: run it here
        ref, _ = run_solve(torch, rt, spmm, "mesh_solve", 256,
                           torch.float64, OPTS64, True, mesh=mesh)
    # the count's spread under rounding-level changes of the one-process
    # run's input (see MP_ITER_BAND), under --only only
    spread = {"b_scale": [1.0], "iters": [ref["iters"]]}
    for scale in () if only is None else (1.0 + 1e-15, 1.0 - 1e-15):
        o, _ = run_solve(torch, rt, spmm, "mesh_solve_b_scaled", 256,
                         torch.float64, OPTS64, True, mesh=mesh,
                         b_scale=scale)
        spread["b_scale"].append(scale)
        spread["iters"].append(o["iters"])
    torch.cuda.empty_cache()
    cases = []
    note = ("all ranks on cuda:0 over gloo (NCCL refuses two ranks on one "
            "card): CUDA tensors staged through pinned host buffers")
    with tempfile.TemporaryDirectory() as d:
        # ---- (a)
        t0 = time.perf_counter()
        ranks = start_workers("solve", MP_RANKS, d, ["cuda:0", "gloo"])
        case_a = mp_solve_summary(ranks, ref, "a: mesh_solve, gloo")
        case_a["phase_wall_s"] = time.perf_counter() - t0
        cases.append(case_a)
        MULTIPROCESS["a"] = case_a
        # ---- (b)
        t0 = time.perf_counter()
        ref_b = eager.get("mesh_schur")
        if ref_b is None:   # phase 17 was skipped: its (b) here
            ref_b = run_cli_schur(torch, spmm, em, 1e-4, side=MESH_CLI_SIDE,
                                  extra=("--distributed",),
                                  label="mesh_schur")
        a, md, b = laplacian_dae(MESH_CLI_SIDE)
        prob = os.path.join(d, "dae")
        os.makedirs(prob)
        rio.write_matrix_market(os.path.join(prob, "A.mtx"), a)
        rio.write_matrix_market(os.path.join(prob, "M.mtx"),
                                sp.diags(md).tocsr())
        rio.write_matrix_market(os.path.join(prob, "B.mtx"),
                                sp.csr_matrix(b))
        with open(os.path.join(prob, "params.json"), "w") as f:
            json.dump({"Lyapunov Solver": {
                "Tolerance": 1e-4, "Maximum iterations": 3000,
                "Expand size": 8, "Restart size": 160,
                "Reduced size": 80}}, f)
        ranks_b = start_workers("cli", MP_CLI_RANKS, d, [prob],
                                {"RAILS_DIST_BACKEND": "gloo"})
        v = rio.read_matrix_market(os.path.join(prob, "V.mtx"))
        t = rio.read_matrix_market(os.path.join(prob, "T.mtx"))
        res_true, _ = host_schur(a, md, b, v, t)
        tab = np.asarray(ranks_b[0]["eig_table"])
        tab1 = np.asarray([row[0] for row in ref_b["eig_table"]])
        case_b = {"case": "b: CLI --distributed, DistributedSchurOperator",
                  "processes": MP_CLI_RANKS, "side": MESH_CLI_SIDE,
                  "ranks": ranks_b, "iters": ranks_b[0]["iters"],
                  "mesh_schur_iters": ref_b["iters"],
                  "res_true_f64": res_true, "tol": 1e-4,
                  "eig_table_max_rel_diff": float(
                      np.abs(tab - tab1).max() / abs(tab1[0]))
                  if tab.shape == tab1.shape else None,
                  "wall_s": max(r["wall_s"] for r in ranks_b),
                  "mesh_schur_wall_s": ref_b["wall_s"],
                  "phase_wall_s": time.perf_counter() - t0}
        faults = []
        if any(r["distributed_operator"] != "DistributedSchurOperator"
               or not r["converged"] for r in ranks_b):
            faults.append("not a converged DistributedSchurOperator run")
        if len({r["iters"] for r in ranks_b}) != 1 or abs(
                case_b["iters"] - ref_b["iters"]) > \
                MP_ITER_BAND * ref_b["iters"]:
            faults.append(f"iterations differ across ranks or by more than "
                          f"{MP_ITER_BAND:.0%} from mesh_schur's")
        if case_b["eig_table_max_rel_diff"] is None or \
                case_b["eig_table_max_rel_diff"] > 1e-6 or any(
                    r["eig_table"] != ranks_b[0]["eig_table"]
                    for r in ranks_b):
            faults.append("eigenvalue tables differ")
        if res_true > 2e-4 or [r["wrote_vt"] for r in ranks_b] != \
                [True] + [False] * (MP_CLI_RANKS - 1):
            faults.append("true residual above 2 tol, or not rank 0 alone "
                          "wrote V/T")
        if any(r["ell_spmm_launches"] <= 0 for r in ranks_b):
            faults.append("a rank never launched ell_spmm")
        if faults:
            raise AssertionError(f"multiprocess (b): {faults}: {case_b}")
        cases.append(case_b)
        # ---- (c)
        cards = torch.cuda.device_count()
        if cards >= MP_RANKS:
            t0 = time.perf_counter()
            ranks_c = start_workers("solve", MP_RANKS, d, ["auto", "nccl"])
            case_c = mp_solve_summary(ranks_c, ref, "c: mesh_solve, nccl")
            case_c["phase_wall_s"] = time.perf_counter() - t0
            cases.append(case_c)
            c_note = None
        else:
            c_note = (f"(c) not run: {cards} card(s) for {MP_RANKS} ranks; "
                      f"NCCL needs a card per rank")
            print(c_note, flush=True)
    emit({"phase": "multiprocess", "note": note, "c_not_run": c_note,
          "rounding_spread": spread, "iter_band": MP_ITER_BAND,
          "cases": cases, "wall_s": time.perf_counter() - t_phase})
    return {"dia_spmm_halo": [r["dia_spmm_halo_launches"] for r in ranks],
            "ell_spmm": [r["ell_spmm_launches"] for r in ranks_b]}


# ----------------------------------------------------------------------
# phase 29: solve(compiled=True) across processes
# ----------------------------------------------------------------------
MPC_MAXIT_A = 60     # (a): the iterations held to eager bit for bit
MPC_AUDIT = ("nccl_all_gather", "gloo_all_gather_staged")


def ranks_agree(torch, comm, *arrays):
    """Whether every rank holds the same bits of ``arrays`` (an
    allgather of 8 bytes of their hash)."""
    import hashlib

    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    d = torch.from_numpy(np.frombuffer(h.digest()[:8], dtype=np.int64)
                         .copy()).to(comm.device)
    got = comm.allgather_many([d])[0]
    return bool((got == got[0]).all())


def info_bits(v, t, info):
    """What every rank must hold bit for bit: T, the counts, res and
    resvec."""
    return (t.detach().cpu().numpy(),
            np.array([info.iter, info.status, info.mvps, v.shape[1]]),
            np.array([info.res]), np.asarray(info.resvec))


def program_collectives(prog):
    """(captured, host-step) collective calls of one pass through a
    recorded program (``engine.describe``), its switch branches
    included; (0, 0) where nothing was recorded."""
    if prog is None:
        return 0, 0
    cap, host = prog["captured_collectives"], prog["host_collectives"]
    for br in prog["branches"]:
        c, h = program_collectives(br)
        cap, host = cap + c, host + h
    return cap, host


def engine_line(info, comm_delta=(0, 0, 0)):
    """A compiled run's costs per iteration, the collectives' route and
    counts among them: the calls, bytes sent and bytes staged that
    ``comm.stats`` gained over the solve (``comm_delta``; replayed
    segments add their captured calls there, and the chunk reads' rank
    checks and the set-up count too), and the recorded program's split
    into captured and host-step collectives."""
    e = info.engine
    n = max(info.iter, 1)
    captured, host = program_collectives(e["program"])
    return {**{k: e[k] for k in (
        "collective_route", "segments_per_iter", "host_steps_per_iter",
        "host_reads_per_iter", "launches_per_iter", "capture_s",
        "captured", "program")},
        "collectives_per_iter": comm_delta[0] / n,
        "collective_bytes_per_iter": comm_delta[1] / n,
        "staged_bytes_per_iter": comm_delta[2] / n,
        "program_captured_collectives": captured,
        "program_host_collectives": host}


def comm_counts(mesh):
    """The mesh's communicator's (calls, bytes, staged bytes) so far;
    zeros in one process."""
    return (0, 0, 0) if mesh.comm is None else mesh.comm.stats.counts()


def mpc_against_eager(torch, rt, mesh, dev, opts, problem):
    """(a) and (d): the problem through ``solve(compiled=True)`` and
    through the eager solver at full capacity on these ranks: both
    ways' iterations, status and wall, whether they are the same bits
    (iterations, resvec, T, this rank's V), and the compiled run's
    costs."""
    _, _, b, aop, mop = problem
    runs = []
    for compiled in (True, False):
        solver = rt.LyapunovSolver(aop, b, mop, dtype=torch.float64,
                                   mesh=mesh, **opts)
        sync(torch, dev)
        c0 = comm_counts(mesh)
        t0 = time.perf_counter()
        if compiled:
            out = solver.solve(compiled=True)
        else:
            with full_capacity():
                out = solver.solve()
        sync(torch, dev)
        runs.append((out, time.perf_counter() - t0,
                     tuple(a - b for a, b in zip(comm_counts(mesh), c0))))
    ((vc, tc, ic), wc, dc), ((ve, te, ie), we, _) = runs
    return {"iters": {"compiled": ic.iter, "eager": ie.iter},
            "status": {"compiled": ic.status, "eager": ie.status},
            "wall_s": {"compiled": wc, "eager": we},
            "s_per_iter": {"compiled": wc / max(ic.iter, 1),
                           "eager": we / max(ie.iter, 1)},
            "same_bits": bool(
                ic.iter == ie.iter and ic.status == ie.status
                and np.array_equal(ic.resvec, ie.resvec)
                and torch.equal(tc, te) and torch.equal(vc, ve)),
            **engine_line(ic, dc)}


def mpc_worker(coordinator, pid, nproc, out_path, device, backend):
    """Phase 29 (a)-(c) in one worker process, this rank one shard:
    (a) mesh_solve's problem for MPC_MAXIT_A iterations compiled and
    eager at full capacity; (b) the problem compiled to tol, counts
    reset just before ``solve()`` and read just after, kernel #3 on the
    rank's shard against its plain version, rank 0 holding the gathered
    V's f64 true residual; (c) mesh_schur (b)'s DAE through
    ``distribute_schur``, compiled, kernel #4's launches counted the
    same way, rank 0 holding the reduced equation's true residual.
    Writes this rank's line as JSON to ``out_path``."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla
    import torch

    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)
    from rails_tpu_torch.sparse import ell_spmm as em
    from rails_tpu_torch.sparse import spmm

    comm = multihost.initialize(coordinator, nproc, pid, device=device,
                                backend=backend, timeout_s=300)
    mesh = rt.make_mesh()
    dev = comm.device
    f64 = torch.float64
    prob = mesh_solve_problem(torch, rt, dev)
    out = {"rank": pid, "processes": nproc, "backend": comm.backend,
           "device": str(dev), "shards": mesh.size}
    # ---- (a)
    t0 = time.perf_counter()
    out["a"] = mpc_against_eager(torch, rt, mesh, dev,
                                 dict(OPTS64, maxit=MPC_MAXIT_A), prob)
    out["a"]["case_wall_s"] = time.perf_counter() - t0
    # ---- (b)
    lap, md, b, aop, mop = prob
    solver = rt.LyapunovSolver(aop, b, mop, dtype=f64, mesh=mesh, **OPTS64)
    marks = []      # (iteration, wall) at each chunk read
    sync(torch, dev)
    c0 = comm.stats.counts()
    spmm.dia_spmm.launches = 0
    spmm.dia_spmm_halo.launches = 0
    t0 = time.perf_counter()
    v, t, info = solver.solve(
        compiled=True,
        progress=lambda it, wall, res: marks.append((it, wall)))
    sync(torch, dev)
    wall = time.perf_counter() - t0
    halo_launches = spmm.dia_spmm_halo.launches
    dia_launches = spmm.dia_spmm.launches
    calls, sent, staged = (a - b for a, b in zip(comm.stats.counts(), c0))
    iters = max(info.iter, 1)
    (i0, w0), (i1, w1) = marks[len(marks) // 2], marks[-1]
    err, scale = halo_kernel_check(torch, spmm, solver, mesh, 100 + pid,
                                   dev)
    line = {"iters": info.iter, "status": info.status, "res": info.res,
            "rank_v": int(v.shape[1]), "local_rows": int(v.shape[0]),
            "wall_s": wall, "s_per_iter": wall / iters,
            "s_per_iter_second_half": (w1 - w0) / max(1, i1 - i0),
            "solve_collectives": calls,
            "solve_bytes_sent_per_iter": sent / iters,
            "solve_host_staged_bytes_per_iter": staged / iters,
            "dia_spmm_halo_launches": halo_launches,
            "dia_spmm_launches": dia_launches,
            "halo_kernel_max_abs_err": err, "halo_kernel_max_abs_y": scale,
            "halo_kernel_ok": err <= TOL["float64"] * scale,
            "ranks_same_bits": ranks_agree(torch, comm,
                                           *info_bits(v, t, info)),
            "resvec_head": [float(r) for r in info.resvec[:RESVEC_HEAD]],
            "tol": OPTS64["tol"],
            "max_memory_allocated": torch.cuda.max_memory_allocated(dev)
            if dev.type == "cuda" else None,
            **engine_line(info, (calls, sent, staged))}
    vfull = comm.gather_rows(v)
    if vfull is not None:
        line["res_true_f64"] = true_residual(lap, md, b, vfull, t,
                                             np.random.default_rng(0))
    out["b"] = line
    del solver, v, vfull, prob
    torch.cuda.empty_cache()
    # ---- (c)
    a, mdd, bd = laplacian_dae(MESH_CLI_SIDE)
    a, m_p, bd, _ = pad_system(a, sp.diags(mdd).tocsr(), bd, mesh.size)
    md_p = np.asarray(m_p.diagonal()).ravel()
    red = rt.schur_reduce(a, m_p, bd, dtype=f64, device=dev)
    op = distribute_schur(red, mesh)
    solver = rt.LyapunovSolver(op, red.bs, red.ms, mesh=mesh, dtype=f64,
                               **CLI_OPTS)
    sync(torch, dev)
    em.ell_spmm.launches = 0
    c0 = comm.stats.counts()
    t0 = time.perf_counter()
    v, t, info = solver.solve(compiled=True)
    sync(torch, dev)
    wall = time.perf_counter() - t0
    c_delta = tuple(a - b for a, b in zip(comm.stats.counts(), c0))
    line = {"operator": type(op).__name__, "n2": red.n2,
            "iters": info.iter, "status": info.status,
            "wall_s": wall, "s_per_iter": wall / max(info.iter, 1),
            "ell_spmm_launches": em.ell_spmm.launches,
            "ranks_same_bits": ranks_agree(torch, comm,
                                           *info_bits(v, t, info)),
            "tol": CLI_OPTS["tol"], **engine_line(info, c_delta)}
    vfull = comm.gather_rows(v)
    if vfull is not None:
        _, i2, blk = schur_blocks(a, md_p)
        lu = spla.splu(blk["A11"].tocsc())
        line["res_true_f64"] = schur_residual(
            blk, lu, md_p[i2], bd[i2], vfull.cpu().double().numpy(),
            t.cpu().double().numpy())
    out["c"] = line
    multihost.shutdown()
    with open(out_path, "w") as f:
        json.dump(out, f)


def mpc_nccl_worker(coordinator, out_path):
    """Phase 29 (d) in one worker process: a one-rank NCCL group on
    cuda:0 and a ``RowComm`` over it, built as ``multihost.initialize``
    builds one for N ranks (``initialize`` is a no-op for one process),
    and mesh_solve's problem compiled and eager at full capacity on its
    one-shard mesh."""
    import torch
    import torch.distributed as dist

    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel.comm import RowComm
    from rails_tpu_torch.parallel.mesh import Mesh

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method=f"tcp://{coordinator}",
                            world_size=1, rank=0)
    comm = RowComm(None, 0, 1, dev, "nccl")
    mesh = Mesh([dev], comm)
    line = mpc_against_eager(torch, rt, mesh, dev, OPTS64,
                             mesh_solve_problem(torch, rt, dev))
    line.update({"processes": 1, "backend": comm.backend,
                 "device": str(dev), "shards": mesh.size,
                 "comm_stats": comm.stats.as_dict()})
    dist.destroy_process_group()
    with open(out_path, "w") as f:
        json.dump(line, f)


def mpc_schur_reference(torch, rt):
    """(c)'s one-process reference: the same reduction through
    ``distribute_schur`` on MP_RANKS shards of cuda:0, compiled."""
    import scipy.sparse as sp

    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)

    mesh = rt.make_mesh(devices=["cuda:0"] * MP_RANKS)
    a, mdd, bd = laplacian_dae(MESH_CLI_SIDE)
    a, m_p, bd, _ = pad_system(a, sp.diags(mdd).tocsr(), bd, mesh.size)
    red = rt.schur_reduce(a, m_p, bd, dtype=torch.float64)
    solver = rt.LyapunovSolver(distribute_schur(red, mesh), red.bs, red.ms,
                               mesh=mesh, dtype=torch.float64, **CLI_OPTS)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, _, info = solver.solve(compiled=True)
    torch.cuda.synchronize()
    return {"iters": info.iter, "status": info.status,
            "wall_s": time.perf_counter() - t0, **engine_line(info)}


def audit_rows(names):
    """Rows of ``capture_audit``, each in a process of its own, all
    started together."""
    procs = {name: subprocess.Popen(
        [sys.executable, "-m", "rails_tpu_torch.capture_audit", "--one",
         name], stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name in names}
    rows = {}
    for name, proc in procs.items():
        out, err = proc.communicate(timeout=300)
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if not lines:
            raise RuntimeError(f"capture_audit --one {name} printed no row: "
                               f"{out[-2000:]}{err[-2000:]}")
        rows[name] = json.loads(lines[-1])
    return rows


def host_step_shape(prog):
    """A recorded program's host steps, top level and per branch."""
    return (prog["host_steps"],
            [None if b is None else host_step_shape(b)
             for b in prog["branches"]])


def mpc_summary(ranks, ref, ref_c, label):
    """Phase 29 (a)-(c)'s lines from their ranks' lines; raises on any
    fault.  ``ref``: the one-process compiled mesh_solve (phase 22);
    ``ref_c``: the one-process compiled run on (c)'s reduction."""
    faults = []
    a = [r["a"] for r in ranks]
    case_a = {"case": f"a: capture against eager, {label}",
              "maxit": MPC_MAXIT_A, "ranks": a}
    if not all(x["same_bits"] for x in a) or \
            len({x["iters"]["compiled"] for x in a}) != 1:
        faults.append("(a) compiled and eager at full capacity differ")
    if any(x["program_host_collectives"] <= 0
           or x["program_captured_collectives"] != 0
           or not x["captured"] for x in a) and label == "gloo":
        faults.append("(a) gloo's collectives were not host steps of a "
                      "captured program")
    b = [r["b"] for r in ranks]
    head = np.asarray(ref["resvec_head"])
    mine = np.asarray(b[0]["resvec_head"])[:head.size]
    case_b = {"case": f"b: mesh_solve compiled to tol, {label}",
              "ranks": b, "iters": b[0]["iters"],
              "res_true_f64": b[0].get("res_true_f64"), "tol": b[0]["tol"],
              "wall_s": max(x["wall_s"] for x in b),
              "s_per_iter": max(x["s_per_iter"] for x in b),
              "resvec_head_max_rel_diff": float(
                  np.max(np.abs(mine - head) / np.abs(head)))
              if mine.size == head.size else None,
              "compiled_mesh_solve_iters": ref["iters"],
              "compiled_mesh_solve_wall_s": ref["wall_s"],
              "multiprocess_a_eager": {
                  k: MULTIPROCESS["a"][k] for k in ("iters", "wall_s",
                                                    "s_per_iter")}
              if "a" in MULTIPROCESS else None}
    if len({x["iters"] for x in b}) != 1 or any(x["status"] != 0
                                                for x in b):
        faults.append("(b) iterations or status differ across ranks, or "
                      "not converged")
    if not all(x["ranks_same_bits"] for x in b):
        faults.append("(b) T and info are not the same bits on every rank")
    if case_b["resvec_head_max_rel_diff"] is None or \
            case_b["resvec_head_max_rel_diff"] > MP_HISTORY_RTOL:
        faults.append(f"(b) the first {RESVEC_HEAD} residual estimates "
                      f"differ from compiled mesh_solve's by more than "
                      f"{MP_HISTORY_RTOL}")
    if abs(case_b["iters"] - ref["iters"]) > MP_ITER_BAND * ref["iters"]:
        faults.append(f"(b) iterations more than {MP_ITER_BAND:.0%} from "
                      f"compiled mesh_solve's")
    if case_b["res_true_f64"] is None or \
            case_b["res_true_f64"] > 2 * case_b["tol"]:
        faults.append("(b) true residual above 2 tol")
    for x, r in zip(b, ranks):
        if x["dia_spmm_launches"] != 0 or x["dia_spmm_halo_launches"] <= 0:
            faults.append(f"(b) rank {r['rank']}: A's applies did not go "
                          f"through the halo kernel")
        if not x["halo_kernel_ok"]:
            faults.append(f"(b) rank {r['rank']}: kernel #3 disagrees with "
                          f"its plain version on the rank's shard")
    c = [r["c"] for r in ranks]
    case_c = {"case": f"c: distributed Schur DAE compiled, {label}",
              "side": MESH_CLI_SIDE, "ranks": c, "iters": c[0]["iters"],
              "res_true_f64": c[0].get("res_true_f64"), "tol": c[0]["tol"],
              "wall_s": max(x["wall_s"] for x in c),
              "one_process": ref_c}
    if any(x["operator"] != "DistributedSchurOperator" or x["status"] != 0
           or not x["ranks_same_bits"] for x in c) or \
            len({x["iters"] for x in c}) != 1:
        faults.append("(c) not a converged DistributedSchurOperator run "
                      "with the same bits on every rank")
    if abs(case_c["iters"] - ref_c["iters"]) > \
            MP_ITER_BAND * ref_c["iters"]:
        faults.append(f"(c) iterations more than {MP_ITER_BAND:.0%} from "
                      f"the one-process compiled run's")
    if case_c["res_true_f64"] is None or \
            case_c["res_true_f64"] > 2 * case_c["tol"]:
        faults.append("(c) true residual above 2 tol")
    if any(x["ell_spmm_launches"] <= 0 for x in c):
        faults.append("(c) a rank never launched ell_spmm")
    if faults:
        raise AssertionError(f"multiprocess_compiled {label}: {faults}: "
                             f"{[case_a, case_b, case_c]}")
    return [case_a, case_b, case_c]


def run_multiprocess_compiled(torch, rt, spmm, em, only):
    """Phase 29: ``solve(compiled=True)`` across processes.  (a)-(c) on
    MP_RANKS processes of cuda:0 over gloo (the row collectives host
    steps); (d) a one-rank NCCL group (the collectives captured) and the
    capture audit's collective rows; (e) (a)-(c) over NCCL where the
    cards reach the rank count.  Returns each rank's launches of kernels
    #3 (in (b)) and #4 (in (c)), or None when the phase is skipped."""
    if not (only is None or "multiprocess_compiled" in only):
        return None
    t_phase = time.perf_counter()
    ref = COMPILED.get("mesh_solve")
    if ref is None:   # phase 22 was skipped: its compiled run here
        ref, _ = run_solve(torch, rt, spmm, "compiled_mesh_solve", 256,
                           torch.float64, OPTS64, True,
                           mesh=rt.make_mesh(devices=["cuda:0"] * MESH_ND),
                           compiled=True)
    ref_c = mpc_schur_reference(torch, rt)
    torch.cuda.empty_cache()
    audit = audit_rows(MPC_AUDIT)
    if not audit["nccl_all_gather"].get("captured") or \
            audit["gloo_all_gather_staged"].get("captured") is not False:
        raise AssertionError(f"multiprocess_compiled: the collectives' "
                             f"capture audit: {audit}")
    with tempfile.TemporaryDirectory() as d:
        t0 = time.perf_counter()
        ranks = start_workers("compiled", MP_RANKS, d, ["cuda:0", "gloo"])
        cases = mpc_summary(ranks, ref, ref_c, "gloo")
        cases[-1]["workers_wall_s"] = time.perf_counter() - t0
        # ---- (d)
        t0 = time.perf_counter()
        (d_line,) = start_workers("nccl1", 1, d, [])
        case_d = {"case": "d: one-rank NCCL group, captured collectives",
                  **d_line, "compiled_mesh_solve_wall_s": ref["wall_s"],
                  "compiled_mesh_solve_iters": ref["iters"],
                  "compiled_mesh_solve_host_steps_per_iter":
                      ref["host_steps_per_iter"],
                  "capture_audit": audit,
                  "phase_wall_s": time.perf_counter() - t0}
        faults = []
        if not d_line["same_bits"] or d_line["status"]["compiled"] != 0:
            faults.append("compiled and eager at full capacity differ, or "
                          "not converged")
        if d_line["collective_route"] != "captured" or \
                d_line["program_host_collectives"] != 0 or \
                d_line["program_captured_collectives"] <= 0 or \
                d_line["collectives_per_iter"] < \
                d_line["program"]["captured_collectives"]:
            faults.append("the collectives were not captured, or a "
                          "collective was a host step")
        if host_step_shape(d_line["program"]) != \
                host_step_shape(ref["program"]):
            faults.append("the program's host steps differ from the "
                          "one-process compiled run's")
        if faults:
            raise AssertionError(f"multiprocess_compiled (d): {faults}: "
                                 f"{case_d}")
        cases.append(case_d)
        # ---- (e)
        cards = torch.cuda.device_count()
        e_note = None
        if cards >= MP_RANKS:
            ranks_e = start_workers("compiled", MP_RANKS, d, ["auto", "nccl"])
            cases.extend(mpc_summary(ranks_e, ref, ref_c, "nccl"))
        else:
            e_note = (f"(e) not run: {cards} card(s) for {MP_RANKS} ranks; "
                      f"NCCL across processes needs a card per rank")
            print(e_note, flush=True)
    emit({"phase": "multiprocess_compiled", "e_not_run": e_note,
          "iter_band": MP_ITER_BAND, "cases": cases,
          "wall_s": time.perf_counter() - t_phase})
    return {"dia_spmm_halo": [r["b"]["dia_spmm_halo_launches"]
                              for r in ranks],
            "ell_spmm": [r["c"]["ell_spmm_launches"] for r in ranks]}


def wall_ms(torch, fn, reps):
    """Median wall ms of ``reps`` calls of ``fn``, each ended by a
    synchronisation of the card (for work that crosses to the host and
    back, which CUDA events alone do not time)."""
    fn()
    torch.cuda.synchronize()
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t0) * 1e3)
    return float(np.median(ts))


def schur_route_case(torch, label, k, a, c):
    """The projected Schur solve on one captured (A_t, C_t) on the card:
    its real factor (dgees) and its real trsyl on the host, each timed
    with its round trip, and its X against scipy's
    ``solve_continuous_lyapunov`` of the same (A, C) in f64 on the
    host."""
    import scipy.linalg
    from rails_tpu_torch.linalg import dense_lyap

    factor = dense_lyap._schur_factor
    solve = factor(a)
    x = solve(c).double().cpu().numpy()
    x_ref = scipy.linalg.solve_continuous_lyapunov(
        a.double().cpu().numpy(), -c.double().cpu().numpy())
    row = {"case": label, "k_active": k, "k_full": a.shape[0],
           "host_factor_ms": wall_ms(torch, lambda: factor(a), 10),
           "host_trsyl_ms": wall_ms(torch, lambda: solve(c), 10),
           "x_rel_diff": float(np.linalg.norm(x - x_ref)
                               / np.linalg.norm(x_ref))}
    row["route_ms"] = row["host_factor_ms"] + row["host_trsyl_ms"]
    if row["x_rel_diff"] > 1e-8:
        raise AssertionError(f"the projected Schur solve disagrees with "
                             f"scipy's: {row}")
    return row


def run_schur_lapack(torch, spmm, em):
    """Phase 18: the projected Schur solve timed on the projected
    matrices of cli_schur with the Schur route asked for (S is tagged
    symmetric, so phase 7's run takes eigh), and that run itself."""
    t0 = time.perf_counter()
    captured = {}
    out_cli = run_cli_schur(torch, spmm, em, 1e-4,
                            label="cli_schur_projected_schur",
                            capture=captured,
                            solver={"projected_solver": "schur"})
    emit(out_cli)
    rows = [schur_route_case(torch, f"k >= {key}" if key != "max"
                             else "largest k", *captured[key])
            for key in (*SCHUR_KS, "max") if key in captured]
    return {"phase": "schur_lapack", "cases": rows,
            "cli_schur": {key: out_cli[key] for key in (
                "iters", "converged", "wall_s", "s_per_iter",
                "project_solve_share", "res_true_f64", "tol",
                "lambda1_rel_diff", "max_memory_allocated",
                "ell_spmm_launches")},
            "cli_driver_load_s": out_cli["scopes"].get(
                "Driver/load", {}).get("total_s"),
            "wall_s": time.perf_counter() - t0}


def rel_diff(y, ref):
    return ((y - ref).abs().max() / ref.abs().max()).item()


def run_schur_native(torch, em, gen):
    """Phase 19: ``a11_solver="native_lu"`` against ``"dense_lu"`` on
    cli_schur's side-192 DAE (S and S' applies, their times, the device
    memory of each reduction), ``sinv(method="native_lu")`` against the
    dense one on the side-96 DAE, and the CLI's load (three
    read_matrix_market calls) with the native reader and with scipy."""
    import scipy.sparse as sp

    from rails_tpu_torch import io as rio
    from rails_tpu_torch.native import host_lib
    from rails_tpu_torch.schur import schur_reduce

    t0 = time.perf_counter()
    f64 = torch.float64
    a, md, b = laplacian_dae(CLI_SIDE)
    x = None
    out = {"phase": "schur_native", "n": a.shape[0],
           "n1": int((md == 0).sum()), "s": 8, "solvers": {}}
    ys = {}
    for kind in ("native_lu", "dense_lu"):
        gc.collect()   # earlier phases' garbage out of the base
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        red = schur_reduce(a, md, b, dtype=f64, a11_solver=kind)
        torch.cuda.synchronize()
        reduce_s = time.perf_counter() - t1
        peak = torch.cuda.max_memory_allocated()
        held = torch.cuda.memory_allocated() - base
        op = red.operator
        if x is None:
            x = random_x(torch, red.n2, 8, f64, gen)
        before = em.ell_spmm.launches
        ys[kind] = (op.matmat(x), op.rmatmat(x))
        torch.cuda.synchronize()
        reps = 20 if kind == "native_lu" else 50
        out["solvers"][kind] = {
            "reduction_wall_s": reduce_s, "max_memory_allocated": peak,
            "peak_over_base": peak - base, "held_after": held,
            "ell_launches_per_apply": (em.ell_spmm.launches - before) / 2,
            "s_apply_us": wall_ms(torch, lambda: op.matmat(x), reps) * 1e3,
            "st_apply_us": wall_ms(torch, lambda: op.rmatmat(x), reps)
            * 1e3}
        del red, op
    out["s_rel_diff"] = rel_diff(ys["native_lu"][0], ys["dense_lu"][0])
    out["st_rel_diff"] = rel_diff(ys["native_lu"][1], ys["dense_lu"][1])
    del ys
    torch.cuda.empty_cache()

    # sinv on the side-96 DAE (a dense sinv at side 192 would hold ~11 GB)
    a96, md96, b96 = laplacian_dae(MESH_CLI_SIDE)
    red = schur_reduce(a96, md96, b96, dtype=f64)
    x96 = random_x(torch, red.n2, 8, f64, gen)
    sinv = {}
    for method in ("native_lu", "dense_lu"):
        gc.collect()
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t1 = time.perf_counter()
        fn = red.sinv(method=method)
        y = fn(x96)
        torch.cuda.synchronize()
        sinv[method] = {"first_call_s": time.perf_counter() - t1,
                        "peak_over_base": torch.cuda.max_memory_allocated()
                        - base,
                        "apply_us": wall_ms(torch, lambda: fn(x96), 10)
                        * 1e3, "y": y}
    out["sinv"] = {"n": a96.shape[0], "rel_diff": rel_diff(
        sinv["native_lu"].pop("y"), sinv["dense_lu"].pop("y")), **sinv}
    del red, sinv
    torch.cuda.empty_cache()

    # the CLI's load: the three files it reads, native reader and scipy
    with tempfile.TemporaryDirectory() as d:
        files = {"A.mtx": a, "M.mtx": sp.diags(md).tocsr(),
                 "B.mtx": sp.csr_matrix(b)}
        for name, arr in files.items():
            rio.write_matrix_market(os.path.join(d, name), arr)
        read_native = host_lib.read_matrix_market
        loads, got = {}, {}
        for reader in ("native", "scipy"):
            if reader == "scipy":
                host_lib.read_matrix_market = lambda path: None
            try:
                t1 = time.perf_counter()
                got[reader] = [rio.read_matrix_market(os.path.join(d, n))
                               for n in files]
                loads[reader] = time.perf_counter() - t1
            finally:
                host_lib.read_matrix_market = read_native
    out["load_s"] = loads
    out["load_equal"] = all((p != q).nnz == 0 for p, q in
                            zip(got["native"], got["scipy"]))
    out["wall_s"] = time.perf_counter() - t0
    if max(out["s_rel_diff"], out["st_rel_diff"]) > 1e-10:
        raise AssertionError(f"the native_lu S apply disagrees with "
                             f"dense_lu: {out}")
    if out["sinv"]["rel_diff"] > 1e-10 or not out["load_equal"]:
        raise AssertionError(f"native sinv or reader disagrees: {out}")
    return out


HUB_M, HUB_L, HUB_BAND, HUB_COUNT, HUB_DEG = 1 << 19, 8, 64, 64, 4096
HUB_SOLVE = dict(m=1 << 16, ell_l=8, band=64, n_hubs=16, hub_deg=2048)


def hub_bench_matrix():
    """bench.py::phase_hub's matrix at its TPU size (:683-707): m = 2^19,
    8 picks per row within +-64 of the diagonal (U[-0.2, 0.2)), 64 hubs
    of degree 4096 (U[-0.1, 0.1)) with their half-weight partner columns,
    duplicates summed; then x (m, 16) U[-1, 1), all from default_rng(0)."""
    import scipy.sparse as sp

    m = HUB_M
    rng = np.random.default_rng(0)
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-HUB_BAND, HUB_BAND + 1,
                                               (m, HUB_L)), 0, m - 1)
    val = rng.uniform(-1, 1, (m, HUB_L)) * 0.2
    rows, cols, vals = [np.repeat(base, HUB_L)], [idx.ravel()], [val.ravel()]
    for hb in rng.choice(m, HUB_COUNT, replace=False):
        c = rng.choice(m, HUB_DEG, replace=False)
        v = rng.uniform(-1, 1, HUB_DEG) * 0.1
        rows += [np.full(HUB_DEG, hb), c]
        cols += [c, np.full(HUB_DEG, hb)]
        vals += [v, v * 0.5]
    a = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                              np.concatenate(cols))),
                      shape=(m, m)).tocsr()
    return a, rng.uniform(-1, 1, (m, 16))


def superhub_matrix(m, ell_l, band, n_hubs, hub_deg, seed=0):
    """tests/test_sparse.py:630-640's superhub-with-locality matrix (L
    picks per row within +-band, U[-1, 1); hub rows U[-1, 1) with their
    half-weight partner columns, assigned over the bulk), symmetrised,
    its diagonal set to -(row abs-sum) - 1 as test_solver_hosts_hub_operator
    does; then B (m, 8) U[0, 1), all from default_rng(seed)."""
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1, (m, ell_l)),
                  0, m - 1)
    val = rng.uniform(-1, 1, (m, ell_l))
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, ell_l), idx.ravel())),
                      shape=(m, m)).tocsr().tolil()
    for hb in rng.choice(m, n_hubs, replace=False):
        c = rng.choice(m, hub_deg, replace=False)
        v = rng.uniform(-1, 1, hub_deg)
        a[hb, c] = v
        a[c, hb] = v * 0.5
    a = a.tocsr()
    a = (a + a.T).tolil()
    a.setdiag(a.diagonal() - np.abs(a).sum(axis=1).A1 - 1.0)
    return a.tocsr(), rng.uniform(0, 1, (m, 8))


def hub_work(op, s, itemsize):
    """Bytes the hub apply must move: both ELL payloads (indices at 4
    bytes), the hub indices, D, x read once, y written once; and its
    flops (2 per stored value and column)."""
    m, n = op.shape
    ells = [e for e in (op.rest, op.hubcol) if e is not None]
    slots = sum(e.indices.numel() for e in ells)
    h = op.hub_idx.numel()
    nbytes = (slots * (4 + itemsize) + h * 8 + h * n * itemsize
              + (n + m) * s * itemsize)
    return nbytes, 2 * (slots + h * n) * s


def run_hub(torch, rt, em, gen):
    """Phase 20: the hub split on the card - bench.py::phase_hub's matrix
    (apply against scipy in f64 and torch.sparse.mm, its time split three
    ways), then a solve on a hub operator at solve_f64's size, ELL
    launches counted through it."""
    from rails_tpu_torch.sparse.ell_spmm import ell_spmm_reference
    from rails_tpu_torch.utils.dtypes import full_precision

    t0 = time.perf_counter()
    f32, f64 = torch.float32, torch.float64
    a, xh = hub_bench_matrix()
    t1 = time.perf_counter()
    op = rt.hub_operator(a, max_hubs=HUB_COUNT, degree_factor=8.0,
                         dtype=f32)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t1
    x = torch.from_numpy(xh).to("cuda", f32)
    x64 = x.double().cpu().numpy()
    errs = {}
    for name, ref in (("matmat", a @ x64), ("rmatmat", a.T @ x64)):
        y = getattr(op, name)(x).double().cpu().numpy()
        errs[name] = float(np.abs(y - ref).max() / np.abs(ref).max())
    before = em.ell_spmm.launches
    op.matmat(x)
    torch.cuda.synchronize()
    per_apply = em.ell_spmm.launches - before
    s = x.shape[1]
    nbytes, flops = hub_work(op, s, 4)
    b_ms, b_by = bound_ms(nbytes, flops, "float32")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # "CSR support is in beta"
        csr = torch.sparse_csr_tensor(
            torch.from_numpy(a.indptr.astype(np.int64)),
            torch.from_numpy(a.indices.astype(np.int64)),
            torch.from_numpy(a.data.astype(np.float32)), size=a.shape,
            device="cuda")
    lib_err = rel_diff(torch.sparse.mm(csr, x), op.matmat(x))
    xhub = x.index_select(0, op.hub_idx)
    yacc = torch.zeros_like(x)

    def d_part():
        with full_precision():
            yacc.index_add_(0, op.hub_idx, op.d @ x)

    def d_chunked():
        # the same product as one batched GEMM over 1024-column chunks of
        # D and a sum: a yardstick for the single GEMM
        h, n = op.d.shape
        q = n // 1024
        with full_precision():
            return torch.bmm(op.d.as_strided((q, h, 1024), (1024, n, 1)),
                             x[:q * 1024].reshape(q, 1024, s)).sum(0)

    def plain(z):
        y = ell_spmm_reference(op.rest, z) + ell_spmm_reference(
            op.hubcol, z.index_select(0, op.hub_idx))
        with full_precision():
            return y.index_add_(0, op.hub_idx, op.d @ z)

    apply_ms = time_ms(torch, op.matmat, [(x,)], 50)
    bench = {
        "m": HUB_M, "nnz": int(a.nnz), "hubs": int(op.hub_idx.numel()),
        "hub_deg": HUB_DEG, "s": s, "dtype": "float32",
        "rest_L": int(op.rest.indices.shape[1]),
        "hubcol_L": int(op.hubcol.indices.shape[1]),
        "d_bytes": op.d.numel() * 4, "build_s": build_s,
        "hub_rel_err": errs["matmat"], "hub_rel_err_rmatmat":
        errs["rmatmat"], "ell_launches_per_apply": per_apply,
        "ms": apply_ms, "call_ms": time_ms(torch, op.matmat, [(x,)], 50,
                                           backlog=False),
        "rmatmat_ms": time_ms(torch, op.rmatmat, [(x,)], 50),
        "plain_ms": time_ms(torch, plain, [(x,)], 5),
        "library_ms": time_ms(torch, torch.sparse.mm, [(csr, x)], 20),
        "library_rel_diff": lib_err, "bound_ms": b_ms, "bound_by": b_by,
        "bytes": nbytes, "bound_share": b_ms / apply_ms,
        "split_ms": {
            "bulk_ell": time_ms(torch, em.ell_spmm, [(op.rest, x)], 50),
            "hubcol_ell": time_ms(torch, em.ell_spmm,
                                  [(op.hubcol, xhub)], 50),
            "d_gemm_index_add": time_ms(torch, d_part, [()], 50),
            "d_chunked_gemm": time_ms(torch, d_chunked, [()], 50)}}
    if max(errs.values()) > 1e-5 or per_apply != 2:
        raise AssertionError(f"hub apply: error above 1e-5 or not 2 ELL "
                             f"launches per apply: {bench}")
    del op, csr, x, xhub, yacc, a
    torch.cuda.empty_cache()

    # a solve on a hub operator at solve_f64's size and parameters
    a, b = superhub_matrix(**HUB_SOLVE)
    op = rt.hub_operator(a, dtype=f64)
    solver = rt.LyapunovSolver(op, b, None, dtype=f64, **OPTS64)
    applies = count_applies(solver.A)
    torch.cuda.synchronize()
    em.ell_spmm.launches = 0
    t1 = time.perf_counter()
    v, t, info = solver.solve()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = em.ell_spmm.launches
    v64 = v.detach().cpu().double().numpy()
    res_true = factored_residual(a @ v64, v64, b, t.detach().cpu().double()
                                 .numpy(), np.random.default_rng(1))
    solve = {"m": a.shape[0], "nnz": int(a.nnz),
             "hubs": int(op.hub_idx.numel()), "dtype": "float64",
             "iters": info.iter, "status": info.status, "res": info.res,
             "converged": info.converged, "rank": int(v.shape[1]),
             "wall_s": wall, "a_applies": applies[0],
             "ell_spmm_launches": launches,
             "ell_launches_per_apply": launches / max(applies[0], 1),
             "res_true_f64": res_true, "tol": OPTS64["tol"]}
    if info.status != 0 or res_true > 2 * OPTS64["tol"] \
            or launches != 2 * applies[0]:
        raise AssertionError(f"hub solve failed its checks: {solve}")
    return {"phase": "hub", "bench": bench, "solve": solve,
            "wall_s": time.perf_counter() - t0}, launches


def run_host_phases(torch, rt, spmm, em, gen, only):
    """Phases 18-20 (this slice's: the LAPACK Schur route, the native
    host library, the hub split), each emitting its line, those not in
    ``only`` skipped (None: all).  Returns the ELL launches of the hub
    solve (None when skipped)."""
    def want(name):
        return only is None or name in only

    if want("schur_lapack"):
        emit(run_schur_lapack(torch, spmm, em))
        torch.cuda.empty_cache()
    if want("schur_native"):
        emit(run_schur_native(torch, em, gen))
        torch.cuda.empty_cache()
    launches = None
    if want("hub"):
        out, launches = run_hub(torch, rt, em, gen)
        emit(out)
    return launches


NEW_PHASES = ("compare_wide", "timing_wide", "refined_acc", "refined_scale",
              "continuation_wide", "compare_halo", "timing_halo",
              "mesh_solve", "mesh_ell", "mesh_schur", "schur_lapack",
              "schur_native", "hub", "compiled_solve", "compiled_mesh",
              "compiled_refined", "compiled_continuation", "compiled_schur",
              "examples", "continuation_full_capacity", "multiprocess",
              "multiprocess_compiled")


def parse_only(argv):
    """``--only a,b``: run env, build and the named phases of NEW_PHASES,
    then stop without the kernel table and the last line (a debugging
    aid); None for a full run."""
    if not argv:
        return None
    if len(argv) != 2 or argv[0] != "--only":
        raise SystemExit(f"usage: chip_smoke.py [--only "
                         f"{','.join(NEW_PHASES)}]")
    only = set(argv[1].split(","))
    if not only <= set(NEW_PHASES):
        raise SystemExit(f"--only takes phases of {NEW_PHASES}")
    return only


def main():
    if sys.argv[1:2] == ["--worker"]:   # one process of phase 28
        worker_main(sys.argv[2:])
        return
    t_start = time.perf_counter()
    only = parse_only(sys.argv[1:])
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke.py needs a CUDA device: "
                           "torch.cuda.is_available() is False")
    import rails_tpu_torch as rt
    from rails_tpu_torch import _build
    from rails_tpu_torch import refine as refine_mod
    from rails_tpu_torch.sparse import ell_spmm as em
    from rails_tpu_torch.sparse import spmm
    from rails_tpu_torch.sparse import wide_spmm as wm
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
    t1 = time.perf_counter()
    host_lib = _build.load_host()   # the C++ host library, by g++
    emit({"phase": "build", "kernels": report,
          "host_library": {"path": host_lib._name,
                           "seconds": time.perf_counter() - t1},
          "wall_s": time.perf_counter() - t0})

    gen = torch.Generator("cuda").manual_seed(0)
    earlier = None
    if only is None:
        earlier = run_earlier_phases(torch, rt, spmm, em, smi, gen)
    wide = run_wide_phases(torch, rt, spmm, em, wm, refine_mod, smi, gen,
                           only)
    halo = run_mesh_phases(torch, rt, spmm, em, smi, gen, only,
                           None if earlier is None else earlier["solve_f64"])
    hub_launches = run_host_phases(torch, rt, spmm, em, gen, only)
    run_compiled_phases(torch, rt, spmm, em, wm, refine_mod, gen, only,
                        EAGER)
    schur_launches = run_slice_phases(torch, rt, em, wm, only, EAGER)
    mp_launches = run_multiprocess(torch, rt, spmm, em, only, EAGER)
    mpc_launches = run_multiprocess_compiled(torch, rt, spmm, em, only)
    if only is not None:
        return

    # ---- the kernel table, the card, and the last line
    def row(name, source, replaces, launches, err, t):
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches,
                "max_abs_err": err, "ms": t["ms"], "plain_ms": t["plain_ms"],
                "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
                "library_ms": t["library_ms"]}

    wide_row = row("wide_spmm", "rails_tpu_torch/csrc/wide_spmm.cu",
                   "rails_tpu/sparse/wide_spmm.py:136", *wide)
    wide_row["ell_ms"] = wide[2]["ell_ms"]
    ell_row = row("ell_spmm", "rails_tpu_torch/csrc/ell_spmm.cu",
                  "rails_tpu/sparse/ell_spmm.py:344", *earlier["ell"])
    ell_row["hub_solve_launches"] = hub_launches
    ell_row["compiled_schur_launches"] = schur_launches
    ell_row["multiprocess_rank_launches"] = mp_launches["ell_spmm"]
    ell_row["multiprocess_compiled_rank_launches"] = mpc_launches["ell_spmm"]
    halo_row = row("dia_spmm_halo", "rails_tpu_torch/csrc/dia_spmm_halo.cu",
                   "rails_tpu/sparse/spmm.py:414", *halo)
    halo_row["multiprocess_rank_launches"] = mp_launches["dia_spmm_halo"]
    halo_row["multiprocess_compiled_rank_launches"] = \
        mpc_launches["dia_spmm_halo"]
    emit({"kernels": [
        row("dia_spmm", "rails_tpu_torch/csrc/dia_spmm.cu",
            "rails_tpu/sparse/spmm.py:75", *earlier["dia"]),
        halo_row, ell_row, wide_row],
        "total_wall_s": time.perf_counter() - t_start})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
