"""Command-line program - the counterpart of the reference's
src/main.cpp, with the flags and the output of the JAX package's
``cli.py``.

Usage:
    python -m rails_tpu_torch.cli [--params params.xml|json]
                                  [--device cuda|cpu] [--x64]
                                  [--only-eigenvalues] [directory]

Reads A.mtx / B.mtx / M.mtx from the directory (main.cpp:62-72), builds
the Schur reduction for the singular mass matrix (main.cpp:78-88: A12,
A21 and A22 in ELL on the device, A11 by dense LU), solves the Lyapunov
equation on (S, M22, Bs) (main.cpp:118), checkpoints V.mtx / T.mtx
(main.cpp:123-126; reloadable with --only-eigenvalues, :128-138), then
computes the dominant eigenpairs of the full-space solution operator and
the trace-normalized spectrum table (main.cpp:140-170), and prints the
profiler's table (main.cpp:172-173).

``--device`` (default ``cuda``) takes the place of the JAX package's
``--platform``; ``--x64`` solves in float64 instead of float32.
``--distributed`` (the multi-process run) is not ported and raises.
"""

from __future__ import annotations

import argparse
import os
import sys

_DISTRIBUTED_TODO = ("--distributed (the multi-process run) is not ported "
                     "yet: ROADMAP Queue 1, the distributed layer")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="rails-tpu-torch",
        description="Low-rank Lyapunov solver (RAILS equivalent) on "
                    "PyTorch / CUDA")
    ap.add_argument("directory", nargs="?", default=".",
                    help="directory with A.mtx, B.mtx, M.mtx")
    ap.add_argument("--params", help="XML (Teuchos) or JSON parameter file")
    ap.add_argument("--device", default="cuda",
                    help="torch device to run on (default cuda; cpu on "
                         "request)")
    ap.add_argument("--only-eigenvalues", action="store_true",
                    help="skip the solve; reload V.mtx/T.mtx")
    ap.add_argument("--tol", type=float, default=None)
    ap.add_argument("--maxit", type=int, default=None)
    ap.add_argument("--num-eigenvalues", type=int, default=None)
    ap.add_argument("--x64", action="store_true",
                    help="solve in float64 (default float32)")
    ap.add_argument("--reorder", choices=["none", "rcm"], default="none",
                    help="symmetric bandwidth-reduction reordering before "
                         "the solve (deterministic, so --only-eigenvalues "
                         "reloads stay consistent)")
    ap.add_argument("--distributed", action="store_true",
                    help="multi-process run (not ported)")
    ap.add_argument("--coordinator", default=None,
                    help="coordinator address host:port (--distributed)")
    ap.add_argument("--num-processes", type=int, default=None,
                    help="process count (--distributed)")
    ap.add_argument("--process-id", type=int, default=None,
                    help="this process's id (--distributed)")
    ap.add_argument("--fmt", choices=["dia", "ell", "hyb"], default="ell",
                    help="sparse operator format for the direct "
                         "(non-Schur) distributed path (--distributed)")
    args = ap.parse_args(argv)
    if args.distributed:
        raise NotImplementedError(_DISTRIBUTED_TODO)

    import torch

    import rails_tpu_torch
    from rails_tpu_torch import io as rio
    from rails_tpu_torch.config import (
        ParameterList, load_json_parameters, load_xml_parameters,
        solver_options_from_params)
    from rails_tpu_torch.eigs import eigs
    from rails_tpu_torch.schur import schur_reduce
    from rails_tpu_torch.timer import (
        disable_profiling, enable_profiling, reset_profiles, save_profiles,
        timer)
    from rails_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    dtype = torch.float64 if args.x64 else torch.float32
    reset_profiles()
    enable_profiling()
    try:
        params = ParameterList()
        if args.params:
            loader = load_xml_parameters if args.params.endswith(".xml") \
                else load_json_parameters
            params = loader(args.params)

        d = args.directory
        print("Loading matrices")
        with timer("Driver", "load"):
            a = rio.read_matrix_market(os.path.join(d, "A.mtx"))
            b = rio.read_matrix_market(os.path.join(d, "B.mtx"))
            m = rio.read_matrix_market(os.path.join(d, "M.mtx"))

        if args.reorder == "rcm":
            from rails_tpu_torch.sparse.reorder import (
                bandwidth, permute_system, rcm_permutation)

            bw0 = bandwidth(a)
            perm = rcm_permutation(a)
            a, m, b = permute_system(a, m, b, perm)
            print(f"RCM reordering: bandwidth {bw0} -> {bandwidth(a)}")

        print("Computing Schur complement")
        with timer("Driver", "schur"):
            red = schur_reduce(a, m, b, dtype=dtype, device=device)

        overrides = {}
        if args.tol is not None:
            overrides["tol"] = args.tol
        if args.maxit is not None:
            overrides["maxit"] = args.maxit
        opts = solver_options_from_params(
            params.sublist("Lyapunov Solver"), **overrides)

        v_path = os.path.join(d, "V.mtx")
        t_path = os.path.join(d, "T.mtx")
        if not args.only_eigenvalues:
            print("Creating solver")
            solver = rails_tpu_torch.LyapunovSolver(
                red.operator, red.bs, red.ms, options=opts, device=device)
            print("Performing solve")
            print(f"Amount of matrix-vector products before the solve: "
                  f"{red.mvps}")
            v, t, info = solver.solve()
            print(f"Amount of matrix-vector products after the solve: "
                  f"{info.mvps}")
            outcome = "converged" if info.converged else "did not converge"
            print(f"Solver {outcome} in {info.iter} iterations, "
                  f"relative residual {info.res:.3e}, space size "
                  f"{v.shape[1]}")
            with timer("Driver", "checkpoint"):
                rio.write_matrix_market(v_path, v)
                rio.write_matrix_market(t_path, t)
        else:
            print("Reloading V.mtx / T.mtx")
            v = torch.as_tensor(rio.read_matrix_market(v_path),
                                dtype=dtype, device=device)
            t = torch.as_tensor(rio.read_matrix_market(t_path),
                                dtype=dtype, device=device)

        eig_params = params.sublist("Eigenvalue Solver")
        num = args.num_eigenvalues or int(
            eig_params.get("Number of Eigenvalues", 10))

        print("Computing eigenvalues of the solution operator")
        with timer("Driver", "eigenvalues"):
            sop = red.solution_operator(v, t)
            # Anasazi BlockKrylovSchurSolMgr parameter names pass through
            # (the reference forwards the whole "Eigenvalue Solver"
            # sublist, src/Epetra_OperatorWrapper.cpp:163-186)
            bsz = int(eig_params.get("Block Size", 1))
            nblocks = eig_params.get("Num Blocks")  # subspace = bsz*blocks
            evals, _ = eigs(
                sop, num=num,
                tol=float(eig_params.get("Convergence Tolerance", 1e-6)),
                block_size=bsz,
                max_restarts=int(eig_params.get("Maximum Restarts", 100)),
                subspace=None if nblocks is None else bsz * int(nblocks),
                dtype=dtype, device=device)

        with timer("Driver", "trace"):
            trace = float(red.trace(v, t))

        print(f"{'eigenvalue':>20}{'eigenvalue/trace':>20}")
        for lam in evals.detach().cpu().numpy():
            print(f"{lam:>20.12g}{lam / trace:>20.12g}")

        save_profiles()
    finally:
        disable_profiling()
    return 0


if __name__ == "__main__":
    sys.exit(main())
