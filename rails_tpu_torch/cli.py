"""Command-line program - the counterpart of the reference's
src/main.cpp, with the flags and the output of the JAX package's
``cli.py``.

Usage:
    python -m rails_tpu_torch.cli [--params params.xml|json]
                                  [--device cuda|cpu] [--x64]
                                  [--only-eigenvalues] [--distributed]
                                  [directory]

Reads A.mtx / B.mtx / M.mtx from the directory (main.cpp:62-72), builds
the Schur reduction for the singular mass matrix (main.cpp:78-88: A12,
A21 and A22 in ELL on the device, A11 by dense LU), solves the Lyapunov
equation on (S, M22, Bs) (main.cpp:118), printing which projected dense
solver it takes (eigh where S is tagged symmetric), checkpoints V.mtx / T.mtx
(main.cpp:123-126; reloadable with --only-eigenvalues, :128-138), then
computes the dominant eigenpairs of the full-space solution operator and
the trace-normalized spectrum table (main.cpp:140-170), and prints the
profiler's table (main.cpp:172-173).  In a ``torch.profiler`` trace the
run is one ``Driver/main`` span, the table's scopes spans inside it.

``--device`` (default ``cuda``) takes the place of the JAX package's
``--platform``; ``--x64`` solves in float64 instead of float32.

``--distributed`` runs the row-sharded mesh path, as the JAX package's
does: ``pad_system`` to the mesh size, then for a singular M the
distributed Schur operator (``parallel/schur_dist.py``), otherwise the
direct path with ``--fmt`` and a diagonal M (a non-diagonal M ends the
run), whose eigenvalue phase runs ``eigs`` over the solution as a
``LowRankOperator`` on the mesh.  With one process the mesh is
``make_mesh`` over the visible devices of ``--device`` (the one CPU
device; a machine's cards would be distinct devices, which one process
does not drive: run one process per card).  With ``--num-processes N``
(above 1), ``--process-id r`` and ``--coordinator host:port`` (defaults
``$RAILS_NUM_PROCESSES``, ``$RAILS_PROCESS_ID``, ``$RAILS_COORDINATOR``)
each of N processes joins the group (``multihost.initialize``: rank r on
``cuda:{r % cards}``, or the CPU with ``--device cpu``;
``RAILS_DIST_BACKEND=gloo`` where ranks share a card) and holds its
rows of B, V and the operators; V is gathered for V.mtx and T.mtx, which
rank 0 alone writes, and every rank prints the eigenvalue table.
"""

from __future__ import annotations

import argparse
import os
import sys


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
                    help="row-sharded mesh run over the visible devices; "
                         "see module docstring")
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

    from rails_tpu_torch.timer import span

    with span("Driver", "main"):
        return _run(args)


def _run(args) -> int:
    import numpy as np
    import scipy.sparse as sp
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
    mesh = comm = None
    if args.distributed:
        from rails_tpu_torch.parallel import multihost
        from rails_tpu_torch.parallel.mesh import make_mesh

        comm = multihost.initialize(args.coordinator, args.num_processes,
                                    args.process_id, device=args.device)
        if comm is not None:
            device = comm.device
            mesh = make_mesh()
            print(f"Distributed run: {comm.world} processes, {mesh.size} "
                  f"shards, backend {comm.backend}, device {device}")
        else:
            mesh = make_mesh() if device.type == "cuda" \
                else make_mesh(devices=[device])
            print(f"Distributed run: {multihost.process_count()} "
                  f"processes, {mesh.size} global devices")
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

        red = None
        if mesh is not None:
            from rails_tpu_torch.parallel.schur_dist import (
                distribute_schur, pad_system)

            # the mesh needs the dynamic row count divisible by its size:
            # pad with decoupled stable zero-forced rows when it is not
            # (deterministic, so --only-eigenvalues reloads stay
            # consistent; the padded solution block is exactly zero)
            a, m, b, n_pad = pad_system(a, m, b, mesh.size)
            if n_pad:
                print(f"Padded system with {n_pad} decoupled rows for the "
                      f"{mesh.size}-device mesh")
            m_sp = sp.csr_matrix(m)
            mdiag = np.asarray(m_sp.diagonal()).ravel()
            if np.any(np.abs(mdiag) < 1e-12):
                # the distributed Schur path, the reference main program's
                # production configuration
                print("Computing Schur complement")
                with timer("Driver", "schur"):
                    red = schur_reduce(a, m, b, dtype=dtype, device=device)
                if not args.only_eigenvalues:
                    aop = distribute_schur(red, mesh, fmt=args.fmt)
                    msop, bs = red.ms, red.bs
            else:
                # the direct path needs a DIAGONAL M (it builds a
                # DiagonalOperator; dropping off-diagonals would solve
                # another equation)
                off_diag = m_sp - sp.diags(mdiag)
                if off_diag.nnz and abs(off_diag).max() > 1e-14:
                    raise SystemExit(
                        "--distributed currently supports diagonal mass "
                        "matrices only (M has off-diagonal entries; run "
                        "without --distributed)")
                if not args.only_eigenvalues:
                    aop = rails_tpu_torch.sparse_from_scipy(
                        sp.csr_matrix(a), fmt=args.fmt, dtype=dtype,
                        device=device)
                    msop = rails_tpu_torch.DiagonalOperator(
                        mdiag, is_spd=bool(np.all(mdiag > 0)), device=device)
                    bs = np.asarray(b.todense()) if sp.issparse(b) \
                        else np.asarray(b)
                    if bs.ndim == 1:
                        bs = bs[:, None]
        else:
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
        v_dev = None
        if not args.only_eigenvalues:
            print("Creating solver")
            if mesh is not None:
                # each process places its own rows of B (the reference's
                # distributed MatrixMarket load, main.cpp:66-68)
                r0, r1 = mesh.local_range(bs.shape[0])
                b_arr = multihost.make_global_array(
                    torch.as_tensor(bs, dtype=dtype, device=device)[r0:r1],
                    mesh)
                solver = rails_tpu_torch.LyapunovSolver(
                    aop, b_arr, msop, options=opts, mesh=mesh)
                print(f"Distributed operator: {type(solver.A).__name__}")
            else:
                solver = rails_tpu_torch.LyapunovSolver(
                    red.operator, red.bs, red.ms, options=opts,
                    device=device)
            if red is not None:
                # the projected dense solve the run takes, as the solver
                # picks it from S's tags: eigh where S is tagged
                # symmetric (schur.py), else Schur or sign
                method, _ = solver._resolve_lyap_method()
                tag = "symmetric" if solver.A.is_symmetric \
                    else "not symmetric"
                print(f"Projected solver: {method} (S {tag})")
            print("Performing solve")
            if red is not None:
                print(f"Amount of matrix-vector products before the "
                      f"solve: {red.mvps}")
            v, t, info = solver.solve()
            print(f"Amount of matrix-vector products after the solve: "
                  f"{info.mvps}")
            outcome = "converged" if info.converged else "did not converge"
            print(f"Solver {outcome} in {info.iter} iterations, "
                  f"relative residual {info.res:.3e}, space size "
                  f"{v.shape[1]}")
            v_dev = v
            if comm is not None:
                # this process's rows -> the whole V on every process (the
                # JAX package's process_allgather): the checkpoint and the
                # Schur path's full-space operator read it
                v = multihost.allgather_rows(v, mesh)
            with timer("Driver", "checkpoint"):
                if comm is None or comm.rank == 0:
                    rio.write_matrix_market(v_path, v)
                    rio.write_matrix_market(t_path, t)
                    if comm is not None:
                        print("Wrote V.mtx and T.mtx")
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
            eig_mesh = None
            if red is None and v_dev is not None:
                # the distributed direct path: X = (V T) V' over the
                # solver's V, with eigs on the mesh
                sop = rails_tpu_torch.LowRankOperator(v_dev @ t, v_dev,
                                                      device=device,
                                                      comm=comm)
                eig_mesh = mesh
            elif red is None:
                # the direct path with V reloaded from disk: X = V T V'
                # applied factored
                sop = rails_tpu_torch.CallableOperator(
                    lambda x: v @ (t @ (v.T @ x)), (v.shape[0], v.shape[0]),
                    is_symmetric=True)
            else:
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
                dtype=dtype, device=device, mesh=eig_mesh)

        with timer("Driver", "trace"):
            # the direct path: tr(V T V') = tr(T) for orthonormal V
            trace = float(torch.trace(t)) if red is None \
                else float(red.trace(v, t))

        print(f"{'eigenvalue':>20}{'eigenvalue/trace':>20}")
        for lam in evals.detach().cpu().numpy():
            print(f"{lam:>20.12g}{lam / trace:>20.12g}")

        save_profiles()
    finally:
        disable_profiling()
    if comm is not None:
        st = comm.stats
        print(f"Collectives: {st.calls} calls, {st.bytes} bytes sent, "
              f"{st.staged_bytes} bytes staged through the host")
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(main())
