"""Continuation sequence with warm starts and on-disk checkpointing, on
rails_tpu_torch (the port of examples/continuation_sequence.py).

The driving application of the reference is continuation of probability
density functions along a bifurcation branch: a sequence of Jacobians
A(theta_i), each Lyapunov solve warm started from the previous converged
subspace (MATLAB restart_data).

This example solves a 3-step sequence on a generalized 2D-Laplacian
problem (n = 1024, DIA, float64), each step through
``ContinuationSolver.step(compiled=True)``, prints the cold and warm
iteration counts, then resumes the sequence in a fresh solver from a
checkpoint file and prints that step's count.

Run:  python examples/continuation_sequence_torch.py [--device cpu]
(default: the CUDA card; ``--device cpu`` runs it on the CPU)
"""

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run as python examples/<name>.py

import numpy as np
import scipy.sparse as sp
import torch

import rails_tpu_torch as rt


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    device = torch.device(args.device)
    dtype = torch.float64
    n = 1024
    side = int(np.sqrt(n))
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, n)
    b = torch.as_tensor(rng.uniform(0, 1, (n, 8)), dtype=dtype,
                        device=device)

    def jacobian(theta):
        """A(theta): reaction-term sweep over the same sparsity."""
        lap = sp.kron(sp.eye(side),
                      sp.diags([1.0, -4.0 - theta, 1.0], [-1, 0, 1],
                               (side, side))) \
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))
        return rt.sparse_from_scipy(lap.tocsr(), fmt="dia", dtype=dtype,
                                    is_symmetric=True, device=device)

    opts = dict(tol=1e-4, dtype=dtype, expand=6, restart_size=120,
                reduced_size=60, maxit=200)

    def solver():
        return rt.ContinuationSolver(
            b, rt.DiagonalOperator(md, device=device), device=device,
            **opts)

    cont = solver()
    print(f"{'theta':>8}{'iters':>8}{'residual':>12}{'wall':>8}")
    for theta in (0.0, 0.05, 0.1):
        t0 = time.perf_counter()
        v, t, info = cont.step(jacobian(theta), compiled=True)
        print(f"{theta:>8.2f}{info.iter:>8}{info.res:>12.2e}"
              f"{time.perf_counter() - t0:>7.1f}s")

    # checkpoint the converged subspace and resume in a fresh solver (a
    # new process would do exactly the same - the on-disk restart_data)
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "continuation.npz")
        cont.save(ckpt)
        cont2 = solver()
        cont2.load(ckpt)
        v, t, info = cont2.step(jacobian(0.15), compiled=True)
        print(f"resumed theta=0.15 from checkpoint: {info.iter} iterations "
              f"(warm), residual {info.res:.2e}")


if __name__ == "__main__":
    main()
