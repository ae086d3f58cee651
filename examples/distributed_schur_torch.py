"""Distributed Schur-complement solve on rails_tpu_torch (the port of
examples/distributed_schur.py) - the reference's production configuration
(an MPI solve on the SchurOperator) on the port's device mesh.

Builds a random index-1 DAE (singular diagonal mass matrix), pads it to
the mesh geometry, reduces it to the dynamic block with a matrix-free
Schur complement whose A12/A21/A22 applies run row-sharded over the mesh
(A11's dense LU held once for every shard), solves the projected
Lyapunov equation, and checks the solve against the single-controller
path.  The port's mesh is one device repeated eight times: the shards
run one after the other on it.

Run:  python examples/distributed_schur_torch.py [--device cpu]
(default: the CUDA card; ``--device cpu`` runs it on the CPU)
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))  # run as python examples/<name>.py

import numpy as np
import scipy.sparse as sp
import torch

import rails_tpu_torch as rt
from rails_tpu_torch.parallel.schur_dist import distribute_schur, pad_system

N_SHARDS = 8


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    dtype = torch.float64
    mesh = rt.make_mesh(devices=[dev] * N_SHARDS)
    nd = mesh.size
    print(f"devices: {nd} ({dev} repeated)")
    rng = np.random.default_rng(0)
    n = 240
    a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
    a = sp.csr_matrix(a - 3.0 * np.eye(n))
    mdiag = rng.uniform(0.5, 1.5, n)
    mdiag[rng.permutation(n)[: n // 3]] = 0.0   # index-1 DAE structure
    m = sp.diags(mdiag).tocsr()
    b = rng.uniform(-1, 1, (n, 2))
    b[mdiag == 0] = 0.0

    # pad the dynamic row count to a mesh multiple (even row slabs;
    # padding rows are decoupled, stable and zero-forced, so the padded
    # solution block is exactly zero)
    a_p, m_p, b_p, n_pad = pad_system(a, m, b, nd)
    print(f"padded with {n_pad} rows for the {nd}-shard mesh")

    red = rt.schur_reduce(a_p, m_p, b_p, dtype=dtype, device=dev)
    print(f"Schur split: n1={red.n1} (algebraic), n2={red.n2} (dynamic)")

    s_dist = distribute_schur(red, mesh)
    print(f"distributed operator: {type(s_dist).__name__}")
    solver = rt.LyapunovSolver(s_dist, red.bs, red.ms, mesh=mesh,
                               tol=1e-8, maxit=150, device=dev)
    v, t, info = solver.solve()
    print(f"distributed solve: {info.iter} iterations, "
          f"residual {info.res:.2e}, rank {v.shape[1]}")

    # single-controller oracle
    v1, t1, info1 = rt.solve(red.operator, red.bs, red.ms, tol=1e-8,
                             maxit=150, device=dev)
    print(f"single-controller:  {info1.iter} iterations, "
          f"residual {info1.res:.2e}")
    assert info.iter == info1.iter

    # true residual of the distributed solve in the reduced space
    eye = torch.eye(red.n2, dtype=dtype, device=dev)
    s_dense = red.operator.matmat(eye).cpu().numpy()
    msd = np.diag(red.ms_diag.cpu().numpy())
    vh, th, bs = v.cpu().numpy(), t.cpu().numpy(), red.bs.cpu().numpy()
    x = vh @ th @ vh.T
    r = s_dense @ x @ msd + msd @ x @ s_dense.T + bs @ bs.T
    rel = np.linalg.norm(r, 2) / np.linalg.norm(bs.T @ bs, 2)
    print(f"true relative residual: {rel:.2e}")
    assert rel < 1e-7
    print("ok")


if __name__ == "__main__":
    main()
