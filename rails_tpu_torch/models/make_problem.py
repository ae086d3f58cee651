"""Write a test problem as A.mtx / B.mtx / M.mtx for the CLI driver.

    python -m rails_tpu_torch.models.make_problem [--kind dae|laplace|moc] [dir]

The same problems, drawn the same way, as the JAX package's
``models/make_problem.py``: 'dae' is a small random index-1 DAE
(singular diagonal M - the Schur path the reference driver expects);
'laplace' the 2D Laplacian with a random SPD diagonal M; 'moc' the
DataErik ocean problem with border augmentation (needs the DataErik
files, see ``rails_tpu_torch.io``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import scipy.sparse as sp


def make(kind: str, directory: str, n: int = 64, seed: int = 4634) -> None:
    from rails_tpu_torch import io as rio

    rng = np.random.default_rng(seed)
    if kind == "dae":
        a = rng.uniform(-1, 1, (n, n)) * (rng.uniform(0, 1, (n, n)) < 0.2)
        a = sp.csr_matrix(a - 3.0 * np.eye(n))
        mdiag = rng.uniform(0.5, 1.5, n)
        mdiag[rng.permutation(n)[: n // 3]] = 0.0
        m = sp.diags(mdiag).tocsr()
        b = rng.uniform(-1, 1, (n, 1))
        b[mdiag == 0] = 0.0
    elif kind == "laplace":
        from rails_tpu_torch.models.problems import laplacian2

        a = sp.csr_matrix(laplacian2(n))
        m = sp.diags(rng.uniform(0.5, 1.5, n)).tocsr()
        b = rng.uniform(0, 1, (n, 1))
    elif kind == "moc":
        a0, m0, b0 = rio.load_moc_problem()
        a, m, b = rio.add_border(a0, m0, b0, rio.moc_border(a0.shape[0]))
    else:
        raise ValueError(kind)

    os.makedirs(directory, exist_ok=True)
    rio.write_matrix_market(os.path.join(directory, "A.mtx"), a)
    rio.write_matrix_market(os.path.join(directory, "M.mtx"), m)
    rio.write_matrix_market(os.path.join(directory, "B.mtx"),
                            sp.csr_matrix(b))
    print(f"wrote {kind} problem (n={a.shape[0]}) to {directory}")


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("directory", nargs="?", default=".")
    ap.add_argument("--kind", default="dae",
                    choices=["dae", "laplace", "moc"])
    ap.add_argument("--n", type=int, default=64)
    ap.add_argument("--seed", type=int, default=4634)
    args = ap.parse_args(argv)
    make(args.kind, args.directory, n=args.n, seed=args.seed)


if __name__ == "__main__":
    main()
