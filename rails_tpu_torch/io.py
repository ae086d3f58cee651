"""Matrix I/O: MatrixMarket files and the DataErik ocean-model format - a
copy of the JAX package's ``io.py`` (the port imports nothing of that
package).  MatrixMarket coordinate files go through the port's C++
reader (``native/host_lib.py``), as the JAX package reads them with its
own; ``scipy.io`` reads the variants that reader declines (array format,
complex, hermitian, skew-symmetric).

- MatrixMarket load/store of A/B/M and the V/T checkpoint
  (the reference's EpetraExt I/O, src/main.cpp:62-72,123-138);
- the DataErik CSR-like on-disk layout (Ap1.beg/jco/co + Bp1.co +
  Frcp1.co) and its preprocessing into (A, M, B)
  (matlab/test/test_MOC.m:100-133);
- the nullspace border augmentation used for the MOC problem
  (matlab/test/test_MOC.m:136-160);
- warm-start data of a solve, saved to and loaded from one ``.npz``.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Tuple

import numpy as np
import scipy.io
import scipy.sparse as sp

__all__ = [
    "read_matrix_market",
    "write_matrix_market",
    "load_dataerik",
    "load_moc_problem",
    "moc_border",
    "add_border",
    "save_restart_data",
    "load_restart_data",
]

# the reference's DataErik files (Ap1.*, Bp1.co, Frcp1.co), expected in
# data/DataErik at the root of the repository
REFERENCE_DATAERIK = str(Path(__file__).resolve().parent.parent / "data"
                         / "DataErik")


def read_matrix_market(path: str):
    """Returns scipy CSR (coordinate files) or ndarray (array files)."""
    from rails_tpu_torch.native import host_lib

    out = host_lib.read_matrix_market(path)
    if out is not None:
        return out
    m = scipy.io.mmread(path)
    return m.tocsr() if sp.issparse(m) else np.asarray(m)


def write_matrix_market(path: str, a, comment: str = "") -> None:
    """Write a scipy sparse matrix (coordinate) or an array (array
    format) to exactly ``path``."""
    if not sp.issparse(a):
        a = np.asarray(a.detach().cpu().numpy() if hasattr(a, "detach")
                       else a)
    else:
        a = sp.csr_matrix(a)
    scipy.io.mmwrite(path, a, comment=comment)
    # scipy appends .mtx if missing; normalize to the exact path
    if not os.path.exists(path) and os.path.exists(path + ".mtx"):
        os.replace(path + ".mtx", path)


def load_dataerik(directory: str = REFERENCE_DATAERIK,
                  prefix: str = "Ap1", mass: str = "Bp1",
                  forcing: str = "Frcp1"):
    """Raw DataErik arrays: (A csr, diag(M), F).

    On-disk layout (matlab/test/test_MOC.m:100-123): <prefix>.beg holds
    1-based row pointers, .jco 1-based column indices, .co values;
    <mass>.co is the diagonal of M; <forcing>.co the forcing vector.
    """
    def load(name):
        return np.loadtxt(os.path.join(directory, name))

    info = load(f"{prefix}.info").astype(int).ravel()
    n, nnz = int(info[0]), int(info[1])
    beg = load(f"{prefix}.beg").astype(np.int64) - 1   # to 0-based
    jco = load(f"{prefix}.jco").astype(np.int64) - 1
    co = load(f"{prefix}.co")
    if len(beg) != n + 1 or len(jco) != nnz:
        raise ValueError(f"{directory}: {prefix}.info says n={n}, "
                         f"nnz={nnz}; .beg has {len(beg)} entries, .jco "
                         f"{len(jco)}")
    a = sp.csr_matrix((co, jco, beg), shape=(n, n))
    mdiag = load(f"{mass}.co")
    f = load(f"{forcing}.co")
    return a, mdiag, f


def load_moc_problem(directory: str = REFERENCE_DATAERIK):
    """(A, M, B) of the MOC ocean problem after the reference's
    preprocessing (matlab/test/test_MOC.m:100-133):

    - of every 6 unknowns per grid cell, only fields 4 (temperature) and 5
      (salinity, 0-based) keep their mass-matrix entries;
    - the stochastic forcing B = 0.1 * F acts on salinity only.
    """
    a, mdiag, f = load_dataerik(directory)
    n = a.shape[0]
    j = np.arange(n)
    mdiag = mdiag.copy()
    mdiag[(j % 6) <= 3] = 0.0        # zero all but temperature/salinity
    f = f.copy()
    f[(j % 6) <= 4] = 0.0            # zero all but salinity
    b = 0.1 * f[:, None]
    m = sp.diags(mdiag).tocsr()
    return a, m, b


def moc_border(n: int) -> np.ndarray:
    """The two checkerboard nullspace border vectors of the MOC problem
    (matlab/test/test_MOC.m:136-160): pressure dofs (field 3) split by the
    parity of their horizontal cell index."""
    border = np.zeros((n, 2))
    j = np.arange(3, n, 6)
    cell = j // 6
    even = ((cell % 4) + ((cell // 4) % 16)) % 2 == 0
    border[j[even], 0] = 1.0
    border[j[~even], 1] = 1.0
    return border


def add_border(a, m, b, border) -> Tuple[sp.csr_matrix, sp.csr_matrix,
                                         np.ndarray]:
    """Append nullspace border rows/columns:
    A2 = [[A, W], [W', 0]], M2 = blkdiag(M, 0), B2 = [B; 0]
    (matlab/test/test_MOC.m:136-160)."""
    a = sp.csr_matrix(a)
    border = np.asarray(border)
    q = border.shape[1]
    a2 = sp.bmat([[a, sp.csr_matrix(border)],
                  [sp.csr_matrix(border.T), None]], format="csr")
    m2 = sp.bmat([[sp.csr_matrix(m), None],
                  [None, sp.csr_matrix((q, q))]], format="csr")
    b = np.asarray(b)
    if b.ndim == 1:
        b = b[:, None]
    b2 = np.vstack([b, np.zeros((q, b.shape[1]))])
    return a2, m2, b2


def save_restart_data(path: str, restart_data: dict) -> None:
    """Persist a solve's warm-start data ``{V, AV, VAV}``
    (``SolveInfo.restart_data``, tensors or arrays) to one ``.npz`` file;
    load with ``load_restart_data`` and pass as
    ``SolverOptions(restart_data=...)``."""
    arrays = {k: (v.detach().cpu().numpy() if hasattr(v, "detach")
                  else np.asarray(v)) for k, v in restart_data.items()}
    # write through a file object: np.savez(path) appends .npz to
    # suffix-less paths while np.load does not
    with open(path, "wb") as f:
        np.savez(f, **arrays)


def load_restart_data(path: str) -> dict:
    """Load warm-start data written by ``save_restart_data`` (numpy
    arrays; ``interop.restart_data`` puts them on a device)."""
    with np.load(path) as z:
        return {k: z[k] for k in z.files}
