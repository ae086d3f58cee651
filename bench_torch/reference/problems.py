"""Problem builders of the benchmark's configurations, plain scipy.

``operator`` builds A from the configuration's ``family``: the file
``families/<family>.py``, whose ``operator(config)`` returns A as a
float64 ``scipy.sparse.csr_matrix`` built from the configuration's own
keys (``side`` and any key of the family's), with plain numpy and scipy
and nothing drawn at random.  A new operator is one such file and a
configuration that names it.  ``schur_blocks`` is the index split of the
reference's SchurOperator (src/SchurOperator.cpp:73-153): the rows where
diag(M) is zero against the rest.
"""

from __future__ import annotations

import importlib.util
from pathlib import Path

import numpy as np
import scipy.sparse as sp

FAMILIES_DIR = Path(__file__).resolve().parent / "families"


def operator(config) -> sp.csr_matrix:
    """A of ``config`` in float64, by its ``family``'s file."""
    family = config["family"]
    present = sorted(p.stem for p in FAMILIES_DIR.glob("*.py"))
    if family not in present:
        raise SystemExit(f"no operator family {family!r} in {FAMILIES_DIR} "
                         f"(it has {present})")
    spec = importlib.util.spec_from_file_location(
        f"bench_torch.reference.families.{family.replace('.', '_')}",
        FAMILIES_DIR / f"{family}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.operator(config)


def schur_blocks(a: sp.csr_matrix, md: np.ndarray):
    """(i1, i2, {A11, A12, A21, A22}) for M = diag(md): i1 the rows where
    md is zero."""
    i1 = np.flatnonzero(md == 0.0)
    i2 = np.flatnonzero(md != 0.0)
    a = a.tocsr()
    blocks = {"A11": a[i1][:, i1], "A12": a[i1][:, i2],
              "A21": a[i2][:, i1], "A22": a[i2][:, i2]}
    return i1, i2, {k: v.tocsr() for k, v in blocks.items()}
