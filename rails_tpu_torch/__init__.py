"""rails_tpu_torch: the PyTorch / CUDA port of rails_tpu.

Solves  A @ X @ M' + M @ X @ A' + B @ B' = 0  for X ~= V T V' low rank,
with the algorithm of the JAX package ``rails_tpu`` and a hand-written
CUDA kernel for every Pallas TPU kernel on the ported path.  Entry points
run on ``cuda`` unless the caller passes ``device="cpu"``; asking for
``cuda`` without a card raises.

Ported so far: the operators; the DIA, ELL and HYB formats with their
CUDA SpMM kernels, the hub split for power-law sparsity
(``hub_operator``: dense hub rows by one GEMM, hub columns and bulk
through the ELL kernel), and the ELL format's dense-window payload for wide
multivectors (``wide_s=True``) with its CUDA kernel; the dense projected
Lyapunov solvers; the solver, in standard and compensated precision; the
refined driver ``solve_refined`` (staged defect correction to 1e-8 at
float32); continuation runs with warm starts (``ContinuationSolver``);
the Schur reduction for a singular M (A11 by dense LU, the C++ sparse
LU ``native_lu`` on the host, or BiCGStab); the eigensolvers; MatrixMarket
I/O (the port's C++ MatrixMarket reader first, ``native/``),
parameter files and the CLI (``python -m rails_tpu_torch.cli``);
the row-sharded mesh path (``make_mesh``, ``parallel/``: halo DIA with
its CUDA kernel, halo ELL/HYB, the distributed Schur operator, ``mesh=``
on the solver, ``eigs`` and continuation, the CLI's ``--distributed``)
on one device.
It imports neither ``jax`` nor ``rails_tpu``.
"""

__version__ = "0.1.0"

from rails_tpu_torch.linalg.dense_lyap import lyap, lyap_residual  # noqa: F401
from rails_tpu_torch.operators import (  # noqa: F401
    CallableOperator,
    DenseOperator,
    DiagonalOperator,
    IdentityOperator,
    LinearOperator,
    LowRankOperator,
    as_operator,
    operator_norm2,
)
from rails_tpu_torch.core.options import (  # noqa: F401
    InvalidOption,
    InverseNotUsedWarning,
    ProjectedSolverPerformanceWarning,
    ProjectionMethodWarning,
    SingularMassMatrixWarning,
    SolverOptions,
)
from rails_tpu_torch.core.solver import (  # noqa: F401
    LyapunovSolver,
    SolveInfo,
    solve,
)
from rails_tpu_torch.continuation import ContinuationSolver  # noqa: F401
from rails_tpu_torch.eigs import eigs, eigs_general  # noqa: F401
from rails_tpu_torch.parallel.mesh import make_mesh  # noqa: F401
from rails_tpu_torch.refine import RefineInfo, solve_refined  # noqa: F401
from rails_tpu_torch.schur import SchurReduction, schur_reduce  # noqa: F401
from rails_tpu_torch.sparse.hub import (  # noqa: F401
    HubSplitOperator,
    hub_coverage,
    hub_operator,
)
from rails_tpu_torch.sparse.formats import (  # noqa: F401
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    SparseOperator,
    sparse_from_csr,
    sparse_from_dense,
    sparse_from_scipy,
)
from rails_tpu_torch.timer import (  # noqa: F401
    disable_profiling,
    enable_profiling,
    save_profiles,
    timer,
)
