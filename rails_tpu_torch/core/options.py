"""Solver options - union of the reference's C++ parameters
(src/LyapunovSolver.hpp:72-98) and the MATLAB opts struct
(matlab/RAILSsolver.m:93-254), with the JAX package's own knobs.
A copy of the JAX package's ``core/options.py``; the port imports nothing
of that package.  ``timevec_chunk`` sets, for ``solve(compiled=True)``,
how many iterations run between two host reads of the state: replays of
the recorded iteration on the card (``core/engine.py``), eager
iterations on the CPU.

Validation rules mirror the reference's error ids
(RAILSsolver:InvalidOption etc.).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional

__all__ = ["SolverOptions", "InvalidOption", "InverseNotUsedWarning",
           "SingularMassMatrixWarning", "ProjectionMethodWarning"]


class InvalidOption(ValueError):
    """Mirrors MATLAB error id 'RAILSsolver:InvalidOption'."""


class InverseNotUsedWarning(UserWarning):
    """Mirrors MATLAB warning id 'RAILSsolver:InverseNotUsed'."""


class SingularMassMatrixWarning(UserWarning):
    """Mirrors MATLAB warning id 'RAILSsolver:SingularMassMatrix'."""


class ProjectedSolverPerformanceWarning(UserWarning):
    """The projected dense solve will run the QR-iteration Schur
    fallback (untagged general A at capacity > 128) - orders of
    magnitude slower per iteration than the eigh/sign paths the
    operator tags unlock.  No reference analogue (SLICOT sb03md is
    CPU-cheap)."""


class ProjectionMethodWarning(UserWarning):
    """Mirrors MATLAB warning id 'RAILSsolver:ProjectionMethod' (emitted
    on non-convergence at maxit with projection_method == 1,
    matlab/RAILSsolver.m:438-452)."""


@dataclasses.dataclass
class SolverOptions:
    # --- core iteration (C++ names in comments) ---
    maxit: int = 100                     # "Maximum iterations" (MATLAB default)
    tol: float = 1e-4                    # "Tolerance" (MATLAB default)
    expand: Optional[int] = None         # "Expand size"; None -> min(3, cols(B))
                                         # (RAILSsolver.m:127; explicit values
                                         #  larger than cols(B) are rejected,
                                         #  RAILSsolver.m:216-218)
    lanczos_vectors: Optional[int] = None  # "Lanczos iterations"; None -> max(2*expand, 10)
    lanczos_tolerance: Optional[float] = None  # residual-Lanczos stopping
                                         # tolerance: the recurrence halts
                                         # (masked) once beta < tol*scale,
                                         # mirroring MATLAB eigs opts.tol

    # --- restarts ---
    restart_size: int = -1               # "Restart size": max space columns
    reduced_size: int = -1               # "Reduced size": columns kept at restart
    restart_iterations: int = -1         # "Restart iterations" (MATLAB default -1;
                                         #  the C++ default is 20)
    restart_tolerance: Optional[float] = None  # "Restart tolerance"; None -> 1e-3*tol
    restart_tolerance_mode: str = "relative"  # 'relative' (MATLAB, d/max(d) >
                                         # rtol) or 'absolute' (C++, |d| > rtol)
    restart_upon_convergence: bool = True  # == C++ "Minimize solution space"
    restart_upon_start: bool = False

    # --- space / warm start ---
    space: Optional[Any] = None          # initial V_0 (array)
    space_is_orthogonalized: bool = False
    restart_data: Optional[dict] = None  # {V, AV, VAV} warm start
    restart_from_solution: bool = False  # C++ param: treat `space` as previous V

    # --- projection methods / inexact inverse ---
    projection_method: float = 1.0       # 1, 1.1, 1.2, 1.3, 2.1, 2.2, 2.3
    inv_a: Optional[Callable] = None     # opts.invA / opts.Ainv: x -> A^{-1} x

    # --- orthogonalization ---
    ortho: Optional[str] = None          # 'M' for M-orthogonalization
    nullspace: Optional[Any] = None      # (m, q) basis to deflate
    fast_orthogonalization: bool = True  # block CGS(2) vs per-column MGS
    ortho_drop_tol: float = 1e-8         # MATLAB Morth tol

    # --- JAX-package knobs ---
    dtype: Any = None                    # None -> torch.get_default_dtype()
    max_space: Optional[int] = None      # hard cap on the padded basis buffer
    projected_solver: str = "auto"       # 'auto'|'schur'|'eigh'|'sign'|'kron'
    lanczos_reorth: bool = True          # full reorthogonalization in the
                                         # residual Lanczos (the reference
                                         # does not reorthogonalize)
    precision: str = "standard"          # 'standard' | 'compensated':
                                         # compensated runs every m-length
                                         # reduction through the error-free-
                                         # transform kernels (utils/
                                         # compensated.py), restoring ~f64-
                                         # quality Gram/Lanczos/ortho scalars
                                         # from f32 storage
    timevec_chunk: int = 8               # compiled=True runs the
                                         # while_loop in chunks of this
                                         # many iterations so timevec has
                                         # real per-chunk wall-clock marks
                                         # (exact at chunk boundaries,
                                         # interpolated within); 0 -> one
                                         # uninterrupted while_loop and a
                                         # uniform timevec
    seed: int = 4634
    verbosity: int = 0

    def __post_init__(self):
        if isinstance(self.verbosity, str):
            self.verbosity = 1 if self.verbosity == "Verbose" else int(self.verbosity)
        if self.reduced_size > 0 and self.restart_size > 0 \
                and self.reduced_size >= self.restart_size:
            raise InvalidOption(
                "reduced_size should be smaller than restart_size")
        if self.reduced_size <= 0 and self.restart_size > 0:
            # MATLAB: reduced_size = restart_size / 2
            self.reduced_size = self.restart_size // 2
        if self.precision not in ("standard", "compensated"):
            raise InvalidOption(f"invalid precision {self.precision!r}")
        if self.restart_tolerance_mode not in ("relative", "absolute"):
            raise InvalidOption(
                f"invalid restart_tolerance_mode {self.restart_tolerance_mode!r}")
        if self.lanczos_vectors is not None and self.expand is not None \
                and self.lanczos_vectors <= self.expand:
            # C++ set_parameters validation (LyapunovSolver.hpp:89-95)
            raise InvalidOption(
                "Amount of Lanczos iterations is smaller than the amount "
                "of vectors that are used to expand the space")
        pm = self.projection_method
        major = math.floor(pm)
        minor = round((pm - major) * 10)
        if major not in (1, 2) or minor not in (0, 1, 2, 3):
            raise InvalidOption(f"invalid projection_method {pm}")
        self.projection_major = major
        self.projection_minor = minor

    @property
    def effective_restart_tolerance(self) -> float:
        return self.restart_tolerance if self.restart_tolerance is not None \
            else 1e-3 * self.tol

    @property
    def effective_expand(self) -> int:
        """The resolved expand size (LyapunovSolver binds the MATLAB
        min(3, cols(B)) default at construction; 3 until then)."""
        return 3 if self.expand is None else self.expand

    @property
    def effective_lanczos(self) -> int:
        if self.lanczos_vectors is not None:
            return self.lanczos_vectors
        # The C++ default is 10 plain Lanczos steps (LyapunovSolver.hpp:89-95);
        # MATLAB uses ARPACK eigs.  With warm-started, fully-reorthogonalized
        # Lanczos (the dominant residual eigenvector is carried across outer
        # iterations), 10 steps match ARPACK candidate quality on the
        # reference problems at a third of the m-sized work.
        return max(self.effective_expand + 4, 10)

    @property
    def uses_inverse_on_expand(self) -> bool:
        """MATLAB: 1 < pm < 2 -> w = inv(A) w;  2 < pm < 3 -> [w, inv(A) w]
        (matlab/RAILSsolver.m:520-524)."""
        return self.projection_minor > 0

    @property
    def expansion_doubles(self) -> bool:
        """projection_method 2.x appends [w, A^{-1} w]."""
        return self.projection_major == 2 and self.projection_minor > 0
