"""Continuation runs: a sequence of similar Lyapunov problems, each warm
started from the previous solution - the counterpart of the JAX
package's ``continuation.py``.

The reference's driving application is the continuation of probability
densities of ocean models along a branch of Jacobians A(theta_i), each
solve warm started from the previous one (MATLAB ``restart_data``, the
C++ "Restart from solution" parameter).  This module packages the loop:

    cont = ContinuationSolver(b, m, tol=..., device="cuda")
    for a in jacobians:
        v, t, info = cont.step(a)

The carried basis is rotated onto the dominant ``reduced_size``
eigenvectors of T before re-entry (``_truncate_basis``), so every warm
step enters at the same k0, and it is marked
``space_is_orthogonalized`` (a unitary rotation of an orthonormal basis
needs no re-orthonormalisation), except under M-orthogonalisation with a
new M.  A warm step applies the new A to all k0 carried columns in its
first Gram block: with an ELL matrix built with ``wide_s=True`` and
k0 >= 192 columns at float32, that apply goes to the dense-window kernel
(``sparse/wide_spmm.py``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from rails_tpu_torch.core.options import SolverOptions
from rails_tpu_torch.core.solver import LyapunovSolver
from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["ContinuationSolver"]


class ContinuationSolver:
    """``ContinuationSolver(b, m=None, options=None, *, device=None,
    draws=None, engine_cache=None, **opt_kwargs)``; every step runs a
    ``LyapunovSolver`` on ``device`` (default ``cuda``) with these
    options and ``draws`` hook.

    All steps share one engine cache (``engine_cache``, a new dict by
    default), as in the JAX package: a ``step(..., compiled=True)``
    whose operators have the structure of an earlier step's (format,
    shapes, DIA offsets, ELL tile windows) replays that step's recorded
    iteration against the new Jacobian, with no new capture.  The cold
    step and the warm steps differ in ``restart_upon_start``, so they
    hold one engine each.  ``mesh``: every step's solver runs
    row-sharded on it (``LyapunovSolver(mesh=...)``)."""

    def __init__(self, b, m=None, options: Optional[SolverOptions] = None,
                 mesh=None, *, device=None, draws=None,
                 engine_cache: Optional[dict] = None, **opt_kwargs):
        self._engine_cache = {} if engine_cache is None else engine_cache
        self.mesh = mesh
        self.b = b
        self.m = m
        self.device = device
        self.draws = draws
        self.options = options or SolverOptions(**opt_kwargs)
        self._prev_space = None
        self.history = []

    @staticmethod
    def _truncate_basis(v: torch.Tensor, t: torch.Tensor,
                        reduced_size: int) -> torch.Tensor:
        """Rotate V onto the dominant-|lambda| eigenvectors of T and keep
        at most ``reduced_size`` columns (the reference's restart
        rotation, applied between steps), in full float32 precision."""
        k = v.shape[1]
        if reduced_size <= 0 or k <= reduced_size:
            return v
        with full_precision():
            evals, evecs = torch.linalg.eigh(0.5 * (t + t.T))
            order = torch.argsort(-torch.abs(evals), stable=True)
            return v @ evecs[:, order[:reduced_size]]

    def step(self, a, b=None, m=None, compiled: bool = False):
        """Solve with operator ``a``, warm started from the last step."""
        warm = self._prev_space is not None
        # the carried basis is orthonormal, except in the inner product
        # of a new M under M-orthogonalisation
        still_orthonormal = warm and not (
            self.options.ortho == "M" and m is not None)
        opts = dataclasses.replace(
            self.options,
            space=self._prev_space if warm else self.options.space,
            space_is_orthogonalized=still_orthonormal
            or self.options.space_is_orthogonalized,
            restart_upon_start=warm or self.options.restart_upon_start,
        )
        solver = LyapunovSolver(a, b if b is not None else self.b,
                                m if m is not None else self.m,
                                options=opts, mesh=self.mesh,
                                device=self.device, draws=self.draws,
                                engine_cache=self._engine_cache)
        v, t, info = solver.solve(compiled=compiled)
        self._prev_space = self._truncate_basis(
            v, t, self.options.reduced_size)
        self.history.append(info)
        return v, t, info

    def save(self, path: str) -> None:
        """Write the continuation state (the last carried subspace) so
        that a later process can resume the sequence."""
        if self._prev_space is None:
            raise ValueError("no step has completed; nothing to save")
        from rails_tpu_torch.io import save_restart_data

        save_restart_data(path, {"V": self._prev_space})

    def load(self, path: str) -> None:
        """Resume from a state written by ``save``: the next ``step``
        warm starts from the stored subspace."""
        from rails_tpu_torch.io import load_restart_data

        self._prev_space = torch.from_numpy(
            np.asarray(load_restart_data(path)["V"]))
