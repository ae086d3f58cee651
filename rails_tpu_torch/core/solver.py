"""The RAILS iteration in PyTorch - the counterpart of the JAX package's
``core/solver.py``, with the same algorithm and the same static-shape
masked state:

- The search space V lives in an (m, Kb) buffer with an active column
  count ``k``; columns >= k are exactly zero.  AV, MV and BV follow V, and
  the projected matrices VAV/VBV/VMV are (Kb, Kb) buffers that are exactly
  zero outside the active block.  Kb grows on a capacity ladder
  (``_grow_state``) as k approaches it.
- The eager loop solves the projected equation on the active k x k
  block.  The recorded engine, whose shapes stay fixed, solves it on the
  whole buffer, its inactive diagonal padded with a shift that dominates
  the active spectral radius, so the padded equation is always solvable;
  either way T == 0 outside the active block.
- One iteration: the incremental Gram update (one apply of A to the
  newest block), the projected dense solve, the residual Lanczos, then a
  restart or an orthonormal append.

Two paths run the iteration.  The eager path (``compiled=False``) is the
JAX package's host loop: the ``lax.cond``/``scan`` become Python control
flow, the control scalars (k, the iteration counters, the convergence
flags) are Python values, and each iteration reads the residual
estimate back once; its capacity grows on the ladder.
``compiled=True`` is the JAX package's ``while_loop`` engine: the state
at full capacity with its control scalars on the device, one iteration
(``_build_iterate``) written on it in place, recorded into CUDA graphs
on the card and replayed, the host reading the state once per chunk of
``timevec_chunk`` iterations (``core/engine.py`` says which calls stay
on the host between graph segments).  Engines are cached under
``_engine_key`` in ``engine_cache``.  Across processes the same
recording runs on every rank, its row collectives captured (NCCL) or
host steps (gloo), and the ranks' chunk reads are checked to agree.

``precision='compensated'`` runs every m-length reduction through the
error-free transforms of ``utils/compensated.py``, as the JAX package
does: the Gram blocks, residual applies and orthogonalisation products
through ``gram2``, the Lanczos and per-column norms through ``dot2``.

On a multi-process mesh (``mesh.comm``, ``parallel/multihost.py``) each
process holds its own rows of V, AV, MV, B and the Lanczos vectors, and
every reduction over m - the Gram blocks, B'x, the residual apply's
products, the Lanczos scalars and norms, the orthogonalisation - is a
local product reduced over the processes (``_tdot``, ``_vdot``,
``_col_norm``, ``_b_rmatmat``, ``parallel/comm.py``'s ``psum`` and
``row_norm``, and ``_Sums``, which packs the reductions that read one
point of the iteration into one collective): GSPMD's psums in the JAX
package.  The
k-sized state (T, the Gram blocks) and every decision of the host loop
are the same bits on every process.  The random draws are the whole
(m, ...) draws, cut to this process's rows, so N processes draw what one
draws.

Random numbers: the solver draws twice per kind of use - the initial
space (``"init_uniform"``, U[0, 1) mapped to U[-1, 1)) and each Lanczos
start (``"lanczos_normal"``).  ``LyapunovSolver(draws=...)`` replaces the
default ``torch.Generator`` (seeded with ``options.seed``) with any
``draws(kind, shape, dtype, device) -> Tensor``; the parity tests pass
the numbers ``jax.random`` gave the JAX package.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import functools
import time
import warnings
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.core.engine import host_call
from rails_tpu_torch.core.options import (
    InvalidOption, InverseNotUsedWarning, ProjectionMethodWarning,
    SingularMassMatrixWarning, SolverOptions)
from rails_tpu_torch.linalg import dense_lyap
from rails_tpu_torch.operators import (
    DenseOperator, LinearOperator, as_operator, operator_norm2)
from rails_tpu_torch.parallel.comm import psum, row_norm
from rails_tpu_torch.timer import span, timer
from rails_tpu_torch.utils.compensated import (
    dot2, dot2_pair, gram2, gram2_pair, rank_pair_sum)
from rails_tpu_torch.utils.device import as_tensor, resolve_device
from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["LyapunovSolver", "SolveInfo", "solve"]

Draws = Callable[[str, Tuple[int, ...], torch.dtype, torch.device],
                 torch.Tensor]


def _round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


def _dus(buf: torch.Tensor, blk: torch.Tensor, r: int, c: int) -> None:
    """In-place ``lax.dynamic_update_slice``: write ``blk`` at (r, c),
    with the start clamped so the block fits, as XLA clamps it."""
    r = max(0, min(r, buf.shape[0] - blk.shape[0]))
    c = max(0, min(c, buf.shape[1] - blk.shape[1]))
    buf[r:r + blk.shape[0], c:c + blk.shape[1]] = blk


def _eigh_sign_fixed(h: torch.Tensor, calls=dense_lyap.EAGER_CALLS):
    """``torch.linalg.eigh`` with each eigenvector's sign fixed so that
    its entry of largest magnitude (the first, on a tie) is positive.
    LAPACK leaves the sign open and the LAPACKs differ (MKL, cuSOLVER,
    the one jaxlib uses); the residual Lanczos's warm start depends on
    it, so the port fixes it to give one answer on every device."""
    w, v = calls.eigh(h)
    idx = torch.argmax(torch.abs(v), dim=0)
    sgn = torch.sign(v.gather(0, idx[None, :]))
    return w, v * torch.where(sgn == 0, torch.ones_like(sgn), sgn)


@dataclasses.dataclass
class SolverState:
    """All per-iteration data.  Tensors live on the solver's device; the
    control scalars are Python values."""

    V: torch.Tensor            # (m, Kb) search space, cols >= k are zero
    AV: torch.Tensor           # (m, Kb) A @ V
    BV: torch.Tensor           # (p, Kb) B' @ V
    MV: Optional[torch.Tensor]  # (m, Kb) M @ V (None when M is None)
    VAV: torch.Tensor          # (Kb, Kb) V' A V
    VBV: torch.Tensor          # (Kb, Kb) V' B B' V
    VMV: Optional[torch.Tensor]  # (Kb, Kb) V' M V
    T: torch.Tensor            # (Kb, Kb) projected solution
    q_warm: torch.Tensor       # (m, 1) warm start for the residual Lanczos
    k: int                     # active columns
    w_start: int = 0           # offset of newest block
    n_new: int = 0             # valid columns in newest block
    res: float = float("inf")  # last relative residual estimate
    iter: int = 0
    iter_since_restart: int = 0
    converged: bool = False    # tolerance reached at least once
    reduced: bool = False      # post-convergence restart done
    done: bool = False
    status: int = 1            # 0 converged / -1 not / -2 blowup / 1 running
    resvec: Optional[np.ndarray] = None  # (maxit,) residual history
    recvec: Optional[np.ndarray] = None  # (maxit,) bool: entry valid
    mvps: int = 0              # logical A-column applications


@dataclasses.dataclass
class SolveInfo:
    res: float
    iter: int
    status: int
    resvec: np.ndarray
    timevec: np.ndarray
    mvps: int
    restart_data: Optional[dict] = None
    # compiled=True: what the iterations cost the host
    # (core/engine.py::EngineStats), else None
    engine: Optional[dict] = None

    @property
    def converged(self) -> bool:
        return self.status == 0


class LyapunovSolver:
    """Solves A X M' + M X A' + B B' = 0, X ~= V T V'.

    Mirrors RAILS::Solver (src/LyapunovSolverDecl.hpp:9-51) and MATLAB
    RAILSsolver; see SolverOptions for the knob set.

    ``device``: where the solve runs (default ``cuda``; raises without a
    card).  Operators and B are moved there and cast to the solve dtype:
    ``options.dtype``, else B's dtype when B is a floating tensor or
    array, else ``torch.get_default_dtype()``.
    ``b_sign``: optional symmetric (p, p) S making the right-hand side
    B S B' instead of B B'.
    ``draws``: optional random-number hook, see the module docstring.
    ``mesh``: optional row mesh (``parallel/mesh.py``): A, M and an
    operator B go through ``parallel.sharded.shard_operator`` with the
    ``spmm`` strategy, so a DIA, ELL or HYB operator applies through the
    explicit-halo operators; the solve runs on the mesh's device
    (``device``, when given, must be that device).  On a multi-process
    mesh B (the whole array or this rank's slab), ``space``,
    ``restart_data`` and ``nullspace`` may be given whole or as this
    process's rows, and ``solve()`` returns this process's rows of V.
    ``engine_cache``: optional dict shared between solvers (the
    continuation driver passes one across its steps).  ``compiled=True``
    keeps its recorded iterations there under ``_engine_key``: every
    option and structural fact the recording closes over, the operators'
    structure (``core/engine.py::structure``) and the nullspace's shape.
    Values - the operator payloads, B, ``b_sign``, ``r0sq``, the
    nullspace - are copied into the engine's own buffers at each solve,
    so a solver with the same key replays the recording against its own
    values without capturing again.
    """

    def __init__(self, a, b, m=None, options: Optional[SolverOptions] = None,
                 mesh=None, spmm: str = "auto", *, device=None,
                 draws: Optional[Draws] = None, b_sign=None,
                 engine_cache: Optional[dict] = None, **opt_kwargs):
        self.options = options or SolverOptions(**opt_kwargs)
        opt = self.options
        self._engine_cache = {} if engine_cache is None else engine_cache
        self.mesh = mesh
        self.comm = None if mesh is None else mesh.comm
        if mesh is not None:
            from rails_tpu_torch.parallel.mesh import canonical_device

            if device is not None and canonical_device(device) != mesh.device:
                raise ValueError(f"device {device} is not the mesh's "
                                 f"device {mesh.device}")
            device = mesh.device
        self.device = resolve_device(device)
        self.draws = draws
        self.dtype = self._resolve_dtype(b)
        if self.dtype.is_complex:
            raise InvalidOption("the port solves real equations only")
        for name, op in (("A", a), ("M", m), ("B", b)):
            pdt = getattr(op, "payload_dtype", None) if isinstance(
                op, LinearOperator) else None
            if pdt is not None and pdt.is_complex:
                raise InvalidOption(
                    f"operator {name} has complex payload dtype {pdt} but "
                    f"the solve dtype {self.dtype} is real; rebuild the "
                    f"operator at a real dtype")
        self.A = self._prep(as_operator(a, device=self.device,
                                         dtype=self.dtype))
        self.M = None if m is None else self._prep(
            as_operator(m, device=self.device, dtype=self.dtype))
        self.b_sign = None if b_sign is None else as_tensor(
            b_sign, self.device, self.dtype)
        if self.b_sign is not None:
            s = self.b_sign
            if s.ndim != 2 or s.shape[0] != s.shape[1]:
                raise InvalidOption("b_sign must be a square (p, p) matrix")
        if isinstance(b, LinearOperator):
            self.B = self._prep(b)
            self._b_is_operator = True
            self._b_array = None
        else:
            self.B = None
            self._b_is_operator = False
            self._b_array = as_tensor(b, self.device, self.dtype)
            if self._b_array.ndim == 1:
                self._b_array = self._b_array[:, None]
        if not self._b_is_operator:
            p = self._b_array.shape[1]
            if opt.expand is None:
                opt.expand = min(3, p)  # MATLAB default (RAILSsolver.m:127)
            elif opt.expand > p:
                raise InvalidOption(
                    "opts.expand is larger than the column dimension of B")
        elif opt.expand is None:
            opt.expand = 3
        if opt.restart_from_solution and opt.space is None \
                and opt.restart_data is None:
            raise InvalidOption(
                "restart_from_solution requires a previous solution basis "
                "in opts.space")
        if opt.inv_a is not None and opt.projection_major == 1 \
                and opt.projection_minor == 0:
            warnings.warn(
                "An inverse application method is provided, but the current "
                "projection method does not make use of this",
                InverseNotUsedWarning)  # RAILSsolver.m:280-284
        self._check_singular_m()
        if mesh is not None:
            from rails_tpu_torch.parallel.sharded import (
                shard_array_rows, shard_operator)

            self.A = shard_operator(self.A, mesh, spmm=spmm)
            if self.M is not None:
                self.M = shard_operator(self.M, mesh, spmm=spmm)
            if self._b_is_operator:
                self.B = shard_operator(self.B, mesh, spmm=spmm)
            else:
                self._b_array = shard_array_rows(self._b_array, mesh,
                                                 m=self.A.shape[0])

    def _resolve_dtype(self, b) -> torch.dtype:
        if self.options.dtype is not None:
            dt = self.options.dtype
            if not isinstance(dt, torch.dtype):
                dt = getattr(torch, np.dtype(dt).name)
            return dt
        if isinstance(b, torch.Tensor) and b.is_floating_point():
            return b.dtype
        if isinstance(b, np.ndarray) and b.dtype.kind == "f":
            return getattr(torch, b.dtype.name)
        return torch.get_default_dtype()

    def _prep(self, op: LinearOperator) -> LinearOperator:
        return op.to(self.device).astype(self.dtype)

    def _check_singular_m(self) -> None:
        """Warn when the mass matrix looks singular - the reference's
        condest(M) > 1e12 check (RAILSsolver.m:272-277): exact on a
        diagonal M, a host sparse LU and condest on a sparse M or a dense
        one with m <= 4096."""
        M = self.M
        if M is None:
            return
        d = getattr(M, "d", None)
        if d is not None:  # diagonal M: exact and cheap
            dd = np.abs(d.detach().cpu().numpy())
            if dd.size and dd.min() < 1e-12 * max(dd.max(), 1.0):
                warnings.warn(
                    "Your M matrix appears to be singular. It is advised "
                    "to use the provided schur_reduce method.",
                    SingularMassMatrixWarning)  # RAILSsolver.m:273-277
            return
        m = M.shape[0]
        if m > 200_000:  # a host sparse LU at this size is a second
            # solve, not a check; narrate the skip
            if self.options.verbosity > 0:
                print(f"rails_tpu_torch: skipping singular-M condest "
                      f"check (m={m} > 200000); if M may be singular, "
                      f"use schur_reduce")
            return
        import scipy.sparse as sp
        import scipy.sparse.linalg as spla

        from rails_tpu_torch.sparse.formats import (
            SparseOperator, payload_to_scipy)

        if isinstance(M, SparseOperator):
            mat = payload_to_scipy(M.fwd).tocsc()
        elif isinstance(M, DenseOperator) and m <= 4096:
            mat = sp.csc_matrix(M.a.detach().cpu().numpy())
        else:
            # matrix-free M, or a dense one too large to copy: nothing
            # to inspect on the host
            if self.options.verbosity > 0:
                print("rails_tpu_torch: skipping singular-M condest check "
                      "(matrix-free M, or a dense M above 4096 rows); if "
                      "M may be singular, use schur_reduce")
            return
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")  # splu singular warnings
                lu = spla.splu(mat)
                inv1 = spla.onenormest(spla.LinearOperator(
                    mat.shape, matvec=lu.solve,
                    rmatvec=lambda x: lu.solve(x, trans="T")))
            cond = float(inv1) * float(spla.norm(mat, 1))
        except (RuntimeError, ValueError):
            cond = np.inf  # factorization failed -> numerically singular
        if not np.isfinite(cond) or cond > 1e12:
            warnings.warn(
                "Your M matrix appears to be singular. It is advised "
                "to use the provided schur_reduce method.",
                SingularMassMatrixWarning)

    def _resolve_lyap_method(self) -> Tuple[str, bool]:
        """Pick the projected dense solver from operator tags."""
        opt = self.options
        if opt.projected_solver != "auto":
            spd = self.M is not None and self.M.is_spd
            return opt.projected_solver, spd
        mortho = opt.ortho == "M"
        if self.A.is_symmetric and (self.M is None or self.M.is_spd or mortho):
            return "eigh", (self.M is not None and self.M.is_spd and not mortho)
        if self.A.is_hurwitz:
            return "sign", False
        return "schur", False

    # ------------------------------------------------------------------
    # public API
    # ------------------------------------------------------------------
    def solve(self, compiled: bool = False, progress=None):
        """Run the iteration.  Returns (V, T, SolveInfo).

        ``progress``: optional callable ``(iter, wall_s, res)`` called
        after every iteration, or with ``compiled=True`` after every
        chunk of ``timevec_chunk`` iterations.

        ``compiled=True``: the iteration with its control state on the
        device, at the full capacity from the start (the JAX package's
        ``while_loop`` engine): on the card recorded once into CUDA
        graphs and replayed, on the CPU run eagerly; the host reads the
        state once per chunk (``core/engine.py``).  Across processes
        each rank records and replays its own rows' iteration, the row
        collectives captured in the graph segments under NCCL and run as
        host steps under gloo; it returns this rank's rows of V and the
        replicated T and info, as the eager path does."""
        with span("Solver", "solve"):
            if compiled:
                v, t, info = self._solve_compiled(progress)
            else:
                v, t, info = self._solve_eager(progress)
        opt = self.options
        if opt.verbosity > 0:
            outcome = "converged" if info.status == 0 else "did not converge"
            print(f"The Lyapunov solver {outcome} in {info.iter} iterations "
                  f"with a final relative residual of {info.res:e}. "
                  f"The size of the space used for the solution is "
                  f"{v.shape[1]}")
        if info.status == -1 and opt.projection_major == 1 \
                and opt.projection_minor == 0:
            warnings.warn(
                "Convergence has not been achieved with "
                "projection_method = 1. It is advised to set "
                "projection_method to a different value. For instance "
                "projection_method = 1.2.",
                ProjectionMethodWarning)  # RAILSsolver.m:438-452
        return v, t, info

    def _solve_eager(self, progress):
        opt = self.options
        m = self.A.shape[0]
        with full_precision():
            with timer("Solver", "init"):
                st, ctx = self._init_state(m)
            t0 = time.perf_counter()
            timevec = []
            while True:
                # grow the capacity bucket before the step would clip
                # (reference "Resize spaces", LyapunovSolver.hpp:309-332)
                if ctx.kb < ctx.cap_kb and \
                        st.k + 2 * ctx.s_slot > ctx.kb - ctx.s_slot:
                    with timer("Solver", "resize"):
                        self._grow_state(
                            st, min(ctx.cap_kb, _round_up(2 * ctx.kb, 8)))
                        ctx.set_kb(st.VAV.shape[0], m)
                with timer("Solver", "iterate"):
                    self._iterate(st, ctx)
                timevec.append(time.perf_counter() - t0)
                if opt.verbosity > 0:
                    print(f"Iteration {st.iter}. "
                          f"Estimate Lanczos, relative: {st.res:e}, "
                          f"space size: {st.k}")
                if progress is not None:
                    progress(st.iter, timevec[-1], st.res)
                if st.done:
                    break

        k = st.k
        v = st.V[:, :k]
        t = st.T[:k, :k]
        n_it = st.iter
        recvec = st.recvec[:n_it]
        info = SolveInfo(
            res=float(st.res), iter=n_it, status=st.status,
            resvec=st.resvec[:n_it][recvec],
            timevec=np.asarray(timevec, dtype=float)[:n_it][recvec],
            mvps=st.mvps,
            restart_data={"V": v, "AV": st.AV[:, :k],
                          "VAV": st.VAV[:k, :k]})
        return v, t, info

    # ------------------------------------------------------------------
    # compiled=True: the recorded iteration (core/engine.py)
    # ------------------------------------------------------------------
    def _engine_key(self, kb: int, ctx, pins: list):
        """Cache key of an engine: every option and static the recorded
        iteration closes over (the JAX package's list,
        rails_tpu/core/solver.py:318-338), and what that list misses:
        dtype and device, the nullspace's shape (the JAX key records
        only whether there is one), b_sign's shape, the timevec chunk
        (the draws buffer's rows) and whether a draws hook fills it, the
        mesh's shard count, the communicator's world size and backend
        (a rank's rows follow from m and the world), and the operators'
        structure - format, shapes, DIA offsets, ELL tile windows, the
        wide payload's w, tags (``core/engine.py::structure``).  Objects
        known only by identity (``inv_a``, a user's callable) go to
        ``pins``, which the engine keeps alive."""
        from rails_tpu_torch.core.engine import structure

        o = self.options
        if o.inv_a is not None:
            pins.append(o.inv_a)
        return (kb, self.A.shape[0], self._p(), str(self.dtype),
                str(self.device), o.maxit, o.tol, o.expand,
                o.expansion_doubles, o.effective_lanczos,
                o.lanczos_tolerance, o.lanczos_reorth, o.restart_size,
                o.reduced_size, o.restart_iterations,
                o.effective_restart_tolerance, o.restart_tolerance_mode,
                o.restart_upon_start, o.restart_upon_convergence,
                o.fast_orthogonalization, o.ortho, o.ortho_drop_tol,
                o.precision, o.projected_solver, o.projection_major,
                o.projection_minor, o.max_space, o.timevec_chunk,
                self.M is None, self._b_is_operator,
                self._resolve_lyap_method(),
                None if o.inv_a is None else id(o.inv_a),
                None if ctx.nullspace is None
                else tuple(ctx.nullspace.shape),
                None if self.b_sign is None else tuple(self.b_sign.shape),
                self.draws is None,
                None if self.mesh is None else self.mesh.size,
                None if self.comm is None
                else (self.comm.world, self.comm.backend),
                structure(self.A, pins), structure(self.M, pins),
                structure(self.B, pins))

    def _host_steps(self) -> dict:
        """What the recorded iteration runs as host steps besides eigh,
        the card's Schur route and the switch: each operator's
        ``host_steps`` tag (a Schur reduction's ``native_lu`` or
        ``iterative`` A11 solve, through ``engine.host_call``) and an
        ``inv_a`` that the expansion applies (a user's callable, always a
        host step).  Reported in ``info.engine``."""
        out = {}
        for name, op in (("A", self.A), ("M", self.M), ("B", self.B)):
            kind = getattr(op, "host_steps", None)
            if kind:
                out[name] = kind
        opt = self.options
        if opt.inv_a is not None and opt.uses_inverse_on_expand:
            out["inv_a"] = "the expansion's inv_a"
        return out

    def _engine_for(self, st, ctx):
        """The cached engine for this solve's key, built at first use."""
        from rails_tpu_torch.core.engine import (
            DeviceState, Engine, clone_tree)

        opt = self.options
        pins = []
        key = self._engine_key(ctx.kb, ctx, pins)
        eng = self._engine_cache.get(key)
        if eng is None:
            view = copy.copy(self)
            view._engine_cache = None
            view.draws = None
            view.options = dataclasses.replace(
                opt, space=None, restart_data=None, nullspace=None)
            view.A, view.M, view.B = (clone_tree(self.A),
                                      clone_tree(self.M),
                                      clone_tree(self.B))
            view._b_array, view.b_sign = (clone_tree(self._b_array),
                                          clone_tree(self.b_sign))
            ectx = copy.copy(ctx)
            ectx.gen = None
            ectx.r0sq = ctx.r0sq.clone()
            ectx.nullspace = clone_tree(ctx.nullspace)
            rows = 0
            if self.draws is not None:
                rows = opt.timevec_chunk if opt.timevec_chunk > 0 \
                    else opt.maxit
            m = self.A.shape[0]
            own = None if self.comm is None else self.mesh.local_range(m)
            eng = Engine(view, ectx, DeviceState.like(st, opt.maxit),
                         LyapunovSolver._build_iterate, rows, pins,
                         comm=self.comm, m=m, own=own)
            self._engine_cache[key] = eng
        return eng

    def _load_engine(self, eng, st, ctx) -> None:
        """Copy this solve's values and initial state into the engine."""
        from rails_tpu_torch.core.engine import copy_tree

        view = eng.view
        copy_tree(view.A, self.A)
        copy_tree(view.M, self.M)
        copy_tree(view.B, self.B)
        copy_tree(view._b_array, self._b_array)
        copy_tree(view.b_sign, self.b_sign)
        copy_tree(eng.ctx.nullspace, ctx.nullspace)
        eng.ctx.r0sq.copy_(ctx.r0sq)
        eng.ds.load(st)
        if ctx.gen is not None:
            eng.gen.set_state(ctx.gen.get_state())

    def _solve_compiled(self, progress):
        from rails_tpu_torch.core.engine import CODE_DONE, describe

        opt = self.options
        m = self.A.shape[0]
        with full_precision():
            with timer("Solver", "init"):
                st, ctx = self._init_state(m)
                self._grow_state(st, ctx.cap_kb)
                ctx.set_kb(ctx.cap_kb, m)
            eng = self._engine_for(st, ctx)
            eng.stats = eng.new_stats()
            caller = torch.cuda.current_stream(self.device) \
                if eng.cuda else None
            if caller is not None:
                eng.stream.wait_stream(caller)
            stream = torch.cuda.stream(eng.stream) if eng.cuda \
                else contextlib.nullcontext()
            t0 = time.perf_counter()
            marks = []
            with timer("Solver", "compiled"), stream:
                self._load_engine(eng, st, ctx)
                it, done = 0, False
                chunk = opt.timevec_chunk
                while not done:
                    tgt = min(it + chunk, opt.maxit) if chunk > 0 \
                        else opt.maxit
                    if eng.draws is not None:
                        eng.fill_draws(self.draws, it, tgt - it,
                                       self.dtype)
                    for _ in range(tgt - it):
                        if eng.step() == CODE_DONE:
                            break
                    it, res, done = eng.read()
                    marks.append((it, time.perf_counter() - t0))
                    if progress is not None:
                        progress(it, marks[-1][1], res)
                    done = done or it >= opt.maxit
                ds = eng.ds
                k, n_it, status, mvps = torch.stack(
                    [ds.k, ds.iter, ds.status, ds.mvps]).tolist()
                v = ds.V[:, :k].clone()
                t = ds.T[:k, :k].clone()
                restart_data = {"V": v, "AV": ds.AV[:, :k].clone(),
                                "VAV": ds.VAV[:k, :k].clone()}
                recvec = ds.recvec[:n_it].cpu().numpy()
                resvec = ds.resvec[:n_it].cpu().numpy()[recvec]
                res = float(ds.res)
            if caller is not None:
                caller.wait_stream(eng.stream)
        xp = [0] + [mk[0] for mk in marks]
        fp = [0.0] + [mk[1] for mk in marks]
        timevec = np.interp(np.arange(1, n_it + 1), xp, fp)[recvec]
        stats = eng.stats.summary()
        stats["program"] = None if eng.program is None \
            else describe(eng.program)
        stats["host_step_sources"] = self._host_steps()
        info = SolveInfo(res=res, iter=n_it, status=status, resvec=resvec,
                         timevec=timevec, mvps=mvps,
                         restart_data=restart_data, engine=stats)
        return v, t, info

    def _build_iterate(self, ctx, ds, rec, draw):
        """One RAILS iteration on the device state ``ds``, in place - the
        JAX package's ``_build_iterate`` (rails_tpu/core/solver.py:
        801-1241).  ``self`` is the engine's view of the solver (its
        operator clones); ``rec`` the recording's hooks
        (``core/engine.py::Recorder``); ``draw()`` the Lanczos start's
        normal draw.

        - Block reads and writes at ``w_start`` and ``k`` are index
          selects and ``index_copy_`` at tensor starts, clamped as XLA
          clamps ``dynamic_slice``; the Gram update's writes are masked
          by ``n_new > 0`` (after a restart the block at ``w_start`` = 0
          is live), as the JAX package's ``lax.cond`` skips them.
        - The decisions (done, status, restart, reduced, converged) are
          device booleans; the iteration ends at ``rec.switch`` on a code
          (``CODE_DONE``, ``CODE_RESTART``, ``CODE_EXPAND``), the JAX
          package's ``lax.cond(do_restart, restart, expand)``.
        - Every state update is a copy into a buffer of fixed address.
        - The dense factorizations go through
          ``dense_lyap.CaptureCalls``: the ``_ex`` forms, and eigh (and
          on the card the schur route) as host steps.
        - The phases run under ``rec.phase``: the eager path's
          ``Solver/<phase>`` spans, and the names of the recorded graph
          segments and host steps."""
        from rails_tpu_torch.core.engine import (
            CODE_DONE, CODE_EXPAND, CODE_RESTART)

        opt = self.options
        dev = self.device
        kb, s_slot, k_limit = ctx.kb, ctx.s_slot, ctx.k_limit
        calls = dense_lyap.CaptureCalls(rec.host)
        slot_ids = torch.arange(s_slot, device=dev)
        false = torch.zeros((), dtype=torch.bool, device=dev)

        def block_ids(start):
            return torch.clamp(start, 0, kb - s_slot) + slot_ids

        def put(buf, dim, ids, blk, mask):
            buf.index_copy_(dim, ids, torch.where(
                mask, blk, buf.index_select(dim, ids)))

        def gram_update():
            g = ds.n_new > 0
            ids = block_ids(ds.w_start)
            W = ds.V.index_select(1, ids)
            AW = self.A.matmat(W)
            put(ds.VAV, 0, ids, self._tdot(W, ds.AV), g)
            put(ds.AV, 1, ids, AW, g)
            put(ds.VAV, 1, ids, self._tdot(ds.V, AW), g)
            BW = self._b_rmatmat(W)
            WBV = BW.T @ self._sgn(ds.BV)
            put(ds.VBV, 0, ids, WBV, g)
            put(ds.VBV, 1, ids, WBV.T, g)
            rows = ds.VBV.index_select(0, ids)
            put(rows, 1, ids, BW.T @ self._sgn(BW), g)
            ds.VBV.index_copy_(0, ids, rows)
            put(ds.BV, 1, ids, BW, g)
            if ctx.has_m:
                MW = self.M.matmat(W)
                put(ds.MV, 1, ids, MW, g)
                if not ctx.mortho:
                    put(ds.VMV, 0, ids, self._tdot(W, ds.MV), g)
                    put(ds.VMV, 1, ids, self._tdot(ds.V, MW), g)
            ds.mvps.add_(torch.where(g, ds.n_new, 0))

        def restart():
            with rec.phase("restart"):
                x, keep = self._restart_rotation(ds, ctx, calls)
                rot, congruence = self._rotators(x)
                for buf in (ds.V, ds.AV, ds.BV) + (
                        (ds.MV,) if ctx.has_m else ()):
                    buf.copy_(rot(buf))
                ds.VAV.copy_(congruence(ds.VAV))
                vbv = congruence(ds.VBV)
                ds.VBV.copy_(0.5 * (vbv + vbv.T))
                if ctx.has_m and not ctx.mortho:
                    ds.VMV.copy_(congruence(ds.VMV))
                ds.k.copy_(keep.sum())
                for x0 in (ds.w_start, ds.n_new, ds.iter_since_restart):
                    x0.zero_()

        def expand(cands):
            with rec.phase("expand"):
                wacc, okv = self._compact(
                    ds, ctx, *self._expansion_block(ds, ctx, cands))
                ds.V.index_copy_(1, block_ids(ds.k), wacc)
                n_acc = okv.sum()
                ds.w_start.copy_(ds.k)
                ds.n_new.copy_(n_acc)
                ds.k.add_(n_acc)

        def iterate():
            with rec.phase("gram_update"):
                gram_update()
            with rec.phase("project_solve"):
                ds.T.copy_(self._projected_t(ds, ctx, calls, rec.host))
            with rec.phase("lanczos"):
                res_abs, cands, q_warm = self._lanczos(ds, ctx, draw(),
                                                       calls)
                ds.q_warm.copy_(q_warm)
            rel = res_abs / ctx.r0sq
            rel64 = rel.to(torch.float64)
            it_ids = ds.iter.reshape(1)
            record = (ds.iter_since_restart > 0) | (ds.iter == 0)
            ds.resvec.index_copy_(0, it_ids, rel64.reshape(1))
            ds.recvec.index_copy_(0, it_ids, record.reshape(1))
            isr = ds.iter_since_restart + 1
            it1 = ds.iter + 1
            # abort on numerical blowup (status -2), as the eager path
            blowup = ~torch.isfinite(rel64) | ~torch.isfinite(ds.T).all()
            conv_now = (rel64 < opt.tol) & ~blowup
            will_minimize = conv_now & ~ds.converged \
                if opt.restart_upon_convergence else false
            space_full = ds.k >= k_limit
            done = (conv_now & ~will_minimize) | (it1 >= opt.maxit) \
                | (space_full & ~will_minimize) | blowup
            status = torch.where(blowup, -2, torch.where(conv_now, 0, -1))
            converged = ds.converged | conv_now
            due = false
            if opt.restart_upon_start:
                due = due | (ds.iter == 0)
            if opt.restart_iterations > 0:
                due = due | (isr >= opt.restart_iterations)
            if opt.restart_size > 0:
                due = due | (ds.k >= opt.restart_size)
            if opt.restart_upon_convergence:
                due = due | (conv_now & ~ds.reduced)
            do_restart = ~done & due
            ds.reduced.copy_(torch.where(do_restart, converged, ds.reduced))
            ds.res.copy_(rel)
            ds.converged.copy_(converged)
            ds.iter.copy_(it1)
            ds.iter_since_restart.copy_(isr)
            ds.done.copy_(done)
            ds.status.copy_(torch.where(done, status, 1))
            code = torch.where(done, CODE_DONE, torch.where(
                do_restart, CODE_RESTART, CODE_EXPAND))
            rec.switch(code, [None, restart,
                              functools.partial(expand, cands)])

        return iterate

    # ------------------------------------------------------------------
    # helpers
    # ------------------------------------------------------------------
    def _draw(self, ctx, kind: str, shape) -> torch.Tensor:
        """The (m, ...) draw of ``kind``, this process's rows of it."""
        if self.draws is not None:
            x = self.draws(kind, tuple(shape), self.dtype, self.device)
            x = as_tensor(x, self.device, self.dtype)
            if tuple(x.shape) != tuple(shape):
                raise ValueError(f"draws({kind!r}) gave shape "
                                 f"{tuple(x.shape)}, expected {shape}")
            return self._own_rows(x)
        if kind == "init_uniform":
            x = torch.rand(shape, generator=ctx.gen, dtype=self.dtype,
                           device=self.device)
        else:
            x = torch.randn(shape, generator=ctx.gen, dtype=self.dtype,
                            device=self.device)
        return self._own_rows(x)

    def _own_rows(self, x):
        """This process's rows of an m-row tensor given whole or as this
        process's rows (the tensor itself with one process)."""
        if self.comm is None or x is None:
            return x
        from rails_tpu_torch.parallel.sharded import shard_array_rows

        return shard_array_rows(x, self.mesh, m=self.A.shape[0])


    def _p(self) -> int:
        return self.B.shape[1] if self._b_is_operator \
            else self._b_array.shape[1]

    def _b_matmat(self, x):
        if self._b_is_operator:
            return self.B.matmat(x)
        return self._b_array @ x

    def _b_rmatmat(self, x):
        if self._b_is_operator:
            return self.B.rmatmat(x)
        return psum(self.comm, self._b_array.T @ x)

    def _b_norm2sq(self) -> torch.Tensor:
        """||B||_2^2 = ||B'B||_2, the residual normalization r0 (MATLAB
        r0 = norm(full(B'*B), 2), RAILSsolver.m:335).  With a signed
        factor this is ||(B'B)^1/2 S (B'B)^1/2||_2.  Recomputed at every
        solve from the current B."""
        if self.b_sign is not None:
            if self._b_is_operator:
                p = self.B.shape[1]
                bb = self.B.rmatmat(self.B.matmat(torch.eye(
                    p, dtype=self.dtype, device=self.device)))
            else:
                bb = psum(self.comm, self._b_array.T @ self._b_array)
            lam, u = torch.linalg.eigh(0.5 * (bb + bb.T))
            half = (u * torch.sqrt(torch.clamp(lam, min=0.0))[None, :]) @ u.T
            core = half @ self.b_sign @ half
            return torch.max(torch.abs(torch.linalg.eigvalsh(
                0.5 * (core + core.T))))
        if self._b_is_operator:
            return operator_norm2(self.B, dtype=self.dtype,
                                  device=self.device) ** 2
        bb = psum(self.comm, self._b_array.T @ self._b_array)
        return torch.linalg.eigvalsh(bb)[-1]

    def _init_space(self, m, ctx) -> torch.Tensor:
        """Initial V_0 per opts: space | restart_data | random, with
        projection-method enrichment (RAILSsolver.m:288-308)."""
        opt = self.options
        dtype, dev = self.dtype, self.device
        v0 = None
        if opt.restart_data is not None:
            rd = opt.restart_data
            for field in ("V", "AV", "VAV"):
                if field not in rd:
                    raise InvalidOption(
                        "restart_data does not contain valid restart data")
            v0 = self._own_rows(as_tensor(rd["V"], dev, dtype))
        elif opt.space is not None:
            v0 = as_tensor(opt.space, dev, dtype)
            if v0.ndim == 1:
                v0 = v0[:, None]
            if v0.shape[0] != m and (self.comm is None or v0.shape[0]
                                     * self.comm.world != m):
                raise InvalidOption(
                    "opts.space should have the same row dimension as A")
            v0 = self._own_rows(v0)
        if v0 is None:
            v0 = (self._draw(ctx, "init_uniform", (m, 1)) - 0.5) * 2.0

        inv_a = opt.inv_a
        pm_major, pm_minor = opt.projection_major, opt.projection_minor
        if inv_a is not None and pm_minor == 1:
            w = inv_a(v0)
        elif inv_a is not None and pm_minor == 2:
            v0 = self._b_matmat(torch.eye(self._p(), dtype=dtype,
                                          device=dev)) \
                if self._b_is_operator else self._b_array
            w = inv_a(v0)
        else:
            w = v0
        if inv_a is not None and pm_major == 2 and pm_minor not in (0, 3):
            v0 = torch.cat([v0, w], dim=1)
        elif inv_a is not None and pm_major == 1 and pm_minor in (1, 2):
            v0 = w
        return v0

    def _init_state(self, m):
        opt = self.options
        dtype, dev = self.dtype, self.device
        ctx = _Context()
        ctx.gen = None
        if self.draws is None:
            ctx.gen = torch.Generator(dev).manual_seed(int(opt.seed))
        v0 = self._init_space(m, ctx)
        mortho = opt.ortho == "M"
        mop = self.M if mortho else None
        nullspace = None
        if opt.nullspace is not None:
            nullspace = _host_orthonormalize(
                self._own_rows(as_tensor(opt.nullspace, dev, dtype)), None,
                mop, opt.ortho_drop_tol, self.comm)
        # restart_data's V is already orthonormal and must stay untouched
        # or the Gram data would go inconsistent; restart_from_solution
        # re-enters from a previous solve's V (Gram data recomputed)
        skip_ortho = opt.space_is_orthogonalized or (
            opt.restart_from_solution and opt.space is not None)
        if opt.restart_data is None and not skip_ortho:
            v0 = _host_orthonormalize(v0, nullspace, mop, opt.ortho_drop_tol,
                                      self.comm)
        k0 = int(v0.shape[1])
        p = self._p()

        s_top = min(opt.expand, p) if not self._b_is_operator else opt.expand
        s_slot = s_top * (2 if opt.expansion_doubles else 1)
        if opt.restart_size > 0:
            cap = min(m, opt.restart_size + 2 * s_slot)
        else:
            cap = min(m, k0 + opt.maxit * s_slot)
        if opt.max_space is not None:
            cap = min(cap, opt.max_space)
        cap = max(cap, k0 + s_slot)
        cap_kb = min(_round_up(cap, 8), m + s_slot) + s_slot
        kb = min(cap_kb, _round_up(max(k0 + s_slot, 17 * s_slot, 48), 8)
                 + s_slot)

        has_m = self.M is not None
        rows = v0.shape[0]   # this process's rows of the m

        def zeros(r, c):
            return torch.zeros((r, c), dtype=dtype, device=dev)

        V = zeros(rows, kb)
        V[:, :k0] = v0
        av0 = self.A.matmat(v0)
        AV = zeros(rows, kb)
        AV[:, :k0] = av0
        sums = _Sums(self)
        sums.b_rmatmat(v0)
        sums.plain(v0.T @ av0)
        if has_m:
            mv0 = self.M.matmat(v0)
            if not mortho:
                sums.plain(v0.T @ mv0)
        bv0, vav0, *vmv0 = sums.done()
        BV = zeros(p, kb)
        BV[:, :k0] = bv0
        VAV = zeros(kb, kb)
        VAV[:k0, :k0] = vav0
        VBV = zeros(kb, kb)
        VBV[:k0, :k0] = bv0.T @ bv0 if self.b_sign is None \
            else bv0.T @ self.b_sign @ bv0
        MV = VMV = None
        if has_m:
            MV = zeros(rows, kb)
            MV[:, :k0] = mv0
            if not mortho:
                VMV = zeros(kb, kb)
                VMV[:k0, :k0] = vmv0[0]
        if opt.restart_data is not None:
            rd = opt.restart_data
            AV[:, :k0] = self._own_rows(as_tensor(rd["AV"], dev, dtype))
            VAV[:k0, :k0] = as_tensor(rd["VAV"], dev, dtype)

        st = SolverState(
            V=V, AV=AV, BV=BV, MV=MV, VAV=VAV, VBV=VBV, VMV=VMV,
            T=zeros(kb, kb), q_warm=zeros(rows, 1), k=k0, mvps=k0,
            resvec=np.zeros(opt.maxit, dtype=float),
            recvec=np.zeros(opt.maxit, dtype=bool))
        lyap_method, e_spd = self._resolve_lyap_method()
        ctx.update(
            p=p, cap_kb=cap_kb, s_top=s_top, s_slot=s_slot,
            L=max(opt.effective_lanczos, s_top + 1), has_m=has_m,
            mortho=mortho, lyap_method=lyap_method, e_spd=e_spd,
            nullspace=nullspace, r0sq=self._b_norm2sq().to(dtype), m=m)
        ctx.set_kb(kb, m)
        return st, ctx

    @staticmethod
    def _grow_state(st: SolverState, kb_new: int) -> None:
        """Zero-pad every k-indexed buffer to a larger bucket size."""
        grow = kb_new - st.VAV.shape[0]
        if grow <= 0:
            return

        def pad_cols(x):
            return None if x is None else torch.nn.functional.pad(
                x, (0, grow))

        def pad_sq(x):
            return None if x is None else torch.nn.functional.pad(
                x, (0, grow, 0, grow))

        st.V, st.AV, st.BV, st.MV = (pad_cols(st.V), pad_cols(st.AV),
                                     pad_cols(st.BV), pad_cols(st.MV))
        st.VAV, st.VBV, st.VMV, st.T = (pad_sq(st.VAV), pad_sq(st.VBV),
                                        pad_sq(st.VMV), pad_sq(st.T))

    # ------------------------------------------------------------------
    # one iteration
    # ------------------------------------------------------------------
    def _iterate(self, st: SolverState, ctx) -> None:
        opt = self.options
        if st.n_new > 0:
            with timer("Solver", "gram_update"):
                self._gram_update(st, ctx)
        with timer("Solver", "project_solve"):
            self._project_solve(st, ctx)
        with timer("Solver", "lanczos"):
            res_abs, cands, st.q_warm = self._lanczos(st, ctx)
            rel_t = res_abs / ctx.r0sq
            rel, t_finite = torch.stack(
                [rel_t, torch.isfinite(st.T).all().to(rel_t.dtype)]).tolist()
        record = st.iter_since_restart > 0 or st.iter == 0
        st.resvec[st.iter] = rel
        st.recvec[st.iter] = record
        isr = st.iter_since_restart + 1
        it1 = st.iter + 1

        conv_now = rel < opt.tol
        # abort on numerical blowup: a singular projected equation gives a
        # non-finite T (the reference continues with garbage,
        # LyapunovSolver.hpp:361-362; status -2 here)
        blowup = (not np.isfinite(rel)) or t_finite == 0.0
        conv_now = conv_now and not blowup
        # C++ exit structure (LyapunovSolver.hpp:224-242): when the
        # tolerance is first reached and space minimization is on, fall
        # through to the restart instead of breaking
        will_minimize = conv_now and not st.converged \
            and opt.restart_upon_convergence
        space_full = st.k >= ctx.k_limit
        done = (conv_now and not will_minimize) or it1 >= opt.maxit \
            or (space_full and not will_minimize) or blowup
        status = -2 if blowup else (0 if conv_now else -1)
        converged = st.converged or conv_now
        do_restart = (not done) and (
            (st.iter == 0 and opt.restart_upon_start)
            or (opt.restart_iterations > 0
                and isr >= opt.restart_iterations)
            or (opt.restart_size > 0 and st.k >= opt.restart_size)
            or (conv_now and not st.reduced
                and opt.restart_upon_convergence))
        if do_restart:
            st.reduced = converged
        st.res, st.converged = rel, converged
        st.iter, st.iter_since_restart = it1, isr
        st.done, st.status = done, (status if done else 1)
        if do_restart:
            with timer("Solver", "restart"):
                self._restart(st, ctx)
        elif not done:
            with timer("Solver", "expand"):
                self._expand(st, ctx, cands)

    # -------------------- Gram update --------------------
    def _tdot(self, x, w):
        """x.T @ w, reducing over the long axis m (compensated: gram2)."""
        if self.options.precision == "compensated":
            return gram2(x, w, comm=self.comm)
        return psum(self.comm, x.T @ w)

    def _vdot(self, x, w):
        """The scalar x[:, 0] . w[:, 0] (compensated: dot2)."""
        if self.options.precision == "compensated":
            return dot2(x[:, 0], w[:, 0], comm=self.comm)
        return psum(self.comm, x.T @ w)[0, 0]

    def _sgn(self, x):
        """Insert the signed middle factor: B S B' instead of B B'."""
        return x if self.b_sign is None else self.b_sign @ x

    def _gram_update(self, st: SolverState, ctx) -> None:
        """The newest block's Gram rows and columns; its reductions over
        the rows are finished together (one collective across
        processes)."""
        ws, s_slot = st.w_start, ctx.s_slot
        W = st.V[:, ws:ws + s_slot].contiguous()
        AW = self.A.matmat(W)
        sums = _Sums(self)
        sums.tdot(W, st.AV)          # the old AV's columns at ws
        _dus(st.AV, AW, 0, ws)
        sums.tdot(st.V, AW)
        sums.b_rmatmat(W)
        if ctx.has_m:
            MW = self.M.matmat(W)
            _dus(st.MV, MW, 0, ws)
            if not ctx.mortho:
                sums.tdot(W, st.MV)  # the new MV's columns at ws
                sums.tdot(st.V, MW)
        wav, vaw, BW, *vmv = sums.done()
        _dus(st.VAV, wav, ws, 0)
        _dus(st.VAV, vaw, 0, ws)

        WBV = BW.T @ self._sgn(st.BV)
        _dus(st.VBV, WBV, ws, 0)
        _dus(st.VBV, WBV.T, 0, ws)
        _dus(st.VBV, BW.T @ self._sgn(BW), ws, ws)
        _dus(st.BV, BW, 0, ws)

        if vmv:
            _dus(st.VMV, vmv[0], ws, 0)
            _dus(st.VMV, vmv[1], 0, ws)
        st.mvps += st.n_new

    # -------------------- projected dense solve --------------------
    def _project_solve(self, st: SolverState, ctx) -> None:
        st.T = self._projected_t(st, ctx)

    def _projected_t(self, st, ctx, calls=dense_lyap.EAGER_CALLS,
                     host=None):
        """The new projected solution T of ``st``.  ``calls``: the dense
        factorizations (``dense_lyap.DenseCalls``); ``host``: the
        recording's host step, which the schur route takes on the card.

        With k a Python int (the eager loop) the equation is formed and
        solved on the active k x k block, inside a ``Solver/active_block``
        span, and T is that block in a zero Kb x Kb buffer.  With k a 0-d
        tensor (the recorded engine, whose shapes stay fixed) it is
        solved on the padded Kb x Kb buffer."""
        vmv = st.VMV if ctx.has_m and not ctx.mortho else None
        if isinstance(st.k, int):
            k = st.k
            with span("Solver", "active_block"):
                y = self._dense_t(
                    st.VAV[:k, :k], st.VBV[:k, :k],
                    None if vmv is None else vmv[:k, :k], None, ctx,
                    calls, host)
                t = y.new_zeros(st.VAV.shape)
                t[:k, :k] = y
            return t
        act = ctx.col_ids < st.k
        y = self._dense_t(st.VAV, st.VBV, vmv,
                          torch.diag(1.0 - act.to(self.dtype)), ctx, calls,
                          host)
        # enforce exact masking of the inactive block
        return torch.where(act[:, None] & act[None, :], y,
                           torch.zeros((), dtype=self.dtype,
                                       device=self.device))

    def _dense_t(self, vav, vbv, vmv, inactive_diag, ctx, calls, host):
        """The symmetric solution of the projected equation on ``vav``,
        ``vbv`` and ``vmv`` (None without M or under M-orthogonality).
        ``inactive_diag``: the diagonal that marks a padded buffer's
        inactive block, which is given the identity in ``vmv`` and a
        shift in ``vav``; None on an active block, which has none."""
        tri = torch.linalg.solve_triangular
        if vmv is not None:
            vmv_i = vmv if inactive_diag is None \
                else vmv + inactive_diag  # identity padding
            if ctx.e_spd and ctx.lyap_method == "eigh":
                l = calls.cholesky(0.5 * (vmv_i + vmv_i.T))
                at = tri(l, vav, upper=False)
                at = tri(l, at.T, upper=False).T
                ct = tri(l, vbv, upper=False)
                ct = tri(l, ct.T, upper=False).T

                def back(y):
                    x = tri(l.T, y, upper=True)
                    return tri(l.T, x.T, upper=True).T
            else:
                at = calls.solve(vmv_i, vav)
                ct = calls.solve(vmv_i, calls.solve(vmv_i, vbv).T).T

                def back(y):
                    return y
        else:
            at, ct = vav, vbv

            def back(y):
                return y
        if inactive_diag is not None:
            # dominate the active spectral radius so the padding never
            # collides with active eigenvalues
            a_pad = -(torch.max(torch.sum(torch.abs(at), dim=1)) + 1.0)
            at = at + a_pad * inactive_diag
        ct = 0.5 * (ct + ct.T)
        if host is not None and ctx.lyap_method == "schur":
            y = host(functools.partial(dense_lyap.lyap, method="schur"),
                     at, ct, name="host_schur")
        elif calls is dense_lyap.EAGER_CALLS:
            y = dense_lyap.lyap(at, ct, method=ctx.lyap_method)
        else:
            y = dense_lyap.lyap(at, ct, method=ctx.lyap_method, calls=calls)
        t_new = back(y)
        return 0.5 * (t_new + t_new.T)

    # -------------------- residual Lanczos --------------------
    def _resid_apply(self, st: SolverState, ctx, q):
        """R q = B(B'q) + AV(T(MV'q)) + MV(T(AV'q)) - matrix-free
        application of the residual (C++ resid_lanczos inner ops,
        src/LyapunovSolver.hpp:388-403)."""
        mv = st.MV if ctx.has_m else st.V
        sums = _Sums(self)
        sums.b_rmatmat(q)
        sums.tdot(mv, q)
        sums.tdot(st.AV, q)
        bq, mq, aq = sums.done()
        y = self._b_matmat(self._sgn(bq))
        y = y + st.AV @ (st.T @ mq)
        y = y + mv @ (st.T @ aq)
        return y

    def _lanczos(self, st, ctx, g=None, calls=dense_lyap.EAGER_CALLS):
        """The residual Lanczos from ``st.q_warm`` and the normal draw
        ``g`` (drawn here when None).  Returns (|top Ritz value|, the
        s_top candidates, the next warm start)."""
        opt = self.options
        m, L, dtype, dev = st.V.shape[0], ctx.L, self.dtype, self.device
        if g is None:
            g = self._draw(ctx, "lanczos_normal", (ctx.m, 1))
        if self.comm is None:
            gnorm = torch.linalg.norm(g)
            wnorm = torch.linalg.norm(st.q_warm)
        else:
            gnorm, wnorm = torch.sqrt(torch.stack(self.comm.allreduce_many(
                [torch.sum(g * g), torch.sum(st.q_warm * st.q_warm)])))
        g = g / gnorm
        # warm start: last iteration's top candidate plus a random
        # component guaranteeing overlap with any newly dominant direction
        one = torch.ones((), dtype=dtype, device=dev)
        q0 = torch.where(wnorm > 0, st.q_warm / torch.where(
            wnorm > 0, wnorm, one) + 0.1 * g, g)
        q = q0 / row_norm(self.comm, q0)
        qbuf = torch.zeros((m, L), dtype=dtype, device=dev)
        eps = torch.finfo(dtype).eps
        # lanczos_tolerance: stop the recurrence once beta < tol * scale
        # (remaining steps are masked); None -> breakdown guard only
        breakdown = max(eps * 100.0, float(opt.lanczos_tolerance or 0.0))
        zero = torch.zeros((), dtype=dtype, device=dev)
        q_prev = torch.zeros_like(q)
        beta_prev, scale = zero, zero
        valid = torch.ones((), dtype=torch.bool, device=dev)
        alphas, betas = [], []
        for j in range(L):
            qbuf[:, j] = q[:, 0]
            y = self._resid_apply(st, ctx, q)
            alpha = self._vdot(y, q)
            y = y - alpha * q - beta_prev * q_prev
            if opt.lanczos_reorth:
                # full reorthogonalization (2 m*L GEMMs per step)
                y = y - qbuf @ self._tdot(qbuf, y)
            beta = torch.sqrt(torch.clamp(self._vdot(y, y), min=0.0))
            scale = torch.maximum(scale, torch.abs(alpha) + beta)
            valid_next = valid & (beta > breakdown * scale)
            alphas.append(torch.where(valid, alpha, zero))
            beta_out = torch.where(valid_next, beta, zero)
            betas.append(beta_out)
            q_next = torch.where(valid_next, y / torch.where(
                beta > 0, beta, one), zero)
            q, q_prev, beta_prev, valid = q_next, q, beta_out, valid_next
        alphas, betas = torch.stack(alphas), torch.stack(betas)
        h = torch.diag(alphas) + torch.diag(betas[:-1], 1) \
            + torch.diag(betas[:-1], -1)
        evals, evecs = _eigh_sign_fixed(h, calls)
        order = torch.argsort(-torch.abs(evals), stable=True)
        evals = evals[order]
        evecs = evecs[:, order]
        cands = qbuf @ evecs[:, :ctx.s_top]
        return torch.abs(evals[0]), cands, qbuf @ evecs[:, :1]

    # -------------------- restart --------------------
    def _restart(self, st: SolverState, ctx) -> None:
        """Truncate the space to the dominant eigenvectors of T (C++
        compute_restart_vectors, LyapunovSolver.hpp:449-482; MATLAB
        RAILSsolver.m:455-513)."""
        x, keep = self._restart_rotation(st, ctx)
        rot, congruence = self._rotators(x)
        st.V, st.AV, st.BV = rot(st.V), rot(st.AV), rot(st.BV)
        st.VAV = congruence(st.VAV)
        vbv = congruence(st.VBV)
        st.VBV = 0.5 * (vbv + vbv.T)
        if ctx.has_m:
            st.MV = rot(st.MV)
            if not ctx.mortho:
                st.VMV = congruence(st.VMV)
        st.k = int(keep.sum())
        st.w_start, st.n_new, st.iter_since_restart = 0, 0, 0

    def _restart_rotation(self, st, ctx, calls=dense_lyap.EAGER_CALLS):
        """The restart's rotation x (columns of T's eigenvectors by
        descending |eigenvalue|, zero where not kept; float64 for a
        float32 solve) and the kept-column mask."""
        opt = self.options
        rtol = opt.effective_restart_tolerance
        evals, evecs = calls.eigh(st.T)
        aevals = torch.abs(evals)
        order = torch.argsort(-aevals, stable=True)
        aevals = aevals[order]
        x = evecs[:, order]
        active = ctx.col_ids < st.k
        if opt.restart_tolerance_mode == "absolute":
            keep = (aevals > rtol) & active  # C++: |lambda| > rtol
        else:
            # MATLAB semantics: |lambda| / max > rtol
            emax = torch.clamp(aevals[0], min=torch.finfo(self.dtype).tiny)
            keep = (aevals / emax > rtol) & active
        if opt.reduced_size > 0:
            keep = keep & (ctx.col_ids < opt.reduced_size)
        # A float32 solve rotates in float64 and rounds once.  The
        # rotations are where the stored AV and MV drift from A V and M V
        # (each restart adds a float32 GEMM's rounding), and the drift is
        # what separates the true residual from the Lanczos estimate: on
        # an H100 the n=4096 phase_solve problem (tol 1e-4) ended at an
        # f64 true residual of 2.74e-4 with float32 rotations and 9.76e-5
        # with float64 ones (chip_smoke.py).
        # The JAX package rotates in float32 (its TPU has no fast
        # float64); at float64 the two are the same algorithm.
        wide = torch.float64 if self.dtype == torch.float32 else self.dtype
        return (x * keep[None, :].to(self.dtype)).to(wide), keep

    def _rotators(self, x):
        """rot(buf) = buf x and congruence(g) = x' g x, in x's dtype,
        rounded once to the solve dtype."""
        def rot(buf):
            return (buf.to(x.dtype) @ x).to(self.dtype)

        def congruence(g):
            return (x.T @ g.to(x.dtype) @ x).to(self.dtype)

        return rot, congruence

    # -------------------- expansion --------------------
    def _inner_prep(self, ctx, w):
        return self.M.matmat(w) if ctx.mortho else w

    def _col_norm(self, ctx, x):
        if ctx.mortho:
            return torch.sqrt(torch.clamp(psum(
                self.comm, torch.sum(x * self._inner_prep(ctx, x), dim=0)),
                min=0.0))
        return row_norm(self.comm, x, dim=0)

    def _finish_append(self, st: SolverState, ctx, wacc, okv) -> None:
        """Capacity limit, compaction of the accepted columns to the
        front (stable), and the append at column k."""
        wacc, okv = self._compact(st, ctx, wacc, okv)
        n_acc = int(okv.sum())
        _dus(st.V, wacc, 0, st.k)
        st.w_start, st.n_new, st.k = st.k, n_acc, st.k + n_acc

    def _compact(self, st, ctx, wacc, okv):
        """The block's accepted columns within the capacity limit,
        moved to the front in order (the rest zero), and their flags."""
        okv_i = okv.to(torch.int32)
        prior = torch.cumsum(okv_i, 0) - okv_i
        okv = okv & (st.k + prior < ctx.k_limit)
        wacc = wacc * okv[None, :].to(self.dtype)
        perm = torch.argsort((~okv).to(torch.int32), stable=True)
        return wacc[:, perm], okv

    def _orthonormal_block_fast(self, st, ctx, wraw):
        """Block CGS(2) against V (two (m,k)x(k,s) GEMM pairs), then the
        cheap within-block orthonormalization and drop decisions per
        column - the MATLAB fast path (RAILSsolver.m:554-563)."""
        m, s_slot = st.V.shape[0], ctx.s_slot
        tdot, prep, ns = self._tdot, self._inner_prep, ctx.nullspace
        drop_tol = self.options.ortho_drop_tol
        dtype, dev = self.dtype, self.device
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        # column-normalize first so the drop tolerance measures the
        # shrink of each direction, not its incoming scale
        n0 = self._col_norm(ctx, wraw)
        w = wraw / torch.where(n0 > 0, n0, one)[None, :]
        for _ in range(2):  # CGS(2): twice is enough
            if ns is not None:
                w = w - ns @ tdot(ns, prep(ctx, w))
            w = w - st.V @ tdot(st.V, prep(ctx, w))
        wacc = torch.zeros((m, s_slot), dtype=dtype, device=dev)
        flags = []
        for i in range(s_slot):
            wi = w[:, i:i + 1]
            for _ in range(2):
                wi = wi - wacc @ tdot(wacc, prep(ctx, wi))
            n1 = self._col_norm(ctx, wi)[0]
            ok = (n1 > drop_tol) & (n0[i] > 0)
            wi = torch.where(ok, wi / torch.where(n1 > 0, n1, one), zero)
            wacc[:, i] = wi[:, 0]
            flags.append(ok)
        # final V-cleanup on the normalized block: a column that shrank to
        # n1 ~ drop_tol amplified its leftover V-component by 1/n1
        wacc = wacc - st.V @ tdot(st.V, prep(ctx, wacc))
        if ns is not None:
            wacc = wacc - ns @ tdot(ns, prep(ctx, wacc))
        n2 = self._col_norm(ctx, wacc)
        wacc = wacc / torch.where(n2 > 0, n2, one)[None, :]
        return wacc, torch.stack(flags)

    def _orthonormal_block(self, st, ctx, wraw):
        """Per-column safe path (opts.fast_orthogonalization=False):
        orthogonalize each candidate against V, the nullspace and the
        block so far, drop near-dependent ones (reference orthogonalize,
        src/StlWrapper.cpp:305-321; MATLAB Morth, RAILSsolver.m:538-618)."""
        m, s_slot = st.V.shape[0], ctx.s_slot
        tdot, prep, ns = self._tdot, self._inner_prep, ctx.nullspace
        drop_tol = self.options.ortho_drop_tol
        dtype, dev = self.dtype, self.device
        one = torch.ones((), dtype=dtype, device=dev)
        zero = torch.zeros((), dtype=dtype, device=dev)
        wacc = torch.zeros((m, s_slot), dtype=dtype, device=dev)
        flags = []
        for i in range(s_slot):
            w = wraw[:, i:i + 1]
            n0 = torch.sqrt(torch.clamp(self._vdot(w, w), min=0.0))
            w = w / torch.where(n0 > 0, n0, one)
            for _ in range(2):  # two CGS passes
                if ns is not None:
                    w = w - ns @ tdot(ns, prep(ctx, w))
                w = w - st.V @ tdot(st.V, prep(ctx, w))
                w = w - wacc @ tdot(wacc, prep(ctx, w))
            if ctx.mortho:
                n1 = torch.sqrt(torch.clamp(
                    self._vdot(w, self.M.matmat(w)), min=0.0))
            else:
                n1 = torch.sqrt(torch.clamp(self._vdot(w, w), min=0.0))
            ok = (n1 > drop_tol) & (n0 > 0)
            w = torch.where(ok, w / torch.where(n1 > 0, n1, one), zero)
            wacc[:, i] = w[:, 0]
            flags.append(ok)
        return wacc, torch.stack(flags)

    def _expand(self, st: SolverState, ctx, cands) -> None:
        self._finish_append(st, ctx, *self._expansion_block(st, ctx, cands))

    def _expansion_block(self, st, ctx, cands):
        """The candidates (with the inverse applied where the projection
        method asks for it) orthonormalized against V, the nullspace and
        each other: (the (m, s_slot) block, its accepted-column flags)."""
        opt = self.options
        w = cands
        if opt.inv_a is not None and opt.uses_inverse_on_expand:
            # a callable of unknown kind: a host step of a recording
            wi = host_call(opt.inv_a, w, name="inv_a")
            w = torch.cat([w, wi], dim=1) if opt.expansion_doubles else wi
        if opt.fast_orthogonalization:
            return self._orthonormal_block_fast(st, ctx, w)
        return self._orthonormal_block(st, ctx, w)


class _Sums:
    """The reductions over the rows that one point of the iteration
    needs, finished together by ``done()``, in the order they were asked
    for.  With one process each is formed at once, as the solver's
    helpers form it; across processes each process's partial (a plain
    product, or a compensated (hi, lo) pair) goes into one collective and
    is summed in rank order."""

    def __init__(self, solver: "LyapunovSolver"):
        self.solver = solver
        self.comm = solver.comm
        self.items = []   # (kind, value): "done", "sum" or "pair"

    def tdot(self, x, w) -> None:
        """x' @ w as ``LyapunovSolver._tdot`` reduces it."""
        s = self.solver
        if self.comm is None:
            self.items.append(("done", s._tdot(x, w)))
        elif s.options.precision == "compensated":
            self.items.append(("pair", gram2_pair(x, w)))
        else:
            self.items.append(("sum", x.T @ w))

    def plain(self, partial) -> None:
        """A plain sum over the rows (``partial`` this process's part)."""
        self.items.append(("done" if self.comm is None else "sum", partial))

    def b_rmatmat(self, x) -> None:
        """B' @ x as ``LyapunovSolver._b_rmatmat`` forms it."""
        s = self.solver
        if s._b_is_operator:
            self.items.append(("done", s.B.rmatmat(x)))
        else:
            self.plain(s._b_array.T @ x)

    def done(self) -> list:
        flat = []
        for kind, v in self.items:
            if kind == "sum":
                flat.append(v)
            elif kind == "pair":
                flat.extend(v)
        got = iter(self.comm.allgather_many(flat) if flat else ())
        out = []
        for kind, v in self.items:
            if kind == "sum":
                out.append(self.comm.rank_sum(next(got)))
            elif kind == "pair":
                his = next(got)
                out.append(rank_pair_sum(his, next(got)))
            else:
                out.append(v)
        return out


class _Context:
    """Per-solve constants: the geometry, the resolved projected-solver
    method, r0sq, the nullspace basis, and the current capacity Kb."""

    def update(self, **kw):
        self.__dict__.update(kw)

    def set_kb(self, kb: int, m: int) -> None:
        self.kb = kb
        self.k_limit = min(m, kb - self.s_slot)
        self.col_ids = torch.arange(kb, device=self.r0sq.device)


def _host_orthonormalize(w, nullspace, m_op, drop_tol, comm=None):
    """Orthonormalize columns (optionally in the M-inner product, with
    nullspace deflation), dropping dependent columns.  Helper for the
    initial space; the column count may shrink.  ``comm``: w holds this
    process's rows, each reduction over the rows is summed over the
    processes."""
    if w.ndim == 1:
        w = w[:, None]
    cols = []

    def ip(x):
        return m_op.matmat(x) if m_op is not None else x

    for i in range(w.shape[1]):
        v = w[:, i:i + 1]
        n0 = float(row_norm(comm, v))
        if n0 == 0.0:
            continue
        v = v / n0
        for _ in range(2):
            if nullspace is not None:
                v = v - nullspace @ psum(comm, nullspace.T @ ip(v))
            for c in cols:
                v = v - c @ psum(comm, c.T @ ip(v))
        if m_op is not None:
            n1 = float(torch.sqrt(torch.clamp(
                psum(comm, v.T @ m_op.matmat(v))[0, 0], min=0)))
        else:
            n1 = float(row_norm(comm, v))
        if n1 < drop_tol:
            continue
        cols.append(v / n1)
    if not cols:
        raise ValueError("initial space is empty after orthogonalization")
    return torch.cat(cols, dim=1)


def solve(a, b, m=None, maxit=None, tol=None, options=None, compiled=False,
          progress=None, *, device=None, draws=None, mesh=None,
          **opt_kwargs):
    """Functional front-end mirroring MATLAB
    ``[V,T,res,iter,resvec,timevec,restart_data] = RAILSsolver(A,M,B,...)``
    with the argument order (A, B, M) of the C++ Solver ctor.

    Returns (V, T, info).  Runs on ``device`` (default ``cuda``), or
    row-sharded on ``mesh`` (``LyapunovSolver(mesh=...)``).
    """
    if options is None:
        if maxit is not None:
            opt_kwargs["maxit"] = maxit
        if tol is not None:
            opt_kwargs["tol"] = tol
        options = SolverOptions(**opt_kwargs)
    solver = LyapunovSolver(a, b, m, options, mesh=mesh, device=device,
                            draws=draws)
    return solver.solve(compiled=compiled, progress=progress)
