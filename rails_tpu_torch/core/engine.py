"""Recording and replay of the solver's iteration: the counterpart of the
JAX package's ``jax.jit`` of ``_build_iterate`` and of the chunked
``while_loop`` around it (``rails_tpu/core/solver.py:411-455``).

``LyapunovSolver.solve(compiled=True)`` grows the state to its fixed
capacity once and keeps all of it, the control scalars included, in a
``DeviceState`` of buffers whose addresses never change; one iteration
(``LyapunovSolver._build_iterate``) reads and writes them in place.

On the card an iteration is recorded once as a *program* and replayed:

- **graph segments**: ``torch.cuda.CUDAGraph`` captures of the tensor
  work, the solver's ``torch.Generator`` registered with each, so every
  replay draws new Lanczos numbers;
- **host steps**: calls that do not capture, run eagerly between two
  segments on the segment's inputs, their outputs copied into buffers
  the next segment reads.  ``torch.linalg.eigh`` is one: it checks
  LAPACK's ``info`` on the host, and cuSOLVER's syevd and syevj do not
  capture either (``rails_tpu_torch/capture_audit.py``).  The projected Schur
  solve (the real Schur form and trsyl on the host) is
  another, and so is any call that code outside the solver routes through ``host_call``: a
  Schur operator's host A11 solve (``native_lu``, the BiCGStab of
  ``iterative``), the expansion's ``inv_a``;
- **one switch** per iteration: the host reads a one-word code (done,
  restart or expand) and replays that branch's program.  PyTorch 2.11
  has no conditional graph nodes, and the restart needs one more eigh,
  so neither branch can stay inside a graph.

The first iteration of a new engine runs eagerly (the warm-up that
CUDA graph capture needs: cuBLAS handles, plans, first kernel loads);
the second is captured segment by segment, each segment replayed as
soon as it is captured, so it computes a real iteration; every later
iteration replays.  The host reads the state once per chunk of
``timevec_chunk`` iterations (``iter``, ``res``, ``done``), calls
``progress`` and interpolates ``timevec`` as the JAX package does.

On the CPU the same iteration runs eagerly: host steps are plain calls
and the switch is a Python branch on a CPU tensor.

An engine owns clones of the operators and of every value the
iteration reads (B, ``b_sign``, ``r0sq``, the nullspace); each solve
copies its own values into them, so a cached engine replays against a
new Jacobian without capturing again.  ``engine_key`` lists what a
recording closes over; ``structure`` is the part of it an operator
gives.

Spans (``timer.span``, ranges in a ``torch.profiler`` trace, nothing
while no profiler collects): ``Engine/replay/<phases>`` around each
graph segment's replay, named at capture by the solver's phases
(``Recorder.phase``) whose work the segment holds, joined by ``+``
(``Engine/replay/project_solve+lanczos``);
``Engine/host/<phase>.<fn>`` around each host step
(``Engine/host/project_solve.eigh``); ``Engine/switch`` around each
switch read and ``Engine/read`` around each chunk read.  The names are
fixed when the iteration is recorded, whether or not a profiler runs
then.  The counters of ``EngineStats`` count at the same boundaries.

Launch counts: a kernel wrapper counts once when its launch is captured.
The recorder takes that count back, keeps each segment's launches, and
adds them to the wrapper's counter at every replay of the segment.

Across processes (``comm``, a ``parallel/comm.py::RowComm``) each rank
records and replays the same program on its own rows.  The row
collectives route by the backend (``RowComm.route``): under NCCL they are
captured in the segments, and the recorder keeps each segment's
collective calls and bytes as it keeps launches, adding them to
``comm.stats`` at every replay; under gloo each is a host step.  The
Lanczos draws are the whole m rows, this rank's kept, so N processes
draw what one draws.  Every chunk read gathers each rank's (iter, res,
done) and raises on every rank when they differ: a captured program
whose ranks took different branches would hang in its next collective.
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import gc
import importlib
import time
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from rails_tpu_torch.timer import span

__all__ = ["DeviceState", "Engine", "structure", "host_call", "CODE_DONE",
           "CODE_RESTART", "CODE_EXPAND"]

# the switch codes of one iteration
CODE_DONE, CODE_RESTART, CODE_EXPAND = 0, 1, 2

# False: run the iteration eagerly on the card too (the tests compare the
# replayed iteration with it)
CAPTURE = True

# the kernel wrappers whose ``launches`` counters the recorder keeps
_COUNTED = (("rails_tpu_torch.sparse.spmm", "dia_spmm"),
            ("rails_tpu_torch.sparse.spmm", "dia_spmm_halo"),
            ("rails_tpu_torch.sparse.ell_spmm", "ell_spmm"),
            ("rails_tpu_torch.sparse.wide_spmm", "wide_spmm"))


def _wrappers():
    return [getattr(importlib.import_module(mod), name)
            for mod, name in _COUNTED]


def _counts() -> Tuple[int, ...]:
    return tuple(w.launches for w in _wrappers())


def _set_counts(counts) -> None:
    for w, n in zip(_wrappers(), counts):
        w.launches = n


def _add_counts(delta) -> None:
    for w, n in zip(_wrappers(), delta):
        w.launches += n


def _comm_counts(comm) -> Tuple[int, int, int]:
    """A row communicator's (calls, bytes, staged bytes) so far; zeros
    without one."""
    return (0, 0, 0) if comm is None else comm.stats.counts()


def _set_comm_counts(comm, counts) -> None:
    if comm is not None:
        st = comm.stats
        st.calls, st.bytes, st.staged_bytes = counts


# the recorder whose capture is under way, None outside a capture and
# inside a host step
_ACTIVE: Optional["Recorder"] = None


def host_call(fn, *args, name: Optional[str] = None):
    """``fn(*args)`` as a host step of the iteration being recorded, for
    code the solver calls but does not own: an operator's apply that
    leaves the device (a host LU solve, a loop that reads a device
    scalar), a user's ``inv_a``.  A plain call when nothing records: on
    the CPU, in an eager solve, in the warm-up iteration, in a replay
    (the recorded host step calls ``fn`` itself) and inside another host
    step.  ``fn``'s tensor arguments must be tensors the iteration
    computed; its outputs land in buffers the next segment reads.
    ``name``: the step's name in its span (default ``fn.__name__``)."""
    rec = _ACTIVE
    if rec is None or not rec.capturing:
        return fn(*args)
    return rec.host(fn, *args, name=name)


# ----------------------------------------------------------------------
# operator structure, clones and payload copies
# ----------------------------------------------------------------------
# lazily filled host caches of the kernel plans: derived from what the
# structure already keys (offsets, tile windows, shapes)
_SKIP = frozenset({"_plans", "comm"})


def _ours(obj) -> bool:
    return type(obj).__module__.startswith("rails_tpu_torch.") \
        and hasattr(obj, "__dict__")


def _fields(obj):
    return [(k, v) for k, v in sorted(vars(obj).items()) if k not in _SKIP]


def structure(obj, pins: Optional[list] = None) -> tuple:
    """What a recording closes over in ``obj`` (an operator, or any
    object of this package): every tensor's shape, dtype and device,
    every host scalar, tuple and numpy array by value (the DIA offsets,
    the ELL tile windows, the wide payload's ``w``, the format tags),
    and anything else - a user's callable - by identity, appended to
    ``pins`` so the cache keeps it alive.  Tensor *values* are not
    part of it: they are copied into the engine's clones.  A ``comm``
    (the row communicator, whose ``stats`` change at every call) is
    left out: the solver's key names its world size and backend."""
    out = []
    memo = {}

    def walk(x, path):
        if x is None or isinstance(x, (bool, int, float, str)):
            out.append((path, x))
        elif isinstance(x, torch.Tensor):
            out.append((path, "tensor", tuple(x.shape), str(x.dtype),
                        str(x.device)))
        elif isinstance(x, (torch.dtype, torch.device)):
            out.append((path, str(x)))
        elif isinstance(x, np.ndarray):
            out.append((path, "array", x.shape, x.dtype.str, x.tobytes()))
        elif isinstance(x, (tuple, list)):
            out.append((path, type(x).__name__, len(x)))
            for i, y in enumerate(x):
                walk(y, f"{path}[{i}]")
        elif _ours(x):
            if id(x) in memo:
                out.append((path, "same as", memo[id(x)]))
                return
            memo[id(x)] = path
            out.append((path, type(x).__qualname__))
            for k, v in _fields(x):
                walk(v, f"{path}.{k}")
        else:
            out.append((path, "object", id(x)))
            if pins is not None:
                pins.append(x)

    walk(obj, "")
    return tuple(out)


def _tensors(obj) -> List[torch.Tensor]:
    """The tensors of ``obj`` in ``structure``'s order."""
    out = []
    seen = set()

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (tuple, list)):
            for y in x:
                walk(y)
        elif _ours(x) and id(x) not in seen:
            seen.add(id(x))
            for _, v in _fields(x):
                walk(v)

    walk(obj)
    return out


def clone_tree(obj):
    """A copy of ``obj`` whose tensors are new buffers with the same
    values (the engine's own payloads); host data, foreign objects and
    objects of this package that hold no tensor are shared (a
    ``NativeSparseLU`` owns a host handle that its copy would free a
    second time)."""
    memo = {}

    def walk(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple):
            return tuple(walk(y) for y in x)
        if isinstance(x, list):
            return [walk(y) for y in x]
        if not _ours(x) or not _tensors(x):
            return x
        if id(x) in memo:
            return memo[id(x)]
        y = copy.copy(x)
        memo[id(x)] = y
        y.__dict__.pop("_plans", None)
        for k, v in _fields(x):
            object.__setattr__(y, k, walk(v))
        return y

    return walk(obj)


def copy_tree(dst, src) -> None:
    """Copy ``src``'s tensor values into ``dst``'s (same structure)."""
    for d, s in zip(_tensors(dst), _tensors(src)):
        d.copy_(s)


# ----------------------------------------------------------------------
# the device state
# ----------------------------------------------------------------------
@dataclasses.dataclass
class DeviceState:
    """The solver state at fixed capacity, control scalars included, on
    the device: the JAX package's ``SolverState`` as buffers written in
    place.  Integers are int64 0-d tensors (index arithmetic), flags
    bool, ``resvec`` float64."""

    V: torch.Tensor
    AV: torch.Tensor
    BV: torch.Tensor
    MV: Optional[torch.Tensor]
    VAV: torch.Tensor
    VBV: torch.Tensor
    VMV: Optional[torch.Tensor]
    T: torch.Tensor
    q_warm: torch.Tensor
    k: torch.Tensor
    w_start: torch.Tensor
    n_new: torch.Tensor
    res: torch.Tensor
    iter: torch.Tensor
    iter_since_restart: torch.Tensor
    converged: torch.Tensor
    reduced: torch.Tensor
    done: torch.Tensor
    status: torch.Tensor
    resvec: torch.Tensor
    recvec: torch.Tensor
    mvps: torch.Tensor

    _ARRAYS = ("V", "AV", "BV", "MV", "VAV", "VBV", "VMV", "T", "q_warm")
    _SCALARS = ("k", "w_start", "n_new", "res", "iter",
                "iter_since_restart", "converged", "reduced", "done",
                "status", "mvps")

    @classmethod
    def like(cls, st, maxit: int) -> "DeviceState":
        """Buffers shaped as the host-side state ``st`` (a
        ``SolverState`` at full capacity)."""
        dev, dtype = st.V.device, st.V.dtype

        def scalar(dt):
            return torch.zeros((), dtype=dt, device=dev)

        arrays = {n: None if getattr(st, n) is None
                  else torch.empty_like(getattr(st, n))
                  for n in cls._ARRAYS}
        i64, b = torch.int64, torch.bool
        return cls(**arrays, k=scalar(i64), w_start=scalar(i64),
                   n_new=scalar(i64), res=scalar(dtype), iter=scalar(i64),
                   iter_since_restart=scalar(i64), converged=scalar(b),
                   reduced=scalar(b), done=scalar(b), status=scalar(i64),
                   resvec=torch.zeros(maxit, dtype=torch.float64,
                                      device=dev),
                   recvec=torch.zeros(maxit, dtype=b, device=dev),
                   mvps=scalar(i64))

    def load(self, st) -> None:
        """Copy the host-side state ``st`` in (values only)."""
        for n in self._ARRAYS:
            if getattr(self, n) is not None:
                getattr(self, n).copy_(getattr(st, n))
        for n in self._SCALARS:
            getattr(self, n).fill_(getattr(st, n))
        self.resvec.zero_()
        self.recvec.zero_()


# ----------------------------------------------------------------------
# the recording: graph segments, host steps, switches
# ----------------------------------------------------------------------
class _Graph:
    __slots__ = ("graph", "launches", "comm", "name")

    def __init__(self, graph, launches, comm, name):
        self.graph, self.launches, self.comm = graph, launches, comm
        self.name = name        # the span of its replays


class _Host:
    __slots__ = ("fn", "args", "outs", "single", "calls", "name")

    def __init__(self, fn, args, outs, single, calls, name):
        self.fn, self.args, self.outs, self.single = fn, args, outs, single
        self.calls = calls      # collective calls of one run of fn
        self.name = name


class _Switch:
    __slots__ = ("code", "branches")

    def __init__(self, code, branches):
        self.code, self.branches = code, branches


@dataclasses.dataclass
class EngineStats:
    """What one solve's iterations cost the host, counted where the
    work is issued: graph segments replayed, host steps run, switch
    codes read, kernel launches (our kernels), iterations, capture
    seconds (0 when the engine came from the cache).  Across processes
    the route of the row collectives: ``"captured"``, ``"host step"``,
    or ``"eager"`` where nothing records.  Their calls and bytes are
    ``comm.stats`` (replayed segments add theirs there), and
    ``describe`` gives each segment's and host step's."""

    iterations: int = 0
    segments: int = 0
    host_steps: int = 0
    switch_reads: int = 0
    launches: int = 0
    capture_s: float = 0.0
    captured: bool = False
    collective_route: Optional[str] = None

    def summary(self) -> dict:
        """The counts, and per iteration: graph segments replayed, host
        steps, host reads (host steps and switch reads), kernel
        launches."""
        n = max(self.iterations, 1)
        return dict(dataclasses.asdict(self),
                    segments_per_iter=self.segments / n,
                    host_steps_per_iter=self.host_steps / n,
                    host_reads_per_iter=(self.host_steps
                                         + self.switch_reads) / n,
                    launches_per_iter=self.launches / n)


class Recorder:
    """The iteration's hooks: ``host(fn, *args)`` for a call that cannot
    be captured, ``switch(code, branches)`` for the branch on a device
    code, ``phase(name)`` around each of the solver's phases.  Eager:
    plain calls.  Capturing: each of the first two closes the current
    graph segment, and the recording grows a program tree."""

    def __init__(self, engine: "Engine"):
        self.engine = engine
        self.comm = getattr(engine, "comm", None)
        self.capturing = False
        self.code = CODE_EXPAND
        self._phase = None      # the phase the iteration is in
        self._phases = []       # the phases of the open graph segment

    # ---- the hooks --------------------------------------------------
    @contextlib.contextmanager
    def phase(self, name: str):
        """The iteration's phase ``name`` (``gram_update``,
        ``project_solve``, ...): a ``Solver/<name>`` span; while
        capturing, it names the graph segments that hold its work and the
        host steps called inside it."""
        prev, self._phase = self._phase, name
        if self.capturing:
            self._phases.append(name)
        try:
            with span("Solver", name):
                yield
        finally:
            self._phase = prev

    def host(self, fn, *args, name: Optional[str] = None):
        global _ACTIVE
        if not self.capturing:
            return fn(*args)
        self._end()
        step = (f"Engine/host/{self._phase or 'iterate'}."
                f"{name or getattr(fn, '__name__', 'call')}")
        _ACTIVE = None          # host_call inside fn: a plain call
        before, cbefore = _counts(), _comm_counts(self.comm)
        try:
            with span(step):
                outs = fn(*args)
        finally:
            _ACTIVE = self
        single = isinstance(outs, torch.Tensor)
        static = tuple(o.clone() for o in ((outs,) if single else outs))
        calls = _comm_counts(self.comm)[0] - cbefore[0]
        self._prog[-1].append(_Host(fn, args, static, single, calls, step))
        if self._exec[-1]:
            self.engine.stats.host_steps += 1
            self.engine.stats.launches += sum(
                a - b for a, b in zip(_counts(), before))
        else:
            _set_comm_counts(self.comm, cbefore)   # a branch not taken
        self._begin()
        return static[0] if single else static

    def switch(self, code: torch.Tensor, branches) -> None:
        if not self.capturing:
            self.code = int(code)
            if branches[self.code] is not None:
                branches[self.code]()
            return
        self._end()
        c = -1
        if self._exec[-1]:
            with span("Engine", "switch"):
                c = self.code = int(code)
            self.engine.stats.switch_reads += 1
        progs = []
        for i, br in enumerate(branches):
            if br is None:
                progs.append(None)
                continue
            self._prog.append([])
            self._exec.append(self._exec[-1] and c == i)
            self._begin()
            br()
            self._end()
            progs.append(self._prog.pop())
            self._exec.pop()
        self._prog[-1].append(_Switch(code, progs))
        self._begin()
        self._after_switch = True

    # ---- capture ----------------------------------------------------
    def record(self, iterate: Callable[[], None]) -> list:
        """Capture one iteration into a program, executing it as it goes
        (each segment is replayed right after its capture).  The cyclic
        garbage collector is held off meanwhile: a dead engine's graphs
        freed during a capture would destroy graph executables, which
        CUDA forbids while a stream captures.  ``host_call`` reaches
        this recorder while it records."""
        global _ACTIVE
        gc.collect()
        gc.disable()
        self.capturing = True
        _ACTIVE = self
        self._prog, self._exec = [[]], [True]
        self._after_switch = False
        self._begin()
        try:
            iterate()
        except BaseException:
            try:
                self._graph.capture_end()
            except RuntimeError:
                pass
            raise
        finally:
            self.capturing = False
            _ACTIVE = None
            gc.enable()
        if self._after_switch:
            # the iteration ends at its switch: drop the empty tail
            self._graph.capture_end()
            _set_counts(self._snap)
            _set_comm_counts(self.comm, self._csnap)
        else:
            self._end()
        return self._prog[0]

    def _begin(self) -> None:
        eng = self.engine
        g = torch.cuda.CUDAGraph()
        g.register_generator_state(eng.gen)
        self._snap, self._csnap = _counts(), _comm_counts(self.comm)
        self._after_switch = False
        g.capture_begin(pool=eng.pool, capture_error_mode=eng.capture_mode)
        eng.segment_ticks.add_(1)       # no segment is empty
        self._graph = g
        self._phases = [self._phase] if self._phase else []

    def _end(self) -> None:
        g = self._graph
        g.capture_end()
        after, cafter = _counts(), _comm_counts(self.comm)
        delta = tuple(a - b for a, b in zip(after, self._snap))
        cdelta = tuple(a - b for a, b in zip(cafter, self._csnap))
        _set_counts(self._snap)   # captured, not launched
        _set_comm_counts(self.comm, self._csnap)
        phases = "+".join(dict.fromkeys(self._phases)) or "iterate"
        node = _Graph(g, delta, cdelta, f"Engine/replay/{phases}")
        self._prog[-1].append(node)
        if self._exec[-1]:
            self.engine.replay_graph(node)

    # ---- replay -----------------------------------------------------
    def replay(self, prog: list) -> None:
        eng = self.engine
        for node in prog:
            if isinstance(node, _Graph):
                eng.replay_graph(node)
            elif isinstance(node, _Host):
                before = _counts()
                with span(node.name):
                    outs = node.fn(*node.args)
                    for s, o in zip(node.outs,
                                    (outs,) if node.single else outs):
                        s.copy_(o)
                eng.stats.host_steps += 1
                eng.stats.launches += sum(
                    a - b for a, b in zip(_counts(), before))
            else:
                with span("Engine", "switch"):
                    self.code = int(node.code)
                eng.stats.switch_reads += 1
                branch = node.branches[self.code]
                if branch is not None:
                    self.replay(branch)


def describe(prog: list) -> dict:
    """Node counts of a recorded program: top-level graph segments and
    host steps, the collective calls captured in those segments and made
    by those host steps, and the same for each switch branch."""
    out = {"graphs": 0, "host_steps": 0, "captured_collectives": 0,
           "host_collectives": 0, "branches": []}
    for node in prog:
        if isinstance(node, _Graph):
            out["graphs"] += 1
            out["captured_collectives"] += node.comm[0]
        elif isinstance(node, _Host):
            out["host_steps"] += 1
            out["host_collectives"] += node.calls
        else:
            out["branches"] = [None if b is None else describe(b)
                               for b in node.branches]
    return out


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
class Engine:
    """One recorded iteration and the buffers it reads: built for the
    first solver with its key, reused by later ones.

    ``view``: the solver as the iteration sees it, with the engine's
    clones of A, M, B and ``b_sign``; ``ctx``: the solve's constants at
    full capacity, with ``r0sq`` and the nullspace as engine buffers;
    ``ds``: the ``DeviceState``.  ``build(view, ctx, ds, rec, draw)``
    returns the iteration (``LyapunovSolver._build_iterate``).  Dropping
    the engine (the solver that owns its cache, or the cache entry)
    frees its graphs and with them their memory pool.

    ``comm``: the row communicator of a multi-process mesh (None for one
    process); ``m``: the rows of the whole problem, ``own`` this rank's
    [r0, r1) of them (None: all rows, one process)."""

    def __init__(self, view, ctx, ds: DeviceState, build, draw_rows: int,
                 pins=(), comm=None, m: Optional[int] = None, own=None):
        self.view, self.ctx, self.ds = view, ctx, ds
        self.pins = list(pins)      # what the key names by identity
        self.device = ds.V.device
        self.cuda = self.device.type == "cuda"
        self.comm = comm
        self.m = ds.V.shape[0] if m is None else m
        self.own = own
        # NCCL's host threads poll their own events while a capture is
        # under way, which the global mode forbids
        self.capture_mode = "thread_local" if comm is not None \
            and comm.route == "captured" else "global"
        self.gen = torch.Generator(self.device)
        self.draws = None if draw_rows <= 0 else torch.zeros(
            (draw_rows, ds.V.shape[0]), dtype=ds.V.dtype, device=self.device)
        self.stats = self.new_stats()
        self.rec = Recorder(self)
        self.segment_ticks = torch.zeros((), dtype=torch.int64,
                                         device=self.device)
        self.program = None
        self._warm = False
        if self.cuda:
            self.pool = torch.cuda.graph_pool_handle()
            self.stream = torch.cuda.Stream(self.device)
        self.iterate = build(view, ctx, ds, self.rec, self._draw)

    def new_stats(self) -> EngineStats:
        route = None
        if self.comm is not None:
            route = self.comm.route if self.cuda and CAPTURE else "eager"
        return EngineStats(collective_route=route)

    def _draw(self) -> torch.Tensor:
        """The Lanczos start's normal draw: a row of the draws buffer
        when a ``draws`` hook fills it, else the engine's generator
        (registered with every graph segment; each solve sets it to the
        state its initial draw left), all m rows drawn and this rank's
        kept."""
        ds = self.ds
        if self.draws is not None:
            row = torch.remainder(ds.iter, self.draws.shape[0]).reshape(1)
            return self.draws.index_select(0, row).reshape(-1, 1)
        x = torch.randn((self.m, 1), generator=self.gen,
                        dtype=ds.V.dtype, device=self.device)
        return x if self.own is None else x[self.own[0]:self.own[1]]

    def replay_graph(self, node: _Graph) -> None:
        with span(node.name):
            node.graph.replay()
        _add_counts(node.launches)
        self.stats.segments += 1
        self.stats.launches += sum(node.launches)
        if self.comm is not None:
            self.comm.stats.add(node.comm)

    def step(self) -> int:
        """One iteration; returns its switch code."""
        if not (self.cuda and CAPTURE):
            self.iterate()
        elif self.program is not None:
            self.rec.replay(self.program)
        elif not self._warm:
            before = _counts()
            self.iterate()                  # the warm-up, eager
            self.stats.launches += sum(a - b for a, b in
                                       zip(_counts(), before))
            self._warm = True
        else:
            torch.cuda.synchronize(self.device)
            t0 = time.perf_counter()
            self.program = self.rec.record(self.iterate)
            torch.cuda.synchronize(self.device)
            self.stats.capture_s = time.perf_counter() - t0
            self.stats.captured = True
        self.stats.iterations += 1
        return self.rec.code

    def fill_draws(self, hook, it0: int, n: int, dtype) -> None:
        """Rows for iterations it0 .. it0 + n - 1 from the ``draws``
        hook (row ``iter % rows``), one call per iteration, in order:
        each call asks for all m rows, this rank's are kept."""
        rows, m = self.draws.shape[0], self.m
        for j in range(n):
            x = hook("lanczos_normal", (m, 1), dtype, self.device)
            x = torch.as_tensor(x, dtype=dtype).reshape(m)
            if self.own is not None:
                x = x[self.own[0]:self.own[1]]
            self.draws[(it0 + j) % rows].copy_(x)

    def read(self) -> Tuple[int, float, bool]:
        """(iter, res, done) of the state; across processes checked to
        be the same bits on every rank, else every rank raises."""
        ds = self.ds
        with span("Engine", "read"):
            vals = torch.stack(
                [ds.iter.double(), ds.res.double(), ds.done.double()])
            if self.comm is not None:
                self._check_in_step(vals)
            it, res, done = vals.tolist()
        return int(it), res, bool(done)

    def _check_in_step(self, vals: torch.Tensor) -> None:
        got = self.comm.allgather_many([vals])[0].cpu()
        bits = got.view(torch.int64)
        off = (bits != bits[0]).any(dim=1).nonzero().flatten().tolist()
        if off:
            rows = "; ".join(
                f"rank {r}: iter {int(i)}, res {x!r}, done {bool(d)}"
                for r, (i, x, d) in enumerate(got.tolist()))
            raise RuntimeError(
                f"ranks out of step at a chunk read: rank(s) {off} differ "
                f"from rank 0 ({rows}); every rank raises")
