"""The port's spans (``rails_tpu_torch/timer.py::span``): ranges on the
profiler's clock that cost nothing while no profiler collects.

CPU: ``span`` makes no ``record_function`` without a profiler; under
``torch.profiler`` the solver's, the projected solve's (its host zgees
and trsyl named by child spans), the Schur apply's and the CLI's spans
nest as the calls do, on a symmetric and a non-symmetric DAE; ``timer`` keeps its
table and its synchronisation rules under the profiler.

Tests marked ``cuda`` run on the card: a replayed solve under the
profiler shows the engine's spans, and the DIA kernel's launches tied to
the replay spans by the profiler's correlation ids match its counter.
"""

import collections
import contextlib
import importlib
import io

import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.profiler import ProfilerActivity, profile

import rails_tpu_torch as rt
from rails_tpu_torch.linalg.dense_lyap import lyap
from rails_tpu_torch.models import make_problem
from rails_tpu_torch.models.problems import tridiagonal_problem
from rails_tpu_torch.schur import schur_reduce

# the module: the package's ``timer`` is the function
timer_mod = importlib.import_module("rails_tpu_torch.timer")

torch.set_num_threads(1)

PHASES = ("gram_update", "project_solve", "lanczos", "expand")


def program_spans(prof):
    """(start, end, name) of the program's spans in a profiler's events,
    by start."""
    return sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                  for e in prof.profiler.kineto_results.events()
                  if "/" in e.name()
                  and not str(e.device_type()).endswith("CUDA"))


def inside(child, parents) -> bool:
    return any(p[0] <= child[0] and child[1] <= p[1] for p in parents)


def named(spans, name):
    return [s for s in spans if s[2] == name]


def holders(children, parents):
    """For each child span, the index of the one parent that holds it."""
    out = []
    for c in children:
        held = [i for i, p in enumerate(parents) if inside(c, [p])]
        assert len(held) == 1, c
        out.append(held[0])
    return out


def small_solve(compiled=False):
    a, b = tridiagonal_problem(np.random.default_rng(0), 30)
    return rt.solve(a, b, device="cpu", tol=1e-8, compiled=compiled)


@pytest.fixture
def timer_state():
    """The timer's switch and table, restored after the test."""
    timer_mod.reset_profiles()
    yield timer_mod
    timer_mod.disable_profiling()
    timer_mod.reset_profiles()


def test_span_is_free_while_no_profiler_collects(monkeypatch, timer_state):
    """Without a profiler no span opens a ``record_function``, eager or
    compiled, with the timer's table on or off."""
    def refuse(*args, **kwargs):
        raise AssertionError("record_function while no profiler collects")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert timer_mod.span("Solver", "solve") is timer_mod.span("x")
    for compiled in (False, True):
        assert small_solve(compiled)[2].converged
    timer_state.enable_profiling()
    assert small_solve()[2].converged
    assert timer_state.get_profiles()


@pytest.mark.parametrize("compiled", [False, True])
def test_solve_spans_nest(compiled):
    """One ``Solver/solve`` holds the whole solve.  Eager: each iteration
    a ``Solver/iterate`` holding its phases; compiled (on the CPU the
    recorded iteration runs eagerly): the phases of ``Recorder.phase``
    and one ``Engine/read`` per chunk, inside ``Solver/compiled``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, info = small_solve(compiled)
    spans = program_spans(prof)
    solve = named(spans, "Solver/solve")
    assert len(solve) == 1
    assert all(inside(s, solve) for s in spans if s not in solve)
    counts = collections.Counter(s[2] for s in spans)
    outer = named(spans, "Solver/compiled" if compiled else "Solver/iterate")
    assert counts["Solver/project_solve"] == counts["Solver/lanczos"] \
        == info.iter
    assert counts["Solver/gram_update"] > 0 and counts["Solver/expand"] > 0
    for s in spans:
        if s[2].split("/")[-1] in PHASES + ("restart", "read"):
            assert inside(s, outer), s
    if compiled:
        assert counts["Engine/read"] >= 1 and "Solver/iterate" not in counts
    else:
        assert len(outer) == info.iter and "Engine/read" not in counts


@pytest.mark.parametrize("compiled", [False, True])
def test_active_block_span_per_eager_iteration(compiled):
    """The eager loop solves the projected equation on the active block:
    one ``Solver/active_block`` per iteration, each inside that
    iteration's ``Solver/project_solve`` and holding its host Schur work.
    The recorded engine keeps the padded buffer and opens none."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _, _, info = small_solve(compiled)
    spans = program_spans(prof)
    block = named(spans, "Solver/active_block")
    if compiled:
        assert block == []
        return
    proj = named(spans, "Solver/project_solve")
    assert len(block) == len(proj) == info.iter > 0
    assert holders(block, proj) == list(range(len(proj)))
    host = named(spans, "DenseLyap/host_schur")
    assert len(host) == 2 * len(block)
    assert holders(host, block) == sorted(2 * list(range(len(block))))


def test_host_schur_once_per_projected_solve():
    """A dense nonsymmetric A takes the Schur route, by LAPACK on the
    host: inside each ``Solver/project_solve`` two
    ``DenseLyap/host_schur``, one holding the factor's
    ``DenseLyap/host_schur/zgees`` and one the solve's
    ``DenseLyap/host_schur/trsyl``."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        small_solve()
    spans = program_spans(prof)
    proj = named(spans, "Solver/project_solve")
    host = named(spans, "DenseLyap/host_schur")
    zgees = named(spans, "DenseLyap/host_schur/zgees")
    trsyl = named(spans, "DenseLyap/host_schur/trsyl")
    assert len(host) == 2 * len(proj) > 0
    assert holders(host, proj) == sorted(2 * list(range(len(proj))))
    assert holders(zgees, proj) == holders(trsyl, proj) \
        == list(range(len(proj)))
    assert sorted(holders(zgees + trsyl, host)) == list(range(len(host)))


def test_host_schur_spans_on_the_host_route():
    """The Schur route: one ``DenseLyap/host_schur`` for its factor and
    one for each trsyl solve, the refinement's included,
    none inside another; each holds one child that names its work,
    ``DenseLyap/host_schur/zgees`` or ``DenseLyap/host_schur/trsyl``."""
    rng = np.random.default_rng(5)
    k = 12
    a = torch.as_tensor(rng.uniform(-1, 1, (k, k)) - 3 * np.eye(k))
    c = torch.as_tensor(np.eye(k))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        x = lyap(a, c, method="schur", refine=1)
    assert torch.linalg.norm(a @ x + x @ a.T + c) < 1e-10
    spans = program_spans(prof)
    host = named(spans, "DenseLyap/host_schur")
    assert len(host) == 3
    assert all(p[1] <= q[0] for p, q in zip(host, host[1:]))
    zgees = named(spans, "DenseLyap/host_schur/zgees")
    trsyl = named(spans, "DenseLyap/host_schur/trsyl")
    assert len(zgees) == 1 and len(trsyl) == 2
    assert holders(zgees + trsyl, host) == [0, 1, 2]


def test_a11_solve_span_inside_schur_apply():
    """Each apply of S (and of S') runs its dense-LU A11 solve inside a
    ``Schur/a11_solve`` span, and the LU solve's op inside that span."""
    rng = np.random.default_rng(3)
    n = 30
    a = sp.csr_matrix(rng.uniform(-1, 1, (n, n)) - 4 * np.eye(n))
    md = rng.uniform(0.5, 1.5, n)
    md[:10] = 0.0
    b = rng.uniform(-1, 1, (n, 2))
    b[:10] = 0.0
    red = schur_reduce(a, md, b,
                       dtype=torch.float64, device="cpu",
                       a11_solver="dense_lu")
    op = red.operator
    x = torch.ones(red.n2, 2, dtype=torch.float64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        op.matmat(x)
        op.rmatmat(x)
    events = prof.profiler.kineto_results.events()
    spans = named(program_spans(prof), "Schur/a11_solve")
    assert len(spans) == 2
    lu = [(e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
          for e in events if "lu_solve" in e.name()]
    assert lu and all(inside(e, spans) for e in lu)


def test_timer_table_unchanged_under_profiler(timer_state):
    """The table the CLI prints (and the benchmark reads): the same
    scopes and calls with the profiler on, positive totals."""
    tables = []
    for traced in (False, True):
        timer_state.reset_profiles()
        timer_state.enable_profiling()
        with profile(activities=[ProfilerActivity.CPU]) \
                if traced else contextlib.nullcontext():
            small_solve()
        timer_state.disable_profiling()
        tables.append({k: p.calls for k, p in
                       timer_state.get_profiles().items()})
        assert all(p.total > 0 for p in timer_state.get_profiles().values())
        out = io.StringIO()
        timer_state.save_profiles(stream=out)
        assert out.getvalue().splitlines()[0].startswith("Class/Name")
    assert tables[0] == tables[1]
    assert tables[0][("Solver", "iterate")] > 0


def test_timer_syncs_only_when_profiling_is_on(monkeypatch, timer_state):
    """Under the profiler with the timer's profiling off: no
    synchronisation; with it on: one at each end of every scope."""
    syncs = []
    monkeypatch.setattr(timer_mod, "_sync", lambda: syncs.append(1))
    with profile(activities=[ProfilerActivity.CPU]):
        small_solve()
    assert syncs == []
    timer_state.enable_profiling()
    with profile(activities=[ProfilerActivity.CPU]):
        small_solve()
    scopes = sum(p.calls for p in timer_state.get_profiles().values())
    assert scopes > 0 and len(syncs) == 2 * scopes


def test_cli_spans_nest_under_driver_main(tmp_path):
    """A CLI run is one ``Driver/main`` span: the table's ``Driver/*``
    scopes, the solve and its Schur applies lie inside it."""
    from rails_tpu_torch import cli

    make_problem.make("dae", str(tmp_path))
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            contextlib.redirect_stdout(io.StringIO()):
        assert cli.main([str(tmp_path), "--device", "cpu", "--x64"]) == 0
    spans = program_spans(prof)
    main = named(spans, "Driver/main")
    assert len(main) == 1
    assert all(inside(s, main) for s in spans)
    names = {s[2] for s in spans}
    assert {"Driver/load", "Driver/schur", "Driver/eigenvalues",
            "Solver/solve", "Schur/a11_solve",
            "DenseLyap/host_schur"} <= names


def test_cli_symmetric_dae_takes_eigh(tmp_path):
    """A CLI run on a Laplacian DAE (symmetric A, dense-LU A11) tags S
    symmetric: it prints the eigh route and its trace has no
    ``DenseLyap/host_schur`` span."""
    from rails_tpu_torch import cli
    from rails_tpu_torch import io as rio
    from rails_tpu_torch.models.problems import laplacian2_sparse

    side = 16
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, side * side)
    md[rng.permutation(side * side)[: side * side // 3]] = 0.0
    b = rng.uniform(0, 1, (side * side, 4))
    b[md == 0] = 0.0
    rio.write_matrix_market(str(tmp_path / "A.mtx"), laplacian2_sparse(side))
    rio.write_matrix_market(str(tmp_path / "M.mtx"), sp.diags(md).tocsr())
    rio.write_matrix_market(str(tmp_path / "B.mtx"), sp.csr_matrix(b))
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            contextlib.redirect_stdout(out):
        assert cli.main([str(tmp_path), "--device", "cpu", "--x64"]) == 0
    assert "Projected solver: eigh (S symmetric)" in out.getvalue()
    assert "Solver converged" in out.getvalue()
    names = {s[2] for s in program_spans(prof)}
    assert "Solver/project_solve" in names
    assert "DenseLyap/host_schur" not in names


def test_cli_non_symmetric_dae_opens_the_child_spans(tmp_path):
    """A CLI run on the convection-diffusion DAE (the benchmark's
    ``fdm2d`` family) on the Schur route: S untagged, one
    ``DenseLyap/host_schur/zgees`` per projected solve and a
    ``DenseLyap/host_schur/trsyl`` for each of its solves, each inside a
    ``DenseLyap/host_schur`` of its own."""
    from bench_torch.reference import problems
    from rails_tpu_torch import cli
    from rails_tpu_torch import io as rio

    side = 16
    a = problems.operator({"family": "fdm2d", "side": side,
                           "convection": {"x": 1.0, "y": 10.0},
                           "reaction": 0.0})
    rng = np.random.default_rng(0)
    md = rng.uniform(0.5, 1.5, side * side)
    md[rng.permutation(side * side)[: side * side // 3]] = 0.0
    b = rng.uniform(0, 1, (side * side, 4))
    b[md == 0] = 0.0
    rio.write_matrix_market(str(tmp_path / "A.mtx"), a)
    rio.write_matrix_market(str(tmp_path / "M.mtx"), sp.diags(md).tocsr())
    rio.write_matrix_market(str(tmp_path / "B.mtx"), sp.csr_matrix(b))
    out = io.StringIO()
    with profile(activities=[ProfilerActivity.CPU]) as prof, \
            contextlib.redirect_stdout(out):
        assert cli.main([str(tmp_path), "--device", "cpu", "--x64"]) == 0
    assert "Projected solver: schur (S not symmetric)" in out.getvalue()
    assert "Solver converged" in out.getvalue()
    spans = program_spans(prof)
    host = named(spans, "DenseLyap/host_schur")
    zgees = named(spans, "DenseLyap/host_schur/zgees")
    trsyl = named(spans, "DenseLyap/host_schur/trsyl")
    assert len(zgees) == len(named(spans, "Solver/project_solve")) > 0
    assert len(trsyl) >= len(zgees)
    assert len(host) == len(zgees) + len(trsyl)
    assert sorted(holders(zgees + trsyl, host)) == list(range(len(host)))


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture has no CPU mode")
    return torch.device("cuda")


def _replayed_solve():
    """A DIA Laplacian solve recorded once, then profiled replaying the
    cached engine: (profiler, info, DIA launches counted in the traced
    solve)."""
    from rails_tpu_torch.models.problems import laplacian2_sparse
    from rails_tpu_torch.sparse import spmm

    side = 32
    rng = np.random.default_rng(0)
    b = rng.uniform(0, 1, (side * side, 4))
    a = rt.sparse_from_scipy(laplacian2_sparse(side), fmt="dia",
                             dtype=torch.float64, is_symmetric=True,
                             device="cuda")
    opts = dict(tol=1e-4, expand=4, restart_size=40, reduced_size=20,
                maxit=500, timevec_chunk=4, engine_cache={})
    rt.LyapunovSolver(a, b, **opts).solve(compiled=True)
    torch.cuda.synchronize()
    before = spmm.dia_spmm.launches
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, _, info = rt.LyapunovSolver(a, b, **opts).solve(compiled=True)
        torch.cuda.synchronize()
    return prof, info, spmm.dia_spmm.launches - before


@pytest.mark.cuda
def test_replayed_solve_spans_on_card(cuda_device):
    """Every iteration of the traced solve replays: one ``Engine/switch``
    each, an ``Engine/host/project_solve.eigh`` host step, and replay
    spans named at capture by the phases their segments hold."""
    prof, info, _ = _replayed_solve()
    assert info.engine["captured"] is False and info.iter > 4
    spans = program_spans(prof)
    counts = collections.Counter(s[2] for s in spans)
    assert counts["Engine/switch"] == info.iter
    assert counts["Engine/host/project_solve.eigh"] == info.iter
    replays = [n for n in counts if n.startswith("Engine/replay/")]
    assert any("lanczos" in n.split("/")[-1].split("+") for n in replays)
    assert "Engine/capture" not in counts
    solve = named(spans, "Solver/solve")
    assert len(solve) == 1 and all(inside(s, solve) for s in spans
                                   if s not in solve)


@pytest.mark.cuda
def test_dia_launches_tied_to_replay_spans(cuda_device):
    """The DIA kernel's launches in the trace, tied by correlation id to
    the ``cudaGraphLaunch`` inside an ``Engine/replay/*`` span, are as
    many as the engine counted; with the eager ones of the solve, as many
    as the kernel's ``launches`` counter gained."""
    from bench_torch.spans import Spans

    prof, info, launches = _replayed_solve()
    s = Spans.from_events(prof.profiler.kineto_results.events())

    def dia(names):
        return sum(1 for a in s.launched(names) if "dia_" in a[3])

    # the engine's count (replays alone: only the DIA wrapper counts
    # here) and the wrapper's, the solve's initial space's launches too
    assert dia(["Engine/replay"]) == info.engine["launches"] > 0
    assert dia(["Solver/solve"]) == launches
