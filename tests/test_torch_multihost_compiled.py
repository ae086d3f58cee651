"""``solve(compiled=True)`` across processes against the JAX package, on
the CPU: ``torch.distributed`` with gloo, four processes (and two of two
shards each), the recorded iteration of every rank running eagerly on
its own rows (the CPU has no graph capture).

The workers are this file run as a script (``python
tests/test_torch_multihost_compiled.py MODES COORDINATOR PID NPROC LOCAL
DIR [DEVICE]``), with tests/test_torch_multihost.py's scheme: each joins
the group (``multihost.initialize``, one intra-op thread), builds
``make_mesh(devices=[DEVICE] * LOCAL)``, runs the named modes and writes
``.npz`` files that the test process holds against the JAX package's
``solve(compiled=True)`` on the eight-device CPU mesh of
tests/conftest.py.  Tolerances:

- the n = 1024 solve, fed the JAX package's draws: the JAX compiled mesh
  run's iterations, status and rank, X = V T V' on three probes to 1e-8
  relative (tests/test_torch_multihost.py's bound), T and info the same
  bits on every rank;
- compiled against the eager solver with its state at full capacity on
  the same ranks: the same bits (the same iteration on the same shapes);
- the distributed Schur operator and three continuation steps, fed the
  JAX package's draws (and, before each warm step, its carried basis):
  the JAX compiled mesh run's iterations and status, X on probes to
  1e-8 relative; with the solver's own draws, the one-process port's
  compiled counts as well.

The routing of the row collectives inside a recording (gloo: host steps,
NCCL: captured) and the ranks-in-step check run without a process group
or with four; the test marked ``cuda`` runs two gloo ranks on one card.
"""

import contextlib
import json
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

from test_torch_multihost import (  # noqa: E402
    CONT_OPTS, N_SOLVE, SCHUR_OPTS, SOLVE_OPTS, ReplayDraws, _digest,
    _free_port, _ranks_agree, continuation_inputs, continuation_jacobian,
    dae_dir, run_workers, solve_inputs)

THETAS = (0.0, 0.05, 0.1)


@contextlib.contextmanager
def full_capacity():
    """The eager solver with its state grown to the full capacity cap_kb
    before the first iteration, as ``solve(compiled=True)`` holds it:
    the same iteration at the same shapes."""
    from rails_tpu_torch.core.solver import LyapunovSolver

    init = LyapunovSolver._init_state

    def grown(self, m, *args, **kwargs):
        st, ctx = init(self, m, *args, **kwargs)
        self._grow_state(st, ctx.cap_kb)
        ctx.set_kb(ctx.cap_kb, m)
        return st, ctx

    LyapunovSolver._init_state = grown
    try:
        yield
    finally:
        LyapunovSolver._init_state = init


# ----------------------------------------------------------------------
# worker modes (run in the worker processes; no JAX there)
# ----------------------------------------------------------------------
def _solve_pair(comm, mesh, d, dev):
    """The n = 1024 solve compiled (through ``rt.solve(mesh=...)``) and
    eagerly at full capacity, both fed the JAX draws where ``d`` holds
    them, else the solver's generator: (compiled (v, t, info), eager (v,
    t, info), the compiled run's collective calls)."""
    import rails_tpu_torch as rt

    lap, b = solve_inputs()
    a = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                             device=dev, is_symmetric=True)
    path = os.path.join(d, "draws.npz")

    def draws():
        return ReplayDraws(path) if os.path.exists(path) else None

    calls = comm.stats.calls
    comp = rt.solve(a, b, mesh=mesh, compiled=True, dtype=torch.float64,
                    draws=draws(), **SOLVE_OPTS)
    calls = comm.stats.calls - calls
    with full_capacity():
        eager = rt.LyapunovSolver(a, b, None, mesh=mesh, dtype=torch.float64,
                                  draws=draws(), **SOLVE_OPTS).solve()
    return comp, eager, calls


def program_collectives(prog):
    """(captured, host-step) collective calls of a recorded program
    (``engine.describe``), its switch branches included."""
    cap, host = prog["captured_collectives"], prog["host_collectives"]
    for br in prog["branches"]:
        if br is not None:
            c, h = program_collectives(br)
            cap, host = cap + c, host + h
    return cap, host


def _same_run(comp, eager) -> bool:
    (vc, tc, ic), (ve, te, ie) = comp, eager
    return (ic.iter == ie.iter and ic.status == ie.status
            and np.array_equal(ic.resvec, ie.resvec)
            and torch.equal(tc, te) and torch.equal(vc, ve))


def w_solve(comm, mesh, d, tag, dev):
    from rails_tpu_torch.parallel import multihost

    comp, eager, calls = _solve_pair(comm, mesh, d, dev)
    v, t, info = comp
    e = info.engine
    np.savez(os.path.join(d, f"solve.{tag}.r{comm.rank}.npz"),
             v=multihost.allgather_rows(v, mesh).cpu().numpy(),
             t=t.cpu().numpy(), iters=info.iter, status=info.status,
             rank=v.shape[1], local_rows=v.shape[0],
             same=_ranks_agree(comm, t.cpu().numpy(), np.array(
                 [info.iter, info.status, info.mvps, v.shape[1]]),
                 np.array([info.res]), info.resvec),
             equal_to_eager=_same_run(comp, eager),
             eager_iters=eager[2].iter, route=str(e["collective_route"]),
             collectives_per_iter=calls / info.iter,
             recorded=e["program"] is not None,
             captured=e["captured"], engine_iters=e["iterations"])


def w_schur(comm, mesh, d, tag, dev):
    import rails_tpu_torch as rt
    from rails_tpu_torch import io as tio
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)

    src = dae_dir(d)
    a, m, b = (tio.read_matrix_market(os.path.join(src, f"{k}.mtx"))
               for k in "AMB")
    a, m, b, _ = pad_system(a, m, b, mesh.size)
    red = rt.schur_reduce(a, m, b, dtype=torch.float64, device=dev)
    op = distribute_schur(red, mesh)
    out = {"operator": type(op).__name__}
    for key, draws in (("own", None),
                       ("jax", ReplayDraws(os.path.join(d, "schur_draws.npz")))):
        v, t, info = rt.LyapunovSolver(
            op, red.bs, red.ms, mesh=mesh, dtype=torch.float64, draws=draws,
            **SCHUR_OPTS).solve(compiled=True)
        out.update({
            f"{key}_v": multihost.allgather_rows(v, mesh).cpu().numpy(),
            f"{key}_t": t.cpu().numpy(), f"{key}_iters": info.iter,
            f"{key}_status": info.status,
            f"{key}_same": _ranks_agree(comm, t.cpu().numpy(), np.array(
                [info.iter, info.status]))})
    np.savez(os.path.join(d, f"schur.{tag}.r{comm.rank}.npz"), **out)


def w_continuation(comm, mesh, d, tag, dev):
    import rails_tpu_torch as rt

    from rails_tpu_torch.parallel import multihost

    md, b = continuation_inputs()
    ref = np.load(os.path.join(d, "cont_jax.npz"))
    r0, r1 = mesh.local_range(md.size)
    iters, sizes, out = {}, [], {}
    for run in ("compiled", "eager", "jax"):
        cont = rt.ContinuationSolver(b, rt.DiagonalOperator(md, device=dev),
                                     mesh=mesh, dtype=torch.float64,
                                     **CONT_OPTS)
        iters[run] = []
        for j, theta in enumerate(THETAS):
            a = rt.sparse_from_scipy(continuation_jacobian(theta),
                                     fmt="dia", dtype=torch.float64,
                                     device=dev, is_symmetric=True)
            if run == "jax":    # each step's key chain starts anew
                cont.draws = ReplayDraws(os.path.join(d, "cont_draws.npz"))
                if j:
                    cont._prev_space = torch.from_numpy(
                        ref[f"space{j - 1}"][r0:r1]).to(dev)
            v, t, info = cont.step(a, compiled=run != "eager")
            iters[run].append(info.iter)
            if run == "compiled":
                sizes.append(len(cont._engine_cache))
            if run == "jax":
                out[f"v{j}"] = multihost.allgather_rows(v, mesh).cpu().numpy()
                out[f"t{j}"] = t.cpu().numpy()
                out[f"status{j}"] = info.status
                out[f"resvec{j}"] = np.asarray(info.resvec)
    np.savez(os.path.join(d, f"continuation.{tag}.r{comm.rank}.npz"),
             iters=np.array(iters["compiled"]),
             eager_iters=np.array(iters["eager"]),
             jax_iters=np.array(iters["jax"]), sizes=np.array(sizes), **out)


def w_out_of_step(comm, mesh, d, tag, dev):
    """Rank 1's residual moved by one part in 1e6 before the first chunk
    read: every rank must raise there, none may hang."""
    import rails_tpu_torch as rt
    from rails_tpu_torch.core import engine

    read = engine.Engine.read

    def perturbed(self):
        if comm.rank == 1 and self.stats.iterations <= 8:
            self.ds.res.mul_(1.0 + 1e-6)
        return read(self)

    engine.Engine.read = perturbed
    lap, b = solve_inputs()
    a = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                             device=dev, is_symmetric=True)
    try:
        rt.LyapunovSolver(a, b, None, mesh=mesh, dtype=torch.float64,
                          **SOLVE_OPTS).solve(compiled=True)
        message = ""
    except RuntimeError as e:
        message = str(e)
    finally:
        engine.Engine.read = read
    np.savez(os.path.join(d, f"out_of_step.{tag}.r{comm.rank}.npz"),
             message=message)


def w_card(comm, mesh, d, tag, dev):
    """The replayed compiled run on the card against the eager run at
    full capacity on the same ranks."""
    comp, eager, calls = _solve_pair(comm, mesh, d, dev)
    e = comp[2].engine
    captured, host = program_collectives(e["program"])
    np.savez(os.path.join(d, f"card.{tag}.r{comm.rank}.npz"),
             equal_to_eager=_same_run(comp, eager), iters=comp[2].iter,
             status=comp[2].status, captured=e["captured"],
             route=str(e["collective_route"]),
             host_collectives=host, captured_collectives=captured,
             collectives_per_iter=calls / comp[2].iter,
             digest=_digest(comp[1].cpu().numpy()))


WORKER_MODES = {"solve": w_solve, "schur": w_schur,
                "continuation": w_continuation, "out_of_step": w_out_of_step,
                "card": w_card}


def worker_main(argv):
    modes, coordinator, pid, nproc, local, d, *rest = argv
    dev = rest[0] if rest else "cpu"
    torch.set_num_threads(1)
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.mesh import make_mesh

    comm = multihost.initialize(coordinator, int(nproc), int(pid),
                                device=dev, backend="gloo")
    mesh = make_mesh(devices=[comm.device] * int(local))
    tag = f"{nproc}x{local}"
    for mode in modes.split(","):
        WORKER_MODES[mode](comm, mesh, d, tag, comm.device)
    print(json.dumps({"rank": comm.rank, "stats": comm.stats.as_dict()}))
    multihost.shutdown()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------------
# the test process: inputs, JAX references, comparisons
# ----------------------------------------------------------------------
LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2)}
MODES = {"4x1": ("solve", "schur", "out_of_step"),
         "2x2": ("solve", "continuation")}


def run_modes(modes, nproc, local, directory, device=None):
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = run_workers(
        [os.path.abspath(__file__)],
        lambda pid: [",".join(modes), coordinator, str(pid), str(nproc),
                     str(local), str(directory)]
        + ([] if device is None else [device]), nproc)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"


def _load(d, mode, tag, nproc):
    return [dict(np.load(os.path.join(d, f"{mode}.{tag}.r{r}.npz")))
            for r in range(nproc)]


@contextlib.contextmanager
def jax_eigh_sign_fixed():
    """The JAX solver's eigh with the signs fixed as the port fixes
    them."""
    import jax.numpy as jnp

    from rails_tpu.core import solver as jax_solver_mod
    from test_torch_parity import _jax_eigh_sign_fixed, _Proxy

    saved = jax_solver_mod.jnp
    jax_solver_mod.jnp = _Proxy(jnp, linalg=_Proxy(
        jnp.linalg, eigh=_jax_eigh_sign_fixed))
    try:
        yield
    finally:
        jax_solver_mod.jnp = saved


def jax_draws(m, iters):
    """The JAX solver's draws for an m-row solve of ``iters`` iterations:
    (init, normal); the compiled port asks for a whole chunk (8) of
    normal draws at a time."""
    from test_torch_parity import JaxDraws

    draws = JaxDraws(4634)
    init = draws("init_uniform", (m, 1), None, None)
    normal = np.stack([draws("lanczos_normal", (m, 1), None, None)
                       for _ in range(iters + 16)])
    return init, normal


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    """The workers' directory, holding the n = 96 DAE."""
    from rails_tpu_torch.models import make_problem

    d = tmp_path_factory.mktemp("multihost_compiled")
    make_problem.make("dae", dae_dir(str(d)), n=96)
    return d


@pytest.fixture(scope="module")
def jax_compiled(workdir):
    """The JAX compiled mesh solve (4 devices); its draws go to the
    workers' directory."""
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse

    lap, b = solve_inputs()
    with jax_eigh_sign_fixed():
        aj = jax_sparse(lap, fmt="dia", dtype=jnp.float64, is_symmetric=True)
        sj = rails_tpu.LyapunovSolver(aj, jnp.asarray(b), None,
                                      mesh=jax_mesh.make_mesh(4),
                                      dtype=jnp.float64, **SOLVE_OPTS)
        vj, tj, ij = sj.solve(compiled=True)
    init, normal = jax_draws(N_SOLVE, ij.iter)
    np.savez(workdir / "draws.npz", init=init, normal=normal)
    return np.asarray(vj), np.asarray(tj), ij


@pytest.fixture(scope="module")
def jax_schur(workdir):
    """The JAX package's distributed Schur operator on the n = 96 DAE,
    solved compiled on its 4-device mesh; its draws go to the workers'
    directory."""
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu import io as jio
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.parallel import schur_dist as jax_sd
    from rails_tpu.schur import schur_reduce as jax_schur_reduce

    src = dae_dir(str(workdir))
    a, m, b = (jio.read_matrix_market(os.path.join(src, f"{k}.mtx"))
               for k in "AMB")
    a, m, b, pad = jax_sd.pad_system(a, m, b, 4)
    assert pad == 0
    red = jax_schur_reduce(a, m, b)
    mesh = jax_mesh.make_mesh(4)
    with jax_eigh_sign_fixed():
        vj, tj, ij = rails_tpu.LyapunovSolver(
            jax_sd.distribute_schur(red, mesh), jnp.asarray(red.bs),
            red.ms, mesh=mesh, dtype=jnp.float64,
            **SCHUR_OPTS).solve(compiled=True)
    vj = np.asarray(vj)
    init, normal = jax_draws(vj.shape[0], ij.iter)
    np.savez(workdir / "schur_draws.npz", init=init, normal=normal)
    return vj, np.asarray(tj), ij


@pytest.fixture(scope="module")
def jax_continuation(workdir):
    """The JAX package's three continuation steps, compiled on its
    4-device mesh: each step's (V, T, info); the draws (the same at
    every step: each step's key chain starts anew) and the bases carried
    into the warm steps go to the workers' directory."""
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.continuation import ContinuationSolver as JaxCont
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse

    md, b = continuation_inputs()
    steps, spaces = [], {}
    with jax_eigh_sign_fixed():
        jc = JaxCont(jnp.asarray(b), rails_tpu.DiagonalOperator(
            jnp.asarray(md)), mesh=jax_mesh.make_mesh(4), dtype=jnp.float64,
            **CONT_OPTS)
        for j, theta in enumerate(THETAS):
            vj, tj, ij = jc.step(jax_sparse(
                continuation_jacobian(theta), fmt="dia", dtype=jnp.float64,
                is_symmetric=True), compiled=True)
            steps.append((np.asarray(vj), np.asarray(tj), ij))
            spaces[f"space{j}"] = np.asarray(jc._prev_space)
    init, normal = jax_draws(md.size, max(s[2].iter for s in steps))
    np.savez(workdir / "cont_draws.npz", init=init, normal=normal)
    np.savez(workdir / "cont_jax.npz", **spaces)
    return steps


@pytest.fixture(scope="module")
def runs(workdir, jax_compiled, jax_schur, jax_continuation):
    """Both layouts' workers, run once, in the workers' directory."""
    for tag, (nproc, local) in LAYOUTS.items():
        run_modes(MODES[tag], nproc, local, workdir)
    return str(workdir)


def x_probes(v, t, probes):
    return v @ (t @ (v.T @ probes))


@pytest.mark.timeout(300)
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_compiled_solve_matches_jax_compiled_mesh_run(runs, jax_compiled,
                                                      tag):
    """The n = 1024 Laplacian in DIA, f64, tol 1e-6, fed the JAX draws,
    compiled on 4 processes (and 2 x 2): the JAX compiled mesh run's
    iterations, status and rank; X on three probes to 1e-8; T and info
    the same bits on every rank; the collectives counted per iteration,
    routed eagerly on the CPU."""
    vj, tj, ij = jax_compiled
    nproc, local = LAYOUTS[tag]
    res = _load(runs, "solve", tag, nproc)
    probes = np.random.default_rng(11).uniform(-1, 1, (N_SOLVE, 3))
    xj = x_probes(vj, tj, probes)
    for z in res:
        assert int(z["iters"]) == ij.iter
        assert int(z["status"]) == ij.status == 0
        assert int(z["rank"]) == vj.shape[1]
        assert int(z["local_rows"]) == N_SOLVE // nproc
        assert bool(z["same"])
        assert np.array_equal(z["t"], res[0]["t"])
        xt = x_probes(z["v"], z["t"], probes)
        assert np.linalg.norm(xt - xj) <= 1e-8 * np.linalg.norm(xj)
        assert str(z["route"]) == "eager" and not bool(z["captured"])
        assert not bool(z["recorded"])
        assert int(z["engine_iters"]) == ij.iter
        assert float(z["collectives_per_iter"]) > 10


@pytest.mark.timeout(300)
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_compiled_equals_eager_at_full_capacity(runs, tag):
    """The compiled run and the eager solver with its state at full
    capacity, on the same ranks with the same draws: the same
    iterations, resvec, T and V, bit for bit."""
    nproc, _ = LAYOUTS[tag]
    for z in _load(runs, "solve", tag, nproc):
        assert bool(z["equal_to_eager"])
        assert int(z["eager_iters"]) == int(z["iters"])


@pytest.mark.timeout(300)
def test_distributed_schur_compiled_on_four_processes(runs, jax_schur):
    """The n = 96 DAE through distribute_schur on 4 processes, compiled.
    Fed the JAX draws: the JAX package's compiled run on its 4-device
    mesh - iterations, status, X of the reduced equation on probes to
    1e-8.  With the solver's own draws: the one-process port's compiled
    run on the same reduction (4 shards of one process) - iterations,
    status, X to 1e-8.  T the same on every rank."""
    import rails_tpu_torch as rt
    from rails_tpu_torch import io as tio
    from rails_tpu_torch.parallel.mesh import make_mesh
    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)

    vj, tj, ij = jax_schur
    res = _load(runs, "schur", "4x1", 4)
    src = dae_dir(runs)
    a, m, b = (tio.read_matrix_market(os.path.join(src, f"{k}.mtx"))
               for k in "AMB")
    a, m, b, pad = pad_system(a, m, b, 4)
    assert pad == 0
    mt = make_mesh(devices=["cpu"] * 4)
    red = rt.schur_reduce(a, m, b, dtype=torch.float64, device="cpu")
    v1, t1, one = rt.LyapunovSolver(distribute_schur(red, mt), red.bs,
                                    red.ms, mesh=mt, dtype=torch.float64,
                                    **SCHUR_OPTS).solve(compiled=True)
    assert one.converged and ij.converged
    probes = np.random.default_rng(12).uniform(-1, 1, (red.n2, 3))
    refs = {"jax": (x_probes(vj, tj, probes), ij.iter),
            "own": (x_probes(v1.numpy(), t1.numpy(), probes), one.iter)}
    for z in res:
        assert str(z["operator"]) == "DistributedSchurOperator"
        for key, (xr, iters) in refs.items():
            assert int(z[f"{key}_iters"]) == iters, key
            assert int(z[f"{key}_status"]) == 0 and bool(z[f"{key}_same"])
            xz = x_probes(z[f"{key}_v"], z[f"{key}_t"], probes)
            assert np.linalg.norm(xz - xr) <= 1e-8 * np.linalg.norm(xr), key


@pytest.mark.timeout(300)
def test_compiled_continuation_on_two_processes(runs, jax_continuation):
    """Three compiled continuation steps on 2 processes of 2 shards.

    Fed the JAX draws, each warm step started from the JAX package's
    carried basis (as tests/test_torch_continuation.py does: that basis
    is fixed only to about the tolerance), against the JAX package's
    compiled run on its 4-device mesh: each step converged, its first 10
    residual estimates to 1e-8 relative, X on probes to the tolerance
    (1e-6) relative, and its iterations within the across-process bound
    (15%).  Not equal: this problem's count moves with the rounding of
    the row sums - the JAX package takes 96 iterations on the cold step
    unsharded and 95 on its 4-device mesh, the port 96 in one process and
    97 on 2 processes, with the same draws - while the warm steps take
    46 and 40 in both packages.

    With the solver's own draws and bases: the eager steps' counts on the same
    ranks, the one-process port's compiled counts on the same 4-shard
    mesh within the across-process bound (15%: the ranks' partial sums
    round otherwise, and the third step takes 42 iterations on 2
    processes, eager and compiled, against 41 in one), and the engine
    cache holding [1, 2, 2] engines on every rank."""
    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel.mesh import make_mesh

    res = _load(runs, "continuation", "2x2", 2)
    md, b = continuation_inputs()
    cont = rt.ContinuationSolver(b, rt.DiagonalOperator(md, device="cpu"),
                                 mesh=make_mesh(devices=["cpu"] * 4),
                                 dtype=torch.float64, **CONT_OPTS)
    iters = [cont.step(rt.sparse_from_scipy(
        continuation_jacobian(theta), fmt="dia", dtype=torch.float64,
        device="cpu", is_symmetric=True), compiled=True)[2].iter
        for theta in THETAS]
    assert iters[1] < iters[0]
    probes = np.random.default_rng(13).uniform(-1, 1, (md.size, 3))
    tol = CONT_OPTS["tol"]
    for z in res:
        for j, (vj, tj, ij) in enumerate(jax_continuation):
            assert int(z[f"status{j}"]) == ij.status == 0
            assert abs(int(z["jax_iters"][j]) - ij.iter) <= 0.15 * ij.iter
            head = np.asarray(ij.resvec)[:10]
            assert np.all(np.abs(z[f"resvec{j}"][:10] - head)
                          <= 1e-8 * np.abs(head)), j
            xj = x_probes(vj, tj, probes)
            xz = x_probes(z[f"v{j}"], z[f"t{j}"], probes)
            assert np.linalg.norm(xz - xj) <= tol * np.linalg.norm(xj), j
        assert list(z["iters"]) == list(z["eager_iters"])
        assert list(z["iters"][:2]) == iters[:2]
        assert all(abs(int(i) - j) <= 0.15 * j
                   for i, j in zip(z["iters"], iters))
        assert list(z["sizes"]) == [1, 2, 2]


@pytest.mark.timeout(300)
def test_ranks_out_of_step_raise_on_every_rank(runs):
    """Rank 1's residual perturbed before the first chunk read: every
    rank raises there, naming rank 1, and no rank hangs (the workers
    exited 0 after the mode)."""
    for z in _load(runs, "out_of_step", "4x1", 4):
        msg = str(z["message"])
        assert "ranks out of step" in msg and "rank(s) [1]" in msg


# ---------------------------------------------------------------- routing
class _StubRecorder:
    """A recorder as ``host_call`` sees it while a capture is under way:
    logs each host step's function and runs it."""

    capturing = True

    def __init__(self, engine_mod):
        self.steps = []
        self.engine_mod = engine_mod

    def host(self, fn, *args, name=None):
        self.steps.append(fn)
        self.engine_mod._ACTIVE = None
        try:
            return fn(*args)
        finally:
            self.engine_mod._ACTIVE = self


def _fake_world(comm_mod, monkeypatch, world):
    """``_gather_into`` as a group of ``world`` ranks whose rank k sends
    this rank's tensor plus 100 k; returns the list of calls."""
    calls = []

    def gather(out, send, group=None):
        calls.append(send.numel())
        out.copy_(torch.cat([send + 100.0 * k for k in range(world)]))

    monkeypatch.setattr(comm_mod, "_gather_into", gather)
    return calls


def test_collectives_route_by_backend_inside_a_recording(monkeypatch):
    """Inside a recording, a gloo communicator's gather - a reduction's
    and a halo exchange's - is a host step (``engine.host_call``) and an
    NCCL one's is not; outside a recording both are plain calls.  The
    halos come from one all-gather: rank r gets rank r-1's last rows and
    rank r+1's first rows.  No process group is launched: the bodies are
    stubbed."""
    from rails_tpu_torch.core import engine as engine_mod
    from rails_tpu_torch.parallel import comm as comm_mod
    from rails_tpu_torch.parallel.comm import RowComm

    x = torch.arange(12.0).reshape(6, 2)
    gloo = RowComm(None, 1, 3, "cpu", "gloo")
    gloo.device = torch.device("cuda", 0)      # ranks sharing a card
    assert gloo.staged and gloo.route == "host step"
    log = []
    monkeypatch.setattr(gloo, "_gather",
                        lambda f: log.append("gather") or f.repeat(3, 1))
    # outside a recording: plain calls
    assert engine_mod._ACTIVE is None
    gloo.allreduce(x)
    gloo.neighbour_halos(x[:1], x[-1:])
    assert log == ["gather"] * 2
    stub = _StubRecorder(engine_mod)
    monkeypatch.setattr(engine_mod, "_ACTIVE", stub)
    gloo.allreduce(x)
    gloo.neighbour_halos(x[:1], x[-1:])
    assert stub.steps == [gloo._gather] * 2
    assert log == ["gather"] * 4

    nccl = RowComm(None, 1, 3, "cpu", "nccl")
    assert nccl.route == "captured" and not nccl.staged
    calls = _fake_world(comm_mod, monkeypatch, 3)
    stub.steps.clear()
    first, last = x[:2], x[-2:]
    lo, hi = nccl.neighbour_halos(first, last)
    assert stub.steps == [] and len(calls) == 1     # one all-gather
    assert torch.equal(lo, last + 0.0) and torch.equal(hi, first + 200.0)
    total = nccl.allreduce(x)
    assert stub.steps == [] and len(calls) == 2
    assert torch.equal(total, 3 * x + 300.0)
    assert nccl.stats.calls == 2
    # the mesh's ends: no lower halo on rank 0, no upper on the last
    for rank, want in ((0, (None, 100.0)), (2, (100.0, None))):
        nccl.rank = rank
        got = nccl.neighbour_halos(first, last)
        for g, w, base in zip(got, want, (last, first)):
            assert (g is None) == (w is None)
            if g is not None:
                assert torch.equal(g, base + w)
    # an empty halo on one side only
    nccl.rank = 1
    lo, hi = nccl.neighbour_halos(None, last)
    assert hi is None and torch.equal(lo, last)


def test_recorder_keeps_host_step_collectives(monkeypatch):
    """A halo exchange under gloo as a host step of the real
    ``Recorder``: the node counts its collective, the halo is a view of
    the node's output, a replay gathers again into that output, and
    ``comm.stats`` counts the gather at record and at replay."""
    from rails_tpu_torch.core import engine as engine_mod
    from rails_tpu_torch.parallel.comm import RowComm

    comm = RowComm(None, 0, 2, "cpu", "gloo")
    x = torch.arange(8.0).reshape(4, 2)

    def gather(flat):       # rank 1 sends rank 0's rows plus 100
        comm.stats.calls += 1
        return torch.stack([flat, flat + 100.0])

    monkeypatch.setattr(comm, "_gather", gather)
    eng = SimpleNamespace(stats=engine_mod.EngineStats(), comm=comm)
    rec = engine_mod.Recorder(eng)
    rec.capturing, rec._prog, rec._exec = True, [[]], [True]
    monkeypatch.setattr(rec, "_end", lambda: None)
    monkeypatch.setattr(rec, "_begin", lambda: None)
    monkeypatch.setattr(engine_mod, "_ACTIVE", rec)
    lo, hi = comm.neighbour_halos(x[:1], x[-1:])
    assert lo is None and torch.equal(hi, x[:1] + 100.0)
    (node,) = rec._prog[0]
    assert node.calls == 1 and eng.stats.host_steps == 1
    assert comm.stats.calls == 1
    assert engine_mod.describe(rec._prog[0])["host_collectives"] == 1
    node.args[0].add_(1.0)     # the next iteration's rows, as a segment
    rec.replay(rec._prog[0])   # writes them into the gather's input
    assert torch.equal(hi, x[:1] + 101.0)
    assert eng.stats.host_steps == 2 and comm.stats.calls == 2


def test_engine_key_names_the_communicator():
    """The engine key holds the communicator's world size and backend,
    and the operators' structure leaves the communicator (whose stats
    move at every call) out, so a later solve finds the same engine."""
    import rails_tpu_torch as rt
    from rails_tpu_torch.core.engine import structure
    from rails_tpu_torch.parallel.comm import RowComm
    from rails_tpu_torch.parallel.mesh import Mesh

    comm = RowComm(None, 0, 2, "cpu", "gloo")
    mesh = Mesh(["cpu"], comm)
    lap, b = solve_inputs()
    solver = rt.LyapunovSolver(
        rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                             device="cpu", is_symmetric=True), b, None,
        mesh=mesh, dtype=torch.float64, **SOLVE_OPTS)
    sig = structure(solver.A)
    comm.stats.calls += 5
    assert structure(solver.A) == sig
    assert not any(".comm" in str(entry[0]) for entry in sig)
    ctx = SimpleNamespace(nullspace=None)
    key = solver._engine_key(64, ctx, [])
    assert (2, "gloo") in key


def test_one_rank_comm_differs_from_one_process_only_in_its_norms(
        monkeypatch):
    """A one-rank gloo group's compiled solve against the one-process
    solve: the same bits once the one process forms its 2-norms as the
    communicator does, sqrt of the (rank-summed) sum of squares, in place
    of ``torch.linalg.norm``.  That rounding alone is what a one-rank
    group changes (a count may move by it, as any rounding moves this
    solver's count)."""
    import socket

    import torch.distributed as dist

    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel.comm import RowComm
    from rails_tpu_torch.parallel.mesh import Mesh

    lap, b = solve_inputs()
    a = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                             device="cpu", is_symmetric=True)

    def run(comm):
        return rt.LyapunovSolver(a, b, None, mesh=Mesh(["cpu"], comm),
                                 dtype=torch.float64,
                                 **SOLVE_OPTS).solve(compiled=True)

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            world_size=1, rank=0)
    try:
        comm = RowComm(None, 0, 1, "cpu", "gloo")
        v1, t1, i1 = run(comm)
        assert comm.stats.calls > i1.iter
    finally:
        dist.destroy_process_group()
    monkeypatch.setattr(torch.linalg, "norm", lambda x, dim=None:
                        torch.sqrt(torch.sum(x * x, dim=dim)))
    v0, t0, i0 = run(None)
    assert i1.iter == i0.iter and i1.status == i0.status == 0
    assert np.array_equal(i1.resvec, i0.resvec)
    assert torch.equal(t1, t0) and torch.equal(v1, v0)


# ---------------------------------------------------------------- on the card
@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: graph capture has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.timeout(300)
def test_replay_across_processes_bit_equal_to_eager_on_card(
        cuda_device, tmp_path):
    """Two gloo ranks on cuda:0, n = 1024, the solver's own draws: the
    compiled run recorded into graph segments (its row collectives host
    steps) and replayed, bit for bit the eager run at full capacity on
    the same ranks."""
    run_modes(("card",), 2, 1, tmp_path, device="cuda:0")
    res = _load(str(tmp_path), "card", "2x1", 2)
    for z in res:
        assert bool(z["equal_to_eager"]) and int(z["status"]) == 0
        assert bool(z["captured"]) and str(z["route"]) == "host step"
        assert int(z["host_collectives"]) > 0
        assert int(z["captured_collectives"]) == 0
        assert np.array_equal(z["digest"], res[0]["digest"])
