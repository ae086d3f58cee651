"""The port's row mesh across processes against the JAX package, on the
CPU: ``torch.distributed`` with gloo, four processes (and two processes
of two shards each), counterparts of tests/test_multihost.py's
multi-process tests.

The workers are this file run as a script (``python
tests/test_torch_multihost.py MODES COORDINATOR PID NPROC LOCAL DIR``):
each joins the group (``multihost.initialize``, one intra-op thread),
builds ``make_mesh(devices=["cpu"] * LOCAL)`` and runs the named modes,
writing ``.npz`` files that the test process holds against the JAX
package, which runs here on the eight-device CPU mesh of
tests/conftest.py.  Tolerances:

- the row reductions and the halo DIA and ELL applies at float64: 1e-12
  of max|y| (each row's few terms in another order);
- the n = 1024 solve, fed the JAX package's draws: the same iterations,
  status and rank, X = V T V' on three probes to 1e-8 relative (as
  tests/test_torch_parity.py), and T and info the same bits on every
  rank;
- the distributed Schur operator's applies: 1e-10 relative; eigenvalues:
  1e-8 relative to the one-process port and the JAX package.
"""

import hashlib
import json
import os
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
N_SOLVE = 1024            # laplacian side 32
SOLVE_OPTS = dict(tol=1e-6)
N_GRAM = 512
DIA_OFFSETS = (-3, 0, 2)


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_workers(script, args_of, nproc, timeout=600, env=None):
    """Start ``nproc`` workers (``args_of(pid)`` their arguments after the
    script), wait for all, kill any left; returns [(rc, out, err)].  The
    limit is generous: with the suite's other workers on the same cores
    every collective waits longer (four processes' CLI run took 15 s
    alone and over 200 s under the full suite)."""
    full_env = dict(os.environ if env is None else env)
    # one thread each: several processes share the cores, and spinning
    # BLAS or OpenMP threads slow their collectives by orders of magnitude
    for var in ("OMP_NUM_THREADS", "OPENBLAS_NUM_THREADS", "MKL_NUM_THREADS"):
        full_env[var] = "1"
    full_env["PYTHONPATH"] = os.pathsep.join(
        [REPO] + full_env.get("PYTHONPATH", "").split(os.pathsep))
    procs = [subprocess.Popen([sys.executable, *script, *args_of(pid)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=full_env, cwd=REPO)
             for pid in range(nproc)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def run_modes(modes, nproc, local, directory):
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = run_workers(
        [os.path.abspath(__file__)],
        lambda pid: [",".join(modes), coordinator, str(pid), str(nproc),
                     str(local), str(directory)], nproc)
    for rc, out, err in outs:
        assert rc == 0, f"worker failed rc={rc}\nstdout:{out}\nstderr:{err}"
    return outs


# ----------------------------------------------------------------------
# inputs (numpy, from seeds), shared by the workers and the test process
# ----------------------------------------------------------------------
def banded(m, band, per_row, seed):
    import scipy.sparse as sp

    rng = np.random.default_rng(seed)
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1,
                                               (m, per_row)), 0, m - 1)
    val = rng.uniform(-1, 1, (m, per_row))
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, per_row), idx.ravel())),
                      shape=(m, m)).tocsr()
    return (a - sp.eye(m) * (np.abs(a).sum(axis=1).max() + 1.0)).tocsr()


def gram_inputs():
    rng = np.random.default_rng(0)
    v = rng.uniform(-1, 1, (N_GRAM, 3))
    data = rng.uniform(-1, 1, (len(DIA_OFFSETS), N_GRAM))
    return v, data, banded(N_GRAM, 40, 5, 1)


def solve_inputs():
    from rails_tpu_torch.models.problems import laplacian2_sparse

    return laplacian2_sparse(32), np.random.default_rng(7).uniform(
        0, 1, (N_SOLVE, 1))


def low_rank_inputs(n=512, k=12):
    rng = np.random.default_rng(3)
    v, _ = np.linalg.qr(rng.uniform(-1, 1, (n, k)))
    t = np.diag(np.geomspace(1.0, 1e-3, k))
    return v, t


def continuation_jacobian(theta, side=16):
    import scipy.sparse as sp

    return (sp.kron(sp.eye(side), sp.diags([1.0, -4.0 - theta, 1.0],
                                           [-1, 0, 1], (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()


def continuation_inputs(side=16):
    rng = np.random.default_rng(0)
    n = side * side
    return rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, (n, 2))


CONT_OPTS = dict(tol=1e-6, expand=2, restart_size=40, reduced_size=20)
SCHUR_OPTS = dict(tol=1e-8, expand=1)


def dae_dir(directory):
    return os.path.join(directory, "dae")


# ----------------------------------------------------------------------
# worker modes (run in the worker processes; no JAX there)
# ----------------------------------------------------------------------
def _digest(*arrays):
    h = hashlib.sha256()
    for a in arrays:
        h.update(np.ascontiguousarray(a).tobytes())
    return np.frombuffer(h.digest()[:8], dtype=np.int64).copy()


def _ranks_agree(comm, *arrays) -> bool:
    """Whether every rank holds the same bits (an allgather of a hash)."""
    d = torch.from_numpy(_digest(*arrays))
    got = comm.allgather_many([d])[0]
    return bool((got == got[0]).all())


class ReplayDraws:
    """The JAX package's draws, precomputed by the test process."""

    def __init__(self, path):
        z = np.load(path)
        self.init, self.normal = z["init"], z["normal"]
        self.used = 0

    def __call__(self, kind, shape, dtype, device):
        if kind == "init_uniform":
            return self.init
        x = self.normal[self.used]
        self.used += 1
        return x


def w_collectives(comm, mesh, d, tag):
    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.halo_spmm import HaloDiaOperator
    from rails_tpu_torch.parallel.sharded import shard_operator, shard_state
    from rails_tpu_torch.sparse.formats import DiaMatrix

    v, data, a_ell = gram_inputs()
    r0, r1 = mesh.local_range(N_GRAM)
    x = multihost.make_global_array(torch.from_numpy(v[r0:r1]), mesh)
    gram = comm.allreduce(x.T @ x)
    op = HaloDiaOperator(DiaMatrix(torch.from_numpy(data), DIA_OFFSETS,
                                   (N_GRAM, N_GRAM)), mesh)
    y_dia = multihost.allgather_rows(op.matmat(x), mesh)
    he = shard_operator(rt.sparse_from_scipy(
        a_ell, fmt="ell", dtype=torch.float64, device="cpu"), mesh)
    y_ell = multihost.allgather_rows(he.matmat(x), mesh)
    yt_ell = multihost.allgather_rows(he.rmatmat(x), mesh)
    # operators with no row-local apply: gathered input, local rows out
    dense = rt.DenseOperator(torch.from_numpy(a_ell.toarray()),
                             device="cpu")
    gd = shard_operator(dense, mesh)
    y_dense = multihost.allgather_rows(gd.rmatmat(x), mesh)
    bop = shard_operator(rt.DenseOperator(torch.from_numpy(v), device="cpu"),
                         mesh)   # an (m, 3) B: B' x replicated, B y local
    btx = bop.rmatmat(x)
    by = multihost.allgather_rows(bop.matmat(btx), mesh)
    state = shard_state({"V": torch.from_numpy(v), "T": btx}, mesh,
                        m=N_GRAM)
    np.savez(os.path.join(d, f"collectives.{tag}.r{comm.rank}.npz"),
             gram=gram.numpy(), y_dia=y_dia.numpy(), y_ell=y_ell.numpy(),
             yt_ell=yt_ell.numpy(), ell_type=type(he).__name__,
             gathered_type=type(gd).__name__, y_dense=y_dense.numpy(),
             btx=btx.numpy(), by=by.numpy(),
             state_rows=state["V"].shape[0],
             state_t_same=bool(state["T"] is btx),
             process_count=multihost.process_count(),
             process_index=multihost.process_index(),
             shards=mesh.size, local_range=np.array([r0, r1]))


def w_solve(comm, mesh, d, tag):
    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel import multihost

    lap, b = solve_inputs()
    a = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                             device="cpu", is_symmetric=True)
    solver = rt.LyapunovSolver(a, b, None, mesh=mesh, dtype=torch.float64,
                               draws=ReplayDraws(os.path.join(
                                   d, "draws.npz")), **SOLVE_OPTS)
    v, t, info = solver.solve()
    vv = multihost.allgather_rows(v, mesh)
    same = _ranks_agree(comm, t.numpy(), np.array(
        [info.iter, info.status, info.mvps, v.shape[1]]),
        np.array([info.res]), info.resvec)
    calls = comm.stats.calls
    # the same solve through the recorded iteration, fed the same draws
    solver.draws = ReplayDraws(os.path.join(d, "draws.npz"))
    _, _, cinfo = solver.solve(compiled=True)
    np.savez(os.path.join(d, f"solve.{tag}.r{comm.rank}.npz"),
             v=vv.numpy(), t=t.numpy(), iters=info.iter,
             status=info.status, rank=v.shape[1], local_rows=v.shape[0],
             same=same, operator=type(solver.A).__name__, calls=calls,
             compiled_iters=cinfo.iter, compiled_status=cinfo.status)


def w_schur(comm, mesh, d, tag):
    import rails_tpu_torch as rt
    from rails_tpu_torch import io as tio
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)

    src = dae_dir(d)
    a, m, b = (tio.read_matrix_market(os.path.join(src, f"{k}.mtx"))
               for k in "AMB")
    a, m, b, _ = pad_system(a, m, b, mesh.size)
    red = rt.schur_reduce(a, m, b, dtype=torch.float64, device="cpu")
    op = distribute_schur(red, mesh)
    x = np.load(os.path.join(d, "schur_x.npy"))
    r0, r1 = mesh.local_range(red.n2)
    xl = torch.from_numpy(x[r0:r1])
    sx = multihost.allgather_rows(op.matmat(xl), mesh)
    stx = multihost.allgather_rows(op.rmatmat(xl), mesh)
    solver = rt.LyapunovSolver(op, red.bs, red.ms, mesh=mesh,
                               dtype=torch.float64, **SCHUR_OPTS)
    v, t, info = solver.solve()
    np.savez(os.path.join(d, f"schur.{tag}.r{comm.rank}.npz"),
             sx=sx.numpy(), stx=stx.numpy(), iters=info.iter,
             status=info.status, operator=type(op).__name__,
             same=_ranks_agree(comm, t.numpy()))


def w_eigs(comm, mesh, d, tag):
    import rails_tpu_torch as rt
    from rails_tpu_torch.models.problems import laplacian2_sparse
    from rails_tpu_torch.parallel.sharded import shard_operator

    v, t = low_rank_inputs()
    r0, r1 = mesh.local_range(v.shape[0])
    vl = torch.from_numpy(v[r0:r1])
    sop = rt.LowRankOperator(vl @ torch.from_numpy(t), vl, device="cpu",
                             comm=comm)
    e_low, vec = rt.eigs(sop, num=4, tol=1e-10, mesh=mesh)
    halo = shard_operator(rt.sparse_from_scipy(
        laplacian2_sparse(16), fmt="dia", dtype=torch.float64,
        device="cpu"), mesh)
    e_halo, _ = rt.eigs(halo, num=4, tol=1e-10, mesh=mesh)
    np.savez(os.path.join(d, f"eigs.{tag}.r{comm.rank}.npz"),
             low=e_low.numpy(), halo=e_halo.numpy(),
             vec_rows=vec.shape[0], same=_ranks_agree(
                 comm, e_low.numpy(), e_halo.numpy()))


def w_continuation(comm, mesh, d, tag):
    import rails_tpu_torch as rt

    md, b = continuation_inputs()
    cont = rt.ContinuationSolver(b, rt.DiagonalOperator(md, device="cpu"),
                                 mesh=mesh, dtype=torch.float64,
                                 **CONT_OPTS)
    iters = []
    for theta in (0.0, 0.05):
        a = rt.sparse_from_scipy(continuation_jacobian(theta), fmt="dia",
                                 dtype=torch.float64, device="cpu",
                                 is_symmetric=True)
        iters.append(cont.step(a)[2].iter)
    np.savez(os.path.join(d, f"continuation.{tag}.r{comm.rank}.npz"),
             iters=np.array(iters))


def w_count(comm, mesh, d, tag):
    from rails_tpu_torch.parallel import multihost

    np.savez(os.path.join(d, f"count.{tag}.r{comm.rank}.npz"),
             process_count=multihost.process_count(),
             process_index=multihost.process_index(), shards=mesh.size)


WORKER_MODES = {"count": w_count, "collectives": w_collectives,
                "solve": w_solve,
                "schur": w_schur, "eigs": w_eigs,
                "continuation": w_continuation}


def worker_main(argv):
    modes, coordinator, pid, nproc, local, d = argv
    torch.set_num_threads(1)
    from rails_tpu_torch.parallel import multihost
    from rails_tpu_torch.parallel.mesh import make_mesh

    comm = multihost.initialize(coordinator, int(nproc), int(pid),
                                device="cpu")
    mesh = make_mesh(devices=["cpu"] * int(local))
    tag = f"{nproc}x{local}"
    for mode in modes.split(","):
        WORKER_MODES[mode](comm, mesh, d, tag)
    print(json.dumps({"rank": comm.rank, "stats": comm.stats.as_dict()}))
    multihost.shutdown()


if __name__ == "__main__":
    worker_main(sys.argv[1:])
    sys.exit(0)


# ----------------------------------------------------------------------
# the test process: inputs, JAX references, comparisons
# ----------------------------------------------------------------------
LAYOUTS = {"4x1": (4, 1), "2x2": (2, 2)}
MODES = {"4x1": ("collectives", "solve", "schur", "eigs"),
         "2x2": ("collectives", "solve", "continuation")}


def _load(d, mode, tag, nproc):
    return [dict(np.load(os.path.join(d, f"{mode}.{tag}.r{r}.npz")))
            for r in range(nproc)]


@pytest.fixture(scope="module")
def jax_solve():
    """The JAX mesh solve (4 devices, eigh signs fixed as the port fixes
    them) and its draws."""
    import jax.numpy as jnp

    import rails_tpu
    from rails_tpu.core import solver as jax_solver_mod
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
    from test_torch_parity import JaxDraws, _jax_eigh_sign_fixed, _Proxy

    lap, b = solve_inputs()
    saved = jax_solver_mod.jnp
    jax_solver_mod.jnp = _Proxy(jnp, linalg=_Proxy(
        jnp.linalg, eigh=_jax_eigh_sign_fixed))
    try:
        aj = jax_sparse(lap, fmt="dia", dtype=jnp.float64, is_symmetric=True)
        sj = rails_tpu.LyapunovSolver(aj, jnp.asarray(b), None,
                                      mesh=jax_mesh.make_mesh(4),
                                      dtype=jnp.float64, **SOLVE_OPTS)
        vj, tj, ij = sj.solve()
    finally:
        jax_solver_mod.jnp = saved
    assert type(sj.A).__name__ == "HaloDiaOperator"
    draws = JaxDraws(4634)
    init = draws("init_uniform", (N_SOLVE, 1), None, None)
    normal = np.stack([draws("lanczos_normal", (N_SOLVE, 1), None, None)
                       for _ in range(ij.iter + 8)])
    return np.asarray(vj), np.asarray(tj), ij, init, normal


@pytest.fixture(scope="module")
def runs(tmp_path_factory, jax_solve):
    """Both layouts' workers, run once: {tag: directory}."""
    from rails_tpu_torch.models import make_problem

    d = tmp_path_factory.mktemp("multihost")
    _, _, _, init, normal = jax_solve
    np.savez(d / "draws.npz", init=init, normal=normal)
    make_problem.make("dae", dae_dir(str(d)), n=96)
    np.save(d / "schur_x.npy", np.random.default_rng(1).uniform(
        -1, 1, (64, 5)))
    out = {}
    for tag, (nproc, local) in LAYOUTS.items():
        run_modes(MODES[tag], nproc, local, d)
        out[tag] = str(d)
    return out


@pytest.mark.timeout(300)
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_collectives_and_halos_match_jax(runs, tag):
    """make_global_array from per-rank slabs; the allreduced Gram, the
    halo DIA apply and the halo ELL apply (and its transpose), gathered,
    against the JAX package's global V'V and halo operators on a
    4-device mesh: process boundaries carry the halos (with 2 x 2 also
    in-process ones)."""
    import jax
    import jax.numpy as jnp

    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.parallel import sharded as jax_sharded
    from rails_tpu.parallel.halo_spmm import halo_dia_spmm as jax_halo_dia
    from rails_tpu.sparse.formats import DiaMatrix as JaxDia
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse

    nproc, local = LAYOUTS[tag]
    res = _load(runs[tag], "collectives", tag, nproc)
    v, data, a_ell = gram_inputs()
    mj = jax_mesh.make_mesh(4)
    vj = jax.device_put(jnp.asarray(v), jax_mesh.row_sharding(mj))
    gram_j = np.asarray(jax.jit(lambda x: x.T @ x)(vj))
    ydia_j = np.asarray(jax.jit(lambda x: jax_halo_dia(
        JaxDia(jnp.asarray(data), DIA_OFFSETS, (N_GRAM, N_GRAM)), x, mj))(vj))
    hj = jax_sharded.shard_operator(jax_sparse(a_ell, fmt="ell",
                                               dtype=jnp.float64), mj)
    assert type(hj).__name__ == "HaloEllOperator"
    yell_j = np.asarray(jax.jit(lambda o, x: o.matmat(x))(hj, vj))
    ytell_j = np.asarray(jax.jit(lambda o, x: o.rmatmat(x))(hj, vj))
    for r, z in enumerate(res):
        assert int(z["process_count"]) == nproc
        assert int(z["process_index"]) == r
        assert int(z["shards"]) == 4
        assert list(z["local_range"]) == [r * N_GRAM // nproc,
                                          (r + 1) * N_GRAM // nproc]
        assert str(z["ell_type"]) == "HaloEllOperator"
        for key, ref in (("gram", gram_j), ("y_dia", ydia_j),
                         ("y_ell", yell_j), ("yt_ell", ytell_j)):
            assert np.abs(z[key] - ref).max() <= 1e-12 * np.abs(ref).max(), \
                (tag, r, key)
        assert np.array_equal(z["gram"], res[0]["gram"])
        # a dense operator and an (m, 3) B through GatheredOperator
        assert str(z["gathered_type"]) == "GatheredOperator"
        ref = a_ell.T @ v
        assert np.abs(z["y_dense"] - ref).max() <= 1e-12 * np.abs(ref).max()
        assert np.abs(z["btx"] - gram_j).max() <= 1e-12 * np.abs(gram_j).max()
        ref = v @ gram_j
        assert np.abs(z["by"] - ref).max() <= 1e-12 * np.abs(ref).max()
        assert int(z["state_rows"]) == N_GRAM // nproc
        assert bool(z["state_t_same"])


@pytest.mark.timeout(300)
@pytest.mark.parametrize("tag", list(LAYOUTS))
def test_solve_matches_jax_mesh_run(runs, jax_solve, tag):
    """The n = 1024 Laplacian in DIA, f64, tol 1e-6, fed the JAX draws:
    the JAX mesh run's iterations, status and rank; X on three probes to
    1e-8; T and info the same bits on every rank; compiled=True on the
    same ranks converged, its count within the across-process bound
    (15%) of the eager run's."""
    vj, tj, ij, _, _ = jax_solve
    nproc, local = LAYOUTS[tag]
    res = _load(runs[tag], "solve", tag, nproc)
    probes = np.random.default_rng(11).uniform(-1, 1, (N_SOLVE, 3))
    xj = vj @ (tj @ (vj.T @ probes))
    for z in res:
        assert str(z["operator"]) == "HaloDiaOperator"
        assert int(z["iters"]) == ij.iter
        assert int(z["status"]) == ij.status == 0
        assert int(z["rank"]) == vj.shape[1]
        assert int(z["local_rows"]) == N_SOLVE // nproc
        assert bool(z["same"])
        assert np.array_equal(z["t"], res[0]["t"])
        v, t = z["v"], z["t"]
        xt = v @ (t @ (v.T @ probes))
        assert np.linalg.norm(xt - xj) <= 1e-8 * np.linalg.norm(xj)
        assert int(z["compiled_status"]) == int(z["status"])
        assert abs(int(z["compiled_iters"]) - int(z["iters"])) \
            <= 0.15 * int(z["iters"])
        # the row reductions went through the communicator
        assert int(z["calls"]) > 10 * ij.iter


@pytest.mark.timeout(300)
def test_distributed_schur_on_four_processes(runs, tmp_path):
    """The n = 96 DAE through distribute_schur on 4 processes: S x and
    S' x against the JAX DistributedSchurOperator to 1e-10, and the solve's
    iteration count equal to the one-process port's."""
    import jax
    import jax.numpy as jnp

    import rails_tpu_torch as rt
    from rails_tpu import io as jio
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.parallel import schur_dist as jax_sd
    from rails_tpu.schur import schur_reduce as jax_schur_reduce
    from rails_tpu_torch.parallel.mesh import make_mesh
    from rails_tpu_torch.parallel.schur_dist import (
        distribute_schur, pad_system)

    res = _load(runs["4x1"], "schur", "4x1", 4)
    src = dae_dir(runs["4x1"])
    a, m, b = (jio.read_matrix_market(os.path.join(src, f"{k}.mtx"))
               for k in "AMB")
    a, m, b, pad = jax_sd.pad_system(a, m, b, 4)
    assert pad == 0
    op_j = jax_sd.distribute_schur(jax_schur_reduce(a, m, b),
                                   jax_mesh.make_mesh(4))
    x = np.load(os.path.join(runs["4x1"], "schur_x.npy"))
    mt = make_mesh(devices=["cpu"] * 4)
    a_t, m_t, b_t, _ = pad_system(a, m, b, 4)
    red = rt.schur_reduce(a_t, m_t, b_t, dtype=torch.float64, device="cpu")
    _, _, one = rt.LyapunovSolver(distribute_schur(red, mt), red.bs, red.ms,
                                  mesh=mt, dtype=torch.float64,
                                  **SCHUR_OPTS).solve()
    assert one.converged
    for name, key in (("matmat", "sx"), ("rmatmat", "stx")):
        yj = np.asarray(jax.jit(lambda o, v, f=name: getattr(o, f)(v))(
            op_j, jnp.asarray(x)))
        for z in res:
            assert str(z["operator"]) == "DistributedSchurOperator"
            assert np.abs(z[key] - yj).max() <= 1e-10 * np.abs(yj).max()
    for z in res:
        assert int(z["iters"]) == one.iter and int(z["status"]) == 0
        assert bool(z["same"])


@pytest.mark.timeout(300)
def test_eigs_over_row_local_bases(runs):
    """eigs over a row-local LowRankOperator and over a halo operator on 4
    processes: the converged eigenvalues equal, on every rank, the
    one-process port's and the JAX package's eigs(mesh=) to 1e-8."""
    import jax.numpy as jnp

    import rails_tpu_torch as rt
    from rails_tpu.eigs import eigs as jax_eigs
    from rails_tpu.operators import LowRankOperator as JaxLowRank
    from rails_tpu.parallel import mesh as jax_mesh
    from rails_tpu.parallel import sharded as jax_sharded
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
    from rails_tpu_torch.models.problems import laplacian2_sparse

    res = _load(runs["4x1"], "eigs", "4x1", 4)
    v, t = low_rank_inputs()
    mj = jax_mesh.make_mesh(4)
    refs = {}
    ej, _ = jax_eigs(JaxLowRank(jnp.asarray(v @ t), jnp.asarray(v)), num=4,
                     tol=1e-10, mesh=mj, dtype=jnp.float64)
    e1, _ = rt.eigs(rt.LowRankOperator(torch.from_numpy(v @ t),
                                       torch.from_numpy(v), device="cpu"),
                    num=4, tol=1e-10, device="cpu")
    refs["low"] = (np.asarray(ej), e1.numpy())
    lap = laplacian2_sparse(16)
    hj = jax_sharded.shard_operator(jax_sparse(lap, fmt="dia",
                                               dtype=jnp.float64), mj)
    ej, _ = jax_eigs(hj, num=4, tol=1e-10, mesh=mj, dtype=jnp.float64)
    e1, _ = rt.eigs(rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float64,
                                         device="cpu"), num=4, tol=1e-10)
    refs["halo"] = (np.asarray(ej), e1.numpy())
    for z in res:
        assert bool(z["same"]) and int(z["vec_rows"]) == 128
        for key, (ej, e1) in refs.items():
            scale = abs(ej[0])
            assert np.abs(z[key] - e1).max() <= 1e-8 * scale, key
            assert np.abs(z[key] - ej).max() <= 1e-8 * scale, key


@pytest.mark.timeout(300)
def test_continuation_on_two_processes(runs):
    """Two continuation steps on 2 processes of 2 shards: the iteration
    counts equal the one-process port's on the same 4-shard mesh."""
    import rails_tpu_torch as rt
    from rails_tpu_torch.parallel.mesh import make_mesh

    res = _load(runs["2x2"], "continuation", "2x2", 2)
    md, b = continuation_inputs()
    cont = rt.ContinuationSolver(b, rt.DiagonalOperator(md, device="cpu"),
                                 mesh=make_mesh(devices=["cpu"] * 4),
                                 dtype=torch.float64, **CONT_OPTS)
    iters = [cont.step(rt.sparse_from_scipy(
        continuation_jacobian(theta), fmt="dia", dtype=torch.float64,
        device="cpu", is_symmetric=True))[2].iter for theta in (0.0, 0.05)]
    assert iters[1] < iters[0]
    for z in res:
        assert list(z["iters"]) == iters


class TestRefusals:
    def test_nccl_on_a_shared_card_raises(self):
        """The device-assignment check, without launching NCCL: two ranks
        on one card refuse NCCL, asked for or by default; gloo there only
        when asked for; NCCL with a card per rank; gloo on the CPU."""
        from rails_tpu_torch.parallel.multihost import choose_backend

        card = torch.device("cuda", 0)
        for asked in ("nccl", None):
            with pytest.raises(ValueError, match="NCCL refuses two ranks"):
                choose_backend(asked, card, 2, 1)
        assert choose_backend("gloo", card, 2, 1) == "gloo"
        assert choose_backend(None, card, 2, 2) == "nccl"
        assert choose_backend(None, torch.device("cpu"), 4, 0) == "gloo"
        with pytest.raises(ValueError, match="CUDA tensors"):
            choose_backend("nccl", torch.device("cpu"), 2, 0)
        with pytest.raises(ValueError, match="unknown backend"):
            choose_backend("mpi", card, 2, 2)

    def test_env_backend_is_read(self, monkeypatch):
        from rails_tpu_torch.parallel.multihost import choose_backend

        monkeypatch.setenv("RAILS_DIST_BACKEND", "gloo")
        assert choose_backend(None, torch.device("cuda", 0), 4, 1) == "gloo"

    def test_one_process_over_distinct_devices_raises(self):
        from rails_tpu_torch.parallel.mesh import make_mesh

        with pytest.raises(NotImplementedError,
                           match="one process per card"):
            make_mesh(devices=["cpu", "meta"])

    def test_single_process_is_a_no_op(self):
        from rails_tpu_torch.parallel import multihost

        assert multihost.initialize(num_processes=1) is None
        assert multihost.process_count() == 1
        assert multihost.process_index() == 0
        x = torch.ones(4, 2)
        assert multihost.make_global_array(x) is x
        assert multihost.allgather_rows(x) is x
