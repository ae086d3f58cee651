"""The port's row-sharded mesh path against the JAX package's, on the CPU.

The JAX package runs its mesh over the eight virtual CPU devices of
``tests/conftest.py``; the port runs eight shards on ``cpu`` in one
process (``make_mesh(devices=["cpu"] * 8)``), with the plain version of
every kernel.  The same matrices and inputs, made with numpy, go through
both.  Tolerances:

- the halo kernel's plain version against the JAX package's Pallas halo
  kernel (interpret mode) at float32: 1e-5 of max|y| (one float32
  rounding per term in another order); against the exact product of the
  extended operand at float64: 1e-13 of max|y|;
- the halo operators against the JAX operators at float64: 1e-11 (both
  sum each row's few terms; the JAX package's shard body adds its
  boundary terms after the interior ones);
- mesh solves, draw for draw (``draws``, as in test_torch_parity.py): the
  same iteration count and status, and X = V T V' to 1e-9 relative;
- the port's mesh path on one device against its unsharded path: equal,
  since each row's terms are summed in the same order (a boundary halo's
  zeros add exact zeros).

Tests of kernel #3 itself carry the ``cuda`` marker and skip without a
card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import rails_tpu
from rails_tpu.parallel import mesh as jax_mesh
from rails_tpu.parallel import sharded as jax_sharded
from rails_tpu.parallel.halo_ell import build_halo_ell as jax_build_halo_ell
from rails_tpu.parallel.halo_spmm import halo_geometry_ok as jax_geometry_ok
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
import rails_tpu_torch as rt
from rails_tpu_torch.models.problems import laplacian2_sparse
from rails_tpu_torch.parallel import multihost
from rails_tpu_torch.parallel.halo_ell import (
    HaloEllOperator, HaloHybOperator, build_halo_ell)
from rails_tpu_torch.parallel.halo_spmm import (
    HaloDiaOperator, halo_dia_spmm, halo_geometry_ok)
from rails_tpu_torch.parallel.mesh import make_mesh
from rails_tpu_torch.parallel.sharded import (
    shard_array_rows, shard_operator, shard_state)
from rails_tpu_torch.sparse import spmm
from rails_tpu_torch.sparse.formats import DiaMatrix
from test_torch_parity import JaxDraws
from test_torch_parity import jax_sign_fixed  # noqa: F401  (fixture)

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def meshes():
    return jax_mesh.make_mesh(8), make_mesh(devices=["cpu"] * 8)


def banded_unstructured(rng, m, band=20, per_row=6):
    """tests/test_sharded.py's banded-unstructured matrix: random column
    picks within +-band, shifted diagonally dominant."""
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1,
                                               (m, per_row)), 0, m - 1)
    val = rng.uniform(-1, 1, (m, per_row))
    a = sp.coo_matrix((val.ravel(), (np.repeat(base, per_row), idx.ravel())),
                      shape=(m, m)).tocsr()
    return (a - sp.eye(m) * (np.abs(a).sum(axis=1).max() + 1.0)).tocsr()


def hyb_matrix(rng, m=1024):
    """tests/test_sharded.py's HYB matrix: a stencil plus stray
    couplings within the neighbour slabs."""
    a = (sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (m, m))
         + sp.diags([0.5, 0.5], [-16, 16], (m, m))).tolil()
    for i in rng.integers(0, m - 1, 40):
        a[i, min(i + int(rng.integers(2, 100)), m - 1)] = 0.3
    return a.tocsr()


def nonsym_stencil(side):
    """A convection-diffusion stencil (nonsymmetric: a transpose
    payload)."""
    n = side * side
    return (laplacian2_sparse(side)
            + 0.3 * sp.diags([1.0, -1.0], [1, -1], (n, n))
            + 0.2 * sp.diags([1.0, -1.0], [side, -side], (n, n))).tocsr()


def _halo_case(rng, dtype):
    m_loc, s = 1024, 4
    offsets = (-100, -1, 0, 1, 100)
    data = rng.uniform(-1, 1, (len(offsets), m_loc)).astype(dtype)
    x = rng.uniform(-1, 1, (m_loc, s)).astype(dtype)
    hl = rng.uniform(-1, 1, (100, s)).astype(dtype)
    hh = rng.uniform(-1, 1, (100, s)).astype(dtype)
    return data, offsets, x, hl, hh


def _port_halo(data, offsets, x, hl, hh):
    t = torch.from_numpy
    return spmm.dia_spmm_halo(t(data), torch.tensor(offsets,
                                                   dtype=torch.int32),
                              t(x), t(hl), t(hh)).numpy()


class TestHaloKernelPlainVersion:
    def test_matches_jax_halo_kernel(self, rng):
        """One shard (m_loc = 1024, offsets (-100, -1, 0, 1, 100), s = 4,
        f32) against the JAX package's dia_spmm_t_halo in interpret mode,
        whose halos are 128-column (s, pad) blocks: the port's hl is the
        last span_lo columns of the JAX hl, transposed."""
        from jax.experimental.pallas import tpu as pltpu
        from rails_tpu.sparse.formats import DiaMatrix as JaxDia
        from rails_tpu.sparse.spmm import dia_spmm_t_halo

        data, offsets, x, hl, hh = _halo_case(rng, np.float32)
        hl_j = np.zeros((4, 128), np.float32)
        hl_j[:, 128 - 100:] = hl.T
        hh_j = np.zeros((4, 128), np.float32)
        hh_j[:, :100] = hh.T
        with pltpu.force_tpu_interpret_mode():
            yj = np.asarray(dia_spmm_t_halo(
                JaxDia(jnp.asarray(data), offsets, (1024, 1024)),
                jnp.asarray(x.T), jnp.asarray(hl_j), jnp.asarray(hh_j))).T
        yt = _port_halo(data, offsets, x, hl, hh)
        assert np.abs(yt - yj).max() <= 1e-5 * np.abs(yj).max()

    def test_matches_extended_product_f64(self, rng):
        data, offsets, x, hl, hh = _halo_case(rng, np.float64)
        xe = np.vstack([hl, x, hh])
        rows, cols, vals = [], [], []
        for k, off in enumerate(offsets):
            i = np.arange(1024)
            rows.append(i)
            cols.append(i + 100 + off)
            vals.append(data[k])
        a_ext = sp.coo_matrix((np.concatenate(vals), (np.concatenate(rows),
                                                      np.concatenate(cols))),
                              shape=(1024, 1224)).tocsr()
        y = a_ext @ xe
        yt = _port_halo(data, offsets, x, hl, hh)
        assert np.abs(yt - y).max() <= 1e-13 * np.abs(y).max()

    def test_one_sided_and_empty_halos(self, rng):
        """A one-sided stencil takes None for its empty halo; offsets
        beyond a halo drop their terms, as the unsharded product drops
        terms beyond the matrix."""
        t = torch.from_numpy
        data = t(rng.uniform(-1, 1, (3, 64)))
        x = t(rng.uniform(-1, 1, (64, 3)))
        hh = t(rng.uniform(-1, 1, (7, 3)))
        offs = torch.tensor([0, 2, 7], dtype=torch.int32)
        y = spmm.dia_spmm_halo(data, offs, x, None, hh)
        xe = torch.cat([x, hh])
        ref = sum(data[k, :, None] * xe[o:o + 64]
                  for k, o in enumerate((0, 2, 7)))
        assert torch.allclose(y, ref, rtol=0, atol=1e-14)
        dia = DiaMatrix(data, (0, 2, 7), (64, 64))
        assert torch.equal(spmm.dia_spmm_halo(data, offs, x, None, None),
                           spmm.dia_spmm_reference(dia, x))


class TestGeometry:
    @pytest.mark.parametrize("side,offsets", [
        (16, None), (8, None), (32, (-40, 0, 1)), (32, (-129, 0)),
        (32, (0, 127)), (32, (0, 128))])
    def test_halo_geometry_ok_agrees(self, meshes, side, offsets):
        mj, mt = meshes
        if offsets is None:
            a = laplacian2_sparse(side)
        else:
            n = side * side
            a = sp.diags([1.0] * len(offsets), offsets, (n, n)).tocsr()
        aj, at = (jax_sparse(a, fmt="dia"),
                  rt.sparse_from_scipy(a, fmt="dia", device="cpu",
                                       dtype=torch.float64))
        assert halo_geometry_ok(at.fwd, mt) == jax_geometry_ok(aj.fwd, mj)

    def test_rectangular_and_uneven(self, meshes):
        _, mt = meshes
        data = torch.ones(1, 100)
        assert not halo_geometry_ok(DiaMatrix(data, (0,), (100, 100)), mt)
        data = torch.ones(1, 96)
        assert not halo_geometry_ok(DiaMatrix(data, (0,), (96, 80)), mt)

    @pytest.mark.parametrize("m,band", [(1024, 20), (2048, 150),
                                        (1024, 200)])
    def test_build_halo_ell_halos_agree(self, meshes, m, band):
        mj, mt = meshes
        a = banded_unstructured(np.random.default_rng(m + band), m,
                                band=band)
        aj, at = (jax_sparse(a, fmt="ell"),
                  rt.sparse_from_scipy(a, fmt="ell", device="cpu",
                                       dtype=torch.float64))
        pj, pt = jax_build_halo_ell(aj.fwd, mj), build_halo_ell(at.fwd, mt)
        assert (pj is None) == (pt is None)
        if pt is not None:
            assert (pt.halo_lo, pt.halo_hi) == (pj.halo_lo, pj.halo_hi)
            assert [e.shape for e in pt.shards] == \
                [(m // 8, pt.halo_lo + m // 8 + pt.halo_hi)] * 8

    def test_mesh_and_multihost(self, tmp_path):
        self.tmp = tmp_path
        mt = make_mesh(devices=["cpu"] * 4)
        assert mt.size == 4 and mt.row_slabs(12) == [(0, 3), (3, 6),
                                                     (6, 9), (9, 12)]
        with pytest.raises(ValueError, match="divisible"):
            mt.row_slabs(10)
        with pytest.raises(NotImplementedError,
                           match="one process per card"):
            make_mesh(devices=["cpu", "meta"])
        # two processes join a gloo group: process_count() is 2 in each
        from test_torch_multihost import run_modes

        run_modes(["count"], 2, 1, self.tmp)
        for r in range(2):
            z = np.load(self.tmp / f"count.2x1.r{r}.npz")
            assert (int(z["process_count"]), int(z["process_index"]),
                    int(z["shards"])) == (2, r, 2)
        multihost.initialize(num_processes=1)
        x = torch.ones(12, 2)
        assert multihost.make_global_array(x, mt) is x
        assert shard_array_rows(x, mt) is x and shard_state(x, mt) is x
        assert rt.make_mesh is make_mesh


def _x(rng, m, s):
    x = rng.uniform(-1, 1, (m, s))
    return x, jax.device_put(jnp.asarray(x), jax_mesh.row_sharding(
        jax_mesh.make_mesh(8))), torch.from_numpy(x)


CASES = {
    "dia laplacian n=256": (lambda rng: laplacian2_sparse(16), "dia",
                            HaloDiaOperator),
    "dia nonsymmetric n=576": (lambda rng: nonsym_stencil(24), "dia",
                               HaloDiaOperator),
    "ell banded m=1024": (lambda rng: banded_unstructured(rng, 1024), "ell",
                          HaloEllOperator),
    "hyb m=1024": (hyb_matrix, "hyb", HaloHybOperator),
}


class TestOperators:
    @pytest.mark.parametrize("case", list(CASES))
    def test_matmat_rmatmat_match_jax(self, rng, meshes, case):
        mj, mt = meshes
        build, fmt, cls = CASES[case]
        a = build(rng)
        aj = jax_sparse(a, fmt=fmt, dtype=jnp.float64)
        at = rt.sparse_from_scipy(a, fmt=fmt, dtype=torch.float64,
                                  device="cpu")
        assert at.format == aj.format == fmt
        hj, ht = jax_sharded.shard_operator(aj, mj), shard_operator(at, mt)
        assert isinstance(ht, cls) and type(hj).__name__ == cls.__name__
        x, xj, xt = _x(rng, a.shape[0], 3)
        for name in ("matmat", "rmatmat"):
            yj = np.asarray(jax.jit(lambda o, v, f=name: getattr(o, f)(v))(
                hj, xj))
            yt = getattr(ht, name)(xt).numpy()
            assert np.abs(yt - yj).max() <= 1e-11 * np.abs(yj).max(), name
            ref = (a if name == "matmat" else a.T) @ x
            assert np.abs(yt - ref).max() <= 1e-12 * np.abs(ref).max()
        # the one-device mesh path sums each row as the unsharded path does
        assert torch.equal(ht.matmat(xt), at.matmat(xt))
        assert torch.equal(ht.rmatmat(xt), at.rmatmat(xt))
        dense = ht.to_dense().numpy()
        assert np.array_equal(dense, at.to_dense().numpy())
        h32 = ht.astype(torch.float32)
        assert h32.payload_dtype == torch.float32 and type(h32) is cls
        assert ht.astype(torch.float64) is ht

    def test_halo_dia_spmm_function(self, rng, meshes):
        from rails_tpu.parallel.halo_spmm import halo_dia_spmm as jax_fn

        mj, mt = meshes
        a = nonsym_stencil(16)
        aj = jax_sparse(a, fmt="dia", dtype=jnp.float64)
        at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                                  device="cpu")
        x = rng.uniform(-1, 1, (256, 2))
        yj = np.asarray(jax.jit(lambda v: jax_fn(aj.fwd, v, mj))(
            jnp.asarray(x)))
        yt = halo_dia_spmm(at.fwd, torch.from_numpy(x), mt).numpy()
        assert np.abs(yt - yj).max() <= 1e-11 * np.abs(yj).max()
        y1 = halo_dia_spmm(at.fwd, torch.from_numpy(x[:, 0]), mt)
        assert y1.shape == (256,)
        with pytest.raises(ValueError, match="divisible"):
            halo_dia_spmm(at.fwd, torch.from_numpy(x),
                          make_mesh(devices=["cpu"] * 3))
        with pytest.raises(ValueError, match="slab"):
            halo_dia_spmm(at.fwd, torch.from_numpy(x),
                          make_mesh(devices=["cpu"] * 16))


class TestDispatch:
    def test_ineligible_periodic_is_unsharded(self, meshes):
        """A periodic wrap-around coupling reaches across the whole mesh:
        'auto' keeps the operator unsharded in both packages, 'halo'
        raises in both."""
        mj, mt = meshes
        m = 1024
        a = sp.diags([1.0, -4.0, 1.0], [-1, 0, 1], (m, m)).tolil()
        a[0, m - 1] = 1.0
        a[m - 1, 0] = 1.0
        a = a.tocsr()
        for fmt in ("ell", "dia"):
            aj = jax_sparse(a, fmt=fmt)
            at = rt.sparse_from_scipy(a, fmt=fmt, device="cpu",
                                      dtype=torch.float64)
            hj = jax_sharded.shard_operator(aj, mj)
            assert type(hj).__name__ == "SparseOperator"
            assert not hj.use_pallas
            assert shard_operator(at, mt) is at
            assert shard_operator(at, mt, spmm="gspmd") is at
            with pytest.raises(ValueError):
                jax_sharded.shard_operator(aj, mj, spmm="halo")
            with pytest.raises(ValueError, match="halo"):
                shard_operator(at, mt, spmm="halo")

    @pytest.mark.parametrize("case", [
        ("laplacian side 16", lambda: laplacian2_sparse(16), "dia"),
        ("laplacian side 8: slab == span", lambda: laplacian2_sparse(8),
         "dia"),
        ("laplacian side 32 in ell", lambda: laplacian2_sparse(32), "ell"),
        ("banded m=2048", lambda: banded_unstructured(
            np.random.default_rng(1), 2048), "ell"),
        ("hyb m=1024", lambda: hyb_matrix(np.random.default_rng(2)), "hyb"),
        ("hyb m=1024, auto", lambda: hyb_matrix(np.random.default_rng(3)),
         "auto"),
    ], ids=lambda c: c[0])
    def test_classes_agree(self, meshes, case):
        mj, mt = meshes
        _, build, fmt = case
        a = build()
        hj = jax_sharded.shard_operator(jax_sparse(a, fmt=fmt), mj)
        ht = shard_operator(rt.sparse_from_scipy(a, fmt=fmt, device="cpu",
                                                 dtype=torch.float64), mt)
        assert type(ht).__name__ == type(hj).__name__

    def test_by_design_no_128_row_slab_rule(self, rng, meshes):
        """m_loc = 100 is not a multiple of 128: the JAX package's TPU
        windows refuse it and it keeps the operator for its partitioner;
        the port's halo ELL has no such rule (ROADMAP Queue 3)."""
        mj, mt = meshes
        a = banded_unstructured(rng, 800)
        hj = jax_sharded.shard_operator(jax_sparse(a, fmt="ell"), mj)
        assert type(hj).__name__ == "SparseOperator"
        ht = shard_operator(rt.sparse_from_scipy(
            a, fmt="ell", device="cpu", dtype=torch.float64), mt)
        assert isinstance(ht, HaloEllOperator)
        x = torch.from_numpy(rng.uniform(-1, 1, (800, 2)))
        assert np.allclose(ht.matmat(x).numpy(), a @ x.numpy(), rtol=0,
                           atol=1e-12)

    def test_passes_through(self, meshes):
        _, mt = meshes
        d = rt.DiagonalOperator(torch.ones(16, dtype=torch.float64),
                                device="cpu")
        dn = rt.DenseOperator(torch.eye(16, dtype=torch.float64),
                              device="cpu")
        cb = rt.CallableOperator(lambda x: x, (16, 16), is_symmetric=True)
        for op in (d, dn, cb, rt.IdentityOperator(16)):
            assert shard_operator(op, mt) is op
        with pytest.raises(TypeError):
            shard_operator(rt.LowRankOperator(torch.ones(16, 2),
                                              device="cpu"), mt)
        with pytest.raises(ValueError, match="strategy"):
            shard_operator(d, mt, spmm="ring")


def _jax_vs_port_solve(a, fmt, b, md, meshes, tags, **opts):
    mj, mt = meshes
    aj = jax_sparse(a, fmt=fmt, dtype=jnp.float64, **tags)
    mj_op = None if md is None else rails_tpu.DiagonalOperator(
        jnp.asarray(md))
    sj = rails_tpu.LyapunovSolver(aj, jnp.asarray(b), mj_op, mesh=mj,
                                  dtype=jnp.float64, **opts)
    vj, tj, ij = sj.solve()
    at = rt.sparse_from_scipy(a, fmt=fmt, dtype=torch.float64,
                              device="cpu", **tags)
    mt_op = None if md is None else rt.DiagonalOperator(md, device="cpu")
    st = rt.LyapunovSolver(at, b, mt_op, mesh=mt, dtype=torch.float64,
                           draws=JaxDraws(4634), **opts)
    vt, tt, it = st.solve()
    return sj, (np.asarray(vj), np.asarray(tj), ij), st, (vt.numpy(),
                                                          tt.numpy(), it)


class TestMeshSolve:
    def test_dia_laplacian_matches_jax(self, rng, meshes, jax_sign_fixed):
        """Laplacian n = 256 in DIA (slab 32 > span 16: halo), B (n, 1),
        tol 1e-6: tests/test_sharded.py's mesh solve."""
        n = 256
        b = rng.uniform(0, 1, (n, 1))
        sj, (vj, tj, ij), st, (vt, tt, it) = _jax_vs_port_solve(
            laplacian2_sparse(16), "dia", b, None, meshes,
            {"is_symmetric": True}, tol=1e-6)
        assert type(sj.A).__name__ == "HaloDiaOperator"
        assert isinstance(st.A, HaloDiaOperator)
        assert it.iter == ij.iter and it.status == ij.status == 0
        xj, xt = vj @ tj @ vj.T, vt @ tt @ vt.T
        assert np.linalg.norm(xt - xj) <= 1e-9 * np.linalg.norm(xj)

    def test_ell_banded_matches_jax(self, rng, meshes, jax_sign_fixed):
        """Banded ELL, m = 1024 (128-row slabs: halo in both), B (m, 1),
        tol 1e-6.  (With B (m, 2) and expand 2 the JAX package's own mesh
        and unsharded solves differ by 2e-9 in X: the problem, not the
        port, sets that floor.)"""
        m = 1024
        a = banded_unstructured(rng, m)
        b = rng.uniform(0, 1, (m, 1))
        sj, (vj, tj, ij), st, (vt, tt, it) = _jax_vs_port_solve(
            a, "ell", b, None, meshes, {}, tol=1e-6, maxit=60)
        assert type(sj.A).__name__ == "HaloEllOperator"
        assert isinstance(st.A, HaloEllOperator)
        assert it.iter == ij.iter and it.status == ij.status == 0
        xj, xt = vj @ tj @ vj.T, vt @ tt @ vt.T
        assert np.linalg.norm(xt - xj) <= 1e-9 * np.linalg.norm(xj)

    def test_mesh_equals_unsharded(self, rng, meshes):
        """On one device the mesh solve is the unsharded solve, bit for
        bit, for a nonsymmetric DIA operator with M and B an operator."""
        _, mt = meshes
        a = nonsym_stencil(12)
        n = a.shape[0]
        md = rng.uniform(0.5, 1.5, n)
        bop = rt.DenseOperator(rng.uniform(0, 1, (n, 2)), device="cpu")
        runs = []
        for mesh in (mt, None):
            at = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                                      device="cpu", is_hurwitz=True)
            mop = rt.sparse_from_scipy(sp.diags(md).tocsr(), fmt="dia",
                                       dtype=torch.float64, device="cpu")
            s = rt.LyapunovSolver(at, bop, mop, mesh=mesh, device="cpu",
                                  dtype=torch.float64, tol=1e-6, expand=2,
                                  maxit=200)
            runs.append((s, s.solve()))
        (s1, (v1, t1, i1)), (_, (v2, t2, i2)) = runs
        assert isinstance(s1.A, HaloDiaOperator)
        assert isinstance(s1.M, HaloDiaOperator)
        assert i1.converged and i1.iter == i2.iter
        assert torch.equal(v1, v2) and torch.equal(t1, t2)

    def test_device_must_be_the_mesh_device(self, meshes):
        _, mt = meshes
        with pytest.raises(ValueError, match="mesh"):
            rt.LyapunovSolver(np.eye(8), np.ones((8, 1)), mesh=mt,
                              device="meta")


def test_eigs_mesh_matches_jax(rng, meshes):
    """eigs(mesh=) on the row-sharded DIA Laplacian: the leading
    eigenvalues of both packages agree to 1e-8 of the largest."""
    from rails_tpu.eigs import eigs as jax_eigs

    mj, mt = meshes
    a = laplacian2_sparse(16)
    hj = jax_sharded.shard_operator(jax_sparse(a, fmt="dia",
                                               dtype=jnp.float64), mj)
    ht = shard_operator(rt.sparse_from_scipy(a, fmt="dia",
                                             dtype=torch.float64,
                                             device="cpu"), mt)
    ej, _ = jax_eigs(hj, num=4, tol=1e-10, mesh=mj, dtype=jnp.float64)
    et, vt = rt.eigs(ht, num=4, tol=1e-10, mesh=mt)
    ej = np.asarray(ej)
    assert np.abs(et.numpy() - ej).max() <= 1e-8 * abs(ej[0])
    assert vt.device.type == "cpu"
    with pytest.raises(NotImplementedError, match="one process per card"):
        rt.eigs(ht, num=2, mesh=make_mesh(devices=["cpu", "meta"]))


def test_continuation_mesh_equals_unsharded(meshes):
    """ContinuationSolver(mesh=) gives the unsharded run's steps."""
    _, mt = meshes
    side = 16
    n = side * side
    rng = np.random.default_rng(0)
    md, b = rng.uniform(0.5, 1.5, n), rng.uniform(0, 1, (n, 4))
    runs = []
    for mesh in (mt, None):
        cont = rt.ContinuationSolver(
            b, rt.DiagonalOperator(md, device="cpu"), mesh=mesh,
            device="cpu", dtype=torch.float64, tol=1e-6, expand=4,
            restart_size=60, reduced_size=30, maxit=200)
        steps = []
        for theta in (0.0, 0.05):
            a = laplacian2_sparse(side) - theta * sp.eye(n)
            steps.append(cont.step(rt.sparse_from_scipy(
                a.tocsr(), fmt="dia", dtype=torch.float64, device="cpu")))
        runs.append(steps)
    for (v1, t1, i1), (v2, t2, i2) in zip(*runs):
        assert i1.converged and i1.iter == i2.iter
        assert torch.equal(v1, v2) and torch.equal(t1, t2)
    assert runs[0][1][2].iter < runs[0][0][2].iter


def test_halo_apply_has_no_fallback():
    """A CUDA apply of a HaloDiaOperator launches kernel #3 or raises: the
    apply and the kernel's wrapper hold no try statement that could switch
    to kernel #1 or the plain version."""
    import ast
    import inspect

    from rails_tpu_torch.parallel import halo_spmm

    for fn in (halo_spmm._halo_apply, spmm.dia_spmm_halo,
               spmm._halo_kernel_fn):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (kernel #3 has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                           (torch.float64, 1e-12)])
    @pytest.mark.parametrize("m,offsets,lo,hi,s", [
        (16384, (-256, -1, 0, 1, 256), 256, 256, 8),
        (1000, (-40, -1, 0, 2, 33), 40, 33, 3),
        (777, (0, 1, 5), 0, 5, 1),
        (4096, (-7, 0), 7, 0, 16),
        (512, (-9, 0, 3), 4, 0, 2),   # terms beyond the halos drop
    ])
    def test_matches_plain_version(self, rng, cuda_device, dtype, tol, m,
                                   offsets, lo, hi, s):
        t = torch.from_numpy

        def arr(*shape):
            return t(rng.uniform(-1, 1, shape)).to(cuda_device, dtype)

        data, x = arr(len(offsets), m), arr(m, s)
        hl = arr(lo, s) if lo else None
        hh = arr(hi, s) if hi else None
        offs = torch.tensor(offsets, dtype=torch.int32, device=cuda_device)
        before = spmm.dia_spmm_halo.launches
        y = spmm.dia_spmm_halo(data, offs, x, hl, hh)
        torch.cuda.synchronize()
        assert spmm.dia_spmm_halo.launches == before + 1
        ref = spmm.dia_spmm_halo_reference(data, offs, x, hl, hh)
        assert (y - ref).abs().max().item() <= tol * ref.abs().max().item()

    def test_mesh_apply_equals_unsharded_kernel(self, rng, cuda_device):
        """Four shards on one card: a HaloDiaOperator apply at f64 equals
        kernel #1's unsharded apply exactly, with 4 launches of kernel
        #3 and none of kernel #1."""
        a = nonsym_stencil(64)
        op = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                                  device=cuda_device)
        mesh = make_mesh(devices=[cuda_device] * 4)
        h = shard_operator(op, mesh)
        x = torch.from_numpy(rng.uniform(-1, 1, (a.shape[0], 8))).to(
            cuda_device)
        k1, k3 = spmm.dia_spmm.launches, spmm.dia_spmm_halo.launches
        y = h.matmat(x)
        torch.cuda.synchronize()
        assert spmm.dia_spmm_halo.launches == k3 + 4
        assert spmm.dia_spmm.launches == k1
        assert torch.equal(y, op.matmat(x))
        assert torch.equal(h.rmatmat(x), op.rmatmat(x))

    def test_rejects_bad_arguments(self, cuda_device):
        data = torch.ones(1, 64, device=cuda_device)
        offs = torch.zeros(1, dtype=torch.int32, device=cuda_device)
        x = torch.ones(64, 4, device=cuda_device)
        with pytest.raises(ValueError, match="contiguous"):
            spmm.dia_spmm_halo(data, offs, torch.ones(
                64, 8, device=cuda_device)[:, ::2], None, None)
        with pytest.raises(TypeError):
            spmm.dia_spmm_halo(data, offs, x.double(), None, None)
        with pytest.raises(ValueError, match="span"):
            spmm.dia_spmm_halo(data, offs, x, torch.ones(
                3, 5, device=cuda_device), None)
        with pytest.raises(ValueError):
            spmm.dia_spmm_halo(data, offs, x.cpu().cuda(), torch.ones(
                3, 4), None)


def test_pack_offsets():
    """The halo kernel's by-value offsets: count, extremes with 0 and the
    offsets in order; None past the cap (the device-array path)."""
    pk = spmm.pack_offsets((-256, -1, 0, 1, 256))
    assert (pk.d, pk.omin, pk.omax) == (5, -256, 256)
    assert list(pk.off)[:5] == [-256, -1, 0, 1, 256]
    pk = spmm.pack_offsets((2, 7))
    assert (pk.d, pk.omin, pk.omax) == (2, 0, 7)
    assert spmm.pack_offsets(range(spmm.OFFSETS_CAP)).d == spmm.OFFSETS_CAP
    assert spmm.pack_offsets(range(spmm.OFFSETS_CAP + 1)) is None


def test_halo_apply_passes_host_offsets(rng, monkeypatch):
    """The mesh apply hands the kernel's wrapper the payload's host tuple,
    so the kernel gets its offsets by value (no device read per launch)."""
    from rails_tpu_torch.parallel import halo_spmm

    seen = []
    real = halo_spmm.dia_spmm_halo

    def spy(*args, **kwargs):
        seen.append(kwargs.get("offsets"))
        return real(*args, **kwargs)

    monkeypatch.setattr(halo_spmm, "dia_spmm_halo", spy)
    a = nonsym_stencil(16)
    op = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                              device="cpu")
    h = shard_operator(op, make_mesh(devices=["cpu"] * 4))
    h.matmat(torch.ones(256, 2, dtype=torch.float64))
    assert seen == [op.fwd.offsets] * 4


@pytest.mark.cuda
class TestHaloRedesignOnCard:
    """Kernel #3's by-value and device-array offsets, vector widths and
    halo shapes against its plain version (f32 1e-5, f64 1e-12 of
    max|y|), and against each other bit for bit."""

    @staticmethod
    def _args(rng, dev, dtype, m, offsets, lo, hi, s):
        def arr(*shape):
            return torch.from_numpy(rng.uniform(-1, 1, shape)).to(dev, dtype)

        return (arr(len(offsets), m),
                torch.tensor(offsets, dtype=torch.int32, device=dev),
                arr(m, s), arr(lo, s) if lo else None,
                arr(hi, s) if hi else None)

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                           (torch.float64, 1e-12)])
    @pytest.mark.parametrize("m,offsets,lo,hi,s", [
        (16384, (-256, -1, 0, 1, 256), 256, 256, 8),
        (4099, tuple(range(-10, 10)), 10, 9, 6),     # 20 > the cap
        (1000, tuple(range(-8, 8)), 8, 7, 16),       # exactly the cap
        (777, (0, 1, 5), 0, 5, 1),                   # one-sided
        (512, (-9, 0, 3), 4, 0, 3),                  # terms beyond halos
        (300, (0,), 0, 0, 256),                      # no halos at all
    ])
    def test_offset_paths_agree(self, rng, cuda_device, dtype, tol, m,
                                offsets, lo, hi, s):
        args = self._args(rng, cuda_device, dtype, m, offsets, lo, hi, s)
        before = spmm.dia_spmm_halo.launches
        y_val = spmm.dia_spmm_halo(*args, offsets=offsets)
        y_dev = spmm.dia_spmm_halo(*args)
        torch.cuda.synchronize()
        assert spmm.dia_spmm_halo.launches == before + 2
        ref = spmm.dia_spmm_halo_reference(*args)
        assert (y_val - ref).abs().max().item() <= \
            tol * ref.abs().max().item()
        assert torch.equal(y_val, y_dev)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("s", [3, 8, 16])
    def test_misaligned_out_and_x(self, rng, cuda_device, dtype, s):
        """``out`` and ``x_loc`` one element into a buffer, off 16-byte
        alignment (as a shard's rows of a global array at odd s): equal
        to the aligned launch, bit for bit."""
        m, offsets = 1000, (-40, -1, 0, 2, 33)
        data, offs, x, hl, hh = self._args(rng, cuda_device, dtype, m,
                                           offsets, 40, 33, s)
        ref = spmm.dia_spmm_halo(data, offs, x, hl, hh, offsets=offsets)
        big = torch.zeros(m * s + 2, dtype=dtype, device=cuda_device)
        xb = torch.zeros(m * s + 1, dtype=dtype, device=cuda_device)
        xs = xb[1:].view(m, s)
        xs.copy_(x)
        out = big[1:m * s + 1].view(m, s)
        assert out.data_ptr() % 16 and xs.data_ptr() % 16
        y = spmm.dia_spmm_halo(data, offs, xs, hl, hh, out=out,
                               offsets=offsets)
        torch.cuda.synchronize()
        assert y.data_ptr() == out.data_ptr()
        assert torch.equal(out, ref)
        assert big[0].item() == 0 and big[-1].item() == 0

    def test_solve_shard_mesh_equals_kernel_one(self, rng, cuda_device):
        """The mesh solve's geometry (n = 65,536, offsets 0, +-1, +-256,
        s = 8, f64) on 4 shards: bit-equal to kernel #1's apply."""
        n = 65536
        a = sp.diags([rng.uniform(-1, 1, n - k) for k in (256, 1)]
                     + [rng.uniform(-1, 1, n)]
                     + [rng.uniform(-1, 1, n - k) for k in (1, 256)],
                     [-256, -1, 0, 1, 256]).tocsr()
        op = rt.sparse_from_scipy(a, fmt="dia", dtype=torch.float64,
                                  device=cuda_device)
        h = shard_operator(op, make_mesh(devices=[cuda_device] * 4))
        assert isinstance(h, HaloDiaOperator)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, 8))).to(cuda_device)
        assert torch.equal(h.matmat(x), op.matmat(x))
        assert torch.equal(h.rmatmat(x), op.rmatmat(x))
