"""The port's ELL and HYB formats and its ELL SpMM module against the JAX
package.

- Format choice and payloads: on the same scipy matrix ``'auto'`` picks
  the same format, and the port builds the same ``indices``, ``values``,
  ``offsets`` and ``data``, bit for bit.
- Products: the plain version ``ell_spmm_reference`` (and the HYB apply)
  must match the JAX package's plain ``EllMatrix.matmat`` to 1e-13
  relative at float64 (the same products summed in the same slot order;
  the bound leaves room for the last bits of the two libraries' fused
  multiply-adds), and the JAX package's Pallas kernel ``ell_spmm_t`` run
  in TPU interpret mode (the JAX tests' own route,
  tests/test_sparse.py TestEllSpmmKernel) to 1e-5 relative at float32.
- The CUDA kernel itself runs only on the card: those tests carry the
  ``cuda`` marker and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from rails_tpu.sparse.ell_spmm import ell_spmm_t
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
from rails_tpu_torch import interop
from rails_tpu_torch.models.problems import laplacian2_sparse
from rails_tpu_torch.sparse.ell_spmm import ell_spmm, ell_spmm_reference
from rails_tpu_torch.sparse.formats import (
    DiaMatrix, EllMatrix, HybMatrix, payload_to_scipy, sparse_from_scipy)
from rails_tpu_torch.sparse.spmm import dia_spmm

# one intra-op thread: the suite runs in several worker processes at once,
# and small ops with many threads each oversubscribe the cores
torch.set_num_threads(1)


def banded_random(rng, m, ell_l, band, n=None, empty_rows=0):
    """Random column picks within +-band of the scaled diagonal, L slots
    per row (tests/test_sparse.py's banded-random geometry); the first
    ``empty_rows`` rows of a random choice are emptied."""
    n = m if n is None else n
    base = np.arange(m)
    idx = base[:, None] * (n / m) + rng.integers(-band, band + 1,
                                                 size=(m, ell_l))
    idx = np.clip(idx, 0, n - 1).astype(np.int64)
    val = rng.uniform(-1, 1, size=(m, ell_l))
    if empty_rows:
        val[rng.permutation(m)[:empty_rows]] = 0.0
    rows = np.repeat(base, ell_l)
    a = sp.coo_matrix((val.ravel(), (rows, idx.ravel())),
                      shape=(m, n)).tocsr()
    a.eliminate_zeros()
    return a


def lap_with_couplings(rng, side, count):
    """The 2D Laplacian plus ``count`` random symmetric long-range
    couplings: banded except for a few stray entries."""
    lap = laplacian2_sparse(side).tolil()
    n = side * side
    for _ in range(count):
        i, j = rng.integers(0, n, 2)
        if abs(int(i) - int(j)) > 2 * side:
            lap[i, j] = lap[j, i] = 0.3
    return lap.tocsr()


def bench_band(rng, m, ell_l=8, band=64):
    """bench.py:271's ELL geometry: L random picks within +-band."""
    base = np.arange(m)
    idx = np.clip(base[:, None] + rng.integers(-band, band + 1, (m, ell_l)),
                  0, m - 1)
    val = rng.uniform(-1, 1, (m, ell_l)) * 0.2
    return sp.coo_matrix((val.ravel(), (np.repeat(base, ell_l),
                                        idx.ravel())), shape=(m, m)).tocsr()


def _rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


def _same_payload(pt, pj):
    """Port payload == JAX payload, bit for bit."""
    if isinstance(pt, DiaMatrix):
        assert pt.offsets == pj.offsets and pt.shape == pj.shape
        assert np.array_equal(pt.data.numpy(), np.asarray(pj.data))
    elif isinstance(pt, EllMatrix):
        assert pt.shape == pj.shape
        assert np.array_equal(pt.indices.numpy(), np.asarray(pj.indices))
        assert np.array_equal(pt.values.numpy(), np.asarray(pj.values))
    else:
        assert isinstance(pt, HybMatrix) and pt.shape == pj.shape
        _same_payload(pt.dia, pj.dia)
        _same_payload(pt.ell, pj.ell)


class TestFormatChoice:
    @pytest.mark.parametrize("kind,expected", [
        ("laplacian", "dia"), ("couplings", "hyb"), ("bench_band", "ell"),
        ("rect_empty", "ell")])
    @pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
    def test_auto_matches_jax(self, rng, kind, expected, dtype):
        a = {"laplacian": lambda: laplacian2_sparse(12),
             "couplings": lambda: lap_with_couplings(rng, 16, 40),
             "bench_band": lambda: bench_band(rng, 2048),
             "rect_empty": lambda: banded_random(rng, 300, 5, 20, n=200,
                                                 empty_rows=40)}[kind]()
        jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
        aj = jax_sparse(a, dtype=jdt)
        at = sparse_from_scipy(a, dtype=dtype, device="cpu")
        assert at.format == aj.format == expected
        assert at.is_symmetric == aj.is_symmetric and at.nnz == aj.nnz
        _same_payload(at.fwd, aj.fwd)
        assert (at.bwd is None) == (aj.bwd is None)
        if at.bwd is not None:
            _same_payload(at.bwd, aj.bwd)

    @pytest.mark.parametrize("fmt", ["ell", "hyb"])
    def test_forced_format_matches_jax(self, rng, fmt):
        a = lap_with_couplings(rng, 12, 40) + sp.diags(
            rng.uniform(-0.1, 0.1, 143), 1, (144, 144))
        aj = jax_sparse(a.tocsr(), fmt=fmt, dtype=jnp.float64)
        at = sparse_from_scipy(a, fmt=fmt, dtype=torch.float64,
                               device="cpu")
        assert at.format == aj.format and not at.is_symmetric
        _same_payload(at.fwd, aj.fwd)
        _same_payload(at.bwd, aj.bwd)

    def test_payload_roundtrip(self, rng):
        a = banded_random(rng, 300, 5, 20, n=200, empty_rows=40)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                               device="cpu")
        assert abs(payload_to_scipy(op.fwd) - a).max() == 0
        assert abs(payload_to_scipy(op.bwd) - a.T).max() == 0
        h = lap_with_couplings(rng, 16, 40)
        oh = sparse_from_scipy(h, dtype=torch.float64, device="cpu")
        assert oh.format == "hyb"
        assert abs(payload_to_scipy(oh.fwd) - h).max() == 0

    def test_padding_index_is_clamped(self):
        # a wide-short block whose empty rows outnumber its columns: the
        # padding index (the row id) is clamped below n
        a = sp.csr_matrix(([1.0], ([0], [1])), shape=(6, 2))
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                               device="cpu")
        assert op.fwd.indices[:, 0].tolist() == [1, 1, 1, 1, 1, 1]
        aj = jax_sparse(a, fmt="ell", dtype=jnp.float64)
        _same_payload(op.fwd, aj.fwd)

    def test_indices_checked(self):
        with pytest.raises(ValueError, match="outside"):
            EllMatrix(torch.tensor([[0, 3]], dtype=torch.int32),
                      torch.ones(1, 2), (1, 3))
        with pytest.raises(TypeError, match="int32"):
            EllMatrix(torch.zeros(1, 2, dtype=torch.int64),
                      torch.ones(1, 2), (1, 3))

    def test_interop_payloads(self, rng):
        a = lap_with_couplings(rng, 16, 40)
        aj = jax_sparse(a, dtype=jnp.float64)
        ell = aj.fwd.ell
        p = {"dia": {"data": np.asarray(aj.fwd.dia.data),
                     "offsets": aj.fwd.dia.offsets,
                     "shape": aj.fwd.dia.shape},
             "ell": {"indices": np.asarray(ell.indices),
                     "values": np.asarray(ell.values), "shape": ell.shape},
             "shape": aj.fwd.shape}
        op = interop.sparse_operator(p, is_symmetric=True, device="cpu")
        assert op.format == "hyb"
        _same_payload(op.fwd, aj.fwd)

    def test_wide_s_and_matmat2_raise(self, rng):
        """``wide_s`` and ``matmat2`` are ported; what is still refused:
        a matrix that resolves to DIA or HYB warns and gets no dense-window
        payload (the JAX package's rule), and a float64 or narrow apply
        never dispatches wide."""
        from rails_tpu_torch.sparse.ell_spmm import wide_eligible

        a = bench_band(rng, 512)
        op = sparse_from_scipy(a, fmt="ell", wide_s=True, device="cpu")
        assert op.fwd.wide is not None and op.bwd.wide is not None
        for fmt, mat in (("dia", laplacian2_sparse(24)),
                         ("hyb", lap_with_couplings(rng, 24, 60))):
            with pytest.warns(UserWarning, match="only applies to the ELL"):
                oh = sparse_from_scipy(mat, wide_s=True, device="cpu")
            assert oh.format == fmt
            ells = [] if fmt == "dia" else [oh.fwd.ell]
            assert all(e.wide is None for e in ells)
        x = torch.ones(512, 256)
        assert wide_eligible(op.fwd, x)
        assert not wide_eligible(op.fwd, x.double())
        assert not wide_eligible(op.fwd, x[:, :191])
        o64 = sparse_from_scipy(a, dtype=torch.float64, device="cpu")
        hi, lo = o64.matmat2(torch.ones(512, 2, dtype=torch.float64))
        assert np.abs((hi + lo).numpy() - a @ np.ones((512, 2))).max() \
            <= 1e-13


class TestProductsF64:
    """f64, against the JAX package's plain EllMatrix.matmat / HYB apply;
    1e-13 relative."""

    @pytest.mark.parametrize("m,n,ell_l,band,empty,s", [
        (1024, 1024, 7, 60, 0, 4),     # square
        (1100, 800, 5, 33, 100, 3),    # tall, empty rows, odd s
        (300, 900, 4, 50, 0, 1),       # wide, one column
        (257, 257, 9, 300, 30, 7),     # band wider than m, odd everything
    ])
    def test_ell_matches_matmat(self, rng, m, n, ell_l, band, empty, s):
        a = banded_random(rng, m, ell_l, band, n=n, empty_rows=empty)
        aj = jax_sparse(a, fmt="ell", dtype=jnp.float64)
        at = sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                               device="cpu")
        x = rng.uniform(-1, 1, (n, s))
        y = rng.uniform(-1, 1, (m, s))
        assert _rel_err(at.matmat(torch.from_numpy(x)).numpy(),
                        aj.fwd.matmat(jnp.asarray(x))) <= 1e-13
        assert _rel_err(at.rmatmat(torch.from_numpy(y)).numpy(),
                        aj.bwd.matmat(jnp.asarray(y))) <= 1e-13
        assert _rel_err(at.matmat(torch.from_numpy(x[:, 0])).numpy(),
                        a @ x[:, 0]) <= 1e-13

    @pytest.mark.parametrize("s", [1, 3, 8])
    def test_hyb_matches_matmat(self, rng, s):
        a = lap_with_couplings(rng, 20, 60)
        aj = jax_sparse(a, dtype=jnp.float64)
        at = sparse_from_scipy(a, dtype=torch.float64, device="cpu")
        assert at.format == "hyb"
        x = rng.uniform(-1, 1, (400, s))
        assert _rel_err(at.matmat(torch.from_numpy(x)).numpy(),
                        aj.fwd.matmat(jnp.asarray(x))) <= 1e-13

    def test_cpu_wrapper_counts_no_launch(self, rng):
        a = banded_random(rng, 64, 3, 8)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                               device="cpu")
        before = ell_spmm.launches
        ell_spmm(op.fwd, torch.ones(64, 2, dtype=torch.float64))
        assert ell_spmm.launches == before

    def test_no_columns(self):
        # an (m, 0) block (a Schur split with no singular part)
        op = sparse_from_scipy(sp.csr_matrix((5, 0)), fmt="ell",
                               dtype=torch.float64, device="cpu")
        y = op.matmat(torch.zeros(0, 3, dtype=torch.float64))
        assert tuple(y.shape) == (5, 3) and not y.any()


class TestReferenceMatchesPallas:
    """f32, against the TPU kernel in interpret mode; 1e-5 relative (sums
    in another order, at most 9 terms per element)."""

    @pytest.mark.parametrize("m,n,ell_l,band,empty,s", [
        (1024, 1024, 7, 60, 0, 4),     # several chunks, medium window
        (1100, 1100, 5, 33, 0, 3),     # m % 128 != 0, odd s
        (512, 512, 13, 150, 0, 1),     # wide window, one column
        (896, 640, 6, 40, 120, 5),     # rectangular, empty rows
    ])
    def test_matches_interpreter(self, rng, m, n, ell_l, band, empty, s):
        a = banded_random(rng, m, ell_l, band, n=n, empty_rows=empty)
        aj = jax_sparse(a, fmt="ell", dtype=jnp.float32)
        assert aj.fwd.well is not None
        at = sparse_from_scipy(a, fmt="ell", dtype=torch.float32,
                               device="cpu")
        x = rng.uniform(-1, 1, (n, s)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            yj = ell_spmm_t(aj.fwd.well, jnp.asarray(x).T).T
        yt = ell_spmm_reference(at.fwd, torch.from_numpy(x))
        assert yt.dtype == torch.float32 and tuple(yt.shape) == (m, s)
        assert _rel_err(yt.numpy(), yj) <= 1e-5


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    """The CUDA kernel against its plain version on the card."""

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                           (torch.float64, 1e-12)])
    @pytest.mark.parametrize("m,n,ell_l,band,empty,s", [
        (4096, 4096, 8, 64, 0, 16),
        (1100, 800, 5, 33, 100, 3),
        (300, 900, 4, 50, 0, 1),
    ])
    def test_matches_reference(self, rng, cuda_device, dtype, tol, m, n,
                               ell_l, band, empty, s):
        a = banded_random(rng, m, ell_l, band, n=n, empty_rows=empty)
        op = sparse_from_scipy(a, fmt="ell", dtype=dtype,
                               device=cuda_device)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, s))).to(cuda_device,
                                                           dtype)
        before = ell_spmm.launches
        y = ell_spmm(op.fwd, x)
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 1
        ref = ell_spmm_reference(op.fwd, x)
        assert (y - ref).abs().max().item() <= \
            tol * ref.abs().max().item()

    def test_hyb_launches_both_kernels(self, rng, cuda_device):
        a = lap_with_couplings(rng, 32, 120)
        op = sparse_from_scipy(a, dtype=torch.float64, device=cuda_device)
        assert op.format == "hyb"
        x = torch.ones(1024, 4, dtype=torch.float64, device=cuda_device)
        d0, e0 = dia_spmm.launches, ell_spmm.launches
        y = op.matmat(x)
        assert (dia_spmm.launches, ell_spmm.launches) == (d0 + 1, e0 + 1)
        ref = op.fwd.matmat(x)
        assert (y - ref).abs().max().item() <= 1e-12 * ref.abs().max().item()

    def test_rejects_noncontiguous(self, rng, cuda_device):
        op = sparse_from_scipy(banded_random(rng, 64, 3, 8), fmt="ell",
                               dtype=torch.float32, device=cuda_device)
        x = torch.ones(64, 4, device=cuda_device)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            ell_spmm(op.fwd, x)


class TestPlan:
    """The ELL kernel's host-side plan (``ell_plan``, the row-tile windows
    of ``EllMatrix``, ``sparse/tiling.py``): pure integer arithmetic that
    decides the launch, checked here without a card."""

    def test_tile_windows_match_numpy(self, rng):
        from rails_tpu_torch.sparse.tiling import tile_windows

        for m, ell_l in ((1000, 8), (128, 3), (129, 1), (5, 4)):
            idx = rng.integers(0, 5000, (m, ell_l)).astype(np.int32)
            win = tile_windows(torch.from_numpy(idx), 128).numpy()
            want = [(idx[r:r + 128].min(), idx[r:r + 128].max())
                    for r in range(0, m, 128)]
            assert win.dtype == np.int32
            assert win.tolist() == [list(map(int, w)) for w in want]

    def test_payload_carries_windows(self, rng):
        a = banded_random(rng, 1100, 5, 33, n=800, empty_rows=100)
        e = sparse_from_scipy(a, fmt="ell", dtype=torch.float64,
                              device="cpu").fwd
        idx = e.indices.numpy()
        assert e.tiles.shape == (9, 2) and e.TILE_ROWS == 128
        for t, (lo, hi) in enumerate(e.tiles.tolist()):
            blk = idx[128 * t:128 * (t + 1)]
            assert (lo, hi) == (blk.min(), blk.max())
            assert e.window_rows[t] == hi - lo + 1
        empty = EllMatrix(torch.zeros(3, 0, dtype=torch.int32),
                          torch.zeros(3, 0), (3, 4))
        assert empty.tiles.tolist() == [[0, -1]]
        assert empty.window_rows.tolist() == [0]

    def test_vector_width_and_lanes(self):
        from rails_tpu_torch.sparse.tiling import column_lanes, vector_width

        assert vector_width(16, 4, 0, 256) == 4
        assert vector_width(16, 4, 8) == 2         # 8-byte aligned only
        assert vector_width(6, 4, 0) == 2          # 24-byte rows
        assert vector_width(3, 4, 0) == 1
        assert vector_width(8, 8, 0, 16) == 2
        assert vector_width(8, 8, 8) == 1
        assert vector_width(7, 8, 0) == 1
        assert column_lanes(200, 4) == (50, 1)
        assert column_lanes(256, 4) == (64, 1)
        assert column_lanes(300, 1) == (60, 5)     # balanced tiles
        assert column_lanes(256, 4, 64) == (16, 4)
        assert column_lanes(200, 4, 42) == (10, 5)
        assert column_lanes(1, 1) == (1, 1)

    @pytest.mark.parametrize("s,itemsize,vec", [
        (1, 8, 1), (3, 4, 1), (8, 8, 2), (16, 4, 4), (67, 4, 1),
        (200, 4, 4), (256, 4, 4), (192, 8, 2)])
    def test_banded_plan_stages_every_tile(self, rng, s, itemsize, vec):
        from rails_tpu_torch.sparse.ell_spmm import (
            SLOT_BUDGET, WINDOW_BUDGET, ell_plan)

        e = sparse_from_scipy(bench_band(rng, 4096), fmt="ell",
                              device="cpu").fwd
        p = ell_plan(e.window_rows, 8, s, itemsize, vec)
        assert p.staged == p.tiles == 32 and p.staged_share == 1.0
        assert p.col_tile == p.lanes * vec and p.col_tile % vec == 0
        assert p.col_tiles * p.col_tile >= s > (p.col_tiles - 1) * \
            p.col_tile
        assert 1 <= p.lanes <= 64
        assert e.window_rows.max() * p.col_tile * itemsize <= \
            p.window_bytes <= WINDOW_BUDGET
        # the slots of a 128-row tile: 8 indices and 8 values a row
        assert p.slot_bytes == 128 * 8 * (4 + itemsize) <= SLOT_BUDGET

    def test_scattered_plan_stages_nothing(self, rng):
        from rails_tpu_torch.sparse.ell_spmm import ell_plan

        m = 4096
        idx = rng.integers(0, m, (m, 4))
        a = sp.coo_matrix((np.ones(4 * m), (np.repeat(np.arange(m), 4),
                                            idx.ravel())), (m, m)).tocsr()
        e = sparse_from_scipy(a, fmt="ell", device="cpu").fwd
        p = ell_plan(e.window_rows, 4, 16, 4, 4)
        assert (p.staged, p.window_bytes, p.staged_share) == (0, 0, 0.0)
        assert (p.lanes, p.col_tiles) == (4, 1)

    def test_mixed_plan_counts_fitting_tiles(self):
        """A tile is staged exactly when its window fits the launch's
        shared bytes, the kernel's own test."""
        from rails_tpu_torch.sparse.ell_spmm import ell_plan

        w = np.array([200, 250, 256, 100000, 300, 5000])
        p = ell_plan(w, 5, 16, 4, 4)
        fits = w * p.col_tile * 4 <= p.window_bytes
        assert p.staged == int(fits.sum()) == 4
        assert p.window_bytes == 300 * p.col_tile * 4
        assert ell_plan(np.zeros(0, np.int64), 5, 8, 8, 2).tiles == 0

    def test_slot_bytes(self):
        """The kernel's layout: 16-byte aligned index and value regions
        for a tile's rows; none past SLOT_BUDGET or with no slots."""
        from rails_tpu_torch.sparse.ell_spmm import ell_plan

        w = np.full(4, 300)
        assert ell_plan(w, 5, 8, 8, 2).slot_bytes == 128 * 5 * 4 + 128 * 5 * 8
        assert ell_plan(w, 3, 8, 4, 4).slot_bytes == 128 * 3 * 8
        assert ell_plan(w, 16, 8, 8, 2).slot_bytes == 128 * 16 * 12
        assert ell_plan(w, 17, 8, 8, 2).slot_bytes == 0
        assert ell_plan(w, 24, 8, 4, 2).slot_bytes == 128 * 24 * 8
        assert ell_plan(w, 0, 8, 8, 2).slot_bytes == 0

    def test_plan_cached_per_shape(self, rng):
        from rails_tpu_torch.sparse.ell_spmm import _plan_for

        e = sparse_from_scipy(bench_band(rng, 512), fmt="ell",
                              device="cpu").fwd
        x = torch.zeros(512, 16)
        p = _plan_for(e, x, torch.zeros(512, 16))
        assert _plan_for(e, x, torch.zeros(512, 16)) is p
        assert _plan_for(e, torch.zeros(512, 3), torch.zeros(512, 3)) \
            is not p


def _scattered(rng, m, n, ell_l):
    """Every slot a random column of all n: no tile's window fits."""
    idx = rng.integers(0, n, (m, ell_l))
    return sp.coo_matrix((rng.uniform(-1, 1, m * ell_l),
                          (np.repeat(np.arange(m), ell_l), idx.ravel())),
                         (m, n)).tocsr()


@pytest.mark.cuda
class TestRedesignOnCard:
    """The 2-D tiled kernel's branches and plans against the plain
    version on the card (f32 1e-5, f64 1e-12 of max|y|)."""

    @staticmethod
    def _check(op, x, dtype):
        before = ell_spmm.launches
        y = ell_spmm(op.fwd, x)
        torch.cuda.synchronize()
        assert ell_spmm.launches == before + 1
        ref = ell_spmm_reference(op.fwd, x)
        tol = 1e-5 if dtype == torch.float32 else 1e-12
        assert tuple(y.shape) == tuple(ref.shape)
        assert (y - ref).abs().max().item() <= \
            tol * max(ref.abs().max().item(), 1e-300)
        return y

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("s", [1, 3, 8, 67, 200, 256])
    @pytest.mark.parametrize("kind", ["window fits", "scattered"])
    def test_branches_and_widths(self, rng, cuda_device, dtype, s, kind):
        from rails_tpu_torch.sparse.ell_spmm import _plan_for

        # scattered over 40,000 columns: even at s = 1 a tile's window
        # (about all of x) is past the 64 KB of shared memory
        m, n = 3000, (3000 if kind == "window fits" else 40000)
        a = bench_band(rng, m) if kind == "window fits" \
            else _scattered(rng, m, n, 5)
        op = sparse_from_scipy(a, fmt="ell", dtype=dtype,
                               device=cuda_device)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, s))).to(cuda_device,
                                                           dtype)
        self._check(op, x, dtype)
        share = _plan_for(op.fwd, x, torch.empty(
            m, s, dtype=dtype, device=cuda_device)).staged_share
        assert share == (1.0 if kind == "window fits" else 0.0)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_branches_give_the_same_bits(self, rng, cuda_device, dtype):
        """Staged and global gathers sum in the same order: forcing every
        tile onto the global branch, slots and x alike, changes no
        bit."""
        import dataclasses

        from rails_tpu_torch.sparse.ell_spmm import _plan_for

        a = bench_band(rng, 4096)
        op = sparse_from_scipy(a, fmt="ell", dtype=dtype,
                               device=cuda_device)
        x = torch.from_numpy(rng.uniform(-1, 1, (4096, 16))).to(
            cuda_device, dtype)
        y = self._check(op, x, dtype)
        plan = _plan_for(op.fwd, x, y)
        assert plan.window_bytes > 0 and plan.slot_bytes > 0
        key = next(k for k, v in op.fwd._plans.items() if v is plan)
        op.fwd._plans[key] = dataclasses.replace(
            plan, window_bytes=0, slot_bytes=0, staged=0)
        try:
            assert torch.equal(ell_spmm(op.fwd, x), y)
        finally:
            op.fwd._plans[key] = plan

    def test_mixed_tiles(self, rng, cuda_device):
        """A band with a few scattered rows: some tiles staged, some not."""
        from rails_tpu_torch.sparse.ell_spmm import _plan_for

        a = bench_band(rng, 4096).tolil()
        for i in rng.integers(0, 4096, 6):
            a[i, int(rng.integers(0, 4096))] = 0.5
        op = sparse_from_scipy(a.tocsr(), fmt="ell", dtype=torch.float64,
                               device=cuda_device)
        x = torch.from_numpy(rng.uniform(-1, 1, (4096, 8))).to(cuda_device)
        self._check(op, x, torch.float64)
        assert 0.0 < _plan_for(op.fwd, x, torch.empty_like(
            x)).staged_share < 1.0

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    @pytest.mark.parametrize("s,skip", [(8, 1), (3, 1), (16, 3)])
    def test_misaligned_row_slice(self, rng, cuda_device, dtype, s, skip):
        """x a row slice whose start is not 16-byte aligned (as a halo
        shard's x[r0:r1] at odd s): the plan narrows the vectors."""
        m = 2048
        op = sparse_from_scipy(bench_band(rng, m), fmt="ell", dtype=dtype,
                               device=cuda_device)
        buf = torch.from_numpy(rng.uniform(-1, 1, (m * s + skip,))).to(
            cuda_device, dtype)
        x = buf[skip:].view(m, s)
        assert x.data_ptr() % 16 != 0
        self._check(op, x, dtype)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
    def test_rectangular_empty_rows_and_no_columns(self, rng, cuda_device,
                                                   dtype):
        for m, n, s in ((1100, 800, 3), (300, 900, 8), (777, 5000, 67)):
            a = banded_random(rng, m, 5, 33, n=n, empty_rows=m // 7)
            op = sparse_from_scipy(a, fmt="ell", dtype=dtype,
                                   device=cuda_device)
            x = torch.from_numpy(rng.uniform(-1, 1, (n, s))).to(
                cuda_device, dtype)
            self._check(op, x, dtype)
        op = sparse_from_scipy(sp.csr_matrix((5, 0)), fmt="ell",
                               dtype=dtype, device=cuda_device)
        y = ell_spmm(op.fwd, torch.zeros(0, 3, dtype=dtype,
                                         device=cuda_device))
        assert tuple(y.shape) == (5, 3) and not y.any()
