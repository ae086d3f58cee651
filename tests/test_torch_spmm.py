"""The port's DIA format and SpMM kernel module against the JAX package.

The plain version ``dia_spmm_reference`` must match the JAX package's
Pallas kernel ``dia_spmm_t`` run in TPU interpret mode (the JAX tests'
own route, tests/test_sparse.py TestDiaSpmmKernel) at float32, and the
JAX package's plain ``DiaMatrix.matmat`` at float64.  The CUDA kernel
itself runs only on the card: those tests carry the ``cuda`` marker and
skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from rails_tpu.sparse.formats import DiaMatrix as JaxDia
from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
from rails_tpu.sparse.spmm import dia_spmm_t
from rails_tpu_torch import interop
from rails_tpu_torch.models.problems import laplacian2, laplacian2_sparse
from rails_tpu_torch.sparse.formats import (
    DiaMatrix, payload_to_scipy, sparse_from_dense, sparse_from_scipy)
from rails_tpu_torch.sparse import spmm
from rails_tpu_torch.sparse.spmm import (
    OFFSETS_CAP, dia_plan, dia_spmm, dia_spmm_reference, tile_segments)

# one intra-op thread: the suite runs in several worker processes at once,
# and small ops with many threads each oversubscribe the cores
torch.set_num_threads(1)


def _dia_pair(rng, m, offsets, dtype, n=None):
    n = m if n is None else n
    data = rng.uniform(-1, 1, (len(offsets), m))
    jd = JaxDia(jnp.asarray(data, dtype=dtype), tuple(offsets), (m, n))
    td = interop.dia_payload(np.asarray(jd.data), jd.offsets, jd.shape,
                             device="cpu")
    return jd, td


def _rel_err(y, ref):
    y, ref = np.asarray(y, np.float64), np.asarray(ref, np.float64)
    return np.abs(y - ref).max() / max(np.abs(ref).max(), 1e-300)


class TestReferenceMatchesPallas:
    """f32, against the TPU kernel in interpret mode; 1e-5 relative (the
    sums run in another order, at most five terms per element)."""

    @pytest.mark.parametrize("s", [1, 6, 13])
    def test_symmetric_stencil(self, rng, s):
        jd, td = _dia_pair(rng, 2048, (-33, -1, 0, 1, 33), jnp.float32)
        x = rng.uniform(-1, 1, (2048, s)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            yj = dia_spmm_t(jd, jnp.asarray(x).T, block_rows=512).T
        yt = dia_spmm_reference(td, torch.from_numpy(x))
        assert yt.dtype == torch.float32 and tuple(yt.shape) == (2048, s)
        assert _rel_err(yt.numpy(), yj) <= 1e-5

    @pytest.mark.parametrize("block_rows", [256, 512])
    def test_asymmetric_odd_size(self, rng, block_rows):
        jd, td = _dia_pair(rng, 1100, (-40, -1, 0, 2, 33), jnp.float32)
        x = rng.uniform(-1, 1, (1100, 3)).astype(np.float32)
        with pltpu.force_tpu_interpret_mode():
            yj = dia_spmm_t(jd, jnp.asarray(x).T, block_rows=block_rows).T
        yt = dia_spmm_reference(td, torch.from_numpy(x))
        assert _rel_err(yt.numpy(), yj) <= 1e-5


class TestReferenceMatchesMatmat:
    """f64, against the JAX package's plain DiaMatrix.matmat; 1e-13."""

    @pytest.mark.parametrize("shape,offsets", [
        ((2048, 2048), (-33, -1, 0, 1, 33)),
        ((1100, 1100), (-40, -1, 0, 2, 33)),
        ((300, 200), (-120, -3, 0, 5, 150)),   # tall, diagonals run out
        ((200, 300), (-150, -1, 0, 40, 260)),  # wide
    ])
    def test_f64(self, rng, shape, offsets):
        m, n = shape
        jd, td = _dia_pair(rng, m, offsets, jnp.float64, n=n)
        x = rng.uniform(-1, 1, (n, 6))
        yj = jd.matmat(jnp.asarray(x))
        yt = dia_spmm(td, torch.from_numpy(x))  # CPU tensor: the plain path
        assert _rel_err(yt.numpy(), yj) <= 1e-13

    def test_cpu_wrapper_counts_no_launch(self, rng):
        _, td = _dia_pair(rng, 64, (-8, 0, 8), jnp.float64)
        before = dia_spmm.launches
        dia_spmm(td, torch.ones(64, 2, dtype=torch.float64))
        assert dia_spmm.launches == before


class TestFormats:
    def test_sparse_from_scipy_matches_jax_payload(self):
        lap = laplacian2_sparse(16)
        aj = jax_sparse(lap, fmt="dia", dtype=jnp.float64)
        at = sparse_from_scipy(lap, dtype=torch.float64, device="cpu")
        assert at.format == "dia" and at.is_symmetric and at.bwd is None
        assert at.fwd.offsets == aj.fwd.offsets
        assert np.array_equal(at.fwd.data.numpy(), np.asarray(aj.fwd.data))
        assert at.nnz == aj.nnz

    def test_nonsymmetric_has_transpose_payload(self, rng):
        a = laplacian2(64) + np.diag(rng.uniform(-1, 1, 63), 1)
        op = sparse_from_dense(a, dtype=torch.float64, device="cpu")
        assert not op.is_symmetric and op.bwd is not None
        x = torch.from_numpy(rng.uniform(-1, 1, (64, 3)))
        assert np.allclose(op.matmat(x).numpy(), a @ x.numpy(), atol=1e-12)
        assert np.allclose(op.rmatmat(x).numpy(), a.T @ x.numpy(),
                           atol=1e-12)
        assert np.allclose(op.to_dense().numpy(), a, atol=0)

    def test_payload_roundtrip_and_transpose(self, rng):
        a = sp.random(50, 50, density=0.0, random_state=1) + sp.diags(
            [rng.uniform(-1, 1, 47), rng.uniform(-1, 1, 50),
             rng.uniform(-1, 1, 45)], [-3, 0, 5], (50, 50))
        op = sparse_from_scipy(a.tocsr(), dtype=torch.float64, device="cpu")
        assert abs(payload_to_scipy(op.fwd) - a).max() == 0
        tr = op.fwd.transpose()
        assert abs(payload_to_scipy(tr) - a.T).max() == 0

    def test_astype_and_to(self, rng):
        op = sparse_from_dense(laplacian2(64), dtype=torch.float64,
                               device="cpu")
        op32 = op.astype(torch.float32)
        assert op32.payload_dtype == torch.float32
        assert op32.astype(torch.float32) is op32
        assert op.to("cpu") is op

    @pytest.mark.parametrize("fmt", ["ell", "hyb"])
    def test_ell_and_hyb_raise(self, fmt):
        # ELL, HYB and the dense-window payload are ported: forced to ELL
        # or HYB (which falls to ELL: the Laplacian has no remainder), the
        # side-8 Laplacian resolves as in the JAX package, and with 64 <
        # 256 rows it has no window, so wide_s builds nothing in either
        op = sparse_from_scipy(laplacian2_sparse(8), fmt=fmt, wide_s=True,
                               dtype=torch.float64, device="cpu")
        aj = jax_sparse(laplacian2_sparse(8), fmt=fmt, wide_s=True)
        assert op.format == aj.format == "ell"
        assert op.fwd.wide is None and aj.fwd.wide is None
        with pytest.warns(UserWarning, match="only applies to the ELL"):
            od = sparse_from_scipy(laplacian2_sparse(8), fmt="dia",
                                   wide_s=True, device="cpu")
        assert od.format == "dia"

    def test_auto_raises_where_jax_picks_ell(self, rng):
        # the port picks ELL where the JAX package does, and wide_s no
        # longer raises: at 100 rows neither package builds a window
        from rails_tpu_torch.models.problems import random_sparse

        a = sp.csr_matrix(random_sparse(rng, 100))
        assert jax_sparse(a).format == "ell"
        assert sparse_from_scipy(a, device="cpu").format == "ell"
        op = sparse_from_scipy(a, wide_s=True, device="cpu")
        assert op.format == "ell" and op.fwd.wide is None
        assert jax_sparse(a, wide_s=True).fwd.wide is None

    def test_dia_shape_checked(self):
        with pytest.raises(ValueError, match="DIA data shape"):
            DiaMatrix(torch.zeros(2, 10), (0, 1), (11, 11))


SOLVE = (-256, -1, 0, 1, 256)


def _rows_read(offsets, i0, rows, m, n):
    """Brute force: the x rows the terms of rows [i0, i0 + rows) read."""
    return {i + o for i in range(i0, min(i0 + rows, m)) for o in offsets
            if 0 <= i + o < n}


def _rows_staged(plan, i0, n):
    """The x rows a tile's segments copy, clamped to [0, n) as the kernel
    clamps them."""
    return {j for lo, hi in plan.segments
            for j in range(max(0, i0 + lo), min(n, i0 + hi))}


def _check_layout(plan, d, itemsize):
    """Slots: d data rows, then the segments, each padded to 16 bytes with
    room for its piece; the stage is their sum."""
    pk = plan.pack
    assert plan.plane_bytes % 16 == 0
    assert plan.plane_bytes >= plan.rows * itemsize
    assert plan.stage_bytes == d * plan.plane_bytes \
        + sum(plan.segment_bytes)
    slot = d * plan.plane_bytes
    for g, ((lo, hi), nb) in enumerate(zip(plan.segments,
                                           plan.segment_bytes)):
        assert nb % 16 == 0 and nb >= (hi - lo) * plan.lanes * plan.vec \
            * itemsize
        assert (pk.seg_lo[g], pk.seg_hi[g], pk.seg_slot[g]) == (lo, hi, slot)
        slot += nb
    assert pk.nseg == len(plan.segments)


class TestPlan:
    """``dia_plan``: the kernel's tiles, x segments and shared-memory
    layout, from host integers (no card needed)."""

    def test_solve_stencil_three_segments_below_span(self):
        assert tile_segments(SOLVE, 128) == ((-256, -128), (-1, 129),
                                            (256, 384))
        assert tile_segments(SOLVE, 255) == ((-256, -1), (-1, 256),
                                            (256, 511))
        p = dia_plan(SOLVE, 65536, 65536, 8, 8, 2, sms=132,
                     branch="staged")
        assert p.staged and p.why == "" and p.stageable
        assert p.rows == 128 and len(p.segments) == 3
        assert p.tiles == 512 and p.stages == 2
        assert p.grid == min(p.tiles, 132 * spmm.MAX_BLOCKS_PER_SM)
        assert p.stage_bytes <= spmm.STAGE_BUDGET
        _check_layout(p, 5, 8)

    def test_solve_stencil_one_segment_above_span(self):
        assert tile_segments(SOLVE, 256) == ((-256, 512),)
        p = dia_plan(SOLVE, 65536, 65536, 8, 8, 2, rows=512,
                     branch="staged")
        assert p.staged and p.rows == 512
        assert p.segments == ((-256, 768),)     # R + 512 rows
        _check_layout(p, 5, 8)

    def test_bench_stencil(self):
        offs = (-1536, -1, 0, 1, 1536)
        m = 1536 * 1536
        p = dia_plan(offs, m, m, 16, 4, 4, sms=132)
        assert p.staged and p.rows == 128       # auto: 70 tiles a block
        assert p.segments == ((-1536, -1408), (-1, 129), (1536, 1664))
        assert p.stages == 2 and p.tiles == m // 128
        assert p.tiles >= spmm.MIN_TILES_PER_BLOCK * p.grid
        assert 2 * (2 * p.stage_bytes + spmm.BLOCK_RESERVE) \
            <= spmm.SM_SHARED                  # two blocks share an SM
        assert tile_segments(offs, 2048) == ((-1536, 3584),)
        _check_layout(p, 5, 4)

    def test_rectangular_segments_clamp_to_n(self):
        offs = (-7000, -3, 0, 5, 20000)
        m, n = 50000, 30000
        p = dia_plan(offs, m, n, 4, 4, 4, sms=132, branch="staged")
        assert p.staged and len(p.segments) == 3
        assert p.segments[1] == (-3, p.rows + 5)
        for i0 in (0, 6912, 9984, 29952, (p.tiles - 1) * p.rows):
            staged = _rows_staged(p, i0, n)
            assert all(0 <= j < n for j in staged)
            need = _rows_read(offs, i0, p.rows, m, n)
            assert need <= staged
            if i0 + p.rows <= m:
                assert need == staged
        # the +20000 diagonal reads rows past n only for i0 >= 10000
        assert not any(i0 + 20000 < n for i0 in range(10000, m, p.rows))

    @pytest.mark.parametrize("m,s,itemsize,vec", [
        (65536, 6, 4, 2),     # a 24-byte x row
        (1100, 3, 4, 1),      # a 12-byte x row, an odd m
        (4097, 8, 8, 2),      # data planes start off 16 bytes (odd m)
        (4097, 6, 4, 2),
    ])
    def test_sixteen_byte_padding(self, m, s, itemsize, vec):
        offs = (-64, -1, 0, 1, 64)
        p = dia_plan(offs, m, m, s, itemsize, vec, branch="staged")
        assert p.staged
        _check_layout(p, 5, itemsize)
        row_aligned = s * itemsize % 16 == 0
        plane_aligned = m * itemsize % 16 == 0
        assert p.plane_bytes == spmm._align16(
            p.rows * itemsize + (0 if plane_aligned else 16 - itemsize))
        for (lo, hi), nb in zip(p.segments, p.segment_bytes):
            assert nb == spmm._align16((hi - lo) * s * itemsize
                                       + (0 if row_aligned else
                                          16 - itemsize))
        # the worst start: a piece whose first byte sits 16 - itemsize
        # past a 16-byte boundary still fits its slot once rounded up
        for (lo, hi), nb in zip(p.segments, p.segment_bytes):
            for start in range(0, 16, itemsize):
                end = start + (hi - lo) * s * itemsize
                if row_aligned and start:
                    continue
                assert spmm._align16(end) <= nb

    @pytest.mark.parametrize("m,staged", [(65536, False),
                                          (8 * 264 * 128, True),
                                          (8 * 264 * 128 - 128, False)])
    def test_few_tiles_per_block_take_the_direct_branch(self, m, staged):
        """Auto stages only where every persistent block walks
        MIN_TILES_PER_BLOCK tiles: with fewer the ring overlaps nothing."""
        p = dia_plan(SOLVE, m, m, 8, 8, 2, sms=132)
        assert p.stageable and p.staged == staged
        if not staged:
            assert "per block" in p.why and p.pack.staged == 0
            q = dia_plan(SOLVE, m, m, 8, 8, 2, sms=132, branch="staged")
            assert q.staged and q.tiles < spmm.MIN_TILES_PER_BLOCK * q.grid
        else:
            assert p.grid == 264 and p.tiles == 8 * p.grid

    def test_many_diagonals_take_the_direct_branch(self):
        offs = tuple(range(-8, 9))
        assert len(offs) == OFFSETS_CAP + 1
        p = dia_plan(offs, 2000, 2000, 4, 8, 2)
        assert not p.staged and not p.stageable
        assert "17 diagonals" in p.why
        assert p.pack.byval == 0 and p.pack.d == 17
        assert (p.lanes, p.col_tiles) == (2, 1)
        with pytest.raises(ValueError, match="staged branch cannot run"):
            dia_plan(offs, 2000, 2000, 4, 8, 2, branch="staged")

    @pytest.mark.parametrize("s,why", [(4096, "wider than a block"),
                                       (320, "passes")])
    def test_wide_rows_take_the_direct_branch(self, s, why):
        p = dia_plan(SOLVE, 65536, 65536, s, 8, 2)
        assert not p.staged and not p.stageable and why in p.why
        assert p.pack.byval == 1 and p.col_tiles * p.lanes * 2 >= s

    def test_unaligned_pointers_and_forcing(self):
        p = dia_plan(SOLVE, 4096, 4096, 8, 8, 2, aligned=False)
        assert not p.staged and "16-byte" in p.why
        q = dia_plan(SOLVE, 4096, 4096, 8, 8, 2, branch="direct")
        assert not q.staged and q.why == "forced" and q.pack.staged == 0
        assert dia_plan(SOLVE, 4096, 4096, 8, 8, 2,
                        branch="staged").staged
        with pytest.raises(ValueError, match="branch"):
            dia_plan(SOLVE, 4096, 4096, 8, 8, 2, branch="fast")

    def test_one_stage_where_two_do_not_fit(self):
        # s = 64 f64: a 512-byte x row; at R = 32, 98 rows of x = 50 KB
        p = dia_plan(SOLVE, 65536, 65536, 64, 8, 2, rows=128,
                     branch="staged")
        assert p.staged and p.stage_bytes > spmm.SMEM_BUDGET // 2
        assert p.stages == 1

    def test_by_value_pack(self):
        offs = (5, -3, 0, 40, -200)
        p = dia_plan(offs, 10000, 9000, 8, 4, 4, branch="staged")
        pk = p.pack
        assert (pk.staged, pk.byval, pk.d) == (1, 1, 5)
        assert list(pk.off[:5]) == list(offs)
        assert (pk.omin, pk.omax) == (-200, 40)
        assert (pk.vec, pk.lanes, pk.rows, pk.stages, pk.grid) == (
            p.vec, p.lanes, p.rows, p.stages, p.grid)
        assert (pk.stage_bytes, pk.plane_bytes) == (p.stage_bytes,
                                                    p.plane_bytes)
        for k, o in enumerate(offs):
            g = [i for i, (lo, hi) in enumerate(p.segments)
                 if lo <= o and o + p.rows <= hi]
            assert len(g) == 1
            assert pk.term_lo[k] == p.segments[g[0]][0]
            assert pk.term_slot[k] == pk.seg_slot[g[0]]
        assert p.summary()["segments"] == [list(g) for g in p.segments]

    @pytest.mark.parametrize("seed", range(8))
    def test_segments_cover_exactly_the_rows_read(self, seed):
        rng = np.random.default_rng(seed)
        d = int(rng.integers(1, OFFSETS_CAP + 1))
        offs = tuple(int(o) for o in rng.choice(np.arange(-300, 301), d,
                                                replace=False))
        m = int(rng.integers(200, 1500))
        n = int(rng.integers(200, 1500))
        rows = int(rng.choice([32, 64, 128, 256]))
        p = dia_plan(offs, m, n, 4, 4, 4, rows=rows, branch="staged")
        assert p.staged and p.rows == rows
        los = [lo for lo, _ in p.segments]
        assert los == sorted(los)
        assert all(a[1] <= b[0] for a, b in zip(p.segments,
                                                p.segments[1:]))
        for t in range(p.tiles):
            i0 = t * rows
            need = _rows_read(offs, i0, rows, m, n)
            staged = _rows_staged(p, i0, n)
            assert need <= staged
            if i0 + rows <= m:
                assert need == staged

    def test_cpu_wrapper_ignores_the_plan(self, rng):
        _, td = _dia_pair(rng, 300, (-8, 0, 8), jnp.float64)
        x = torch.from_numpy(rng.uniform(-1, 1, (300, 4)))
        p = dia_plan((-8, 0, 8), 300, 300, 4, 8, 2)
        assert torch.equal(dia_spmm(td, x, plan=p),
                           dia_spmm_reference(td, x))


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
    @pytest.mark.parametrize("shape,offsets,s", [
        ((4096, 4096), (-64, -1, 0, 1, 64), 6),
        ((1100, 1100), (-40, -1, 0, 2, 33), 3),
        ((3000, 2000), (-500, -7, 0, 3, 1900), 5),
    ])
    def test_matches_reference(self, rng, cuda_device, dtype, tol, shape,
                               offsets, s):
        m, n = shape
        data = torch.from_numpy(rng.uniform(-1, 1, (len(offsets), m)))
        dia = DiaMatrix(data.to(cuda_device, dtype), offsets, shape)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, s))).to(cuda_device,
                                                           dtype)
        before = dia_spmm.launches
        y = dia_spmm(dia, x)
        torch.cuda.synchronize()
        assert dia_spmm.launches == before + 1
        ref = dia_spmm_reference(dia, x)
        err = (y - ref).abs().max().item()
        assert err <= tol * ref.abs().max().item()

    @pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                           (torch.float64, 1e-12)])
    @pytest.mark.parametrize("shape,offsets,s", [
        ((4096, 4096), (-64, -1, 0, 1, 64), 6),
        ((1100, 1100), (-40, -1, 0, 2, 33), 3),
        ((3000, 2000), (-500, -7, 0, 3, 1900), 5),
        ((50000, 30000), (-7000, -3, 0, 5, 20000), 4),
        ((65536, 65536), SOLVE, 1),
        ((65536, 65536), SOLVE, 8),
        ((65536, 65536), SOLVE, 16),
        ((4097, 4097), SOLVE, 8),
        ((4097, 4097), (-64, -1, 0, 1, 64), 6),
        ((64000, 64000), (-1600, -40, -1, 0, 1, 40, 1600), 8),  # 3-D
    ])
    def test_both_branches(self, rng, cuda_device, dtype, tol, shape,
                           offsets, s):
        """Each branch, forced through the plan, against the plain
        version; the two bit-equal."""
        from rails_tpu_torch.sparse.tiling import vector_width

        m, n = shape
        data = torch.from_numpy(rng.uniform(-1, 1, (len(offsets), m)))
        dia = DiaMatrix(data.to(cuda_device, dtype), offsets, shape)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, s))).to(cuda_device,
                                                           dtype)
        ref = dia_spmm_reference(dia, x)
        vec = vector_width(s, x.element_size(), x.data_ptr())
        ys = {}
        for branch in ("staged", "direct"):
            plan = dia_plan(offsets, m, n, s, x.element_size(), vec,
                            branch=branch,
                            sms=spmm._sm_count(cuda_device))
            assert plan.staged == (branch == "staged")
            ys[branch] = dia_spmm(dia, x, plan=plan)
            torch.cuda.synchronize()
            err = (ys[branch] - ref).abs().max().item()
            assert err <= tol * ref.abs().max().item(), branch
        assert torch.equal(ys["staged"], ys["direct"])
        assert torch.equal(dia_spmm(dia, x), ys["staged"])   # the plan's

    @pytest.mark.parametrize("s", [1, 8, 16])
    def test_bit_equal_to_halo_shards(self, rng, cuda_device, s):
        """Kernel #1 at f64 equals kernel #3's four shard applies of the
        same rows, bit for bit (the mesh solve's guarantee)."""
        from rails_tpu_torch.sparse.spmm import dia_spmm_halo

        m, nd = 65536, 4
        data = torch.from_numpy(rng.uniform(-1, 1, (5, m))).to(cuda_device)
        x = torch.from_numpy(rng.uniform(-1, 1, (m, s))).to(cuda_device)
        dia = DiaMatrix(data, SOLVE, (m, m))
        y1 = dia_spmm(dia, x)
        offs_t = torch.tensor(SOLVE, dtype=torch.int32, device=cuda_device)
        parts = []
        for r in range(nd):
            r0, r1 = r * m // nd, (r + 1) * m // nd
            hl = x[r0 - 256:r0].clone() if r0 else torch.zeros_like(
                x[:256])
            hh = x[r1:r1 + 256].clone() if r1 < m else torch.zeros_like(
                x[:256])
            parts.append(dia_spmm_halo(data[:, r0:r1].contiguous(), offs_t,
                                       x[r0:r1], hl, hh, offsets=SOLVE))
        assert torch.equal(torch.cat(parts), y1)

    def test_rejects_noncontiguous(self, rng, cuda_device):
        dia = DiaMatrix(torch.ones(1, 64, device=cuda_device), (0,),
                        (64, 64))
        x = torch.ones(64, 4, device=cuda_device)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            dia_spmm(dia, x)
