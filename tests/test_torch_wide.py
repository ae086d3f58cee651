"""The port's dense-window payload and SpMM module (``sparse/wide_spmm.py``)
against the JAX package's ``sparse/wide_spmm.py``.

- ``build_wide_window``: ``c0``, ``w`` and the bfloat16 planes bit-equal to
  the JAX package's (mapped onto the port's layout by
  ``interop.wide_window``), and the same decisions where there is no
  payload: m < 256, a window wider than min(2048, n_pad), the bytes cap,
  and ``passes`` outside {3, 6}.
- ``wide_spmm_reference`` against the TPU kernel ``wide_spmm_t`` in
  interpret mode (tests/test_sparse.py TestWideSpmm's route): 1e-5 of
  max|y| (the same exact bf16 products summed in another order), and
  against the exact product within the JAX tests' bounds, 8e-5 max|y|
  at three passes and 5e-7 max|y| at six.
- The dispatch rule, and the CPU path, which never dispatches wide (the
  JAX package's dispatch is off the TPU).
- The CUDA kernel runs only on the card: those tests carry the ``cuda``
  marker and skip without one.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from jax.experimental.pallas import tpu as pltpu

from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse
from rails_tpu.sparse.wide_spmm import build_wide_window as jax_build
from rails_tpu.sparse.wide_spmm import wide_spmm_t
from rails_tpu_torch import interop
from rails_tpu_torch.sparse import ell_spmm as em
from rails_tpu_torch.sparse import wide_spmm as wm
from rails_tpu_torch.sparse.formats import EllMatrix, sparse_from_scipy
from test_torch_ell import banded_random

torch.set_num_threads(1)


def _pair(a, passes=3, **kw):
    """The JAX package's and the port's window of ``a`` (float32 ELL)."""
    aj = jax_sparse(a, fmt="ell", dtype=jnp.float32)
    at = sparse_from_scipy(a, fmt="ell", dtype=torch.float32, device="cpu")
    wj = None if aj.fwd.well is None else jax_build(aj.fwd.well,
                                                    passes=passes, **kw)
    return wj, wm.build_wide_window(at.fwd, passes=passes, **kw), at


def _as_port(wj):
    return interop.wide_window(
        np.asarray(wj.c0), np.asarray(wj.p_hi), np.asarray(wj.p_lo),
        None if wj.p3 is None else np.asarray(wj.p3), wj.w, wj.shape,
        wj.min_s, device="cpu")


def _bits(t):
    return t.view(torch.int16).numpy()


@pytest.mark.parametrize("m,n,ell_l,band,empty,passes", [
    (512, 512, 4, 32, 0, 3),
    (512, 512, 5, 40, 0, 6),
    (1111, 700, 6, 40, 150, 3),     # odd m, n < m, empty rows
    (900, 1300, 7, 300, 0, 6),      # n > m, wide band
])
def test_planes_bit_equal(rng, m, n, ell_l, band, empty, passes):
    a = banded_random(rng, m, ell_l, band, n=n, empty_rows=empty)
    wj, wt, _ = _pair(a, passes)
    assert wj is not None and wt is not None
    assert wt.w == wj.w and wt.shape == wj.shape and wt.passes == passes
    assert np.array_equal(wt.c0.numpy(), np.asarray(wj.c0))
    ref = _as_port(wj)
    for name in ("p_hi", "p_lo", "p3"):
        pt, pj = getattr(wt, name), getattr(ref, name)
        assert (pt is None) == (pj is None)
        if pt is not None:
            assert np.array_equal(_bits(pt), _bits(pj)), name


def test_sparse_from_scipy_builds_both_payloads(rng):
    a = banded_random(rng, 600, 5, 30, n=640)
    at = sparse_from_scipy(a, fmt="ell", dtype=torch.float32, device="cpu",
                           wide_s=True, wide_passes=6)
    aj = jax_sparse(a, fmt="ell", dtype=jnp.float32, wide_s=True,
                    wide_passes=6)
    for pt, pj in ((at.fwd, aj.fwd), (at.bwd, aj.bwd)):
        ref = _as_port(pj.wide)
        assert pt.wide.passes == 6 and pt.wide.w == pj.wide.w
        assert np.array_equal(_bits(pt.wide.p3), _bits(ref.p3))
    # the payload rides astype and to; the planes stay bfloat16
    a64 = at.astype(torch.float64)
    assert a64.fwd.wide is at.fwd.wide
    assert a64.fwd.wide.p_hi.dtype == torch.bfloat16


def test_interop_ell_payload_carries_the_window(rng):
    """The JAX package's ELL payload and window through ``interop``: the
    port's plain version on it gives the port's own payload's result bit
    for bit; planes that are not bfloat16 are refused."""
    a = banded_random(rng, 520, 5, 30, n=610, empty_rows=20)
    aj = jax_sparse(a, fmt="ell", dtype=jnp.float32, wide_s=True,
                    wide_passes=6)
    ell = interop.ell_payload(np.asarray(aj.fwd.indices),
                              np.asarray(aj.fwd.values), aj.fwd.shape,
                              wide=_as_port(aj.fwd.wide), device="cpu")
    at = sparse_from_scipy(a, fmt="ell", dtype=torch.float32, device="cpu",
                           wide_s=True, wide_passes=6)
    x = torch.from_numpy(rng.uniform(-1, 1, (610, 7)).astype(np.float32))
    assert ell.wide.passes == 6
    assert torch.equal(wm.wide_spmm_reference(ell.wide, x),
                       wm.wide_spmm_reference(at.fwd.wide, x))
    wj = aj.fwd.wide
    with pytest.raises(ValueError, match="bfloat16"):
        interop.wide_window(np.asarray(wj.c0),
                            np.asarray(wj.p_hi, np.float32),
                            np.asarray(wj.p_lo), None, wj.w, wj.shape,
                            device="cpu")


@pytest.mark.parametrize("case", ["few_rows", "too_wide", "bytes_cap"])
def test_same_none_decisions(rng, case):
    if case == "few_rows":
        wj, wt, _ = _pair(banded_random(rng, 255, 4, 20))
        assert wj is None and wt is None
        wj, wt, _ = _pair(banded_random(rng, 256, 4, 20))
        assert wj is not None and wt is not None
    elif case == "too_wide":
        # every chunk spans more than 2048 columns
        wj, wt, _ = _pair(banded_random(rng, 512, 6, 1500, n=6000))
        assert wj is None and wt is None
    else:
        a = banded_random(rng, 512, 4, 32)
        _, full, _ = _pair(a, 6)
        need = 3 * full.w * 512 * 2       # three bf16 (w, m_pad) planes
        wj, wt, _ = _pair(a, 6, bytes_cap=need - 1)
        assert wj is None and wt is None
        wj, wt, _ = _pair(a, 6, bytes_cap=need)
        assert wj is not None and wt is not None


def test_passes_checked_in_the_same_order(rng):
    a = banded_random(rng, 512, 4, 32)
    for build, payload in ((jax_build, jax_sparse(
            a, fmt="ell", dtype=jnp.float32).fwd.well),
            (wm.build_wide_window, sparse_from_scipy(
                a, fmt="ell", dtype=torch.float32, device="cpu").fwd)):
        with pytest.raises(ValueError, match="passes"):
            build(payload, passes=4)
    # no window: None before the passes are looked at, in both packages
    small = banded_random(rng, 200, 4, 20)
    assert jax_sparse(small, fmt="ell", dtype=jnp.float32).fwd.well is None
    assert wm.build_wide_window(sparse_from_scipy(
        small, fmt="ell", dtype=torch.float32, device="cpu").fwd,
        passes=4) is None


@pytest.mark.parametrize("m,n,s,passes", [
    (512, 512, 64, 3), (512, 512, 67, 3), (512, 512, 72, 6),
    (1111, 700, 5, 6),
])
def test_reference_matches_interpreter(rng, m, n, s, passes):
    a = banded_random(rng, m, 5, 40, n=n, empty_rows=m // 10)
    wj, wt, _ = _pair(a, passes)
    x = rng.uniform(-1, 1, (n, s)).astype(np.float32)
    with pltpu.force_tpu_interpret_mode():
        yj = np.asarray(wide_spmm_t(wj, jnp.asarray(x).T).T)
    yt = wm.wide_spmm_reference(wt, torch.from_numpy(x))
    assert yt.dtype == torch.float32 and tuple(yt.shape) == (m, s)
    scale = np.abs(yj).max()
    assert np.abs(yt.numpy() - yj).max() <= 1e-5 * scale
    exact = a.astype(np.float32).astype(np.float64) @ x.astype(np.float64)
    bound = 8e-5 if passes == 3 else 5e-7
    assert np.abs(yt.numpy() - exact).max() <= bound * np.abs(exact).max()


def test_reference_groups_agree(rng):
    a = banded_random(rng, 700, 5, 60, n=650)
    _, wt, _ = _pair(a, 6)
    x = torch.from_numpy(rng.uniform(-1, 1, (650, 9)).astype(np.float32))
    y1 = wm.wide_spmm_reference(wt, x, group=1)
    assert torch.equal(y1, wm.wide_spmm_reference(wt, x))
    assert torch.equal(y1, wm.wide_spmm_reference(wt, x, group=4))


def test_dispatch_rule(rng):
    a = banded_random(rng, 512, 4, 32)
    op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32, device="cpu",
                           wide_s=True)
    ell = op.fwd
    min_s = ell.wide.min_s
    assert min_s == 192
    x = torch.zeros(512, min_s)
    assert em.wide_eligible(ell, x)
    assert not em.wide_eligible(ell, x[:, :min_s - 1])     # narrow
    assert not em.wide_eligible(ell, x.double())            # float64
    assert not em.wide_eligible(ell, x[:, 0])               # a vector
    assert not em.wide_eligible(sparse_from_scipy(
        a, fmt="ell", dtype=torch.float32, device="cpu").fwd, x)


def test_cpu_apply_never_dispatches_wide(rng):
    """On a CPU tensor every apply is the plain ELL product, as the JAX
    package's dispatch is off the TPU; no kernel launch is counted."""
    a = banded_random(rng, 512, 4, 32)
    op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32, device="cpu",
                           wide_s=True)
    x = torch.from_numpy(rng.uniform(-1, 1, (512, 200)).astype(np.float32))
    w0, e0 = wm.wide_spmm.launches, em.ell_spmm.launches
    y = op.matmat(x)
    assert torch.equal(y, em.ell_spmm_reference(op.fwd, x))
    assert (wm.wide_spmm.launches, em.ell_spmm.launches) == (w0, e0)
    yr = wm.wide_spmm(op.fwd.wide, x)          # CPU: the plain version
    assert torch.equal(yr, wm.wide_spmm_reference(op.fwd.wide, x))
    assert wm.wide_spmm.launches == w0


def _check_tiling(s, passes):
    tw, nct = wm.wide_tiling(s, passes)
    assert tw % 8 == 0 and 8 <= tw <= wm.TILE_MAX[passes]
    tiles = [(t * tw, min(s, (t + 1) * tw)) for t in range(nct)]
    assert all(c1 > c0 for c0, c1 in tiles)
    assert np.array_equal(np.concatenate([np.arange(c0, c1)
                                          for c0, c1 in tiles]),
                          np.arange(s))
    assert sum(-(-(c1 - c0) // 8) for c0, c1 in tiles) == -(-s // 8)
    return tw, nct


@pytest.mark.parametrize("s,passes,tiles", [
    (1, 3, (8, 1)), (8, 6, (8, 1)), (67, 6, (72, 1)), (192, 3, (192, 1)),
    (200, 3, (200, 1)), (200, 6, (104, 2)), (256, 6, (128, 2)),
    (300, 3, (152, 2)), (300, 6, (104, 3))])
def test_tiling_covers_each_column_once(s, passes, tiles):
    """The kernel's column tiles: a multiple of 8 (the mma's n), at most
    256 wide at three passes and 128 at six, every column in exactly one
    tile, and no more padding than rounding s up to 8 (s = 200 runs 25
    n8 tiles, not 26 or 32)."""
    assert _check_tiling(s, passes) == tiles


@pytest.mark.parametrize("passes", [3, 6])
def test_tiling_every_width(passes):
    for s in range(1, 2049):
        _check_tiling(s, passes)


@pytest.mark.parametrize("nb,s,passes", [(1, 1, 3), (3, 200, 6),
                                         (5, 67, 3), (128, 200, 6),
                                         (7, 300, 3), (4, 600, 6)])
def test_blocks_adjacent_per_chunk(nb, s, passes):
    """In launch order a chunk's column tiles are adjacent and cover its
    s columns once, chunk after chunk."""
    blocks = wm.wide_blocks(nb, s, passes)
    _, nct = wm.wide_tiling(s, passes)
    assert len(blocks) == nb * nct
    chunks = [b for b, _, _ in blocks]
    assert chunks == sorted(chunks)
    for b in range(nb):
        mine = [(c0, c1) for bb, c0, c1 in blocks if bb == b]
        assert [c for c0, c1 in mine for c in range(c0, c1)] == list(
            range(s))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
class TestKernelOnCard:
    """The CUDA kernel against its plain version on the card: 1e-5 of
    max|y| (the same exact products, float32 sums in another order).
    The cases hit the kernel's tiling: s from 1 to 300 (one partial n8
    tile, 56-wide tiles at 200, five tiles at 300), w = 128 and 2048,
    n not a multiple of 128 with window rows past n, rectangular
    matrices with empty rows, three and six passes."""

    @pytest.mark.parametrize("m,n,ell_l,band,empty,s,passes", [
        (4096, 4096, 5, 100, 0, 200, 3),
        (4096, 4096, 5, 100, 0, 256, 6),
        (1111, 700, 6, 40, 150, 67, 3),
        (1111, 700, 6, 40, 150, 3, 6),
        (1000, 1300, 7, 300, 0, 192, 6),
        (1000, 1000, 3, 0, 0, 1, 3),            # w = 128, rows past n
        (1000, 1000, 3, 0, 0, 8, 6),
        (4096, 4096, 6, 900, 0, 300, 6),        # w = 2048
        (4096, 4096, 6, 900, 0, 67, 3),
        (2000, 1900, 5, 60, 100, 200, 6),       # rows past n, empty rows
        (2000, 1900, 5, 60, 100, 300, 3),
        (1111, 700, 6, 40, 150, 1, 6),
        (1111, 700, 6, 40, 150, 8, 3),
        (1000, 1300, 7, 300, 0, 192, 3),
    ])
    def test_matches_reference(self, rng, cuda_device, m, n, ell_l, band,
                               empty, s, passes):
        a = banded_random(rng, m, ell_l, band, n=n, empty_rows=empty)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32,
                               device=cuda_device)
        wide = wm.build_wide_window(op.fwd, passes=passes)
        x = torch.from_numpy(rng.uniform(-1, 1, (n, s)).astype(
            np.float32)).to(cuda_device)
        before = wm.wide_spmm.launches
        y = wm.wide_spmm(wide, x)
        torch.cuda.synchronize()
        assert wm.wide_spmm.launches == before + 1
        ref = wm.wide_spmm_reference(wide, x)
        assert (y - ref).abs().max().item() <= \
            1e-5 * ref.abs().max().item()

    @pytest.mark.parametrize("kind,s", [("continuation", 200),
                                        ("continuation", 256),
                                        ("banded", 192)])
    def test_six_passes_within_exact_bound(self, rng, cuda_device, kind, s):
        """The 6-pass kernel against the exact float64 product of the
        float32 ELL payload at the JAX tests' 5e-7 max|y|: the tensor
        cores' truncated float32 sums must not eat the bound."""
        if kind == "continuation":     # bench.py's Jacobian, theta 0.05
            side = 64
            a = (sp.kron(sp.eye(side), sp.diags([1.0, -4.05, 1.0],
                                                [-1, 0, 1], (side, side)))
                 + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                           sp.eye(side))).tocsr()
        else:
            a = banded_random(rng, 3000, 7, 200, n=2900, empty_rows=30)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32,
                               device=cuda_device)
        wide = wm.build_wide_window(op.fwd, passes=6)
        x = torch.from_numpy(rng.uniform(-1, 1, (a.shape[1], s)).astype(
            np.float32)).to(cuda_device)
        y = wm.wide_spmm(wide, x)
        exact = em.ell_spmm_reference(
            EllMatrix(op.fwd.indices, op.fwd.values.double(),
                         op.fwd.shape), x.double())
        assert (y.double() - exact).abs().max().item() <= \
            5e-7 * exact.abs().max().item()

    def test_dispatch_launches_wide_or_ell(self, rng, cuda_device):
        a = banded_random(rng, 2048, 5, 60)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32,
                               device=cuda_device, wide_s=True)
        w0, e0 = wm.wide_spmm.launches, em.ell_spmm.launches
        op.matmat(torch.ones(2048, 192, device=cuda_device))
        assert (wm.wide_spmm.launches, em.ell_spmm.launches) == (w0 + 1, e0)
        op.matmat(torch.ones(2048, 191, device=cuda_device))
        op.astype(torch.float64).matmat(
            torch.ones(2048, 256, dtype=torch.float64, device=cuda_device))
        assert (wm.wide_spmm.launches, em.ell_spmm.launches) == (w0 + 1,
                                                                e0 + 2)

    def test_build_failure_raises(self, rng, cuda_device, monkeypatch):
        """A wide-eligible apply whose kernel cannot be had raises; it is
        never answered by the ELL kernel or the plain version."""
        from rails_tpu_torch import _build

        a = banded_random(rng, 1024, 4, 32)
        op = sparse_from_scipy(a, fmt="ell", dtype=torch.float32,
                               device=cuda_device, wide_s=True)
        monkeypatch.setattr(wm, "_FN", [])

        def broken(name):
            raise RuntimeError(f"kernel build failed: {name}")

        monkeypatch.setattr(_build, "load", broken)
        with pytest.raises(RuntimeError, match="build failed"):
            op.matmat(torch.ones(1024, 200, device=cuda_device))


def test_ablation_cuts_match_the_kernel_source():
    """``kernel_ablation`` cuts parts of a kernel by text substitution;
    each cut must still find its text, once, in its kernel's source
    (``csrc/wide_spmm.cu``, ``ell_spmm.cu``, ``dia_spmm_halo.cu``)."""
    from rails_tpu_torch import _build, kernel_ablation

    cuts = kernel_ablation.CUTS
    assert set(cuts["wide_spmm"]) == {
        "kernel", "no_mma", "no_mma_no_x", "no_mma_no_planes"}
    assert set(cuts["ell_spmm"]) == {
        "kernel", "no_x_gathers", "no_slot_loads", "no_staging"}
    assert set(cuts["dia_spmm_halo"]) == {"kernel", "no_data", "no_x"}
    for kernel, copies in cuts.items():
        src = _build.sources()[kernel].read_text()
        for subs in copies.values():
            for old, _ in subs:
                assert src.count(old) == 1, (kernel, old)
