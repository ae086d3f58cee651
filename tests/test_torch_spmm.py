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
from rails_tpu_torch.sparse.spmm import dia_spmm, dia_spmm_reference

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

    def test_rejects_noncontiguous(self, rng, cuda_device):
        dia = DiaMatrix(torch.ones(1, 64, device=cuda_device), (0,),
                        (64, 64))
        x = torch.ones(64, 4, device=cuda_device)[:, ::2]
        with pytest.raises(ValueError, match="contiguous"):
            dia_spmm(dia, x)
