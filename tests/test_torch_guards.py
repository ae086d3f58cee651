"""Guards of the port: it imports neither JAX nor the JAX package, its
entry points run on ``cuda`` unless told otherwise and raise without a
card, and the state it takes over from the JAX package arrives intact."""

import dataclasses
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import rails_tpu
import rails_tpu_torch as rt
from rails_tpu_torch import interop

# one intra-op thread: the suite runs in several worker processes at once,
# and small ops with many threads each oversubscribe the cores
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def test_import_pulls_in_no_jax():
    """The package's modules and the ported examples (imported, not run)
    load neither JAX nor the JAX package."""
    code = ("import sys, rails_tpu_torch, rails_tpu_torch.interop, "
            "rails_tpu_torch.models.problems, rails_tpu_torch._build, "
            "rails_tpu_torch.refine, "
            "rails_tpu_torch.continuation, rails_tpu_torch.sparse.wide_spmm, "
            "rails_tpu_torch.utils.compensated, rails_tpu_torch.cli, "
            "rails_tpu_torch.parallel.sharded, "
            "rails_tpu_torch.parallel.schur_dist, "
            "rails_tpu_torch.parallel.multihost, "
            "rails_tpu_torch.kernel_ablation, rails_tpu_torch.core.engine, "
            "rails_tpu_torch.capture_audit, importlib.util\n"
            "for name in ('continuation_sequence_torch', "
            "'distributed_schur_torch'):\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, f'examples/{name}.py')\n"
            "    spec.loader.exec_module(\n"
            "        importlib.util.module_from_spec(spec))\n"
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith(('jax.', 'jaxlib', 'rails_tpu.')) or "
            "m == 'rails_tpu')\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def test_wide_apply_has_no_fallback():
    """A CUDA apply that qualifies for the dense-window kernel launches it
    or raises: the ELL and wide wrappers hold no try statement that could
    switch to the ELL kernel or a plain version (the card-side check,
    tests/test_torch_wide.py::TestKernelOnCard::test_build_failure_raises,
    breaks the build and sees the apply raise)."""
    import ast
    import inspect

    from rails_tpu_torch.sparse import ell_spmm as em
    from rails_tpu_torch.sparse import wide_spmm as wm

    for fn in (em.ell_spmm, wm.wide_spmm, wm._kernel_fn):
        tree = ast.parse(inspect.getsource(fn))
        assert not any(isinstance(n, ast.Try) for n in ast.walk(tree))


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.mark.parametrize("entry", [
    lambda: rt.DiagonalOperator(np.ones(4)),
    lambda: rt.DenseOperator(np.eye(4)),
    lambda: rt.sparse_from_dense(np.eye(4)),
    lambda: rt.solve(-np.eye(4), np.ones((4, 1))),
    lambda: rt.LyapunovSolver(-np.eye(4), np.ones((4, 1))),
    lambda: interop.rhs(np.ones((4, 1))),
    lambda: rt.solve_refined(-np.eye(4), np.ones((4, 1))),
    lambda: rt.ContinuationSolver(np.ones((4, 1))).step(-np.eye(4)),
    lambda: rt.make_mesh(),
])
def test_default_device_is_cuda_and_raises_without_card(no_card, entry):
    with pytest.raises(RuntimeError, match="no CUDA device|is_available"):
        entry()


def test_explicit_cuda_raises_without_card(no_card):
    with pytest.raises(RuntimeError):
        rt.solve(-np.eye(4), np.ones((4, 1)), device="cuda")


def test_precision_policy_pins_full_f32():
    from rails_tpu_torch.utils.dtypes import full_precision, precision_flags

    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with full_precision():
            flags = precision_flags()
        assert flags == {"cuda.matmul.allow_tf32": False,
                         "cudnn.allow_tf32": False,
                         "float32_matmul_precision": "highest"}
        assert torch.backends.cuda.matmul.allow_tf32 is True  # restored
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before


def test_precision_policy_after_legacy_tf32_switch():
    """A caller who turned TF32 on through the legacy switch leaves the
    legacy and per-backend settings disagreeing, where PyTorch's legacy
    getter raises; ``full_precision`` must still pin full f32 and give
    the caller's settings back unchanged."""
    from rails_tpu_torch.utils.dtypes import (
        _fp32_switches, full_precision, precision_flags)

    saved = [(o, o.fp32_precision) for o in _fp32_switches()]
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        state = [o.fp32_precision for o in _fp32_switches()]
        for _ in range(2):
            with full_precision():
                assert precision_flags()["float32_matmul_precision"] == \
                    "highest"
                assert not torch.backends.cuda.matmul.allow_tf32
            assert [o.fp32_precision for o in _fp32_switches()] == state
            assert torch.backends.cuda.matmul.allow_tf32 is True
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
        for obj, value in saved:
            obj.fp32_precision = value


class TestInterop:
    def test_options_round_trip(self):
        jopt = rails_tpu.SolverOptions(tol=1e-7, expand=4, restart_size=40,
                                       projection_method=1.0, seed=11)
        fields = dataclasses.asdict(jopt)
        fields.pop("dtype")
        opt = interop.solver_options(fields, device="cpu", dtype="float32")
        assert opt.dtype == torch.float32
        for f in ("tol", "expand", "restart_size", "reduced_size", "seed",
                  "projection_major", "projection_minor"):
            assert getattr(opt, f) == getattr(jopt, f), f

    def test_options_reject_unknown_fields(self):
        with pytest.raises(ValueError, match="unknown"):
            interop.solver_options({"mesh_axis": 1}, device="cpu")

    def test_operators_and_arrays(self, rng):
        from rails_tpu.sparse.formats import sparse_from_dense as jsd

        a = np.diag(rng.uniform(-1, 1, 30)) + np.diag(np.ones(29), 3)[:30,
                                                                   :30]
        aj = jsd(a, fmt="dia")
        op = interop.sparse_operator(
            {"data": np.asarray(aj.fwd.data), "offsets": aj.fwd.offsets,
             "shape": aj.fwd.shape},
            {"data": np.asarray(aj.bwd.data), "offsets": aj.bwd.offsets,
             "shape": aj.bwd.shape}, nnz=aj.nnz, device="cpu")
        x = rng.uniform(-1, 1, (30, 2))
        assert np.allclose(op.matmat(torch.from_numpy(x)).numpy(),
                           np.asarray(aj.matmat(jnp.asarray(x))), atol=0)
        assert np.allclose(op.rmatmat(torch.from_numpy(x)).numpy(),
                           np.asarray(aj.rmatmat(jnp.asarray(x))), atol=0)
        d = interop.dense_operator(a, device="cpu")
        assert np.array_equal(d.to_dense().numpy(), a)
        m = interop.diagonal_operator(np.full(30, 2.0), device="cpu")
        assert m.is_spd
        b = interop.rhs(np.ones(30), device="cpu")
        assert tuple(b.shape) == (30, 1)
        rd = interop.restart_data({"V": np.eye(30)[:, :3],
                                   "AV": a[:, :3], "VAV": a[:3, :3]},
                                  device="cpu")
        assert set(rd) == {"V", "AV", "VAV"}
