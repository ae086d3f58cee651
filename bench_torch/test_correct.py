"""The comparison that decides ``correct``, held against its control and
the faults a cell can have, on the CPU at a size a test run holds.

    python3 -m pytest bench_torch/test_correct.py -q

Each test drives a whole run (``harness.run_cell``: set-up, window,
the reference's check) without the look for a card, on a cell of
``BENCHMARK.json`` cut to a small side, under the committed limits:

- the cell as it is runs correct;
- the control - the program's own path one precision lower (float32
  for the cells' float64) - comes out not correct;
- so does each fault the cells can have, planted under the timed path:
  an answer altered where it is produced (one entry of T), a step that
  returns its state unchanged (the solver hands back its initial state
  as converged), half of the batch left out (the solver sees half of
  B's columns), an early stop reported as converged (the solver's
  tolerance loosened under the timed path, ``control.early_stop``).  The cells run on one chip, so there is no exchange
  between chips to leave out.

A non-symmetric operator joins by a family file alone: the CLI cell on
a convection-diffusion stencil written into a directory of the test's
own, with no file of the benchmark edited, runs correct, and its
control and early stop do not, so the checks hold where A is not A'
(the residual's A V', the transposed A11 solve, A12' in the full-space
operator) and the projected solve takes the Schur route.

The control's readings at the cells' own sizes come from
``control.py`` on the card (PERF.md).
"""

import contextlib
import time

import pytest
import torch

from bench_torch import control, harness
from bench_torch.reference import problems

SIDES = {"laplace2d.f64_n65k": 16, "dae_index1.cli_n9k": 12}
SEED = 2 ** 35 + 11


def run(workload, control=False):
    cell = harness.load_cell(workload, SEED, device="cpu")
    cell.config["side"] = SIDES[workload]
    if control:
        cell.dtype = cell.traffic["control_dtype"]
    return harness.run_cell(cell, 1.0, False, time.perf_counter())[0]


def over(out):
    """The numbers of a run that are not within their limits (a number
    that could not be read, None, is not); asserts the run is not
    correct."""
    assert not out["correct"]
    return [k for k, c in out["check"].items()
            if c["value"] is None or c["value"] > c["limit"]]


@pytest.fixture
def solver_cls():
    from rails_tpu_torch.core.solver import LyapunovSolver

    return LyapunovSolver


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_sound_run_is_correct(workload):
    out = run(workload)
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out["check"])[-1] == "failed_requests"


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_control_one_precision_lower_is_not_correct(workload):
    assert "galerkin" in over(run(workload, control=True))


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_answer_altered_where_produced(workload, solver_cls, monkeypatch):
    solve = solver_cls.solve

    def altered(self, *args, **kwargs):
        v, t, info = solve(self, *args, **kwargs)
        t = t.clone()
        t[0, 0] *= 1 + 1e-6
        return v, t, info

    monkeypatch.setattr(solver_cls, "solve", altered)
    assert over(run(workload))


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_state_returned_unchanged(workload, solver_cls, monkeypatch):
    from rails_tpu_torch.core.solver import SolveInfo

    def unchanged(self, *args, **kwargs):
        st, _ = self._init_state(self.A.shape[0])
        k = st.k
        v = st.V[:, :k]
        info = SolveInfo(res=0.0, iter=1, status=0, resvec=[0.0],
                         timevec=[0.0], mvps=k,
                         restart_data={"V": v, "AV": st.AV[:, :k],
                                       "VAV": st.VAV[:k, :k]})
        return v, torch.zeros((k, k), dtype=v.dtype), info

    monkeypatch.setattr(solver_cls, "solve", unchanged)
    assert over(run(workload))


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_half_the_batch_left_out(workload, solver_cls, monkeypatch):
    init = solver_cls.__init__

    def half(self, a, b, m=None, options=None, *args, **kwargs):
        p = b.shape[1] // 2
        if options is not None:
            options.expand = min(options.expand, p)
        if "expand" in kwargs:
            kwargs["expand"] = min(kwargs["expand"], p)
        init(self, a, b[:, :p], m, options, *args, **kwargs)

    monkeypatch.setattr(solver_cls, "__init__", half)
    assert over(run(workload))


@pytest.mark.parametrize("workload", sorted(SIDES))
def test_early_stop_reported_converged(workload):
    with control.early_stop():
        assert over(run(workload)) == ["true_res"]


# the 5-point Laplacian with off-diagonals 1 + p and 1 - p along x: -A is
# an irreducibly diagonally dominant M-matrix, so A11 is non-singular and
# S stable, and A is not symmetric for p > 0
CONVECTION_FAMILY = """
import scipy.sparse as sp


def operator(config):
    side, p = int(config["side"]), float(config["convection"])
    return (sp.kron(sp.eye(side),
                    sp.diags([1.0 + p, -4.0, 1.0 - p], [-1, 0, 1],
                             (side, side)))
            + sp.kron(sp.diags([1.0, 1.0], [-1, 1], (side, side)),
                      sp.eye(side))).tocsr()
"""


@pytest.fixture
def convection(tmp_path, monkeypatch):
    """The CLI cell on a non-symmetric family found in ``tmp_path``; runs
    it (``kind``: sound, control or early stop) and returns its result
    and the tags S got."""
    from rails_tpu_torch.schur import SchurReduction

    (tmp_path / "convection2.py").write_text(CONVECTION_FAMILY)
    monkeypatch.setattr(problems, "FAMILIES_DIR", tmp_path)
    tags = []
    init = SchurReduction.__init__

    def tagged(self, *args, **kwargs):
        init(self, *args, **kwargs)
        tags.append(self.symmetric)

    monkeypatch.setattr(SchurReduction, "__init__", tagged)

    def go(kind="sound"):
        cell = harness.load_cell("dae_index1.cli_n9k", SEED, device="cpu")
        cell.config.update(family="convection2", convection=0.25,
                           side=SIDES[cell.name])
        a = problems.operator(cell.config)
        assert abs(a - a.T).max() == pytest.approx(0.5)
        if kind == "control":
            cell.dtype = cell.traffic["control_dtype"]
        fault = control.early_stop() if kind == "early_stop" \
            else contextlib.nullcontext()
        with fault:
            out = harness.run_cell(cell, 1.0, False, time.perf_counter())[0]
        return out, tags

    return go


def test_non_symmetric_family_by_a_file_alone(convection):
    out, tags = convection()
    assert out["correct"], out["check"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert tags and not any(tags)   # S untagged: the Schur route


@pytest.mark.parametrize("kind, caught", [("control", "galerkin"),
                                          ("early_stop", "true_res")])
def test_non_symmetric_family_control_and_early_stop(convection, kind,
                                                     caught):
    assert caught in over(convection(kind)[0])
