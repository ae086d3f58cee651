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

The control's readings at the cells' own sizes come from
``control.py`` on the card (PERF.md).
"""

import time

import pytest
import torch

from bench_torch import control, harness

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
