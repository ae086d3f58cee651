"""The ported examples (examples/*_torch.py) run as a user runs them,
each in a subprocess, beside the JAX package's originals.

Held within each example: its own assertions (exit 0; the Schur
example's distributed count equal to its single-controller count, true
relative residual below 1e-7, "ok"; the continuation's warm steps and
the step resumed from the checkpoint below the cold count).  Held across
the packages: the Schur split (padding, n1, n2) and convergence.  The
examples draw their own random numbers (the port's torch generator, the
JAX package's key chain), so their iteration counts are reported beside
each other, not held equal.

The four processes start together, each on one intra-op thread (the
JAX distributed example takes about a minute on the CPU, the others
seconds).  A ``cuda`` case runs the two ports on the card.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = {"cont_port": ("continuation_sequence_torch.py", "--device",
                         "cpu"),
           "schur_port": ("distributed_schur_torch.py", "--device", "cpu"),
           "cont_jax": ("continuation_sequence.py",),
           "schur_jax": ("distributed_schur.py",)}
TIMEOUT = 600


def launch(script, *args):
    # one intra-op thread each: the suite runs in several workers, and
    # four processes with a thread per core each oversubscribe the cores
    flags = os.environ.get("XLA_FLAGS", "")
    if "xla_force_host_platform_device_count" not in flags:
        flags += " --xla_force_host_platform_device_count=8"
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="1",
               OPENBLAS_NUM_THREADS="1",
               XLA_FLAGS=(flags + " --xla_cpu_multi_thread_eigen=false"
                          " intra_op_parallelism_threads=1").strip())
    return subprocess.Popen(
        [sys.executable, os.path.join(ROOT, "examples", script), *args],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


def finish(proc):
    out, err = proc.communicate(timeout=TIMEOUT)
    return proc.returncode, out, err


@pytest.fixture(scope="module")
def runs():
    procs = {k: launch(*v) for k, v in SCRIPTS.items()}
    try:
        return {k: finish(p) for k, p in procs.items()}
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()


def continuation_counts(out):
    """(cold, [warm counts], resumed count, [residuals])."""
    rows = [ln.split() for ln in out.splitlines()
            if re.match(r"^\s*\d+\.\d\d\s+\d+\s", ln)]
    iters = [int(r[1]) for r in rows]
    res = [float(r[2]) for r in rows]
    resumed = int(re.search(r"checkpoint: (\d+) iterations", out).group(1))
    resumed_res = float(re.search(r"residual (\S+)$", out.strip())
                        .group(1))
    return iters[0], iters[1:], resumed, res + [resumed_res]


def schur_fields(out):
    def grab(pattern, cast=int):
        return cast(re.search(pattern, out).group(1))

    return {"n_pad": grab(r"padded with (\d+) rows"),
            "n1": grab(r"n1=(\d+)"), "n2": grab(r"n2=(\d+)"),
            "dist": grab(r"distributed solve: (\d+)"),
            "single": grab(r"single-controller:\s+(\d+)"),
            "res_true": grab(r"true relative residual: (\S+)", float),
            "ok": out.strip().splitlines()[-1] == "ok"}


def check_continuation(rc, out, err, tol=1e-4):
    assert rc == 0, err[-3000:]
    cold, warm, resumed, res = continuation_counts(out)
    assert len(warm) == 2
    assert all(w < cold for w in warm), out
    assert resumed < cold, out              # the resumed step is warm
    assert all(r < tol for r in res), out
    return cold, warm, resumed


def check_schur(rc, out, err):
    assert rc == 0, err[-3000:]
    f = schur_fields(out)
    assert f["ok"] and f["dist"] == f["single"], out
    assert f["res_true"] < 1e-7, out
    return f


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_continuation_example(runs, pkg):
    """Exit 0, every step converged to tol, the warm steps and the
    resumed one below the cold count, in each package."""
    check_continuation(*runs[f"cont_{pkg}"])


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_schur_example(runs, pkg):
    """Exit 0, "ok": the distributed count equals the single-controller
    count and the true residual is below 1e-7, in each package."""
    check_schur(*runs[f"schur_{pkg}"])


def test_schur_split_matches_jax(runs):
    """Both examples pad and split the same DAE the same way."""
    port, jax_ = (schur_fields(runs[k][1]) for k in ("schur_port",
                                                     "schur_jax"))
    assert (port["n_pad"], port["n1"], port["n2"]) == \
        (jax_["n_pad"], jax_["n1"], jax_["n2"])


def test_iteration_counts_reported(runs):
    """The counts side by side (printed with -s): reported, not held
    across the packages, whose draws differ."""
    for name in ("cont", "schur"):
        for pkg in ("port", "jax"):
            rc, out, _ = runs[f"{name}_{pkg}"]
            assert rc == 0
            counts = continuation_counts(out)[:3] if name == "cont" \
                else {k: schur_fields(out)[k] for k in ("dist", "single")}
            print(f"{name} {pkg}: {counts}")


@pytest.mark.cuda
def test_ported_examples_on_card():
    """Both ports on the card, as ``python examples/<name>`` runs them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    procs = [launch("continuation_sequence_torch.py"),
             launch("distributed_schur_torch.py")]
    check_continuation(*finish(procs[0]))
    check_schur(*finish(procs[1]))
