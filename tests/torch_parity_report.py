"""Report the numbers behind the port's parity tolerances and its float32
restart, on the CPU (not collected by pytest: no test_ prefix).

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py drift
    JAX_PLATFORMS=cpu python tests/torch_parity_report.py f32

``drift``: the relative difference between the JAX package's resvec and
the port's, iteration by iteration, on the three problems of
tests/test_torch_parity.py (draws fed across, float64), and how far
their V T V' differ.

``f32``: the JAX bench's n=4096 phase_solve problem at float32 (tol
1e-4) through both packages over a few seeds: iterations, the Lanczos
estimate and the float64 true residual (factored power iteration).
"""

import sys
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent))
sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import conftest  # noqa: E402,F401  (CPU JAX with x64, as the tests run)
import jax.numpy as jnp  # noqa: E402
import pytest  # noqa: E402
import scipy.sparse as sp  # noqa: E402
import torch  # noqa: E402

import test_torch_parity as tp  # noqa: E402


def true_residual(lap, md, b, v, t):
    v, t = np.asarray(v, np.float64), np.asarray(t, np.float64)
    av, mv = lap @ v, md[:, None] * v

    def r_apply(x):
        return b @ (b.T @ x) + av @ (t @ (mv.T @ x)) + mv @ (t @ (av.T @ x))

    x = np.random.default_rng(1).standard_normal((lap.shape[0], 1))
    x /= np.linalg.norm(x)
    lam = 0.0
    for _ in range(60):
        y = r_apply(x)
        lam = float(np.linalg.norm(y))
        x = y / lam
    return lam / np.linalg.norm(b.T @ b, 2)


def drift():
    mp = pytest.MonkeyPatch()
    mp.setattr(tp.jax_solver_mod, "jnp", tp._Proxy(
        jnp, linalg=tp._Proxy(jnp.linalg, eigh=tp._jax_eigh_sign_fixed)))
    rng = np.random.default_rng(4634)  # the tests' rng fixture
    n = 256
    md = rng.uniform(0.5, 1.5, n)
    b = rng.uniform(0, 1, (n, 8))
    runs = [("symmetric + M", tp.run_both(
        tp.laplacian2_sparse(16), b, md, {"is_symmetric": True}, tol=1e-4,
        expand=6, restart_size=120, reduced_size=60, maxit=200))]
    rng = np.random.default_rng(4634)
    side, n = 8, 64
    a = (tp.laplacian2_sparse(side)
         + 0.3 * sp.diags([1.0, -1.0], [1, -1], (n, n))
         + 0.2 * sp.diags([1.0, -1.0], [side, -side], (n, n))).tocsr()
    for with_m in (False, True):
        md = rng.uniform(0.5, 1.5, n) if with_m else None
        b = rng.uniform(0, 1, (n, 2))
        runs.append((f"nonsymmetric, M={with_m}", tp.run_both(
            a, b, md, {}, tol=1e-4, expand=2, maxit=100)))
    for name, ((vj, tj, ij), (vt, tt, it), _) in runs:
        d = np.abs(ij.resvec - it.resvec) / np.abs(ij.resvec)
        xj, xt = vj @ tj @ vj.T, vt @ tt @ vt.T
        print(f"{name}: iters {ij.iter}/{it.iter}, resvec drift "
              + " ".join(f"{x:.0e}" for x in d)
              + f"; V T V' rel diff "
              f"{np.linalg.norm(xt - xj) / np.linalg.norm(xj):.1e}")
    mp.undo()


def f32(seeds=(1, 2, 3, 4634)):
    import rails_tpu
    import rails_tpu_torch as rt
    from rails_tpu.sparse.formats import sparse_from_scipy as jax_sparse

    side = 64
    n = side * side
    rng = np.random.default_rng(0)
    lap = tp.laplacian2_sparse(side)
    md = rng.uniform(0.5, 1.5, n)
    b = rng.uniform(0, 1, (n, 8))
    opts = dict(tol=1e-4, expand=6, restart_size=120, reduced_size=60,
                maxit=200)
    aj = jax_sparse(lap, fmt="dia", dtype=jnp.float32, is_symmetric=True)
    at = rt.sparse_from_scipy(lap, fmt="dia", dtype=torch.float32,
                              is_symmetric=True, device="cpu")
    for seed in seeds:
        v, t, info = rails_tpu.LyapunovSolver(
            aj, jnp.asarray(b, jnp.float32),
            rails_tpu.DiagonalOperator(jnp.asarray(md, jnp.float32)),
            dtype=jnp.float32, seed=seed, **opts).solve()
        print(f"rails_tpu       seed {seed}: {info.iter} iterations, "
              f"res {info.res:.3e}, true {true_residual(lap, md, b, v, t):.3e}")
        v, t, info = rt.solve(at, b, rt.DiagonalOperator(md, device="cpu"),
                              dtype=torch.float32, seed=seed, device="cpu",
                              **opts)
        print(f"rails_tpu_torch seed {seed}: {info.iter} iterations, "
              f"res {info.res:.3e}, true "
              f"{true_residual(lap, md, b, v.numpy(), t.numpy()):.3e}")


if __name__ == "__main__":
    {"drift": drift, "f32": f32}[sys.argv[1]]()
