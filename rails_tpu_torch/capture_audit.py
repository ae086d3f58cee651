"""Which calls of the solver's iteration capture into a CUDA graph on this
card, and what the calls that do not capture cost - the measurements
behind ``core/engine.py``'s split of the iteration into graph segments
and host steps.

    python3 -m rails_tpu_torch.capture_audit

Each call runs in a process of its own (a capture that fails can leave
its process's CUDA state unusable): eager once, warmed up on a side
stream, then captured with ``torch.cuda.graph`` and replayed.  One JSON
line: per call, whether it captured (else the error), its replay and
eager ms, and for the captured ones the largest difference from the
eager result; the eager ms of the solver's dense calls at solve_f64's
sizes (184 x 184 and the 16 x 16 Lanczos tridiagonal, float64), of one
restart rotation (65,536 x 184 by 184 x 184, float64), and whether this
torch has conditional graph nodes (``begin_capture_to_if_node``).
cuSOLVER's syevd, syevj and Xsyevd are called directly through ctypes
with their workspace allocated before the capture, to tell the library
apart from PyTorch's own ``info`` check.
"""

from __future__ import annotations

import ctypes
import glob
import json
import os
import subprocess
import sys
import time

K, M = 184, 65536      # solve_f64's capacity and rows

CALLS = ("eigh", "eigvalsh", "cusolver_syevd", "cusolver_syevj",
         "cusolver_xsyevd", "cholesky_ex", "solve_ex", "inv_ex",
         "lu_factor_ex", "slogdet", "solve_triangular", "lu_solve",
         "argsort", "randn_registered")


def _cusolver():
    import torch

    for name in ("libcusolver.so.11", "libcusolver.so"):
        try:
            return ctypes.CDLL(name)
        except OSError:
            pass
    base = os.path.dirname(torch.__file__)
    for path in glob.glob(os.path.join(base, "..", "nvidia", "cusolver",
                                       "lib", "libcusolver.so*")):
        return ctypes.CDLL(path)
    raise OSError("libcusolver not found")


def _case(name):
    """(setup, body) of one call at solve_f64's sizes."""
    import torch

    dev = torch.device("cuda")
    gen = torch.Generator(dev).manual_seed(0)
    a = torch.randn(K, K, dtype=torch.float64, device=dev, generator=gen)
    spd = a @ a.T + K * torch.eye(K, dtype=torch.float64, device=dev)
    rhs = torch.randn(K, 8, dtype=torch.float64, device=dev, generator=gen)
    st = {}

    if name.startswith("cusolver"):
        lib = _cusolver()
        h = ctypes.c_void_p()
        if lib.cusolverDnCreate(ctypes.byref(h)):
            raise RuntimeError("cusolverDnCreate failed")
        buf, w = spd.clone(), torch.empty(K, dtype=torch.float64, device=dev)
        info = torch.zeros(1, dtype=torch.int32, device=dev)
        p = ctypes.c_void_p
        lw = ctypes.c_int()
        if name == "cusolver_syevd":
            rc = lib.cusolverDnDsyevd_bufferSize(
                h, 1, 0, K, p(buf.data_ptr()), K, p(w.data_ptr()),
                ctypes.byref(lw))
        elif name == "cusolver_syevj":
            prm = ctypes.c_void_p()
            lib.cusolverDnCreateSyevjInfo(ctypes.byref(prm))
            st["prm"] = prm
            rc = lib.cusolverDnDsyevj_bufferSize(
                h, 1, 0, K, p(buf.data_ptr()), K, p(w.data_ptr()),
                ctypes.byref(lw), prm)
        else:
            prm = ctypes.c_void_p()
            lib.cusolverDnCreateParams(ctypes.byref(prm))
            st["prm"] = prm
            dws, hws = ctypes.c_size_t(), ctypes.c_size_t()
            rc = lib.cusolverDnXsyevd_bufferSize(
                h, prm, 1, 0, ctypes.c_longlong(K), 1, p(buf.data_ptr()),
                ctypes.c_longlong(K), 1, p(w.data_ptr()), 1,
                ctypes.byref(dws), ctypes.byref(hws))
            st["dws"] = torch.empty(max(dws.value, 8), dtype=torch.uint8,
                                    device=dev)
            st["hws"] = ctypes.create_string_buffer(max(hws.value, 8))
            st["nh"] = hws.value
        if rc:
            raise RuntimeError(f"{name} buffer size: status {rc}")
        work = torch.empty(max(lw.value, 1), dtype=torch.float64, device=dev)

        def body():
            lib.cusolverDnSetStream(
                h, p(torch.cuda.current_stream().cuda_stream))
            buf.copy_(spd)
            if name == "cusolver_syevd":
                rc = lib.cusolverDnDsyevd(
                    h, 1, 0, K, p(buf.data_ptr()), K, p(w.data_ptr()),
                    p(work.data_ptr()), lw.value, p(info.data_ptr()))
            elif name == "cusolver_syevj":
                rc = lib.cusolverDnDsyevj(
                    h, 1, 0, K, p(buf.data_ptr()), K, p(w.data_ptr()),
                    p(work.data_ptr()), lw.value, p(info.data_ptr()),
                    st["prm"])
            else:
                rc = lib.cusolverDnXsyevd(
                    h, st["prm"], 1, 0, ctypes.c_longlong(K), 1,
                    p(buf.data_ptr()), ctypes.c_longlong(K), 1,
                    p(w.data_ptr()), 1, p(st["dws"].data_ptr()),
                    ctypes.c_size_t(st["dws"].numel()), st["hws"],
                    ctypes.c_size_t(st["nh"]), p(info.data_ptr()))
            if rc:
                raise RuntimeError(f"{name}: status {rc}")
            return w
        return body, None

    lu = torch.linalg.lu_factor(spd)
    tri = torch.tril(spd)
    bodies = {
        "eigh": lambda: torch.linalg.eigh(spd)[1],
        "eigvalsh": lambda: torch.linalg.eigvalsh(spd),
        "cholesky_ex": lambda: torch.linalg.cholesky_ex(spd)[0],
        "solve_ex": lambda: torch.linalg.solve_ex(spd, rhs)[0],
        "inv_ex": lambda: torch.linalg.inv_ex(spd)[0],
        "lu_factor_ex": lambda: torch.linalg.lu_factor_ex(spd)[0],
        "slogdet": lambda: torch.linalg.slogdet(spd)[1],
        "solve_triangular": lambda: torch.linalg.solve_triangular(
            tri, rhs, upper=False),
        "lu_solve": lambda: torch.linalg.lu_solve(*lu, rhs),
        "argsort": lambda: torch.argsort(-torch.abs(a[0]), stable=True),
        "randn_registered": lambda: torch.randn(
            (M, 1), generator=gen, dtype=torch.float64, device=dev),
    }
    return bodies[name], gen if name == "randn_registered" else None


def _ms(torch, fn, reps=20):
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def audit_one(name):
    import torch

    body, gen = _case(name)
    ref = body().clone()
    eager = _ms(torch, body)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    if gen is not None:
        g.register_generator_state(gen)
    try:
        with torch.cuda.graph(g, stream=side):
            out = body()
    except Exception as e:  # the audit's answer, not a failure
        return {"call": name, "captured": False, "eager_ms": eager,
                "error": repr(e)[:160]}
    g.replay()
    torch.cuda.synchronize()
    row = {"call": name, "captured": True, "eager_ms": eager,
           "replay_ms": _ms(torch, g.replay)}
    if gen is None:
        row["max_abs_diff_vs_eager"] = (
            out.double() - ref.double()).abs().max().item()
    else:
        first = out.clone()
        g.replay()
        torch.cuda.synchronize()
        row["replays_draw_anew"] = not torch.equal(first, out)
    return row


def main():
    if len(sys.argv) == 3 and sys.argv[1] == "--one":
        print(json.dumps(audit_one(sys.argv[2])), flush=True)
        return
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("capture_audit needs a CUDA device")
    rows = []
    for i in range(0, len(CALLS), 7):
        procs = [(c, subprocess.Popen(
            [sys.executable, "-m", "rails_tpu_torch.capture_audit",
             "--one", c], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)) for c in CALLS[i:i + 7]]
        for c, p in procs:
            out, _ = p.communicate(timeout=300)
            lines = [ln for ln in out.splitlines() if ln.startswith("{")]
            rows.append(json.loads(lines[-1]) if lines else
                        {"call": c, "captured": None, "error": out[-300:]})
    dev = torch.device("cuda")
    h = torch.randn(16, 16, dtype=torch.float64, device=dev)
    t = torch.randn(K, K, dtype=torch.float64, device=dev)
    v = torch.randn(M, K, dtype=torch.float64, device=dev)
    print(json.dumps({
        "calls": rows,
        "conditional_nodes": hasattr(torch.cuda.CUDAGraph,
                                     "begin_capture_to_if_node"),
        "eigh_184_ms": _ms(torch, lambda: torch.linalg.eigh(t + t.T)),
        "eigh_16_ms": _ms(torch, lambda: torch.linalg.eigh(h + h.T)),
        "rotation_gemm_ms": _ms(torch, lambda: v @ t),
        "torch": torch.__version__}), flush=True)


if __name__ == "__main__":
    main()
