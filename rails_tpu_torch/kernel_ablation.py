"""Where the dense-window kernel's time goes: time ``csrc/wide_spmm.cu``
beside copies of it with one part of its work cut out.

    python3 -m rails_tpu_torch.kernel_ablation [--bench] [--continuation]

Each copy is the kernel's source with text substitutions (``CUTS``),
built with nvcc for sm_90a into ``build/kernel_ablation/`` and timed with
CUDA events at timing_wide's continuation shapes (side 128, s = 200, six
and three passes) and, with ``--bench``, the JAX bench's ELL geometry
(m = 2^21, s = 192 and 256, three passes).  The copies compute wrong
answers (their error against the plain version is printed) and say only
what each part costs: ``no_mma`` drops the tensor-core products,
``no_mma_no_x`` also the x loads, ``no_mma_no_planes`` the plane loads
instead.  ``--continuation`` then runs chip_smoke.py's continuation_wide
twice, its wide applies through the kernel and through the plain version
on the card, to show how far the iteration counts move with the float32
sum order alone.  Needs a CUDA card and nvcc; prints one JSON line per
case and the card's name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from rails_tpu_torch import _build
from rails_tpu_torch.sparse import wide_spmm as wm

NO_MMA = ("if (!__any_sync(0xffffffffu, any != 0)) return;", "return;")
NO_X = ("if (xc + h < cols) cp_async16_zfill(dst + h, src + h, live);", ";")
NO_PLANES = ("cp_async16(dst + row * PROW + c8, src + row * CHUNK + c8);",
             ";")
CUTS = {"kernel": [], "no_mma": [NO_MMA], "no_mma_no_x": [NO_MMA, NO_X],
        "no_mma_no_planes": [NO_MMA, NO_PLANES]}
OUT = _build.BUILD_DIR.parent / "kernel_ablation"


def build():
    """Every copy, one nvcc each, in parallel; name -> C entry point."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.sources()["wide_spmm"].read_text()
    procs = {}
    for name, subs in CUTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{name}: {old!r} not in the source")
            text = text.replace(old, new)
        cu = OUT / f"{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{name}: nvcc failed\n{log}")
        fn = ctypes.CDLL(str(OUT / f"{name}.so")).rails_wide_spmm_f32
        fn.restype = ctypes.c_int
        fn.argtypes = wm._kernel_fn().argtypes
        fns[name] = fn
    return fns


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

    fns = build()
    gen = torch.Generator("cuda").manual_seed(0)
    f32 = torch.float32
    cont = sparse_from_scipy(cs.continuation_jacobian(cs.CONT_SIDE, 0.05),
                             fmt="ell", dtype=f32).fwd
    cases = [("continuation s=200", wm.build_wide_window(cont, passes=p),
              200, 200) for p in (6, 3)]
    if "--bench" in argv:
        bench = sparse_from_scipy(cs.banded_ell(1 << 21, 1 << 21, 8, 64, 0,
                                                seed=0), fmt="ell",
                                  dtype=f32).fwd
        bw = wm.build_wide_window(bench, passes=3)
        cases += [("bench s=192", bw, 192, 10), ("bench s=256", bw, 256, 10)]
    kernel_fn = wm._kernel_fn()
    try:
        for label, wide, s, reps in cases:
            xs = [cs.random_x(torch, wide.shape[1], s, f32, gen)
                  for _ in range(2)]
            ref = wm.wide_spmm_reference(wide, xs[0])
            for name, fn in fns.items():
                wm._FN[:] = [fn]
                y = wm.wide_spmm(wide, xs[0])
                err = ((y - ref).abs().max() / ref.abs().max()).item()
                ms = cs.time_ms(torch, wm.wide_spmm,
                                [(wide, x) for x in xs], reps)
                cs.emit({"case": label, "passes": wide.passes, "copy": name,
                         "us": ms * 1e3, "rel_err": err})
    finally:
        wm._FN[:] = [kernel_fn]
    if "--continuation" in argv:
        continuation(cs)
    print(cs.nvidia_smi_line(), flush=True)


def continuation(cs):
    import rails_tpu_torch as rt
    from rails_tpu_torch.sparse import ell_spmm as em

    kernel = em.wide_spmm

    def plain(wide, x):
        wm.wide_spmm.launches += 1       # the phase checks the dispatch
        return wm.wide_spmm_reference(wide, x)

    try:
        for label, fn in (("kernel", kernel), ("plain", plain)):
            em.wide_spmm = fn
            out = cs.run_continuation_wide(torch, rt, em, wm)
            cs.emit({"continuation_wide": label,
                     "iters": [st["iters"] for st in out["steps"]],
                     "res_true_f64": [st["res_true_f64"]
                                      for st in out["steps"]]})
    finally:
        em.wide_spmm = kernel


if __name__ == "__main__":
    main(sys.argv[1:])
