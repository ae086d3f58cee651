"""Where a kernel's time goes: time a hand-written kernel beside copies of
it with one part of its work cut out.

    python3 -m rails_tpu_torch.kernel_ablation [--bench] [--continuation]
    python3 -m rails_tpu_torch.kernel_ablation --ell [--bench] --dia --halo
    python3 -m rails_tpu_torch.kernel_ablation --cli-draws

Each copy is the kernel's source with text substitutions (``CUTS``),
built with nvcc for sm_90a into ``build/kernel_ablation/`` and timed with
CUDA events (``chip_smoke.time_ms``, rotating through input copies that
exceed the 50 MB L2).  The copies compute wrong answers (their error
against the plain version is printed) and say only what each part costs:

- the dense-window kernel (``csrc/wide_spmm.cu``, the default): at
  timing_wide's continuation shapes (side 128, s = 200, six and three
  passes) and, with ``--bench``, the JAX bench's ELL geometry (m = 2^21,
  s = 192 and 256, three passes); ``no_mma`` drops the tensor-core
  products, ``no_mma_no_x`` also the x loads, ``no_mma_no_planes`` the
  plane loads instead.  ``--continuation`` then runs chip_smoke.py's
  continuation_wide twice, its wide applies through the kernel and
  through the plain version on the card, to show how far the iteration
  counts move with the float32 sum order alone.
- ``--ell``, the ELL kernel (``csrc/ell_spmm.cu``) at the side-256 DAE's
  A22 (f64, s = 8), the continuation shape (f32, s = 200), a mesh_ell
  shard (f64, s = 8) and the JAX bench's ELL geometry (f32, s = 16; with
  ``--bench`` also s = 192 and 256): ``no_x_gathers`` reads no x (from
  shared memory or global), ``no_slot_loads`` reads no indices or
  values, ``no_staging`` reads the slots and gathers x from global
  memory (the first design's data path, in the 2-D tiles).
- ``--dia``, kernel #1 (``csrc/dia_spmm.cu``) at the solve_f64,
  refined_scale and solve_f32 shapes, a mid size (m = 2^19, f64) and the
  JAX bench's geometry (side 1536, s = 16, f32), each copy through the
  branch the plan picks and, where both can run, the other (the
  ``no_staging`` reading): ``no_data`` copies and reads no diagonal
  data, ``no_x`` no x, ``direct_chunk8`` and ``direct_chunk4`` load 8
  or 4 terms at a time at both types; ``rows_<R>`` the staged branch at
  other tile heights; and clock64 stamps of three blocks of the staged
  branch at f64 (block set-up, each tile's issue, landing and
  arithmetic).
- ``--halo``, kernel #3 (``csrc/dia_spmm_halo.cu``) at the mesh solve's
  shard (f64, s = 8) and the bench mesh shard (f32, s = 16): ``no_data``
  reads no diagonal data, ``no_x`` no x or halo rows.

Each of those prints the launch floor (``chip_smoke.launch_floor_ms``)
too.  ``--cli-draws`` runs chip_smoke.py's cli_schur with the solver's
random numbers drawn from a CPU ``torch.Generator`` (the ``draws`` hook),
the draws of a CPU run, to compare its iteration count with the CPU's.
Needs a CUDA card and nvcc; prints one JSON line per case and the card's
name and power limit.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from rails_tpu_torch import _build
from rails_tpu_torch.sparse import ell_spmm as em
from rails_tpu_torch.sparse import spmm
from rails_tpu_torch.sparse import wide_spmm as wm

NO_MMA = ("if (!__any_sync(0xffffffffu, any != 0)) return;", "return;")
NO_X = ("if (xc + h < cols) cp_async16_zfill(dst + h, src + h, live);", ";")
NO_PLANES = ("cp_async16(dst + row * PROW + c8, src + row * CHUNK + c8);",
             ";")
# a load cut keeps its address alive, so the loads it depends on stay
NO_PACK = ("  return *reinterpret_cast<const Pack<T, V>*>(p);",
           "  Pack<T, V> r;\n  for (int e = 0; e < V; ++e) "
           "r.v[e] = T((size_t)p & 1023);\n  return r;")
CUTS = {
    "wide_spmm": {"kernel": [], "no_mma": [NO_MMA],
                  "no_mma_no_x": [NO_MMA, NO_X],
                  "no_mma_no_planes": [NO_MMA, NO_PLANES]},
    "ell_spmm": {"kernel": [], "no_x_gathers": [NO_PACK],
                 "no_slot_loads": [("j[q] = ri[l0 + q];", "j[q] = w0 + q;"),
                                   ("v[q] = rv[l0 + q];", "v[q] = T(0.5);"),
                                   ("const bool slots = slot_bytes > 0;",
                                    "const bool slots = false;")],
                 "no_staging": [("window_bytes > 0 &&", "false &&"),
                                ("const bool slots = slot_bytes > 0;",
                                 "const bool slots = false;")]},
    "dia_spmm": {"kernel": [],
                 "no_data": [("base = reinterpret_cast<const unsigned char*>"
                              "(data);", "base = nullptr;"),
                             ("dv[q] = st[db[k] + r];", "dv[q] = T(k + 1);"),
                             ("dv[q] = __ldg(data + (size_t)k * m + i);",
                              "dv[q] = T(k + 1);")],
                 "no_x": [("base = reinterpret_cast<const unsigned char*>"
                           "(x);", "base = nullptr;"), NO_PACK]},
    "dia_spmm_halo": {"kernel": [],
                      "no_data": [("dv[q] = __ldg(data + (size_t)k * m + i);",
                                   "dv[q] = T(k + 1);")],
                      "no_x": [NO_PACK]},
}
SYMBOLS = {"wide_spmm": {torch.float32: "rails_wide_spmm_f32"},
           "ell_spmm": em._SYMBOLS, "dia_spmm": spmm._SYMBOLS,
           "dia_spmm_halo": spmm._HALO_SYMBOLS}
OUT = _build.BUILD_DIR.parent / "kernel_ablation"


def _real_fn(kernel, dtype):
    return {"wide_spmm": lambda d: wm._kernel_fn(),
            "ell_spmm": em._kernel_fn, "dia_spmm": spmm._kernel_fn,
            "dia_spmm_halo": spmm._halo_kernel_fn}[kernel](dtype)


def build(kernel, cuts=None):
    """Every copy of ``kernel`` (``cuts``: name -> substitutions, default
    ``CUTS[kernel]``), one nvcc each, in parallel; copy name -> {dtype: C
    entry point}."""
    OUT.mkdir(parents=True, exist_ok=True)
    src = _build.sources()[kernel].read_text()
    procs = {}
    for name, subs in (CUTS[kernel] if cuts is None else cuts).items():
        text = src
        for old, new in subs:
            if old not in text:
                raise RuntimeError(f"{kernel} {name}: {old!r} not in the "
                                   f"source")
            text = text.replace(old, new)
        cu = OUT / f"{kernel}-{name}.cu"
        cu.write_text(text)
        procs[name] = subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(cu.with_suffix(
                ".so")), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
    fns = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"{kernel} {name}: nvcc failed\n{log}")
        lib = ctypes.CDLL(str(OUT / f"{kernel}-{name}.so"))
        fns[name] = {}
        for dtype, sym in SYMBOLS[kernel].items():
            fn = getattr(lib, sym)
            fn.restype = ctypes.c_int
            fn.argtypes = _real_fn(kernel, dtype).argtypes
            fns[name][dtype] = fn
    return fns


def run_copies(cs, label, fns, install, dtype, kernel, plain, sets, reps):
    """Time every copy on ``sets``, each put in the wrapper's place for
    its turn by ``install(fn)``, which returns the entry point it
    replaced."""
    ref = plain(*sets[0])
    real = None
    try:
        for name, by_dtype in fns.items():
            prev = install(by_dtype[dtype])
            real = prev if real is None else real
            y = kernel(*sets[0])
            err = ((y - ref).abs().max() / ref.abs().max()).item()
            ms = cs.time_ms(torch, kernel, sets, reps)
            cs.emit({"case": label, "copy": name, "us": ms * 1e3,
                     "rel_err": err})
    finally:
        if real is not None:
            install(real)


def _install_in(table, dtype):
    """``install`` for a wrapper that caches its entry points by dtype."""
    def install(fn):
        prev = table[dtype]
        table[dtype] = fn
        return prev
    return install


def _install_wide(fn):
    prev = wm._kernel_fn()
    wm._FN[:] = [fn]
    return prev


def wide_cases(cs, argv):
    fns = build("wide_spmm")
    gen = torch.Generator("cuda").manual_seed(0)
    f32 = torch.float32
    from rails_tpu_torch.sparse.formats import sparse_from_scipy

    cont = sparse_from_scipy(cs.continuation_jacobian(cs.CONT_SIDE, 0.05),
                             fmt="ell", dtype=f32).fwd
    cases = [(f"continuation s=200, {p} passes",
              wm.build_wide_window(cont, passes=p), 200, 200)
             for p in (6, 3)]
    if "--bench" in argv:
        bench = sparse_from_scipy(cs.banded_ell(1 << 21, 1 << 21, 8, 64, 0,
                                                seed=0), fmt="ell",
                                  dtype=f32).fwd
        bw = wm.build_wide_window(bench, passes=3)
        cases += [("bench s=192", bw, 192, 10), ("bench s=256", bw, 256, 10)]
    for label, wide, s, reps in cases:
        sets = [(wide, cs.random_x(torch, wide.shape[1], s, f32, gen))
                for _ in range(2)]
        run_copies(cs, label, fns, _install_wide, f32, wm.wide_spmm,
                   wm.wide_spmm_reference, sets, reps)


def ell_cases(cs, argv):
    from rails_tpu_torch.sparse.formats import EllMatrix, sparse_from_scipy

    fns = build("ell_spmm")
    gen = torch.Generator("cuda").manual_seed(0)
    f32, f64 = torch.float32, torch.float64
    a, md, _ = cs.laplacian_dae(256)
    _, _, blocks = cs.schur_blocks(a, md)
    cases = [
        ("A22 f64 s=8", sparse_from_scipy(blocks["A22"], fmt="ell",
                                          dtype=f64).fwd, 8, 400),
        ("continuation f32 s=200", sparse_from_scipy(
            cs.continuation_jacobian(cs.CONT_SIDE, 0.05), fmt="ell",
            dtype=f32).fwd, 200, 200),
        ("mesh_ell shard f64 s=8", cs.mesh_ell_shard(torch, _rt()), 8, 400)]
    bench = sparse_from_scipy(cs.banded_ell(1 << 21, 1 << 21, 8, 64, 0,
                                            seed=0), fmt="ell",
                              dtype=f32).fwd
    cases.append(("bench f32 s=16", bench, 16, 50))
    if "--bench" in argv:
        cases += [("bench f32 s=192", bench, 192, 10),
                  ("bench f32 s=256", bench, 256, 10)]
    for label, ell, s, reps in cases:
        dtype = ell.values.dtype
        itemsize = ell.values.element_size()
        nbytes, _ = cs.ell_work(ell, s, itemsize)
        sets = [(EllMatrix(ell.indices.clone(), ell.values.clone(),
                           ell.shape),
                 cs.random_x(torch, ell.shape[1], s, dtype, gen))
                for _ in range(cs.n_copies(nbytes))]
        cs.emit({"case": label, **cs.ell_staging(em, ell, s, itemsize)})
        run_copies(cs, label, fns, _install_in(em._FNS, dtype), dtype,
                   em.ell_spmm, em.ell_spmm_reference, sets, reps)
        del sets


SOLVE = (-256, -1, 0, 1, 256)
# kernel #1's copies beyond CUTS: the direct branch with 8-term load
# chunks at float64 too, or 4-term ones at float32 too, and the staged
# branch with clock64 stamps of one
# block written over its first rows of y (block start = 0): after the
# barrier set-up, after each of its first 4 tiles' issue (warp 0), after
# each wait for a tile's data and after each tile's arithmetic (consumer
# thread 0), at the end
DIA_EXTRA = {
    "direct_chunk8": [("kDirectChunk = sizeof(T) == 8 ? 4 : 8;",
                       "kDirectChunk = 8;")],
    "direct_chunk4": [("kDirectChunk = sizeof(T) == 8 ? 4 : 8;",
                       "kDirectChunk = 4;")],
}
_END = "  }\n}\n\n// " + "-" * 64 + " launch"
DIA_STAMPS = [
    ("  __shared__ int tab[2][2 * kCap];\n  const int R = p.rows;",
     "  __shared__ int tab[2][2 * kCap];\n  __shared__ long long dbg[16];\n"
     "  const long long c0 = clock64();\n  const int R = p.rows;"),
    ("  __syncthreads();\n  int q = 0;",
     "  __syncthreads();\n  if (threadIdx.x == 32) dbg[0] = clock64() - c0;"
     "\n  int q = 0;"),
    ("                     &full[q], t * R, m, n, s, p.d);\n",
     "                     &full[q], t * R, m, n, s, p.d);\n      if "
     "(threadIdx.x == 0 && use < 4) dbg[1 + use] = clock64() - c0;\n"),
    ("    mbar_wait(&full[q], phase);\n",
     "    mbar_wait(&full[q], phase);\n    const int tt = (t - blockIdx.x) "
     "/ gridDim.x;\n    if (ct == 0 && tt < 4) dbg[5 + tt] = clock64() - "
     "c0;\n"),
    ("    if (warp_leader) mbar_arrive(&empty[q]);\n",
     "    if (warp_leader) mbar_arrive(&empty[q]);\n    if (ct == 0 && tt < "
     "4) dbg[9 + tt] = clock64() - c0;\n"),
    (_END, "  }\n  if (ct == 0) {\n    dbg[13] = clock64() - c0;\n    for "
     "(int i = 0; i < 14; ++i) y[(size_t)blockIdx.x * R * s + i] = "
     "(T)dbg[i];\n  }\n}\n\n// " + "-" * 64 + " launch"),
]


def dia_cases(cs, argv):
    """Kernel #1 at the main path's shapes and the JAX bench's: each copy
    (CUTS and ``direct_chunk8``) through the branch its plan picks and,
    where both can run, the other one; the staged branch at other tile
    heights (``rows_<R>``); a mid-size case between the two regimes; the
    clock64 stamps of three blocks of the staged branch."""
    fns = build("dia_spmm", {**CUTS["dia_spmm"], **DIA_EXTRA})
    stamps = build("dia_spmm", {"stamps": DIA_STAMPS})["stamps"]
    gen = torch.Generator("cuda").manual_seed(0)
    sms = spmm._sm_count(torch.device("cuda"))
    f32, f64 = torch.float32, torch.float64
    for label, m, offsets, s, dtype, reps in (
            ("solve_f64 f64 s=8", 65536, SOLVE, 8, f64, 400),
            ("refined_scale f32 s=8", 65536, SOLVE, 8, f32, 400),
            ("solve_f32 f32 s=6", 4096, (-64, -1, 0, 1, 64), 6, f32, 400),
            ("mid f64 m=2^19 s=8", 1 << 19, SOLVE, 8, f64, 200),
            ("bench f32 s=16", 1536 * 1536, (-1536, -1, 0, 1, 1536), 16,
             f32, 50)):
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (len(offsets) * m + 2 * m * s) * itemsize
        sets = [(cs.random_dia(torch, m, m, offsets, dtype, gen),
                 cs.random_x(torch, m, s, dtype, gen))
                for _ in range(cs.n_copies(nbytes))]
        plan = spmm.launch_plan(*sets[0])
        plans = {("staged" if plan.staged else "direct"): plan}
        if plan.stageable:
            other = "direct" if plan.staged else "staged"
            plans[other] = spmm.dia_plan(offsets, m, m, s, itemsize,
                                         plan.vec, branch=other, sms=sms)
        cs.emit({"case": label, "bound_us": cs.bound_ms(
            nbytes + 4 * len(offsets), 0, "float32")[0] * 1e3,
            "plan": plan.summary()})
        for branch, pl in plans.items():
            def kernel(dia, x, pl=pl):
                return spmm.dia_spmm(dia, x, plan=pl)

            run_copies(cs, f"{label} {branch}", fns,
                       _install_in(spmm._FNS, dtype), dtype, kernel,
                       spmm.dia_spmm_reference, sets, reps)
        if plan.stageable:
            for rows in (64, 128, 256, 512):
                pl = spmm.dia_plan(offsets, m, m, s, itemsize, plan.vec,
                                   branch="staged", rows=rows, sms=sms)
                if pl.rows == plans["staged"].rows:
                    continue

                def kernel(dia, x, pl=pl):
                    return spmm.dia_spmm(dia, x, plan=pl)

                cs.emit({"case": f"{label} staged", "copy": f"rows_{rows}",
                         "us": cs.time_ms(torch, kernel, sets, reps) * 1e3,
                         "plan": pl.summary()})
        if dtype == f64 and plan.stageable:
            pl = plans["staged"]
            install = _install_in(spmm._FNS, dtype)
            real = install(stamps[dtype])
            try:
                for r in range(4):
                    y = spmm.dia_spmm(*sets[r % len(sets)], plan=pl)
                torch.cuda.synchronize()
            finally:
                install(real)
            flat = y.reshape(-1)
            for b in (0, pl.grid // 2, pl.grid - 1):
                st = flat[b * pl.rows * s: b * pl.rows * s + 14].tolist()
                cs.emit({"case": f"{label} staged", "stamps_block": b,
                         "cycles": {"setup": st[0], "issued": st[1:5],
                                    "landed": st[5:9], "computed": st[9:13],
                                    "end": st[13]}})
        del sets


def halo_cases(cs, argv):
    fns = build("dia_spmm_halo")
    gen = torch.Generator("cuda").manual_seed(0)
    for label, m_loc, offsets, s, dtype, reps in (
            ("mesh solve shard f64 s=8", 16384, (-256, -1, 0, 1, 256), 8,
             torch.float64, 400),
            ("bench mesh shard f32 s=16", 589824, (-1536, -1, 0, 1, 1536),
             16, torch.float32, 50)):
        lo, hi = -min(offsets), max(offsets)
        itemsize = torch.empty((), dtype=dtype).element_size()
        nbytes = (len(offsets) * m_loc + (lo + 2 * m_loc + hi) * s) \
            * itemsize
        offs = torch.tensor(offsets, dtype=torch.int32, device="cuda")
        sets = [(cs.random_x(torch, len(offsets), m_loc, dtype, gen), offs,
                 cs.random_x(torch, m_loc, s, dtype, gen),
                 cs.random_x(torch, lo, s, dtype, gen),
                 cs.random_x(torch, hi, s, dtype, gen))
                for _ in range(cs.n_copies(nbytes))]

        def dia_spmm_halo(*args, offsets=offsets):
            return spmm.dia_spmm_halo(*args, offsets=offsets)

        run_copies(cs, label, fns, _install_in(spmm._HALO_FNS, dtype),
                   dtype, dia_spmm_halo, spmm.dia_spmm_halo_reference, sets,
                   reps)


def _rt():
    import rails_tpu_torch as rt

    return rt


def main(argv):
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ablation needs a CUDA card")
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke as cs

    chosen = {"--ell", "--dia", "--halo", "--cli-draws"} & set(argv)
    if chosen - {"--cli-draws"}:
        cs.emit({"launch_floor_us": cs.launch_floor_ms(torch) * 1e3})
    if not chosen:
        wide_cases(cs, argv)
    if "--ell" in argv:
        ell_cases(cs, argv)
    if "--dia" in argv:
        dia_cases(cs, argv)
    if "--halo" in argv:
        halo_cases(cs, argv)
    if "--continuation" in argv:
        continuation(cs)
    if "--cli-draws" in argv:
        cli_draws(cs)
    print(cs.nvidia_smi_line(), flush=True)


def continuation(cs):
    import rails_tpu_torch as rt

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


def cli_draws(cs):
    """cli_schur with the solver's draws from a CPU generator seeded as
    the solver seeds its own: the random numbers of a CPU run."""
    import rails_tpu_torch as rt

    base = rt.LyapunovSolver

    class CpuDraws:
        def __init__(self, seed):
            self.gen = torch.Generator("cpu").manual_seed(seed)

        def __call__(self, kind, shape, dtype, device):
            draw = torch.rand if kind == "init_uniform" else torch.randn
            return draw(shape, generator=self.gen, dtype=dtype).to(device)

    class Solver(base):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.draws = CpuDraws(int(self.options.seed))

    rt.LyapunovSolver = Solver
    try:
        out = cs.run_cli_schur(torch, spmm, em, 1e-4,
                               label="cli_schur_cpu_draws")
    finally:
        rt.LyapunovSolver = base
    cs.emit({k: out[k] for k in ("phase", "n", "iters", "converged",
                                 "res_true_f64", "lambda1_rel_diff",
                                 "wall_s", "ell_spmm_launches")})


if __name__ == "__main__":
    main(sys.argv[1:])
