"""DIA SpMM: the hand-written CUDA kernel's wrapper and its plain version.

``dia_spmm(dia, x)`` computes y = A @ x for a ``DiaMatrix`` A (m, n) and a
multivector x (n, s) in the solver's own row-major (m, s) layout:

    y[i, c] = sum_d data[d, i] * x[i + offsets[d], c],

dropping the terms with i + offsets[d] outside [0, n).  On a CUDA tensor
it launches ``csrc/dia_spmm.cu`` (the counterpart of the JAX package's
Pallas kernel ``sparse/spmm.py::_dia_spmm_t_impl``); on a CPU tensor it
runs ``dia_spmm_reference``, the plain PyTorch version.  There is no size
threshold and no fallback: a CUDA tensor goes to the kernel or raises.
``dia_spmm.launches`` counts the kernel's launches.

The kernel has two hand-written branches, and the host plan
(``dia_plan``, integer arithmetic on the payload's offsets tuple, cached
on the payload per (s, itemsize, vec, 16-byte alignment)) picks one:

- *staged*: persistent blocks walk tiles of R rows; per tile one thread
  copies the d data rows and the tile's x segments (the union of the
  rows [i0 + o, i0 + o + R) over the offsets, overlapping ones merged)
  into a ring of shared-memory stages with TMA bulk copies, while the
  block computes the previous tile from shared memory;
- *direct*: kernel #3's design without halos (offsets by value, 2-D
  (row, lane) indexing, loads issued in chunks of terms), where
  staging cannot run: more than ``OFFSETS_CAP`` diagonals, a pointer
  that is not 16-byte aligned, a row wider than one block's lanes, or a
  stage that does not fit shared memory.

Both give the same bits: per element, ``fma`` from 0 in offset order.

``dia_spmm_halo(data_loc, offsets_t, x_loc, hl, hh)`` is the same product
on one row shard of the mesh path (``parallel/halo_spmm.py``), with the
rows the stencil needs below and above the shard given as halos:

    y[i, c] = sum_d data_loc[d, i] * xe[i + offsets[d], c],
    xe = [hl; x_loc; hh]  (hl: rows [-span_lo, 0), hh: [m_loc, m_loc + span_hi))

On a CUDA tensor it launches ``csrc/dia_spmm_halo.cu`` (the counterpart
of the JAX package's ``sparse/spmm.py::_dia_spmm_t_halo_impl``); on a CPU
tensor it runs ``dia_spmm_halo_reference``.  ``dia_spmm_halo.launches``
counts its launches.  A caller that holds the offsets as a host tuple
(``DiaMatrix.offsets``) passes it as ``offsets=``: up to 16 diagonals then
go to the kernel by value (``pack_offsets``), with no device read ahead
of its loads; without it, or past 16, the kernel reads ``offsets_t``.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Tuple

import torch

from rails_tpu_torch.sparse.tiling import column_lanes, vector_width

__all__ = ["DiaPlan", "dia_plan", "launch_plan", "tile_segments",
           "dia_spmm", "dia_spmm_reference", "dia_spmm_halo",
           "dia_spmm_halo_reference", "pack_offsets", "OFFSETS_CAP"]


def dia_spmm_reference(dia, x: torch.Tensor) -> torch.Tensor:
    """The plain version: one slice-multiply-add per diagonal, in offset
    order.  Accepts x of shape (n,) + anything."""
    m, n = dia.shape
    y = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    tail = (1,) * (x.ndim - 1)
    for idx, off in enumerate(dia.offsets):
        lo, hi = max(0, -off), min(m, n - off)
        if hi <= lo:
            continue
        y[lo:hi] += dia.data[idx, lo:hi].reshape((hi - lo,) + tail) \
            * x[lo + off:hi + off]
    return y


OFFSETS_CAP = 16   # diagonals the kernels take by value

# The staged branch's shared memory (an H100 SM: 228 KB, 227 KB a block):
# one stage of a tile is held to STAGE_BUDGET (R = 128 at the JAX bench's
# shape: 134.7 us, against 141.4 at R = 256 with 54 KB stages and 173.6
# at R = 64; an H100 at 700 W, kernel_ablation --dia); a stage above it
# at the smallest tile still runs where two stages (else one) fit
# SMEM_BUDGET.
STAGE_BUDGET = 32 * 1024
SMEM_BUDGET = 200 * 1024
SM_SHARED = 228 * 1024
BLOCK_RESERVE = 1024          # the runtime's shared bytes per block
MAX_BLOCKS_PER_SM = 2         # csrc/dia_spmm.cu: __launch_bounds__(288, 2)
THREADS = 256
TILE_ROWS = (1024, 512, 256, 128, 64, 32)   # R, largest first
MIN_TILES_PER_SM = 2
# The ring overlaps one tile's copies with another's arithmetic only when
# a persistent block walks several tiles; with few the staged branch's
# serial chain (issue, land, compute) is slower than the direct branch,
# so the plan takes the direct branch there (kernel_ablation --dia, an
# H100 at 700 W: 2 tiles per block at the solve's shape, 10.2 against
# 7.2 us; 15.5 per block at m = 2^19, f64, s = 8, 39.6 against 43.3;
# 70 at the JAX bench's, 134.7 against 147.2).
MIN_TILES_PER_BLOCK = 8
H100_SMS = 132


class _PlanPack(ctypes.Structure):
    """csrc/dia_spmm.cu's RailsDiaPlan: the launch's plan and offsets by
    value, per term its segment's first row (relative to the tile's) and
    shared-memory slot."""

    _fields_ = [(name, ctypes.c_int) for name in (
        "staged", "byval", "d", "omin", "omax", "vec", "lanes", "rows",
        "stages", "grid", "stage_bytes", "plane_bytes", "nseg")] + [
        (name, ctypes.c_int * OFFSETS_CAP) for name in (
            "off", "seg_lo", "seg_hi", "seg_slot", "term_lo",
            "term_slot")]


@dataclasses.dataclass(frozen=True)
class DiaPlan:
    """How ``csrc/dia_spmm.cu`` runs one (offsets, m, s, itemsize, vec).

    ``staged``: the staged branch (else the direct one, for the reason in
    ``why``); ``stageable``: the staged branch could run
    (``branch="staged"`` forces it).  ``vec`` columns per lane, ``lanes``
    lanes per column tile, ``col_tiles`` column tiles (the staged branch
    takes a whole row: lanes = s / vec, one tile).  Staged only:
    ``rows`` (R) per tile, ``segments`` the x rows a tile at row i0
    reads, as [i0 + lo, i0 + hi) pairs (lo, hi), each copied as one range
    (clamped to [0, n) by the kernel); ``plane_bytes`` the shared slot of
    one data row,
    ``segment_bytes`` those of the segments (each padded to 16 bytes,
    with room for a start that is not), ``stage_bytes`` their sum,
    ``stages`` of them in a ring, ``grid`` persistent blocks over
    ``tiles`` tiles."""

    staged: bool
    why: str
    stageable: bool
    vec: int
    lanes: int
    col_tiles: int
    rows: int
    segments: Tuple[Tuple[int, int], ...]
    plane_bytes: int
    segment_bytes: Tuple[int, ...]
    stage_bytes: int
    stages: int
    grid: int
    tiles: int
    pack: _PlanPack = dataclasses.field(compare=False, repr=False)

    def summary(self) -> dict:
        """The plan as a JSON-able dict (chip_smoke.py's rows)."""
        return {"staged": self.staged, "why": self.why,
                "stageable": self.stageable, "vec": self.vec,
                "lanes": self.lanes, "rows": self.rows,
                "segments": [list(g) for g in self.segments],
                "stage_bytes": self.stage_bytes, "stages": self.stages,
                "grid": self.grid, "tiles": self.tiles}


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def _slot(nbytes: int, itemsize: int, aligned: bool) -> int:
    """Shared bytes for a piece of ``nbytes``: its start is rounded down
    to 16 bytes (by up to 16 - itemsize) and its end up."""
    return _align16(nbytes if aligned else nbytes + 16 - itemsize)


def tile_segments(offsets, rows: int) -> Tuple[Tuple[int, int], ...]:
    """The union of [o, o + rows) over the offsets, overlapping intervals
    merged (touching ones are not), in increasing order."""
    out = []
    for lo in sorted(set(int(o) for o in offsets)):
        if out and lo < out[-1][1]:
            out[-1][1] = max(out[-1][1], lo + rows)
        else:
            out.append([lo, lo + rows])
    return tuple((lo, hi) for lo, hi in out)


def _stage(offsets, m, s, itemsize, rows):
    """(segments, plane slot, segment slots, stage bytes) at R = rows."""
    segs = tile_segments(offsets, rows)
    plane = _slot(rows * itemsize, itemsize, (m * itemsize) % 16 == 0)
    row_aligned = (s * itemsize) % 16 == 0
    seg_bytes = tuple(_slot((hi - lo) * s * itemsize, itemsize,
                            row_aligned) for lo, hi in segs)
    return segs, plane, seg_bytes, len(offsets) * plane + sum(seg_bytes)


def dia_plan(offsets, m: int, n: int, s: int, itemsize: int, vec: int, *,
             aligned: bool = True, sms: int = H100_SMS,
             branch: str = "auto", rows: int = 0) -> DiaPlan:
    """The kernel's plan, from host integers only.  ``aligned``: the data
    and x pointers are 16-byte aligned (the bulk copy's rule).  ``sms``:
    the card's SM count.  ``branch``: "auto", or "staged" / "direct" to
    force one (raises where staging cannot run).  ``rows``: force R.

    R is the largest of ``TILE_ROWS`` whose stage fits ``STAGE_BUDGET``
    and that gives every SM ``MIN_TILES_PER_SM`` tiles; failing the
    second, the smallest whose stage fits (the most tiles); failing
    both, the smallest.  "auto" stages where staging can run and every
    persistent block walks ``MIN_TILES_PER_BLOCK`` tiles or more."""
    offs = [int(o) for o in offsets]
    d = len(offs)
    if branch not in ("auto", "staged", "direct"):
        raise ValueError(f"dia_plan: branch {branch!r}")
    units = -(-s // vec)
    why = ""
    if d == 0 or d > OFFSETS_CAP:
        why = f"{d} diagonals (staging takes 1 to {OFFSETS_CAP})"
    elif not aligned:
        why = "a data or x pointer is not 16-byte aligned"
    elif s % vec or units > THREADS:
        why = f"a row of {units} lanes is wider than a block"
    choice = None
    if not why:
        cands = (int(rows),) if rows else TILE_ROWS
        fits = [r for r in cands
                if _stage(offs, m, s, itemsize, r)[3] <= STAGE_BUDGET]
        many = [r for r in fits if -(-m // r) >= MIN_TILES_PER_SM * sms]
        r = many[0] if many else fits[-1] if fits else cands[-1]
        segs, plane, seg_bytes, stage = _stage(offs, m, s, itemsize, r)
        stages = 2 if 2 * stage <= SMEM_BUDGET else 1
        if stage > SMEM_BUDGET:
            why = f"one stage of {stage} bytes passes {SMEM_BUDGET}"
        else:
            tiles = -(-m // r)
            per_sm = min(MAX_BLOCKS_PER_SM,
                         SM_SHARED // (stages * stage + BLOCK_RESERVE))
            grid = max(1, min(tiles, sms * per_sm))
            choice = (r, segs, plane, seg_bytes, stage, stages, tiles, grid)
    stageable = choice is not None
    if branch == "staged" and not stageable:
        raise ValueError(f"dia_plan: the staged branch cannot run: {why}")
    if branch == "direct" and stageable:
        choice, why = None, "forced"
    elif branch == "auto" and stageable \
            and choice[6] < MIN_TILES_PER_BLOCK * choice[7]:
        why = (f"{choice[6]} tiles for {choice[7]} blocks: fewer than "
               f"{MIN_TILES_PER_BLOCK} per block")
        choice = None
    pk = _PlanPack(d=d, vec=vec, byval=int(d <= OFFSETS_CAP),
                   omin=min(offs, default=0), omax=max(offs, default=0))
    if d <= OFFSETS_CAP:
        pk.off[:d] = offs
    if choice is None:
        lanes, col_tiles = column_lanes(s, vec)
        rpb = THREADS // lanes
        pk.lanes = lanes
        return DiaPlan(staged=False, why=why, stageable=stageable,
                       vec=vec, lanes=lanes,
                       col_tiles=col_tiles, rows=0, segments=(),
                       plane_bytes=0, segment_bytes=(), stage_bytes=0,
                       stages=0, grid=-(-m // rpb) * col_tiles,
                       tiles=-(-m // rpb), pack=pk)
    r, segs, plane, seg_bytes, stage, stages, tiles, grid = choice
    slots = [d * plane]
    for b in seg_bytes[:-1]:
        slots.append(slots[-1] + b)
    pk.staged, pk.lanes, pk.rows = 1, units, r
    pk.stages, pk.grid, pk.stage_bytes, pk.plane_bytes = \
        stages, grid, stage, plane
    pk.nseg = len(segs)
    for g, (lo, hi) in enumerate(segs):
        pk.seg_lo[g], pk.seg_hi[g], pk.seg_slot[g] = lo, hi, slots[g]
    for k, o in enumerate(offs):
        g = next(g for g, (lo, hi) in enumerate(segs) if lo <= o < hi)
        pk.term_lo[k], pk.term_slot[k] = segs[g][0], slots[g]
    return DiaPlan(staged=True, why="", stageable=True, vec=vec,
                   lanes=units, col_tiles=1,
                   rows=r, segments=segs, plane_bytes=plane,
                   segment_bytes=seg_bytes, stage_bytes=stage,
                   stages=stages, grid=grid, tiles=tiles, pack=pk)


_SMS = {}


def _sm_count(device) -> int:
    """The card's SM count, read once per device."""
    idx = device.index if device.index is not None \
        else torch.cuda.current_device()
    if idx not in _SMS:
        _SMS[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _SMS[idx]


def launch_plan(dia, x: torch.Tensor) -> DiaPlan:
    """The plan ``dia_spmm(dia, x)`` runs, cached on the payload per (s,
    itemsize, vec, 16-byte alignment of data and x).  y is the wrapper's
    own allocation, so aligned: the pointers that matter are x's and the
    data's."""
    s, itemsize = x.shape[1], x.element_size()
    vec = vector_width(s, itemsize, x.data_ptr())
    aligned = (dia.data.data_ptr() | x.data_ptr()) % 16 == 0
    cache = dia.__dict__.setdefault("_plans", {})
    key = (s, itemsize, vec, aligned)
    plan = cache.get(key)
    if plan is None:
        m, n = dia.shape
        plan = cache[key] = dia_plan(dia.offsets, m, n, s, itemsize, vec,
                                     aligned=aligned,
                                     sms=_sm_count(x.device))
    return plan


_SYMBOLS = {torch.float32: "rails_dia_spmm_f32",
            torch.float64: "rails_dia_spmm_f64"}
_FNS = {}


def _kernel_fn(dtype):
    """The C entry point for ``dtype``; builds and loads at first use."""
    fn = _FNS.get(dtype)
    if fn is None:
        from rails_tpu_torch import _build

        fn = getattr(_build.load("dia_spmm"), _SYMBOLS[dtype])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(_PlanPack),
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p]
        _FNS[dtype] = fn
    return fn


INDEX_LIMIT = 2 ** 31 - 1   # the kernel's rows and row + offset are int32


def dia_spmm(dia, x: torch.Tensor, plan: DiaPlan = None) -> torch.Tensor:
    """y = A @ x.  CPU tensors: the plain version.  CUDA tensors: the
    kernel, after checking device, dtype, shape, contiguity and the
    kernel's 32-bit row index.  ``plan``: a ``dia_plan`` for this
    payload and x to run in place of the cached one (to force a
    branch)."""
    if x.device.type == "cpu":
        return dia_spmm_reference(dia, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        # the C side launches on the calling thread's current device
        with torch.cuda.device(x.device):
            return dia_spmm(dia, x, plan)
    m, n = dia.shape
    data, offs = dia.data, dia.offsets_t
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"dia_spmm kernel takes float32 or float64, "
                        f"got {x.dtype}")
    if data.dtype != x.dtype:
        raise TypeError(f"dia_spmm: data {data.dtype} != x {x.dtype}")
    if data.device != x.device or offs.device != x.device:
        raise ValueError(f"dia_spmm: payload on {data.device}, x on "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"dia_spmm: x shape {tuple(x.shape)} does not "
                         f"match A shape {dia.shape}")
    if not (x.is_contiguous() and data.is_contiguous()
            and offs.is_contiguous()):
        raise ValueError("dia_spmm: x, data and offsets must be contiguous")
    reach = max((abs(o) for o in dia.offsets), default=0) + TILE_ROWS[0]
    if max(m, n) + reach > INDEX_LIMIT:
        raise ValueError(f"dia_spmm: {max(m, n)} rows with offsets up to "
                         f"{reach - TILE_ROWS[0]} overflow the kernel's "
                         f"32-bit row index")
    s = x.shape[1]
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    auto = launch_plan(dia, x)
    if plan is None:
        plan = auto
    elif (plan.pack.d != len(dia.offsets) or plan.vec != auto.vec
          or (plan.staged and (data.data_ptr() | x.data_ptr()) % 16)):
        raise ValueError("dia_spmm: the plan is not for this payload and x")
    fn = _kernel_fn(x.dtype)
    rc = fn(data.data_ptr(), ctypes.byref(plan.pack), offs.data_ptr(),
            x.data_ptr(), y.data_ptr(), m, n, s,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmm kernel launch failed: cudaError {rc}")
    dia_spmm.launches += 1
    return y


dia_spmm.launches = 0


def _span(h) -> int:
    return 0 if h is None else int(h.shape[0])


def dia_spmm_halo_reference(data_loc: torch.Tensor, offsets_t: torch.Tensor,
                            x_loc: torch.Tensor, hl, hh,
                            out=None) -> torch.Tensor:
    """The plain version: one slice-multiply-add per diagonal, in offset
    order, over the extended operand [hl; x_loc; hh] (``None`` for an
    empty halo).  Terms outside the extended rows are dropped."""
    m, s = x_loc.shape
    lo = _span(hl)
    xe = torch.cat([h for h in (hl, x_loc, hh) if h is not None])
    ext = xe.shape[0]
    y = torch.zeros((m, s), dtype=x_loc.dtype, device=x_loc.device) \
        if out is None else out.zero_()
    for idx, off in enumerate(offsets_t.tolist()):
        a, b = max(0, -lo - off), min(m, ext - lo - off)
        if b <= a:
            continue
        y[a:b] += data_loc[idx, a:b, None] * xe[a + lo + off:b + lo + off]
    return y


class _OffsetPack(ctypes.Structure):
    """csrc/dia_spmm_halo.cu's RailsHaloOffsets: the diagonal count, min(0,
    offsets), max(0, offsets) and up to OFFSETS_CAP offsets."""

    _fields_ = [("d", ctypes.c_int), ("omin", ctypes.c_int),
                ("omax", ctypes.c_int),
                ("off", ctypes.c_int * OFFSETS_CAP)]


def pack_offsets(offsets):
    """The halo kernel's by-value offsets for a host sequence, or None
    when there are more than OFFSETS_CAP (the kernel then reads the
    device array)."""
    offs = [int(o) for o in offsets]
    if len(offs) > OFFSETS_CAP:
        return None
    pk = _OffsetPack(len(offs), min([0] + offs), max([0] + offs))
    pk.off[:len(offs)] = offs
    return pk


_HALO_SYMBOLS = {torch.float32: "rails_dia_spmm_halo_f32",
                 torch.float64: "rails_dia_spmm_halo_f64"}
_HALO_FNS = {}


def _halo_kernel_fn(dtype):
    """The halo kernel's C entry point for ``dtype``; builds and loads at
    first use."""
    fn = _HALO_FNS.get(dtype)
    if fn is None:
        from rails_tpu_torch import _build

        fn = getattr(_build.load("dia_spmm_halo"), _HALO_SYMBOLS[dtype])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.POINTER(_OffsetPack),
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        _HALO_FNS[dtype] = fn
    return fn


def dia_spmm_halo(data_loc: torch.Tensor, offsets_t: torch.Tensor,
                  x_loc: torch.Tensor, hl, hh, out=None,
                  offsets=None) -> torch.Tensor:
    """y = A_loc @ [hl; x_loc; hh] for one row shard: ``data_loc`` (d,
    m_loc), ``offsets_t`` (d,) int32, ``x_loc`` (m_loc, s), ``hl``
    (span_lo, s) and ``hh`` (span_hi, s), ``None`` where a span is 0.
    Offsets are expected within [-span_lo, span_hi]; terms outside the
    extended rows are dropped.  ``out``: optional (m_loc, s) tensor to
    write y into (a shard's rows of a global y).  ``offsets``: the same
    offsets as a host sequence, when the caller holds one (it is trusted
    to equal ``offsets_t``).  CPU tensors: the plain version.  CUDA
    tensors: the kernel, after checking device, dtype, shape and
    contiguity."""
    if x_loc.device.type == "cpu":
        return dia_spmm_halo_reference(data_loc, offsets_t, x_loc, hl, hh,
                                       out)
    if x_loc.device.type != "cuda":
        raise ValueError(f"dia_spmm_halo: unsupported device {x_loc.device}")
    if x_loc.device.index != torch.cuda.current_device():
        with torch.cuda.device(x_loc.device):
            return dia_spmm_halo(data_loc, offsets_t, x_loc, hl, hh, out,
                                 offsets)
    if x_loc.dtype not in _HALO_SYMBOLS:
        raise TypeError(f"dia_spmm_halo kernel takes float32 or float64, "
                        f"got {x_loc.dtype}")
    if x_loc.ndim != 2:
        raise ValueError(f"dia_spmm_halo: x_loc must be (m_loc, s), got "
                         f"{tuple(x_loc.shape)}")
    m, s = x_loc.shape
    d = offsets_t.shape[0]
    if offsets_t.dtype != torch.int32 or offsets_t.ndim != 1:
        raise TypeError("dia_spmm_halo: offsets_t must be a 1-D int32 tensor")
    if tuple(data_loc.shape) != (d, m):
        raise ValueError(f"dia_spmm_halo: data_loc {tuple(data_loc.shape)} "
                         f"!= ({d}, {m})")
    if out is None:
        out = torch.empty((m, s), dtype=x_loc.dtype, device=x_loc.device)
    args = {"data_loc": data_loc, "x_loc": x_loc, "out": out}
    for name, h in (("hl", hl), ("hh", hh)):
        if h is not None:
            if h.ndim != 2 or h.shape[1] != s:
                raise ValueError(f"dia_spmm_halo: {name} "
                                 f"{tuple(h.shape)} is not (span, {s})")
            args[name] = h
    for name, t in args.items():
        if t.dtype != x_loc.dtype:
            raise TypeError(f"dia_spmm_halo: {name} {t.dtype} != x_loc "
                            f"{x_loc.dtype}")
        if t.device != x_loc.device:
            raise ValueError(f"dia_spmm_halo: {name} on {t.device}, x_loc "
                             f"on {x_loc.device}")
        if not t.is_contiguous():
            raise ValueError(f"dia_spmm_halo: {name} must be contiguous")
    if tuple(out.shape) != (m, s):
        raise ValueError(f"dia_spmm_halo: out {tuple(out.shape)} != "
                         f"({m}, {s})")
    if offsets_t.device != x_loc.device or not offsets_t.is_contiguous():
        raise ValueError("dia_spmm_halo: offsets_t must be contiguous on "
                         "x_loc's device")
    if offsets is not None and len(offsets) != d:
        raise ValueError(f"dia_spmm_halo: {len(offsets)} host offsets for "
                         f"{d} diagonals")
    if m == 0 or s == 0:
        return out
    lo, hi = _span(hl), _span(hh)
    pk = None if offsets is None else pack_offsets(offsets)
    vec = vector_width(s, x_loc.element_size(),
                       *(t.data_ptr() for t in (x_loc, out, hl, hh)
                         if t is not None and t.numel()))
    lanes, _ = column_lanes(s, vec)
    fn = _halo_kernel_fn(x_loc.dtype)
    rc = fn(data_loc.data_ptr(), None if pk is None else ctypes.byref(pk),
            offsets_t.data_ptr(), d, x_loc.data_ptr(),
            hl.data_ptr() if lo else None, hh.data_ptr() if hi else None,
            out.data_ptr(), m, lo, hi, s, vec, lanes,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"dia_spmm_halo kernel launch failed: "
                           f"cudaError {rc}")
    dia_spmm_halo.launches += 1
    return out


dia_spmm_halo.launches = 0
