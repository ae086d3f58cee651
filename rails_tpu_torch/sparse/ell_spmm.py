"""ELL SpMM: the hand-written CUDA kernel's wrapper and its plain version.

``ell_spmm(ell, x)`` computes y = A @ x for an ``EllMatrix`` A (m, n) and
a multivector x (n, s) in the solver's own row-major (m, s) layout:

    y[i, c] = sum_l values[i, l] * x[indices[i, l], c].

m and n may differ (the Schur split's A12 is n1 x n2, A21 n2 x n1).  On
a CUDA tensor it launches ``csrc/ell_spmm.cu``, the counterpart of the
JAX package's three Pallas schedules of this product
(``sparse/ell_spmm.py::_ell_spmm_t_impl``, ``_ell_spmm_t_nc_impl`` and
``_ell_spmm_t_sliced_impl``); on a CPU tensor it runs
``ell_spmm_reference``, the plain PyTorch version.  There is no fallback:
a CUDA tensor goes to the kernel or raises.  ``ell_spmm.launches`` counts
the kernel's launches.

Dispatch to the dense-window kernel: on a CUDA tensor, an ``EllMatrix``
that carries a ``wide`` payload and a float32 x with at least
``wide.min_s`` columns goes to ``sparse/wide_spmm.py::wide_spmm``
(``csrc/wide_spmm.cu``) instead - the JAX package's rule
(rails_tpu/sparse/ell_spmm.py:644-649), without its TPU memory gate.  On
a CPU tensor the apply stays the plain ELL product, as the JAX package's
dispatch is off the TPU.

The kernel's plan (``ell_plan``): each lane owns ``vec`` adjacent
columns (4 float32 or 2 float64 where s and the pointers allow), a block
covers a tile of ``EllMatrix.TILE_ROWS`` rows by one column tile, and a
tile whose window of x rows (``EllMatrix.window_rows``) fits the shared
bytes is staged there by the kernel, as are the tile's indices and
values; the plan is cached on the payload per (s, itemsize, vec), and
computing it reads nothing from the device.
"""

from __future__ import annotations

import ctypes
import dataclasses

import numpy as np
import torch

from rails_tpu_torch.sparse.tiling import TILE_ROWS, column_lanes, \
    vector_width
from rails_tpu_torch.sparse.wide_spmm import wide_spmm

__all__ = ["EllPlan", "ell_plan", "ell_spmm", "ell_spmm_reference",
           "wide_eligible", "WINDOW_BUDGET", "SLOT_BUDGET"]

# shared bytes a block may give its x window, and its tile's slots: with
# both full, two blocks share an SM's 227 KB; at the bench geometry (8 KB
# of slots), three
WINDOW_BUDGET = 64 * 1024
SLOT_BUDGET = 24 * 1024
# a staged row of a column tile carries at least this many bytes (or the
# whole row): a narrower tile would re-read the slots for little reuse
MIN_STAGED_ROW_BYTES = 128


def ell_spmm_reference(ell, x: torch.Tensor) -> torch.Tensor:
    """The plain version: one ``index_select`` and multiply-add per slot,
    in slot order (the JAX package's ``EllMatrix.matmat``).  Accepts x of
    shape (n,) + anything."""
    m, n = ell.shape
    y = torch.zeros((m,) + tuple(x.shape[1:]), dtype=x.dtype,
                    device=x.device)
    if n == 0:
        return y
    vshape = (m,) + (1,) * (x.ndim - 1)
    for l in range(ell.indices.shape[1]):
        y = y + ell.values[:, l].reshape(vshape) * x.index_select(
            0, ell.indices[:, l])
    return y


def wide_eligible(ell, x: torch.Tensor) -> bool:
    """Does a CUDA apply of ``ell`` to ``x`` go to the dense-window
    kernel?  Only for a ``wide`` payload and a float32 (n, s) x with
    s >= ``wide.min_s``."""
    wide = getattr(ell, "wide", None)
    return (wide is not None and x.dtype == torch.float32 and x.ndim == 2
            and x.shape[1] >= wide.min_s)


@dataclasses.dataclass(frozen=True)
class EllPlan:
    """How ``csrc/ell_spmm.cu`` runs one (payload, s, dtype, vec):
    ``lanes`` lanes of ``vec`` columns per column tile (``col_tile`` =
    lanes * vec columns, ``col_tiles`` of them), ``window_bytes`` of
    shared memory for a tile's x window (0: no tile is staged),
    ``slot_bytes`` for its indices and values (0: read from the payload),
    and ``staged`` row tiles of ``tiles`` whose window fits."""

    vec: int
    lanes: int
    col_tile: int
    col_tiles: int
    window_bytes: int
    slot_bytes: int
    staged: int
    tiles: int

    @property
    def staged_share(self) -> float:
        return self.staged / self.tiles if self.tiles else 0.0


def _align16(nbytes: int) -> int:
    return (nbytes + 15) // 16 * 16


def ell_plan(window_rows, slots: int, s: int, itemsize: int,
             vec: int) -> EllPlan:
    """The kernel's plan from the payload's row-tile window widths
    (``EllMatrix.window_rows``) and its ``slots`` per row (L).  The
    column tile is as wide as the median window lets a staged tile fit
    ``WINDOW_BUDGET`` bytes (at most ``MAX_LANES`` lanes); when that is narrower
    than a 128-byte row (and than s), nothing is staged and the column
    tile is as wide as it goes.  A tile is staged when window * col_tile
    * itemsize <= window_bytes - the kernel's own test - and window_bytes
    is the largest such need, so a launch asks for no more shared memory
    than its tiles use.  The tile's slots go to shared memory when they
    fit ``SLOT_BUDGET``, laid out as the kernel lays them out."""
    w = np.asarray(window_rows, dtype=np.int64)
    s_row = -(-s // vec) * vec
    if w.size:
        fit = WINDOW_BUDGET // (max(int(np.median(w)), 1) * itemsize) \
            // vec * vec
    else:
        fit = 0
    if fit >= min(s_row, max(vec, MIN_STAGED_ROW_BYTES // itemsize)):
        lanes, col_tiles = column_lanes(s, vec, fit)
        need = w * (lanes * vec * itemsize)
        fits = need <= WINDOW_BUDGET
        window = int(need[fits].max()) if fits.any() else 0
        staged = int(fits.sum()) if window > 0 else 0
    else:
        lanes, col_tiles = column_lanes(s, vec)
        window = staged = 0
    slot_bytes = _align16(TILE_ROWS * slots * 4) \
        + _align16(TILE_ROWS * slots * itemsize)
    if slot_bytes > SLOT_BUDGET:
        slot_bytes = 0
    return EllPlan(vec=vec, lanes=lanes, col_tile=lanes * vec,
                   col_tiles=col_tiles, window_bytes=window,
                   slot_bytes=slot_bytes, staged=staged, tiles=int(w.size))


def _plan_for(ell, x: torch.Tensor, y: torch.Tensor) -> EllPlan:
    """The launch's plan, cached on the payload per (s, itemsize, vec)."""
    s, itemsize = x.shape[1], x.element_size()
    vec = vector_width(s, itemsize, x.data_ptr(), y.data_ptr())
    cache = ell.__dict__.setdefault("_plans", {})
    key = (s, itemsize, vec)
    plan = cache.get(key)
    if plan is None:
        plan = cache[key] = ell_plan(ell.window_rows, ell.indices.shape[1],
                                     s, itemsize, vec)
    return plan


_SYMBOLS = {torch.float32: "rails_ell_spmm_f32",
            torch.float64: "rails_ell_spmm_f64"}
_FNS = {}


def _kernel_fn(dtype):
    """The C entry point for ``dtype``; builds and loads at first use."""
    fn = _FNS.get(dtype)
    if fn is None:
        from rails_tpu_torch import _build

        fn = getattr(_build.load("ell_spmm"), _SYMBOLS[dtype])
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        _FNS[dtype] = fn
    return fn


def ell_spmm(ell, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CPU tensors: the plain version.  CUDA tensors: the
    kernel, after checking device, dtype, shape and contiguity (the
    indices were checked to lie in [0, n) when the ``EllMatrix`` was
    built)."""
    if x.device.type == "cpu":
        return ell_spmm_reference(ell, x)
    if x.device.type != "cuda":
        raise ValueError(f"ell_spmm: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        # the C side launches on the calling thread's current device
        with torch.cuda.device(x.device):
            return ell_spmm(ell, x)
    if wide_eligible(ell, x):
        return wide_spmm(ell.wide, x)
    m, n = ell.shape
    idx, val = ell.indices, ell.values
    if x.dtype not in _SYMBOLS:
        raise TypeError(f"ell_spmm kernel takes float32 or float64, "
                        f"got {x.dtype}")
    if val.dtype != x.dtype:
        raise TypeError(f"ell_spmm: values {val.dtype} != x {x.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"ell_spmm: indices must be int32, got {idx.dtype}")
    if val.device != x.device or idx.device != x.device:
        raise ValueError(f"ell_spmm: payload on {val.device}, x on "
                         f"{x.device}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"ell_spmm: x shape {tuple(x.shape)} does not "
                         f"match A shape {ell.shape}")
    if not (x.is_contiguous() and val.is_contiguous()
            and idx.is_contiguous()):
        raise ValueError("ell_spmm: x, indices and values must be "
                         "contiguous")
    s = x.shape[1]
    if m == 0 or s == 0 or n == 0:
        # nothing to gather from (n == 0: every value is padding)
        return torch.zeros((m, s), dtype=x.dtype, device=x.device)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    plan = _plan_for(ell, x, y)
    fn = _kernel_fn(x.dtype)
    rc = fn(idx.data_ptr(), val.data_ptr(), idx.shape[1], x.data_ptr(),
            y.data_ptr(), m, s, ell.tiles.data_ptr(), ell.TILE_ROWS,
            plan.vec, plan.col_tile, plan.window_bytes, plan.slot_bytes,
            torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm kernel launch failed: cudaError {rc}")
    ell_spmm.launches += 1
    return y


ell_spmm.launches = 0
