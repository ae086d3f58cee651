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

import torch

from rails_tpu_torch.sparse.tiling import column_lanes, vector_width

__all__ = ["dia_spmm", "dia_spmm_reference", "dia_spmm_halo",
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
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p]
        _FNS[dtype] = fn
    return fn


def dia_spmm(dia, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x.  CPU tensors: the plain version.  CUDA tensors: the
    kernel, after checking device, dtype, shape and contiguity."""
    if x.device.type == "cpu":
        return dia_spmm_reference(dia, x)
    if x.device.type != "cuda":
        raise ValueError(f"dia_spmm: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        # the C side launches on the calling thread's current device
        with torch.cuda.device(x.device):
            return dia_spmm(dia, x)
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
    s = x.shape[1]
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    if m == 0 or s == 0:
        return y
    fn = _kernel_fn(x.dtype)
    rc = fn(data.data_ptr(), offs.data_ptr(), len(dia.offsets),
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


OFFSETS_CAP = 16   # diagonals the halo kernel takes by value


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
