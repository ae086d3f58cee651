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
"""

from __future__ import annotations

import ctypes

import torch

__all__ = ["dia_spmm", "dia_spmm_reference"]


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
