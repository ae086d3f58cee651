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
"""

from __future__ import annotations

import ctypes

import torch

from rails_tpu_torch.sparse.wide_spmm import wide_spmm

__all__ = ["ell_spmm", "ell_spmm_reference", "wide_eligible"]


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
    fn = _kernel_fn(x.dtype)
    rc = fn(idx.data_ptr(), val.data_ptr(), idx.shape[1], x.data_ptr(),
            y.data_ptr(), m, s, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ell_spmm kernel launch failed: cudaError {rc}")
    ell_spmm.launches += 1
    return y


ell_spmm.launches = 0
