"""Dtype and precision policy.

The reference (Sbte/RAILS) is float64 throughout.  The port is
dtype-generic like the JAX package: every entry point takes a ``dtype``
(default ``torch.get_default_dtype()``, float32 unless the caller changed
it), and the H100 runs float64 natively, so a plain float64 solve is a
first-class path on the card.

Full-precision float32: iterative linear algebra must never run its
float32 products in TF32, which keeps about three decimal digits (the
JAX package records a 2e-3 error from a reduced-precision default that
slipped into its hub split).  ``highest_precision`` pins the three
PyTorch switches that could allow it.
"""

from __future__ import annotations

import contextlib
import functools

import torch

__all__ = [
    "complex_dtype_for",
    "full_precision",
    "highest_precision",
    "precision_flags",
]


def _fp32_switches():
    """Every ``fp32_precision`` switch of ``torch.backends`` (the
    per-backend API of recent PyTorch; empty where it is absent)."""
    b = torch.backends
    objs = (b, b.cuda.matmul, b.cudnn, getattr(b.cudnn, "conv", None),
            getattr(b.cudnn, "rnn", None), b.mkldnn,
            getattr(b.mkldnn, "matmul", None),
            getattr(b.mkldnn, "conv", None), getattr(b.mkldnn, "rnn", None))
    return [o for o in objs
            if o is not None and hasattr(o, "fp32_precision")]


@contextlib.contextmanager
def full_precision():
    """Run the enclosed block with TF32 off for matmuls and cuDNN and the
    float32 matmul precision at "highest"; restore the caller's settings
    on exit.

    Where PyTorch also has per-backend ``fp32_precision`` switches, those
    are saved and put back exactly after the legacy switches: setting
    the matmul precision back through the legacy setter alone would also
    turn switches the caller never set (mkldnn's matmul), and PyTorch's
    getters raise once the switches disagree."""
    saved = [(o, o.fp32_precision) for o in _fp32_switches()]
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32,
           torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.set_float32_matmul_precision(old[2])
        torch.backends.cuda.matmul.allow_tf32 = old[0]
        torch.backends.cudnn.allow_tf32 = old[1]
        for obj, value in saved:
            obj.fp32_precision = value


def highest_precision(fn):
    """Decorator: run ``fn`` under ``full_precision``."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with full_precision():
            return fn(*args, **kwargs)

    return wrapped


def precision_flags() -> dict:
    """The three switches ``full_precision`` pins, as they stand now."""
    return {
        "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
        "cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
        "float32_matmul_precision": torch.get_float32_matmul_precision(),
    }


def complex_dtype_for(dtype) -> torch.dtype:
    """The complex dtype matching a real dtype's precision."""
    if dtype in (torch.float64, torch.complex128):
        return torch.complex128
    return torch.complex64
