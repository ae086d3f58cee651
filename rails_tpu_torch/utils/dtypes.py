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


@contextlib.contextmanager
def full_precision():
    """Run the enclosed block with TF32 off for matmuls and cuDNN and the
    float32 matmul precision at "highest"; restore the caller's settings
    on exit."""
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
