"""Device policy: every entry point runs on ``cuda`` unless the caller
asks for another device.  Asking for ``cuda`` without a card raises; the
port never carries on on the CPU in its place."""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["resolve_device", "as_tensor"]


def resolve_device(device=None) -> torch.device:
    """``None`` means ``cuda``.  Raises if a CUDA device is asked for and
    none is available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "rails_tpu_torch: device 'cuda' was asked for (the default) "
            "but torch.cuda.is_available() is False; pass device='cpu' to "
            "run on the CPU")
    return dev


def as_tensor(x, device=None, dtype=None) -> torch.Tensor:
    """A tensor on ``resolve_device(device)`` from a tensor, numpy array
    or sequence; ``dtype`` casts when given."""
    dev = resolve_device(device)
    if not isinstance(x, torch.Tensor):
        x = torch.from_numpy(np.array(x, copy=True))
    return x.to(device=dev, dtype=dtype if dtype is not None else x.dtype)
