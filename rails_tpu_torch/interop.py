"""State carried across from the JAX package.

Turns the JAX package's objects, handed over as numpy arrays and plain
Python values (``np.asarray`` of each array), into the port's objects on
a given device.  Nothing here imports JAX: a caller that holds a
``rails_tpu`` object pulls its arrays out with ``np.asarray`` and passes
them in.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from rails_tpu_torch.core.options import SolverOptions
from rails_tpu_torch.operators import DenseOperator, DiagonalOperator
from rails_tpu_torch.sparse.formats import (
    DiaMatrix, EllMatrix, HybMatrix, SparseOperator)
from rails_tpu_torch.sparse.hub import HubSplitOperator
from rails_tpu_torch.sparse.wide_spmm import (
    CHUNK, MIN_S_DEFAULT, WideWindow)
from rails_tpu_torch.utils.device import as_tensor, resolve_device

__all__ = ["dia_payload", "ell_payload", "hyb_payload", "hub_payload",
           "sparse_operator", "diagonal_operator", "dense_operator", "rhs",
           "solver_options", "restart_data", "wide_window"]

# SolverOptions fields that carry an array (moved to the device) and the
# derived fields __post_init__ sets (not constructor arguments)
_ARRAY_FIELDS = ("space", "nullspace")
_DERIVED_FIELDS = ("projection_major", "projection_minor")


def dia_payload(data, offsets: Sequence[int], shape: Tuple[int, int], *,
                device=None, dtype=None) -> DiaMatrix:
    """A ``DiaMatrix`` from the JAX package's DIA payload fields
    ``data`` (d, m), ``offsets`` and ``shape``."""
    dev = resolve_device(device)
    return DiaMatrix(as_tensor(np.asarray(data), dev, dtype),
                     tuple(int(o) for o in offsets),
                     (int(shape[0]), int(shape[1])))


def ell_payload(indices, values, shape: Tuple[int, int], *, device=None,
                dtype=None, wide: Optional[WideWindow] = None) -> EllMatrix:
    """An ``EllMatrix`` from the JAX package's ELL payload fields
    ``indices`` (m, L), ``values`` (m, L) and ``shape`` (its windowed
    ``well`` payload has no counterpart and is not taken), with the
    dense-window payload ``wide`` (``wide_window``) when given."""
    dev = resolve_device(device)
    return EllMatrix(as_tensor(np.asarray(indices, np.int32), dev),
                     as_tensor(np.asarray(values), dev, dtype),
                     (int(shape[0]), int(shape[1])),
                     None if wide is None else wide.to(dev))


def _bf16(a) -> torch.Tensor:
    """A bfloat16 CPU tensor with the bits of a bfloat16 numpy array
    (ml_dtypes' type, what np.asarray of a JAX array gives), so nothing
    is rounded."""
    a = np.asarray(a)
    if a.dtype.itemsize != 2 or a.dtype.kind == "f":
        raise ValueError(f"wide planes must be bfloat16, got {a.dtype}")
    t = torch.from_numpy(np.array(a, copy=True).view(np.int16))
    return t.view(torch.bfloat16)


def wide_window(c0, p_hi, p_lo, p3, w: int, shape: Tuple[int, int],
                min_s: int = MIN_S_DEFAULT, *, device=None) -> WideWindow:
    """A ``WideWindow`` from the JAX package's ``WideWindow`` arrays:
    ``c0`` (nb,), the bfloat16 planes ``p_hi``, ``p_lo`` and ``p3`` (or
    None) laid out (w, m_pad) with chunk b in columns [128 b, 128 b +
    128), ``w``, ``shape`` and ``min_s``.  The planes are mapped onto the
    port's (nb, w, 128) layout bit for bit."""
    dev = resolve_device(device)
    w = int(w)

    def plane(p):
        t = _bf16(p)
        nb = t.shape[1] // CHUNK
        return t.reshape(w, nb, CHUNK).permute(1, 0, 2).contiguous().to(dev)

    return WideWindow(as_tensor(np.asarray(c0, np.int32), dev),
                      plane(p_hi), plane(p_lo),
                      None if p3 is None else plane(p3), w,
                      (int(shape[0]), int(shape[1])), int(min_s))


def hyb_payload(dia: Mapping, ell: Mapping, shape: Tuple[int, int], *,
                device=None, dtype=None) -> HybMatrix:
    """A ``HybMatrix`` from the JAX package's HYB parts, as dicts
    {data, offsets, shape} and {indices, values, shape}."""
    return HybMatrix(_payload(dia, device, dtype),
                     _payload(ell, device, dtype),
                     (int(shape[0]), int(shape[1])))


def _payload(p: Mapping, device, dtype):
    """A payload from its dict: HYB {dia, ell, shape}, ELL {indices,
    values, shape} or DIA {data, offsets, shape}."""
    if "dia" in p:
        return hyb_payload(p["dia"], p["ell"], p["shape"], device=device,
                           dtype=dtype)
    if "indices" in p:
        return ell_payload(p["indices"], p["values"], p["shape"],
                           device=device, dtype=dtype)
    return dia_payload(p["data"], p["offsets"], p["shape"], device=device,
                       dtype=dtype)


def hub_payload(rest: Mapping, hubcol: Optional[Mapping], hub_idx, d,
                shape: Tuple[int, int], *, bwd: Optional[Mapping] = None,
                is_symmetric: bool = False, is_hurwitz: bool = False,
                nnz: int = 0, device=None, dtype=None) -> HubSplitOperator:
    """A ``HubSplitOperator`` from the JAX package's ``HubSplitOperator``
    arrays: ``rest`` and ``hubcol`` as ELL dicts {indices, values, shape}
    (``hubcol`` None when absent), ``hub_idx`` (h,), ``d`` (h, n) or
    None, ``shape``, and ``bwd`` the transpose's split as a dict {rest,
    hubcol, hub_idx, d, shape} (None when symmetric)."""
    dev = resolve_device(device)

    def ell(p):
        return None if p is None else ell_payload(
            p["indices"], p["values"], p["shape"], device=dev, dtype=dtype)

    back = None if bwd is None else hub_payload(
        bwd["rest"], bwd.get("hubcol"), bwd["hub_idx"], bwd.get("d"),
        bwd["shape"], device=dev, dtype=dtype)
    return HubSplitOperator(
        ell(rest), ell(hubcol),
        as_tensor(np.asarray(hub_idx, np.int64), dev),
        None if d is None else as_tensor(np.asarray(d), dev, dtype),
        (int(shape[0]), int(shape[1])), bwd=back,
        is_symmetric=bool(is_symmetric), is_hurwitz=bool(is_hurwitz),
        nnz=int(nnz))


def sparse_operator(fwd: Mapping, bwd: Optional[Mapping] = None, *,
                    is_symmetric: bool = False, is_spd: bool = False,
                    is_hurwitz: bool = False, nnz: int = 0, device=None,
                    dtype=None) -> SparseOperator:
    """A ``SparseOperator`` from payload dicts - DIA {data, offsets,
    shape}, ELL {indices, values, shape} or HYB {dia, ell, shape} -
    (``bwd`` the transposed payload, None when symmetric) and the tags."""
    return SparseOperator(_payload(fwd, device, dtype),
                          None if bwd is None else _payload(bwd, device,
                                                            dtype),
                          is_symmetric=bool(is_symmetric),
                          is_spd=bool(is_spd), is_hurwitz=bool(is_hurwitz),
                          nnz=int(nnz))


def diagonal_operator(d, *, is_spd: Optional[bool] = None, device=None,
                      dtype=None) -> DiagonalOperator:
    """A diagonal M from its diagonal ``d``."""
    dev = resolve_device(device)
    return DiagonalOperator(as_tensor(np.asarray(d), dev, dtype),
                            is_spd=is_spd, device=dev)


def dense_operator(a, *, is_symmetric: bool = False, is_spd: bool = False,
                   is_hurwitz: bool = False, device=None,
                   dtype=None) -> DenseOperator:
    dev = resolve_device(device)
    return DenseOperator(as_tensor(np.asarray(a), dev, dtype),
                         is_symmetric=bool(is_symmetric),
                         is_spd=bool(is_spd), is_hurwitz=bool(is_hurwitz),
                         device=dev)


def rhs(b, *, device=None, dtype=None) -> torch.Tensor:
    """The right-hand side factor B (m, p) (a 1-D B becomes (m, 1))."""
    t = as_tensor(np.asarray(b), device, dtype)
    return t[:, None] if t.ndim == 1 else t


def restart_data(rd: Mapping, *, device=None, dtype=None) -> dict:
    """``restart_data`` {V, AV, VAV} on the device."""
    return {k: as_tensor(np.asarray(rd[k]), device, dtype)
            for k in ("V", "AV", "VAV")}


def solver_options(fields: Mapping, *, device=None,
                   dtype=None) -> SolverOptions:
    """``SolverOptions`` from the JAX package's option fields
    (``dataclasses.asdict`` of its SolverOptions, or any subset).
    ``dtype`` names the solve dtype when given (numpy names such as
    ``'float64'`` are taken too); array fields move to the device."""
    kw = {k: v for k, v in fields.items() if k not in _DERIVED_FIELDS}
    names = {f.name for f in dataclasses.fields(SolverOptions)}
    unknown = set(kw) - names
    if unknown:
        raise ValueError(f"unknown SolverOptions fields {sorted(unknown)}")
    if dtype is not None:
        kw["dtype"] = dtype
    if kw.get("dtype") is not None and not isinstance(kw["dtype"],
                                                      torch.dtype):
        kw["dtype"] = getattr(torch, np.dtype(kw["dtype"]).name)
    for k in _ARRAY_FIELDS:
        if kw.get(k) is not None:
            kw[k] = as_tensor(np.asarray(kw[k]), device, kw.get("dtype"))
    if kw.get("restart_data") is not None:
        kw["restart_data"] = restart_data(kw["restart_data"], device=device,
                                          dtype=kw.get("dtype"))
    return SolverOptions(**kw)
