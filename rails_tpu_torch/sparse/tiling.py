"""Host-side tiling arithmetic shared by the ELL kernel (``csrc/ell_spmm.cu``)
and the halo DIA kernel (``csrc/dia_spmm_halo.cu``).

Both kernels give each thread a *lane*: ``vec`` adjacent columns of one
output row, loaded and stored as one 16-, 8- or 4-byte access.  A block
of at most 256 threads covers 256 // lanes rows of one column tile of
``lanes * vec`` columns.  This module picks ``vec`` from
the shapes and pointers and splits s into column tiles (at every
launch, so it does only integer arithmetic), and takes an ELL payload's
row-tile windows once, when the payload is built.
"""

from __future__ import annotations

import math
from typing import Tuple

__all__ = ["MAX_LANES", "TILE_ROWS", "vector_width", "column_lanes",
           "tile_windows"]

MAX_LANES = 64    # lanes per column tile, at most
TILE_ROWS = 128   # rows of an ELL row tile (EllMatrix.tiles)


def vector_width(s: int, itemsize: int, *ptrs: int) -> int:
    """Columns per lane: the widest of 16, 8 or 4 bytes (at least one
    element) that divides a row of s columns and to which every pointer
    in ``ptrs`` is aligned."""
    for nbytes in (16, 8, 4):
        vec = max(1, nbytes // itemsize)
        if s % vec == 0 and all(p % (vec * itemsize) == 0 for p in ptrs):
            return vec
    return 1


def column_lanes(s: int, vec: int, max_cols: int = 0) -> Tuple[int, int]:
    """(lanes, column tiles) for s columns at ``vec`` per lane: at most
    ``MAX_LANES`` lanes, and at most ``max_cols`` columns per tile when it
    is given (never fewer than one lane); the tiles are balanced, so the
    last is not a sliver."""
    units = math.ceil(s / vec)
    cap = MAX_LANES if max_cols <= 0 else max(1, min(MAX_LANES,
                                                     max_cols // vec))
    tiles = math.ceil(units / cap)
    return math.ceil(units / tiles), tiles


def tile_windows(indices, rows: int):
    """(T, 2) int32 on ``indices``' device: per tile of ``rows`` rows of an
    (m, L) index array, the smallest and largest index (the rows of x the
    tile reads); (0, -1) - an empty window - for a tile with no slots."""
    import torch

    m, width = indices.shape
    count = -(-m // rows)
    if width == 0 or m == 0:
        win = torch.zeros((count, 2), dtype=torch.int32,
                          device=indices.device)
        win[:, 1] = -1
        return win
    full = m // rows
    los, his = [], []
    if full:
        lo, hi = torch.aminmax(indices[:full * rows].reshape(
            full, rows * width), dim=1)
        los.append(lo)
        his.append(hi)
    if m > full * rows:
        lo, hi = torch.aminmax(indices[full * rows:].reshape(1, -1), dim=1)
        los.append(lo)
        his.append(hi)
    return torch.stack([torch.cat(los), torch.cat(his)], dim=1).to(
        torch.int32).contiguous()
