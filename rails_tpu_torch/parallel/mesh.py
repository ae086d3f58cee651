"""The 1-D row mesh - the counterpart of the JAX package's
``parallel/mesh.py``.

The reference partitions every m-sized object by rows over its MPI ranks
and replicates every k-sized one (its Epetra_Map distribution).  The JAX
package's counterpart is a 1-D ``rows`` mesh over the devices one
process drives; its tests run eight shards on the CPU in one process.
This module's ``Mesh`` is the same single-controller mesh over a tuple
of torch devices, in which one device may appear more than once: each
entry is one row shard, and the shards of a device run one after the
other.  That is how one card runs the row-sharded path with real
neighbour halos (eight shards on ``cpu`` in the tests, four on
``cuda:0`` in ``chip_smoke.py``).

A mesh over more than one distinct device needs a row-sharded solver
state and collectives between cards; it raises ``NotImplementedError``
(``MULTI_DEVICE_TODO``).  The JAX package's ``NamedSharding`` helpers
(``row_sharding``, ``col_sharding``, ``replicated``) have no counterpart:
with one device there is nothing to place, and the operators of
``halo_spmm.py``, ``halo_ell.py`` and ``schur_dist.py`` cut their own
per-shard payloads.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rails_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "ROW_AXIS", "MULTI_DEVICE_TODO",
           "canonical_device"]

ROW_AXIS = "rows"

MULTI_DEVICE_TODO = (
    "a mesh over more than one distinct device (a row-sharded solver "
    "state, NCCL collectives between cards, more than one process) is not "
    "ported yet: ROADMAP Queue 1 item 7, the multi-card slice")


def canonical_device(device) -> torch.device:
    """``resolve_device`` with a CUDA index filled in (``cuda`` means the
    current card), so that two names of one device compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D ``rows`` mesh: ``devices[r]`` holds row shard r.

    ``size`` is the number of shards; ``device`` is the one device they
    all lie on."""

    def __init__(self, devices: Sequence):
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) > 1:
            raise NotImplementedError(MULTI_DEVICE_TODO)
        self.devices = devs

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def row_slabs(self, m: int) -> List[Tuple[int, int]]:
        """The per-shard row ranges [r0, r1) of an m-row object: equal
        contiguous slabs, as the JAX package's shardings require."""
        if m % self.size:
            raise ValueError(f"rows {m} not divisible by mesh size "
                             f"{self.size}")
        m_loc = m // self.size
        return [(r * m_loc, (r + 1) * m_loc) for r in range(self.size)]

    def __repr__(self):
        return f"Mesh({self.size} x {self.device})"


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device, the
    first ``n_devices`` of them when given).  Pass a list that repeats one
    device, e.g. ``devices=["cpu"] * 8``, for several shards on it."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_mesh: no CUDA device is visible; pass devices=[...] "
                "(e.g. ['cpu'] * 8) to build a mesh on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(devices)
