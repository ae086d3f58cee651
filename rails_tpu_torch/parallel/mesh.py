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

Across cards the port runs one process per device
(``multihost.initialize``): inside a process group ``make_mesh()`` is
the global mesh of ``world x local`` shards, where ``local`` is this
process's entries, all on its one device; ``comm`` (``comm.RowComm``)
carries the row reductions, halos and gathers between the processes, and
this process holds the rows of its own shards (``local_range``).  One
process over several distinct devices raises ``NotImplementedError``
(``MULTI_DEVICE_BY_DESIGN``): it would be a second distributed
implementation beside the one-process-per-card one.  The JAX package's
``NamedSharding`` helpers (``row_sharding``, ``col_sharding``,
``replicated``) have no counterpart: the operators of ``halo_spmm.py``,
``halo_ell.py`` and ``schur_dist.py`` cut their own per-shard payloads,
and ``sharded.shard_array_rows`` a process's rows.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from rails_tpu_torch.utils.device import resolve_device

__all__ = ["Mesh", "make_mesh", "ROW_AXIS", "MULTI_DEVICE_BY_DESIGN",
           "canonical_device"]

ROW_AXIS = "rows"

MULTI_DEVICE_BY_DESIGN = (
    "one process over more than one distinct device is not supported, by "
    "design: run one process per card (multihost.initialize(coordinator, "
    "num_processes, process_id), or python -m rails_tpu_torch.cli "
    "--distributed --num-processes N --process-id r --coordinator "
    "host:port), each with make_mesh() over its own device (ROADMAP, "
    "Differences by design)")


def canonical_device(device) -> torch.device:
    """``resolve_device`` with a CUDA index filled in (``cuda`` means the
    current card), so that two names of one device compare equal."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A 1-D ``rows`` mesh: ``devices[i]`` holds this process's i-th row
    shard.

    ``size`` is the number of shards over all processes; ``device`` is
    the one device this process's shards lie on; ``comm`` the row
    communicator of a multi-process mesh (None for one process), whose
    rank r holds shards ``r * len(devices)`` onwards."""

    def __init__(self, devices: Sequence, comm=None):
        devs = tuple(canonical_device(d) for d in devices)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        if len(set(devs)) > 1:
            raise NotImplementedError(MULTI_DEVICE_BY_DESIGN)
        if comm is not None and devs[0] != canonical_device(comm.device):
            raise ValueError(f"the mesh's device {devs[0]} is not this "
                             f"rank's device {comm.device}")
        self.devices = devs
        self.comm = comm

    @property
    def size(self) -> int:
        return len(self.devices) * (1 if self.comm is None
                                    else self.comm.world)

    @property
    def device(self) -> torch.device:
        return self.devices[0]

    def row_slabs(self, m: int) -> List[Tuple[int, int]]:
        """The per-shard row ranges [r0, r1) of an m-row object, over all
        processes: equal contiguous slabs, as the JAX package's shardings
        require."""
        if m % self.size:
            raise ValueError(f"rows {m} not divisible by mesh size "
                             f"{self.size}")
        m_loc = m // self.size
        return [(r * m_loc, (r + 1) * m_loc) for r in range(self.size)]

    def local_slabs(self, m: int) -> List[Tuple[int, int]]:
        """This process's shards' row ranges of an m-row object (global
        rows)."""
        first = 0 if self.comm is None else self.comm.rank * len(self.devices)
        return self.row_slabs(m)[first:first + len(self.devices)]

    def local_range(self, m: int) -> Tuple[int, int]:
        """The rows [r0, r1) of an m-row object that this process holds."""
        slabs = self.local_slabs(m)
        return slabs[0][0], slabs[-1][1]

    def shard_slabs(self, rows: int) -> List[Tuple[int, int]]:
        """This process's shards' ranges within its own ``rows`` rows
        (local rows; with one process the global slabs)."""
        n = len(self.devices)
        if rows % n:
            raise ValueError(f"rows {rows} not divisible by the {n} local "
                             f"shards")
        step = rows // n
        return [(i * step, (i + 1) * step) for i in range(n)]

    def __repr__(self):
        if self.comm is None:
            return f"Mesh({self.size} x {self.device})"
        return (f"Mesh({self.size} shards, rank {self.comm.rank} of "
                f"{self.comm.world}: {len(self.devices)} x {self.device})")


def make_mesh(n_devices: Optional[int] = None, devices=None) -> Mesh:
    """1-D mesh over ``devices`` (default: every visible CUDA device, the
    first ``n_devices`` of them when given).  Pass a list that repeats one
    device, e.g. ``devices=["cpu"] * 8``, for several shards on it.

    Inside a process group (``multihost.initialize``) this is the global
    mesh: ``devices`` (default: this rank's device, once) are this
    process's shards, and every process passes as many."""
    from rails_tpu_torch.parallel.multihost import current_comm

    comm = current_comm()
    if comm is not None:
        return Mesh([comm.device] if devices is None else devices, comm)
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
