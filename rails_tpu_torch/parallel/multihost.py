"""Multi-process runs - the counterpart of the JAX package's
``parallel/multihost.py`` (``jax.distributed.initialize``,
``make_global_array``).

The port runs one process per device, as the reference runs one MPI rank
per Epetra map slab, and as NCCL is built to run: ``initialize`` joins
this process to a ``torch.distributed`` group and makes its row
communicator (``comm.RowComm``); ``mesh.make_mesh()`` then gives the
global row mesh, this process holding its own contiguous rows.

- ``initialize(coordinator_address, num_processes, process_id, *,
  device=None, backend=None)``: ``init_process_group`` over
  ``tcp://coordinator_address``, with the JAX module's environment
  defaults (``RAILS_NUM_PROCESSES``, ``RAILS_COORDINATOR``,
  ``RAILS_PROCESS_ID``) and ``RAILS_DIST_BACKEND`` for the backend; a
  no-op for one process.  The device defaults to
  ``cuda:{process_id % device_count}``; ``device="cpu"`` runs on the CPU.
- The backend is chosen explicitly (``choose_backend``), never switched
  silently: ``gloo`` on the CPU, ``nccl`` when every rank has a card of
  its own, ``gloo`` on a card that ranks share only when asked for; NCCL
  asked for on a shared card raises.
- ``make_global_array(local_rows, mesh)`` checks that the ranks' slabs
  add up to the mesh's rows and returns this rank's slab;
  ``allgather_rows`` is ``multihost_utils.process_allgather(tiled=True)``.
"""

from __future__ import annotations

import datetime
import os
from typing import Optional

import torch

from rails_tpu_torch.parallel.comm import RowComm

__all__ = ["initialize", "shutdown", "current_comm", "process_count",
           "process_index", "make_global_array", "allgather_rows",
           "choose_backend", "rank_device"]

_COMM: Optional[RowComm] = None

DEFAULT_TIMEOUT_S = 600.0


def current_comm() -> Optional[RowComm]:
    """This process's row communicator; None outside a group."""
    return _COMM


def process_count() -> int:
    """Processes of this run (1 outside a group)."""
    return 1 if _COMM is None else _COMM.world


def process_index() -> int:
    """This process's rank (0 outside a group)."""
    return 0 if _COMM is None else _COMM.rank


def rank_device(process_id: int, device=None) -> torch.device:
    """This rank's device: ``device`` when it names one (``cpu``,
    ``cuda:1``), else ``cuda:{process_id % device_count}``."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "rails_tpu_torch: device 'cuda' was asked for (the default) "
                "but torch.cuda.is_available() is False; pass device='cpu' "
                "to run on the CPU")
        dev = torch.device("cuda", process_id % torch.cuda.device_count())
    return dev


def choose_backend(backend: Optional[str], device: torch.device,
                   num_processes: int, device_count: int) -> str:
    """The backend for ``num_processes`` ranks on ``device``
    (``device_count`` visible cards): ``backend`` (default
    ``$RAILS_DIST_BACKEND``) when it can run there, ``gloo`` on the CPU,
    else ``nccl``.  NCCL refuses two ranks on one card, so where the ranks
    outnumber the cards NCCL raises, asked for or not: ask for gloo."""
    backend = backend or os.environ.get("RAILS_DIST_BACKEND") or None
    if backend not in (None, "gloo", "nccl"):
        raise ValueError(f"unknown backend {backend!r} (gloo or nccl)")
    if device.type != "cuda":
        if backend == "nccl":
            raise ValueError(f"nccl carries CUDA tensors only; the ranks run "
                             f"on {device}: use gloo")
        return "gloo"
    if backend == "gloo":
        return "gloo"
    if num_processes > device_count:
        raise ValueError(
            f"{num_processes} ranks on {device_count} card(s): NCCL refuses "
            f"two ranks on one card.  Run one process per card, or ask for "
            f"gloo on the shared card (backend='gloo' or "
            f"RAILS_DIST_BACKEND=gloo; tensors then go through host memory)")
    return "nccl"


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, *, device=None,
               backend: Optional[str] = None,
               timeout_s: float = DEFAULT_TIMEOUT_S) -> Optional[RowComm]:
    """Join the process group (a no-op for one process) and return this
    rank's row communicator (None for one process).  A collective that
    waits longer than ``timeout_s`` raises."""
    global _COMM
    if num_processes is None:
        num_processes = int(os.environ.get("RAILS_NUM_PROCESSES", "1"))
    if num_processes <= 1:
        return None
    if _COMM is not None:
        raise RuntimeError(f"already initialized: {_COMM}")
    import torch.distributed as dist

    coordinator_address = coordinator_address or os.environ.get(
        "RAILS_COORDINATOR")
    if not coordinator_address:
        raise ValueError("a multi-process run needs the coordinator's "
                         "host:port (coordinator_address or "
                         "RAILS_COORDINATOR)")
    if process_id is None:
        process_id = int(os.environ.get("RAILS_PROCESS_ID", "0"))
    if not 0 <= process_id < num_processes:
        raise ValueError(f"process_id {process_id} outside "
                         f"[0, {num_processes})")
    dev = rank_device(process_id, device)
    count = torch.cuda.device_count() if dev.type == "cuda" else 0
    be = choose_backend(backend, dev, num_processes, count)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        be, init_method=f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    _COMM = RowComm(None, process_id, num_processes, dev, be)
    return _COMM


def shutdown() -> None:
    """Leave the process group (after a barrier, so that no rank tears
    its connections down under a peer still at work)."""
    global _COMM
    if _COMM is None:
        return
    import torch.distributed as dist

    try:
        _COMM.barrier()
    finally:
        dist.destroy_process_group()
        _COMM = None


def make_global_array(local_rows, mesh=None):
    """This rank's slab of a row-distributed array, checked against the
    mesh: the ranks' row counts must add up to ``world`` equal slabs (one
    allreduce of the count).  With one process the slab is the whole
    array."""
    comm = _COMM if mesh is None else mesh.comm
    if comm is None:
        return local_rows
    x = torch.as_tensor(local_rows)
    rows = torch.tensor([x.shape[0]], dtype=torch.int64, device=comm.device)
    total = int(comm.allreduce(rows)[0])
    if total != x.shape[0] * comm.world:
        raise ValueError(f"the ranks' slabs hold {total} rows in all; every "
                         f"rank must hold {total // comm.world} (this rank "
                         f"has {x.shape[0]})")
    return x


def allgather_rows(x, mesh=None):
    """Every rank's rows of ``x`` in rank order, on every rank (the JAX
    package's ``process_allgather(x, tiled=True)``); ``x`` itself with one
    process."""
    comm = _COMM if mesh is None else mesh.comm
    if comm is None:
        return x
    return comm.allgather_rows(x)
