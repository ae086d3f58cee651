"""Multi-process scaffolding - the counterpart of the JAX package's
``parallel/multihost.py``.

The JAX package runs one process per host under ``jax.distributed`` and
assembles row-sharded global arrays from per-process slabs.  The port's
mesh is one process over one device (``mesh.py``), so:

- ``initialize`` is a no-op for one process and raises
  ``NotImplementedError`` for more (ROADMAP Queue 1 item 7, the
  multi-card slice: ``torch.distributed`` with NCCL);
- ``make_global_array`` returns the one process's rows as they are.

The environment defaults are the JAX package's: ``RAILS_NUM_PROCESSES``,
``RAILS_COORDINATOR`` and ``RAILS_PROCESS_ID``.
"""

from __future__ import annotations

import os
from typing import Optional

from rails_tpu_torch.parallel.mesh import MULTI_DEVICE_TODO

__all__ = ["initialize", "make_global_array", "process_count"]


def process_count() -> int:
    """Processes of this run: always one until the multi-card slice."""
    return 1


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """No-op for a single process; raises for more than one."""
    if num_processes is None:
        num_processes = int(os.environ.get("RAILS_NUM_PROCESSES", "1"))
    if num_processes > 1:
        raise NotImplementedError(
            f"{num_processes} processes asked for: {MULTI_DEVICE_TODO}")


def make_global_array(local_rows, mesh=None):
    """The global row-sharded array from this process's row slab: with
    one process the slab is the whole array."""
    return local_rows
