"""The row communicator of a multi-process mesh - the torch counterpart of
the collectives that the JAX package's partitioner inserts
(``rails_tpu/parallel/mesh.py:1-17``): GSPMD's psum after a local
``V' @ W`` (``rails_tpu/utils/compensated.py:34-37``,
``schur_dist.py:91``), ``shard_map``'s non-cyclic ``ppermute`` of the
halo rows (``halo_spmm.py:102-110``, ``halo_ell.py:234-238``) and
``multihost_utils.process_allgather`` (``rails_tpu/cli.py:243-247``).

The port's multi-card posture is one process per device
(``multihost.initialize``), each holding a contiguous block of rows.
Three kinds of operation cross processes:

- *row reductions*: each rank's partial (a local ``x' @ w``, a sum of
  squares) is gathered and summed in rank order
  (``allreduce_many``), so every rank holds the same bits whatever the
  backend's own reduction order; several partials go in one call;
- *neighbour halos*: rank r takes rank r-1's last rows and rank r+1's
  first rows (``neighbour_halos``), a boundary rank nothing, from one
  all-gather of every rank's first and last rows;
- *gathers*: every rank's rows, in rank order (``allgather_rows``,
  ``gather_rows``).

The backend is ``nccl`` (one card per rank) or ``gloo`` (the CPU, or a
card that several ranks share, on request).  gloo carries host tensors
only: a CUDA tensor is copied into a pinned host buffer, sent, and copied
back, here and nowhere else; ``stats`` counts the calls, the bytes and
the bytes staged so.  A collective that fails or times out raises on
every rank that takes part (``init_process_group``'s timeout).

Inside a recorded iteration (``solve(compiled=True)`` on the card,
``core/engine.py``) every collective of the iteration is a gather
(``_allgather_flat``), and its route follows the backend, never switched
silently (``route``):

- ``nccl``: *captured*.  The gather is one ``all_gather_into_tensor``
  into a buffer of the graph segment, so a segment holds its
  collectives; a collective that does not capture raises.
- ``gloo``: a *host step*.  gloo is a host library, so the gather runs
  through ``engine.host_call`` between two segments, its result in a
  buffer the next segment reads.

Outside a recording it is a plain call.  ``stats`` is bumped in Python,
once per call made; the engine's recorder keeps each segment's captured
calls and bytes and adds them at every replay.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from rails_tpu_torch.core.engine import host_call

__all__ = ["RowComm", "CommStats", "psum", "row_norm"]

# one tensor's gather into a (world * n,) buffer: torch 2.13 renames
# ``all_gather_into_tensor`` ``all_gather_single`` and warns at every call
# of the old name, which torch 2.11 alone has
_gather_into = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor


def psum(comm, t: torch.Tensor) -> torch.Tensor:
    """The sum over ranks of a local partial; ``t`` itself without a
    communicator (one process)."""
    return t if comm is None else comm.allreduce(t)


def row_norm(comm, x: torch.Tensor, dim=None) -> torch.Tensor:
    """The 2-norm of x over all its rows (per column with ``dim=0``):
    ``torch.linalg.norm`` without a communicator, else the square root of
    the ranks' sums of squares, summed."""
    if comm is None:
        return torch.linalg.norm(x, dim=dim)
    return torch.sqrt(comm.allreduce(torch.sum(x * x, dim=dim)))


@dataclasses.dataclass
class CommStats:
    """What crossed processes: collective calls, the bytes this rank
    sent, and how many of them were staged through host memory (gloo
    with CUDA tensors)."""

    calls: int = 0
    bytes: int = 0
    staged_bytes: int = 0

    def as_dict(self) -> dict:
        return dataclasses.asdict(self)

    def counts(self) -> Tuple[int, int, int]:
        return self.calls, self.bytes, self.staged_bytes

    def add(self, delta: Sequence[int]) -> None:
        self.calls += delta[0]
        self.bytes += delta[1]
        self.staged_bytes += delta[2]


class RowComm:
    """``RowComm(group, rank, world, device, backend)``: the collectives of
    a row mesh whose ranks each own a contiguous block of rows, in rank
    order.  ``device`` is where this rank's tensors live; ``group`` the
    process group (None: the default group)."""

    def __init__(self, group, rank: int, world: int, device, backend: str):
        self.group = group
        self.rank = rank
        self.world = world
        self.device = torch.device(device)
        self.backend = backend
        self.stats = CommStats()

    def __repr__(self):
        return (f"RowComm(rank {self.rank} of {self.world}, {self.backend}, "
                f"{self.device})")

    @property
    def staged(self) -> bool:
        """True when a CUDA tensor goes through host memory (gloo)."""
        return self.backend == "gloo" and self.device.type == "cuda"

    @property
    def route(self) -> str:
        """How a collective of a recorded iteration runs: ``"captured"``
        in the graph segment (NCCL) or as a ``"host step"`` between two
        segments (gloo)."""
        return "captured" if self.backend == "nccl" else "host step"

    # -- staging -------------------------------------------------------
    def _out(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the backend carries it: a pinned host copy under
        gloo for a CUDA tensor, else ``t`` itself (contiguous)."""
        t = t.contiguous()
        if t.device.type == "cuda" and self.backend == "gloo":
            host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
            host.copy_(t)
            self.stats.staged_bytes += t.numel() * t.element_size()
            return host
        return t

    def _empty(self, shape, dtype) -> torch.Tensor:
        """A receive buffer where the backend writes."""
        if self.staged:
            return torch.empty(shape, dtype=dtype, pin_memory=True)
        return torch.empty(shape, dtype=dtype, device=self.device)

    def _back(self, t: torch.Tensor) -> torch.Tensor:
        """A received buffer on this rank's device."""
        if t.device != self.device:
            self.stats.staged_bytes += t.numel() * t.element_size()
            return t.to(self.device, non_blocking=True)
        return t

    # -- gathers -------------------------------------------------------
    def _allgather_flat(self, flat: torch.Tensor) -> torch.Tensor:
        """(world, n) from every rank's (n,) in rank order: one call, a
        host step of a recording under gloo."""
        if self.backend == "gloo":
            return host_call(self._gather, flat)
        return self._gather(flat)

    def _gather(self, flat: torch.Tensor) -> torch.Tensor:
        send = self._out(flat)
        out = self._empty((self.world * flat.numel(),), flat.dtype)
        _gather_into(out, send, group=self.group)
        self.stats.calls += 1
        self.stats.bytes += flat.numel() * flat.element_size()
        return self._back(out).reshape(self.world, flat.numel())

    def allgather_many(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """Each tensor of every rank, stacked as (world, *shape), packed
        into one collective; the tensors share one dtype."""
        dtypes = {t.dtype for t in tensors}
        if len(dtypes) != 1:
            raise TypeError(f"allgather_many packs one dtype, got {dtypes}")
        flat = torch.cat([t.reshape(-1) for t in tensors])
        rows = self._allgather_flat(flat)
        out, at = [], 0
        for t in tensors:
            n = t.numel()
            out.append(rows[:, at:at + n].reshape((self.world,) + t.shape))
            at += n
        return out

    def allgather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """Every rank's rows of x, concatenated in rank order (each rank
        holds as many rows)."""
        g = self.allgather_many([x])[0]
        return g.reshape((self.world * x.shape[0],) + tuple(x.shape[1:]))

    def gather_rows(self, x: torch.Tensor, root: int = 0
                    ) -> Optional[torch.Tensor]:
        """Every rank's rows of x in rank order on ``root``; None on the
        other ranks."""
        send = self._out(x)
        recv = None
        if self.rank == root:
            recv = [self._empty(tuple(x.shape), x.dtype)
                    for _ in range(self.world)]
        dist.gather(send, recv, dst=root, group=self.group)
        self.stats.calls += 1
        self.stats.bytes += x.numel() * x.element_size()
        if recv is None:
            return None
        return self._back(torch.cat(recv))

    # -- reductions ----------------------------------------------------
    @staticmethod
    def rank_sum(parts: torch.Tensor) -> torch.Tensor:
        """Sum over the leading (rank) axis, rank 0 first: the same bits
        on every rank that holds the same parts."""
        acc = parts[0]
        for i in range(1, parts.shape[0]):
            acc = acc + parts[i]
        return acc

    def allreduce_many(self, tensors: Sequence[torch.Tensor]
                       ) -> List[torch.Tensor]:
        """The sum over ranks of each tensor, in rank order, in one
        collective."""
        return [self.rank_sum(g) for g in self.allgather_many(tensors)]

    def allreduce(self, t: torch.Tensor) -> torch.Tensor:
        """The sum over ranks of ``t`` (a new tensor)."""
        return self.allreduce_many([t])[0]

    def allreduce_(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` replaced in place by its sum over ranks."""
        return t.copy_(self.allreduce(t))

    # -- halos ---------------------------------------------------------
    def neighbour_halos(self, first: Optional[torch.Tensor],
                        last: Optional[torch.Tensor]
                        ) -> Tuple[Optional[torch.Tensor],
                                   Optional[torch.Tensor]]:
        """The non-cyclic neighbour exchange: this rank's ``first`` rows go
        to rank r-1 (its upper halo) and its ``last`` rows to rank r+1
        (its lower halo).  Returns (lo, hi): rank r-1's ``last`` and rank
        r+1's ``first``, None at the mesh's ends or where every rank
        passes None (an empty halo).  Every rank passes the same shapes.
        One all-gather of every rank's ``first`` and ``last``, each rank
        taking its neighbours' rows (exact copies, as point-to-point
        sends would give)."""
        parts = [p for p in (first, last) if p is not None]
        if not parts:
            return None, None
        got = self.allgather_many(parts)
        firsts = got[0] if first is not None else None
        lasts = got[-1] if last is not None else None
        lo = lasts[self.rank - 1] \
            if lasts is not None and self.rank > 0 else None
        hi = firsts[self.rank + 1] \
            if firsts is not None and self.rank + 1 < self.world else None
        return lo, hi

    def barrier(self) -> None:
        dist.barrier(group=self.group)
