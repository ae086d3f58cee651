"""The one generator of the benchmark's inputs.

A configuration fixes its operators: A from its ``family`` and ``side``,
and M drawn from its ``base_seed`` on the device with a
``torch.Generator``:

    "m_diag": {"low": 0.5, "high": 1.5, "zero_one_in": 3}
        M = diag(U[low, high)); with ``zero_one_in`` = q, n // q entries
        chosen by a random permutation are set to zero (a singular M)
    "rhs": {"columns": 8, "low": 0.0, "high": 1.0}
        the right-hand sides: (n, columns) U[low, high), zero on the rows
        where M is zero

Request i solves with B = B_i Q.  B_i is drawn from (``base_seed``, i):
each request poses an equation of its own (B_i B_i' differs), and every
seed runs the same sequence of equations, so the seed does not change
the work.  Q, a random orthogonal (columns x columns) matrix drawn from
(seed, i), is what the seed adds: B B' = B_i B_i', so the equation stays
the same while the bytes differ from seed to seed.  The right-hand sides
are drawn on the host, so that the check after the window draws the
same bits on any device; they are float64, and the caller casts them to
the traffic's dtype, so a run at a lower precision solves the same
equations.
"""

from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
import scipy.sparse as sp
import torch

from bench_torch.reference.problems import operator

WARMUP = -1   # the request index of the set-up's warm-up request
F64 = torch.float64


def stream_seed(seed: int, stream: str, index: int = 0) -> int:
    """A 63-bit generator seed for (seed, stream, index); any integer
    seed, however large, maps to one."""
    h = hashlib.blake2b(f"{seed}:{stream}:{index}".encode(), digest_size=8)
    return int.from_bytes(h.digest(), "little") & (2 ** 63 - 1)


def _gen(device, seed, stream, index=0) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(
        stream_seed(seed, stream, index))


@dataclass
class Problem:
    a: sp.csr_matrix      # A, float64
    md: np.ndarray        # diag(M), float64
    n: int
    base_seed: int
    rhs_spec: dict        # the configuration's "rhs"

    @property
    def singular(self) -> np.ndarray:
        return self.md == 0.0


def problem(config, device) -> Problem:
    """A and M of ``config``, M drawn from its ``base_seed`` on
    ``device`` (kept on the host)."""
    a = operator(config)
    n = a.shape[0]
    base = int(config["base_seed"])
    spec = config["m_diag"]
    gen = _gen(device, base, "m_diag")
    md = spec["low"] + (spec["high"] - spec["low"]) * torch.rand(
        n, generator=gen, device=device, dtype=F64)
    q = spec.get("zero_one_in")
    if q:
        md[torch.randperm(n, generator=gen, device=device)[: n // q]] = 0.0
    return Problem(a, md.cpu().numpy(), n, base, config["rhs"])


def rotation(p: int, seed: int, index: int) -> torch.Tensor:
    """A random orthogonal (p, p) matrix (Haar) drawn from (seed,
    index), float64 on the host."""
    g = torch.randn((p, p), generator=_gen("cpu", seed, "rotation", index),
                    dtype=F64)
    q, r = torch.linalg.qr(g)
    return q * torch.sign(torch.diagonal(r))


def rhs(prob: Problem, seed: int, index: int, device) -> torch.Tensor:
    """B of request ``index``: B_index Q (float64, on ``device``)."""
    spec, p = prob.rhs_spec, int(prob.rhs_spec["columns"])
    b = spec["low"] + (spec["high"] - spec["low"]) * torch.rand(
        (prob.n, p), generator=_gen("cpu", prob.base_seed, "rhs", index),
        dtype=F64)
    b[torch.as_tensor(prob.singular)] = 0.0
    return (b @ rotation(p, seed, index)).to(device)
