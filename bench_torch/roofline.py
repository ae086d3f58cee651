"""The roofline arithmetic of the benchmark: published peaks of the card,
and each kernel's bytes and operations from its shapes.

A kernel's share of its roofline is the least time the card could take
for the work - the larger of bytes over the memory bandwidth and
operations over the peak rate of its dtype - over the time the trace
gives the kernel.  Each input byte is counted read once and each output
byte written once, whatever the kernel reads again.  The share is stated
against the published peak, with the card's power limit beside it.
"""

from __future__ import annotations

import subprocess

# NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at 700 W;
# the SpMM kernels use plain FMAs, so the peaks outside the tensor cores
PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "hbm_bytes_per_s": 3.35e12,
        "flops": {"float64": 34e12, "float32": 67e12},
    },
}


def peaks(device_name: str):
    """The published peaks of the card named ``device_name`` (as
    ``torch.cuda.get_device_name`` gives it), or None for a card not in
    the table."""
    return PEAKS.get(device_name)


def power_limit_w():
    """The card's power limit in W from nvidia-smi, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=60, check=True).stdout
        return float(out.strip().splitlines()[0])
    except (OSError, subprocess.SubprocessError, ValueError, IndexError):
        return None


def dia_work(m: int, n: int, offsets, s: int, itemsize: int):
    """(bytes, operations) of y = A x for an (m, n) DIA matrix with
    ``offsets`` and x of ``s`` columns: the (d, m) data, the offsets (4
    bytes each) and x read once, y written once; two operations per
    term of the matrix that lies inside it, per column."""
    d = len(offsets)
    nbytes = (d * m + n * s + m * s) * itemsize + 4 * d
    terms = sum(max(0, min(m, n - o) - max(0, -o)) for o in offsets)
    return nbytes, 2 * terms * s


def ell_work(m: int, n: int, slots: int, s: int, itemsize: int):
    """(bytes, operations) of y = A x for an (m, n) ELL matrix of
    ``slots`` entries per row: indices (4 bytes) and values read once, x
    read once, y written once; two operations per stored entry per
    column."""
    nbytes = slots * m * (4 + itemsize) + (n * s + m * s) * itemsize
    return nbytes, 2 * slots * m * s


def least_seconds(nbytes: float, ops: float, dtype: str, pk) -> float:
    return max(nbytes / pk["hbm_bytes_per_s"], ops / pk["flops"][dtype])


def share_pct(works, kernel_seconds: float, pk):
    """100 x (the least time of ``works``, a list of (bytes, operations,
    dtype)) / ``kernel_seconds``; None without peaks or time."""
    if pk is None or not works or kernel_seconds <= 0:
        return None
    least = sum(least_seconds(b, f, dt, pk) for b, f, dt in works)
    return 100.0 * least / kernel_seconds
