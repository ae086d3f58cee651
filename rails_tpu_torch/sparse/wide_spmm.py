"""Dense-window SpMM for wide multivectors: the hand-written CUDA kernel's
wrapper, its plain version and its payload.

The counterpart of the JAX package's ``sparse/wide_spmm.py``.  For each
128-row chunk b of an ELL matrix A (m, n), with a 128-aligned column
window [c0_b, c0_b + w), the payload holds the chunk's entries scattered
into a dense block

    P_b[c, r] = A[128 b + r, c0_b + c],

split into bfloat16 planes P = hi + lo (+ p3).  The product y = A @ x for
a float32 multivector x (n, s) is then, for every row i = 128 b + r < m,

    y[i, j] = sum_{c < w} sum_pass P_pass[b][c, r] * X_pass[c0_b + c, j]

with x split the same way (X_hi = bf16(x), X_lo = bf16(x - X_hi),
X_3 = bf16(x - X_hi - X_lo)) and the TPU kernel's terms: three passes
(xh Ph + xh Pl + xl Ph, about 1.5e-5 relative) or six (adding xl Pl,
xh P3 and x3 Ph, float32-grade).  Rows c0_b + c >= n read as zero.

Layout: the port keeps each chunk's planes as one contiguous (w, 128)
block, (nb, w, 128) in all; ``interop.wide_window`` maps the JAX
package's (w, m_pad) planes onto it.

``build_wide_window`` builds the payload from the port's plain
``EllMatrix`` on the payload's device, by the JAX package's window rule
(``ell_windowize``/``windowize_arrays`` of the masked layout) and its
``build_wide_window``: None exactly when the JAX package gives None.

``wide_spmm(wide, x)`` launches ``csrc/wide_spmm.cu`` on a CUDA tensor
and runs ``wide_spmm_reference`` on a CPU tensor; a CUDA tensor goes to
the kernel or raises.  ``wide_spmm.launches`` counts the kernel's
launches.  Dispatch from ``ell_spmm`` happens on a CUDA tensor only, for
a payload carrying a window and x float32 with s >= ``min_s`` columns.

The kernel replaces the TPU kernel ``_wide_spmm_t_impl``
(rails_tpu/sparse/wide_spmm.py:136, pallas_call at :199).  Its bound is
bytes: the planes read once, x read and y written once (``wide_work``):
15.3 us at the continuation shape (m = 16384, w = 384, s = 200, three
passes; 19.1 us at six) and 1.92 ms at the bench shape (m = 2^21,
w = 384, s = 192, three passes) on an H100 at 3.35 TB/s.  It treats each
chunk as a GEMM D (128 x s) = P^T (128 x w) X (w x s) per pass term on
the tensor cores (bf16 ``mma.sync`` from shared memory, float32 sums),
skipping window steps whose plane fragments are zero; it stages the
planes and x with ``cp.async`` while the previous tile multiplies,
splits x to bf16 in shared memory, and covers a chunk with adjacent
blocks of up to 256 columns (three passes) or 128 (six)
(``wide_tiling``, ``wide_blocks``), so that its planes come from device
memory once and from L2 after.  At six passes the leading term xh Ph
sums in its own accumulator apart from the correction terms: the tensor
cores truncate their float32 sums, and kept apart the small terms'
truncation is 2^8 smaller than the leading sum's ulp; the two are added
once, round-to-nearest, which keeps six passes within 5e-7 max|y| of
the exact product.  Three passes (bound 8e-5) use one accumulator.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import torch

from rails_tpu_torch.utils.dtypes import full_precision

__all__ = ["WideWindow", "build_wide_window", "wide_blocks", "wide_spmm",
           "wide_spmm_reference", "wide_tiling", "wide_work"]

CHUNK = 128
MIN_S_DEFAULT = 192           # the JAX package's dispatch threshold
BYTES_CAP_DEFAULT = 4 << 30   # refuse multi-GB payloads
W_CAP = 2048                  # widest window (ell_spmm.py's _W_CAP)
MIN_ROWS = 256                # ell_spmm.py's _MIN_ROWS


@dataclasses.dataclass
class WideWindow:
    """Dense-window payload: ``c0`` (nb,) int32 128-aligned window starts;
    bfloat16 planes ``p_hi``, ``p_lo`` and, for six passes, ``p3``, each
    (nb, w, 128); the window width ``w``, the logical ``shape`` (m, n)
    and the dispatch threshold ``min_s``."""

    c0: torch.Tensor
    p_hi: torch.Tensor
    p_lo: torch.Tensor
    p3: Optional[torch.Tensor]
    w: int
    shape: Tuple[int, int]
    min_s: int = MIN_S_DEFAULT

    def __post_init__(self):
        self.w = int(self.w)
        self.shape = (int(self.shape[0]), int(self.shape[1]))
        nb = -(-self.shape[0] // CHUNK)
        planes = [self.p_hi, self.p_lo] + ([] if self.p3 is None
                                           else [self.p3])
        for p in planes:
            if p.dtype != torch.bfloat16 or tuple(p.shape) != (
                    nb, self.w, CHUNK):
                raise ValueError(
                    f"wide planes must be bfloat16 ({nb}, {self.w}, "
                    f"{CHUNK}), got {p.dtype} {tuple(p.shape)}")
        if self.c0.dtype != torch.int32 or tuple(self.c0.shape) != (nb,):
            raise ValueError(f"wide c0 must be int32 ({nb},)")

    @property
    def passes(self) -> int:
        return 6 if self.p3 is not None else 3

    def to(self, device) -> "WideWindow":
        dev = torch.device(device)
        if self.p_hi.device == dev:
            return self
        return WideWindow(self.c0.to(dev), self.p_hi.to(dev),
                          self.p_lo.to(dev),
                          None if self.p3 is None else self.p3.to(dev),
                          self.w, self.shape, self.min_s)


def _window(indices: torch.Tensor, shape):
    """The JAX package's masked-layout window analysis
    (``windowize_arrays``, rails_tpu/sparse/ell_spmm.py:255-285) on the
    plain payload: rows padded to a multiple of 128 by repeating the last
    row's indices, c0 = (chunk min index // 128) * 128, w = the largest
    span rounded up to 128, c0 clamped to n_pad - w.  Returns (c0, lidx
    (m_pad, L) window-local, w) or None when the matrix does not
    qualify."""
    m, n = shape
    if m < MIN_ROWS:
        return None
    ell_l = indices.shape[1]
    m_pad = -(-m // CHUNK) * CHUNK
    idx = indices.to(torch.int64)
    if m_pad != m:
        idx = torch.cat([idx, idx[m - 1:m].expand(m_pad - m, ell_l)])
    nb = m_pad // CHUNK
    ci = idx.reshape(nb, CHUNK * ell_l)
    c0 = (ci.amin(dim=1) // CHUNK) * CHUNK
    span = ci.amax(dim=1) - c0 + 1
    w = -(-int(span.max()) // CHUNK) * CHUNK
    n_pad = -(-n // CHUNK) * CHUNK
    if w > min(W_CAP, n_pad):
        return None
    c0 = torch.clamp(c0, max=n_pad - w)
    lidx = idx - torch.repeat_interleave(c0, CHUNK)[:, None]
    return c0.to(torch.int32), lidx, w


def _split_planes(p: torch.Tensor, three: bool):
    """bfloat16 planes of a float32 array, p ~= hi + lo (+ p3), each by
    round-to-nearest-even (the JAX package's ``_split_planes``)."""
    hi = p.to(torch.bfloat16)
    r = p - hi.to(torch.float32)
    lo = r.to(torch.bfloat16)
    if not three:
        return hi, lo, None
    return hi, lo, (r - lo.to(torch.float32)).to(torch.bfloat16)


def build_wide_window(ell, *, passes: int = 3, min_s: int = MIN_S_DEFAULT,
                      bytes_cap: int = BYTES_CAP_DEFAULT
                      ) -> Optional[WideWindow]:
    """The dense-window planes of an ``EllMatrix``, built on its device.

    None when the matrix has no window (m < 256, or a window wider than
    min(2048, n_pad)) or the planes would exceed ``bytes_cap``; a
    ``passes`` other than 3 or 6 raises - the JAX package's decisions,
    in its order."""
    m, n = ell.shape
    win = _window(ell.indices, ell.shape)
    if win is None:
        return None
    if passes not in (3, 6):
        raise ValueError(f"passes must be 3 or 6, got {passes}")
    c0, lidx, w = win
    m_pad = lidx.shape[0]
    nb = m_pad // CHUNK
    n_planes = 3 if passes == 6 else 2
    if n_planes * w * m_pad * 2 > bytes_cap:
        return None
    # P_b[c, r] at flat (b * w + c) * 128 + r; padding slots add their
    # zero value at a live index, which the scatter-add absorbs
    rows = torch.arange(m_pad, device=lidx.device)
    base = ((rows // CHUNK) * w * CHUNK + rows % CHUNK)[:, None]
    flat = (base + lidx * CHUNK).reshape(-1)
    vals = ell.values.to(torch.float32)
    if m_pad != m:
        vals = torch.cat([vals, vals.new_zeros((m_pad - m, vals.shape[1]))])
    p = torch.zeros(nb * w * CHUNK, dtype=torch.float32,
                    device=lidx.device)
    p.index_put_((flat,), vals.reshape(-1), accumulate=True)
    hi, lo, p3 = _split_planes(p.reshape(nb, w, CHUNK), passes == 6)
    return WideWindow(c0, hi, lo, p3, w, (m, n), min_s)


def wide_work(wide: WideWindow, s: int):
    """Bytes and flops of one apply at s columns - the TPU kernel's
    CostEstimate (wide_spmm.py:203-207): the planes read once, x read and
    y written once (m_pad rows each), passes * 2 * w * 128 * s flops per
    chunk."""
    nb = wide.c0.shape[0]
    m_pad = nb * CHUNK
    n_planes = 3 if wide.p3 is not None else 2
    return (n_planes * wide.w * m_pad * 2 + 2 * m_pad * s * 4,
            wide.passes * 2 * wide.w * CHUNK * s * nb)


def _bf16_split(x: torch.Tensor, three: bool):
    xh = x.to(torch.bfloat16).to(torch.float32)
    xr = x - xh
    xl = xr.to(torch.bfloat16).to(torch.float32)
    x3 = (xr - xl).to(torch.bfloat16).to(torch.float32) if three else None
    return xh, xl, x3


def wide_spmm_reference(wide: WideWindow, x: torch.Tensor,
                        group: Optional[int] = None) -> torch.Tensor:
    """The plain version: the TPU kernel's pass terms (wide_spmm.py:
    172-181) as batched float32 matrix products, chunk group by chunk
    group, so that at most ``group`` x windows (group * w * s floats;
    default about 64 MB) exist at once."""
    m, n = wide.shape
    s = x.shape[1]
    nb, w = wide.c0.shape[0], wide.w
    six = wide.p3 is not None
    if group is None:
        group = max(1, (1 << 24) // max(1, w * s))
    out = torch.empty((nb * CHUNK, s), dtype=torch.float32, device=x.device)
    cols = torch.arange(w, device=x.device)
    with full_precision():
        for g0 in range(0, nb, group):
            g1 = min(nb, g0 + group)
            ridx = wide.c0[g0:g1].to(torch.int64)[:, None] + cols
            valid = (ridx < n).to(torch.float32)[:, :, None]
            xw = x.index_select(0, ridx.clamp(max=max(n - 1, 0)).reshape(-1))
            xw = xw.reshape(g1 - g0, w, s) * valid
            xh, xl, x3 = _bf16_split(xw, six)

            def dot(xp, plane):
                return torch.bmm(plane[g0:g1].to(torch.float32)
                                 .transpose(1, 2), xp)

            acc = dot(xh, wide.p_hi) + dot(xh, wide.p_lo) \
                + dot(xl, wide.p_hi)
            if six:
                acc = acc + dot(xl, wide.p_lo) + dot(xh, wide.p3) \
                    + dot(x3, wide.p_hi)
            out[g0 * CHUNK:g1 * CHUNK] = acc.reshape(-1, s)
    return out[:m]


TILE_MAX = {3: 256, 6: 128}   # widest column tile of the kernel (NT)
K_TILE = 32                   # window rows per K-tile of the kernel (BK)


def wide_tiling(s: int, passes: int = 3) -> Tuple[int, int]:
    """The kernel's column tiles at ``s`` columns: (tw, nct), tiles of
    width tw (a multiple of 8, the mma's n; at most 256 at three passes,
    128 at six, whose leading term keeps a second accumulator) as even
    as that allows, so that no more than the last 8-column group of s is
    padding: 200 at six passes -> (104, 2) covers 104 + 96."""
    if s <= 0:
        raise ValueError(f"wide_tiling: s must be positive, got {s}")
    cap = TILE_MAX[passes]
    nct = -(-s // cap)
    tw = -(-(-(-s // nct)) // 8) * 8
    return tw, -(-s // tw)


def wide_blocks(nb: int, s: int, passes: int = 3):
    """The kernel's blocks in launch order (block id = chunk * nct +
    column tile, the tile fastest) as (chunk, col0, col1): a chunk's
    column tiles are adjacent, so all but the first read its planes from
    L2."""
    tw, nct = wide_tiling(s, passes)
    return [(i // nct, (i % nct) * tw, min(s, (i % nct + 1) * tw))
            for i in range(nb * nct)]


_FN = []


def _kernel_fn():
    """The C entry point; builds and loads at first use."""
    if not _FN:
        from rails_tpu_torch import _build

        fn = _build.load("wide_spmm").rails_wide_spmm_f32
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                       ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
                       ctypes.c_void_p]
        _FN.append(fn)
    return _FN[0]


def wide_spmm(wide: WideWindow, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x through the dense-window payload.  CPU tensors: the
    plain version.  CUDA tensors: the kernel, after checking device,
    dtype, shape and contiguity."""
    if x.device.type == "cpu":
        return wide_spmm_reference(wide, x)
    if x.device.type != "cuda":
        raise ValueError(f"wide_spmm: unsupported device {x.device}")
    if x.device.index != torch.cuda.current_device():
        with torch.cuda.device(x.device):
            return wide_spmm(wide, x)
    m, n = wide.shape
    if x.dtype != torch.float32:
        raise TypeError(f"wide_spmm kernel takes float32, got {x.dtype}")
    if x.ndim != 2 or x.shape[0] != n:
        raise ValueError(f"wide_spmm: x shape {tuple(x.shape)} does not "
                         f"match A shape {wide.shape}")
    planes = [wide.p_hi, wide.p_lo] + ([] if wide.p3 is None
                                       else [wide.p3])
    for t in planes + [wide.c0]:
        if t.device != x.device:
            raise ValueError(f"wide_spmm: payload on {t.device}, x on "
                             f"{x.device}")
        if not t.is_contiguous():
            raise ValueError("wide_spmm: payload must be contiguous")
    if wide.w % K_TILE or any(p.data_ptr() % 16 for p in planes):
        raise ValueError(f"wide_spmm kernel takes w a multiple of {K_TILE} "
                         f"and 16-byte aligned planes, got w={wide.w}")
    if not x.is_contiguous():
        raise ValueError("wide_spmm: x must be contiguous")
    s = x.shape[1]
    if m == 0 or s == 0:
        return torch.zeros((m, s), dtype=x.dtype, device=x.device)
    y = torch.empty((m, s), dtype=x.dtype, device=x.device)
    p3 = 0 if wide.p3 is None else wide.p3.data_ptr()
    rc = _kernel_fn()(wide.c0.data_ptr(), wide.p_hi.data_ptr(),
                      wide.p_lo.data_ptr(), p3, wide.w,
                      wide.c0.shape[0], x.data_ptr(), n, m, s,
                      wide_tiling(s, wide.passes)[0], y.data_ptr(),
                      torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"wide_spmm kernel launch failed: cudaError {rc}")
    wide_spmm.launches += 1
    return y


wide_spmm.launches = 0
