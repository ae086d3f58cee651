"""One thread for the host's BLAS inside a block.

The numpy and scipy wheels each bundle their own OpenBLAS (in
``numpy.libs`` and ``scipy.libs`` beside the packages).  The port calls
small LAPACK and BLAS routines on the host between stretches of device
work - the projected Schur solve's Schur factor and trsyl at k of a few
hundred - where OpenBLAS's threads cost more than they give: on the 8-core host
of an H100 80GB HBM3 (700.00 W), ``chip_smoke.py``'s cli_schur spent
200 ms per projected solve (zgees and trsyl) with the default threads
(88.6 s in all) and 49 ms with one (31.0 s).
``single_thread_blas`` sets every bundled OpenBLAS it finds to one
thread and puts the counts back on exit; where it finds none (a numpy
built on another BLAS) it changes nothing.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from pathlib import Path

__all__ = ["single_thread_blas"]

# (set, get) thread-count symbols: scipy-openblas with 64-bit and 32-bit
# integers, and a plain OpenBLAS
_SYMBOLS = (("scipy_openblas_set_num_threads64_",
             "scipy_openblas_get_num_threads64_"),
            ("scipy_openblas_set_num_threads",
             "scipy_openblas_get_num_threads"),
            ("openblas_set_num_threads", "openblas_get_num_threads"))


@functools.lru_cache(maxsize=None)
def _controls():
    """The (set, get) functions of each OpenBLAS bundled with numpy and
    scipy."""
    import numpy
    import scipy

    found = []
    for pkg in (numpy, scipy):
        libs = Path(pkg.__file__).resolve().parent.parent / \
            f"{pkg.__name__}.libs"
        for path in sorted(libs.glob("lib*openblas*.so*")):
            lib = ctypes.CDLL(str(path))
            for set_name, get_name in _SYMBOLS:
                if hasattr(lib, set_name) and hasattr(lib, get_name):
                    found.append((getattr(lib, set_name),
                                  getattr(lib, get_name)))
                    break
    return tuple(found)


@contextlib.contextmanager
def single_thread_blas():
    """Run the enclosed block with one OpenBLAS thread."""
    controls = _controls()
    saved = [get() for _, get in controls]
    for set_threads, _ in controls:
        set_threads(1)
    try:
        yield
    finally:
        for (set_threads, _), n in zip(controls, saved):
            set_threads(n)
