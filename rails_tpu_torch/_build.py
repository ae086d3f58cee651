"""Build and load the port's CUDA kernels and its C++ host library.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, ``build/rails_tpu_torch/
<name>-<hash>.so`` beside the package (the directory is git-ignored), and
loaded with ctypes.  ``<hash>`` covers the source and the flags, so a
changed source builds anew and an unchanged one is reused.  The build
uses only the sources in this checkout and the installed CUDA toolkit
(``$CUDA_HOME/bin/nvcc``, else ``/usr/local/cuda/bin/nvcc``, else
``nvcc`` on the PATH).  It runs at first use, never at import.

``build_all()`` starts one ``nvcc`` per source, all at once, and waits
for them; it returns each kernel's build seconds and ``-Xptxas -v``
lines (registers, stack, spills).

``load_host()`` builds ``native/librails_host.cpp`` (the sparse LU and
the MatrixMarket reader) the same way with ``g++ -O2 -shared -fPIC
-std=c++17`` into ``build/rails_tpu_torch/librails_host-<hash>.so`` at
first use.  A failed build raises with g++'s output: there is no
fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict

__all__ = ["build_all", "load", "load_host", "sources", "BUILD_DIR",
           "HOST_SOURCE"]

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "rails_tpu_torch"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
HOST_SOURCE = PKG_DIR / "native" / "librails_host.cpp"
HOST_FLAGS = ["-O2", "-shared", "-fPIC", "-std=c++17"]

_lock = threading.Lock()
_loaded: Dict[str, ctypes.CDLL] = {}


def sources() -> Dict[str, Path]:
    """Kernel name -> source path, for every ``csrc/*.cu``."""
    return {p.stem: p for p in sorted(CSRC_DIR.glob("*.cu"))}


def _nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and (Path(cand) / "bin" / "nvcc").is_file():
            return str(Path(cand) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only "
                           "where the CUDA toolkit is installed")
    return found


def _target(src: Path, flags=NVCC_FLAGS) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(flags).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, dict]:
    """Compile the named kernels (default: all) that are not built yet,
    one ``nvcc`` each, in parallel.  Returns, per kernel, ``seconds``
    (0.0 when cached), ``cached`` and ``ptxas`` (the -Xptxas -v lines).
    Raises with the compiler's output if a build fails."""
    srcs = sources()
    names = list(srcs) if names is None else list(names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report, procs = {}, {}
    for name in names:
        src = srcs[name]
        out = _target(src)
        log = out.with_suffix(".log")
        if out.is_file():
            report[name] = {"seconds": 0.0, "cached": True,
                            "ptxas": _ptxas_lines(log)}
            continue
        tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       time.perf_counter(), tmp, out, log)
    failed = []
    for name, (proc, t0, tmp, out, log) in procs.items():
        text, _ = proc.communicate()
        secs = time.perf_counter() - t0
        log.write_text(text)
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exit {proc.returncode}\n{text}")
            continue
        os.replace(tmp, out)
        report[name] = {"seconds": secs, "cached": False,
                        "ptxas": _ptxas_lines(log)}
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return report


def _ptxas_lines(log: Path):
    if not log.is_file():
        return []
    return [ln.strip() for ln in log.read_text().splitlines()
            if "ptxas" in ln or "spill" in ln]


def load(name: str) -> ctypes.CDLL:
    """The built library of kernel ``name``, building it at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            build_all([name])
            lib = _loaded[name] = ctypes.CDLL(str(_target(sources()[name])))
        return lib


def build_host() -> Path:
    """Compile the host library if it is not built yet; returns its
    path.  Raises with g++'s output if the build fails."""
    out = _target(HOST_SOURCE, HOST_FLAGS)
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host library "
                           f"{HOST_SOURCE.name} builds with g++")
    proc = subprocess.run([cxx, *HOST_FLAGS, "-o", str(tmp),
                           str(HOST_SOURCE)], capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"host library build failed: g++ exit "
                           f"{proc.returncode}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def load_host() -> ctypes.CDLL:
    """The built host library, building it at first use."""
    with _lock:
        lib = _loaded.get("librails_host")
        if lib is None:
            lib = _loaded["librails_host"] = ctypes.CDLL(str(build_host()))
        return lib
