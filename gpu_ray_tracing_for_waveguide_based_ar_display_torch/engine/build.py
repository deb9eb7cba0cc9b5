"""Build the CUDA sources of ``csrc/`` with ``nvcc`` and load them by ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and compiles into
``build/kernels/<name>-<hash>.so`` under the repository root at first use; the
hash covers the source, every header of ``csrc/`` and the flags, so an edited
source or header never loads a stale library.  A failed build raises with the
compiler's output.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"

# -fmad=false: no multiply-add contraction, so the kernels match their plain
# PyTorch versions bit for bit (a deliberate cost of the first port)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

# name -> {"seconds": build time (0.0 when cached), "log": compiler output}
build_info = {}
_LOADED = {}


def nvcc_path() -> str:
    """``nvcc`` from PATH, else from CUDA_HOME or /usr/local/cuda."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, CUDA_HOME, /usr/local/cuda); "
                       "the CUDA kernels cannot be built")


def library_path(name: str) -> Path:
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    digest = h.hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library is already built."""
    out = library_path(name)
    if out.is_file():
        build_info.setdefault(name, {"seconds": 0.0, "log": ""})
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    log = (proc.stdout + proc.stderr).strip()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed to build {name} "
                           f"(exit {proc.returncode}):\n{' '.join(cmd)}\n{log}")
    os.replace(tmp, out)
    build_info[name] = {"seconds": seconds, "log": log}
    return out


def build_all(names) -> list:
    """Build several sources at once, one ``nvcc`` process each."""
    names = list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        return list(pool.map(build, names))


def load_library(name: str) -> ctypes.CDLL:
    """Build if needed and load ``csrc/<name>.cu`` as a shared library."""
    if name not in _LOADED:
        _LOADED[name] = ctypes.CDLL(str(build(name)))
    return _LOADED[name]
