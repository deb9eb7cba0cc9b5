"""ctypes bindings for the native host pupil sampler (``csrc/host_sampler.cpp``).

Port of ``engine/native.py`` of the JAX package.  ``csrc/host_sampler.cpp``
is a byte-identical copy of the JAX package's ``native/host_sampler.cpp``:
pupil rejection sampling and SoA ray-block construction (the reference's
``generate_points_in_polygon`` and its ray-initialisation loops).  It is
built with ``g++`` and the JAX package's ``native/Makefile`` flags at first
use, into ``build/native/host_sampler-<hash>.so`` under the repository root;
the hash covers the source, the compiler, the flags and the host CPU
(``-march=native`` builds for it).  Where the JAX binding falls back to
numpy when the library cannot be built, the port raises with the compiler's
output.

With ``-march=native`` and GCC's default ``-ffp-contract=fast`` the points are
reproducible only between libraries built with the same flags on the same
machine.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parent.parent / "csrc" / "host_sampler.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "native"
CXX = "g++"
# the JAX package's native/Makefile CXXFLAGS
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-shared", "-std=c++17", "-Wall"]

_LIB = None


def _cpu_key() -> bytes:
    """The host CPU's model and feature flags (what -march=native reads)."""
    try:
        lines = Path("/proc/cpuinfo").read_text().splitlines()
    except OSError:
        return os.uname().machine.encode()
    keep = [ln for ln in lines if ln.startswith(("model name", "flags"))]
    return "\n".join(sorted(set(keep))).encode()


def library_path() -> Path:
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join([CXX, *CXX_FLAGS]).encode())
    h.update(_cpu_key())
    return BUILD_DIR / f"host_sampler-{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile :data:`SOURCE` unless its library is already built; raises
    with the compiler's output if the build fails."""
    out = library_path()
    if out.is_file():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except FileNotFoundError as e:
        raise RuntimeError(f"{CXX} not found: the native pupil sampler "
                           "cannot be built") from e
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"{CXX} failed to build {SOURCE.name} (exit {proc.returncode}):"
            f"\n{' '.join(cmd)}\n{(proc.stdout + proc.stderr).strip()}")
    os.replace(tmp, out)
    return out


def _load() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(build()))
        lib.sample_points_in_polygon.restype = ctypes.c_long
        lib.sample_points_in_polygon.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_int, ctypes.c_long,
            ctypes.c_uint64, ctypes.POINTER(ctypes.c_double),
        ]
        lib.fill_ray_blocks.restype = None
        lib.fill_ray_blocks.argtypes = [
            ctypes.POINTER(ctypes.c_double), ctypes.c_long,
            ctypes.POINTER(ctypes.c_int), ctypes.c_long, ctypes.c_long,
            ctypes.c_long, ctypes.c_uint64, ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint32),
        ]
        _LIB = lib
    return _LIB


def available() -> bool:
    """Whether the library builds and loads here."""
    try:
        _load()
    except (RuntimeError, OSError):
        return False
    return True


def sample_points_in_polygon(poly: np.ndarray, num: int,
                             seed: int) -> np.ndarray:
    """(num, 2) float64 points uniform inside the polygon, drawn from a
    xoshiro256 stream seeded by ``seed``."""
    lib = _load()
    poly = np.ascontiguousarray(poly, dtype=np.float64)
    out = np.empty((num, 2), dtype=np.float64)
    lib.sample_points_in_polygon(
        poly.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(poly), num, seed & 0xFFFFFFFFFFFFFFFF,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    return out


def fill_ray_blocks(points: np.ndarray, cell_ids: np.ndarray, rpc: int,
                    rp: int, seed: int,
                    iter_offset: int) -> Tuple[np.ndarray, np.ndarray]:
    """SoA kernel blocks: (rays (C, 6, rp) f32, rng (C, rp) u32) with
    seeding identical to :func:`..ops.rng.seed_fast` on indices
    ``cell_id * rpc + i + iter_offset``."""
    lib = _load()
    points = np.ascontiguousarray(points, dtype=np.float64)
    cell_ids = np.ascontiguousarray(cell_ids, dtype=np.int32)
    n_cells = len(cell_ids)
    rays = np.empty((n_cells, 6, rp), dtype=np.float32)
    rng = np.empty((n_cells, rp), dtype=np.uint32)
    lib.fill_ray_blocks(
        points.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        len(points),
        cell_ids.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
        n_cells, rpc, rp, seed & 0xFFFFFFFFFFFFFFFF,
        iter_offset & 0xFFFFFFFFFFFFFFFF,
        rays.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        rng.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
    )
    return rays, rng
