"""Per-ray xorshift32 RNG and seed hashes.

A frozen copy of the port's ``ops/rng.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The host seed hashes run in numpy (uint32 / uint64 arithmetic); the torch
steps serve the plain trace: the 32-bit state lives in ``int64`` tensors and
is masked to 32 bits after every left shift.
"""

from __future__ import annotations

import numpy as np
import torch

_GOLDEN = np.uint32(0x9E3779B9)
_RESEED = 0x6D2B79F5
_MASK32 = 0xFFFFFFFF
_INV_2_24 = 1.0 / 16777216.0


def xorshift32_step(s: torch.Tensor) -> torch.Tensor:
    """One xorshift32 update; ``s`` is int64 holding values in [0, 2^32)."""
    s = s ^ ((s << 13) & _MASK32)
    s = s ^ (s >> 17)
    s = s ^ ((s << 5) & _MASK32)
    return s


def draw24(s_new: torch.Tensor) -> torch.Tensor:
    """U[0, 1) float32 from the top 24 bits of a post-step state (exact in
    float32; not ``s * 2^-32``)."""
    return (s_new >> 8).to(torch.float32) * _INV_2_24


def seed_parity(ray_idx: np.ndarray) -> np.ndarray:
    """Reference seeding: 0x9E3779B9 * (idx + 1) mod 2^32."""
    return (_GOLDEN * (ray_idx.astype(np.uint32) + np.uint32(1))).astype(np.uint32)


def seed_fast(ray_idx: np.ndarray, seed: int) -> np.ndarray:
    """splitmix64 hash of (global seed, ray index), low 32 bits, never 0."""
    offset = np.uint64((seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF)
    x = ray_idx.astype(np.uint64) + offset
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    x = x ^ (x >> np.uint64(31))
    out = (x & np.uint64(_MASK32)).astype(np.uint32)
    return np.where(out == 0, np.uint32(1), out)
