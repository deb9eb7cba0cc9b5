"""Per-ray xorshift32 RNG and seed hashes.

Port of ``ops/rng.py`` of the JAX package.  The host seed hashes run in
numpy (uint32 / uint64 arithmetic, bitwise equal to the JAX package's);
:func:`seed_fast_device` is the same hash in ``int64`` tensor arithmetic on
any device.  The torch versions serve the plain trace: the 32-bit state lives
in ``int64`` tensors and is masked to 32 bits after every left shift, because
torch's ``uint32`` shifts and multiplies are only partly supported.
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


def draw_uniform(state: torch.Tensor, ray_idx: torch.Tensor,
                 advance: torch.Tensor):
    """U[0, 1) float32 per ray, and the state advanced only where
    ``advance``: a zero state first reseeds from the ray index as
    ``_RESEED ^ (idx + 1)``; a ray that does not advance keeps its state
    (its draw means nothing).  ``state`` and ``ray_idx`` are int64 holding
    uint32 values."""
    s = torch.where(state == 0, _RESEED ^ ((ray_idx + 1) & _MASK32), state)
    s_new = xorshift32_step(s)
    return draw24(s_new), torch.where(advance, s_new, state)


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


def _i64(k: int) -> int:
    """A 64-bit constant as the signed int64 holding the same bits."""
    k &= 0xFFFFFFFFFFFFFFFF
    return k - (1 << 64) if k >= 1 << 63 else k


def _shr_xor(x: torch.Tensor, k: int) -> torch.Tensor:
    """``x ^ (x >> k)`` with a logical shift: torch's int64 ``>>`` is
    arithmetic, so the sign bits it brings in are masked off."""
    return x ^ ((x >> k) & ((1 << (64 - k)) - 1))


def seed_fast_device(ray_idx: torch.Tensor, seed: int) -> torch.Tensor:
    """:func:`seed_fast` on the tensor's device, bitwise: ``ray_idx`` is an
    integer tensor of global ray indices (any value below 2^63); returns
    int64 holding the uint32 seeds.  The splitmix64 rounds run in native
    int64, whose additions and multiplications wrap mod 2^64 as uint64's do.
    The JAX package emulates uint64 in uint32 pairs (its device has no
    64-bit integers) and keeps a host branch for indices from 2^32 on; here
    one path covers every index and gives the host hash's values."""
    x = ray_idx.to(torch.int64) + _i64(seed * 0x9E3779B97F4A7C15)
    x = _shr_xor(x, 30) * _i64(0xBF58476D1CE4E5B9)
    x = _shr_xor(x, 27) * _i64(0x94D049BB133111EB)
    out = _shr_xor(x, 31) & _MASK32
    return torch.where(out == 0, 1, out)


def as_int32_bits(u32: torch.Tensor) -> torch.Tensor:
    """int64 values in [0, 2^32) -> int32 holding the same bits (values from
    2^31 on wrap to negative), the kernels' view of uint32 seeds."""
    return torch.where(u32 >= 2**31, u32 - 2**32, u32).to(torch.int32)
