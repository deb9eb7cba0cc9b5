"""PyTorch port: seeds hashed on the device are the host's seeds, bit for bit.

``ops.rng.seed_fast_device`` against the numpy ``seed_fast`` (every index,
from 2^32 on included) and against the JAX package's ``seed_fast_device``
(plain jit, its uint32 index range), the int32 view the kernels take, and
the seed blocks of the persistent Simulator and the design sweep against
``seeding.cell_seeds``.  Everything runs on the CPU."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.ops import rng as jrng

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    seeding,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.ops import rng
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    design_sweep,
)

SEEDS = (0, 1, 6, 12345, 2**31 - 1, 2**40 + 3)


def _indices(seed: int) -> np.ndarray:
    """A dense run from 0, the indices at and around 2^32, those whose low
    word carries into the high word when the seed's offset is added, and a
    few up to 2^63 - 1."""
    off_lo = (seed * 0x9E3779B97F4A7C15) & 0xFFFFFFFF
    carry = (2**32 - off_lo + np.arange(-300, 300)) % 2**32
    return np.concatenate([
        np.arange(200_000), np.arange(2**32 - 500, 2**32 + 500), carry,
        carry + 2**32, np.array([2**40, 2**62 + 5, 2**63 - 1]),
    ]).astype(np.uint64)


@pytest.mark.parametrize("seed", SEEDS)
def test_device_hash_equals_numpy_hash(seed):
    idx = _indices(seed)
    want = rng.seed_fast(idx, seed)
    got = rng.seed_fast_device(torch.from_numpy(idx.astype(np.int64)), seed)
    assert got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
    assert (got.numpy() >= 2**31).any() and got.min() >= 1


@pytest.mark.parametrize("seed", SEEDS[:5])
def test_device_hash_equals_jax_device_hash(seed):
    """The JAX package's uint32-pair emulation (its index range is uint32)
    and the port's int64 hash give the same bits, and the port's int32 view
    holds them (values from 2^31 wrap to negative)."""
    idx = np.concatenate([np.arange(100_000),
                          np.arange(2**32 - 100_000, 2**32)]).astype(np.uint32)
    want = np.asarray(jax.jit(lambda i: jrng.seed_fast_device(i, seed))(
        jnp.asarray(idx)))
    got = rng.seed_fast_device(torch.from_numpy(idx.astype(np.int64)), seed)
    bits = rng.as_int32_bits(got)
    assert bits.dtype == torch.int32
    np.testing.assert_array_equal(bits.numpy(), want.view(np.int32))
    assert (bits < 0).any() and (bits > 0).any()


def test_int32_view_wraps():
    u = torch.tensor([0, 1, 2**31 - 1, 2**31, 2**31 + 7, 2**32 - 1])
    np.testing.assert_array_equal(
        rng.as_int32_bits(u).numpy(),
        u.numpy().astype(np.uint32).view(np.int32))


@pytest.mark.parametrize("iteration", [0, 3])
def test_cell_seeds_device_equal_host(iteration):
    """Contiguous and scattered cells, hashed a few cells at a time, with
    indices past 2^32 at iteration 3."""
    total, slots = 600_000, 2048
    for cells in (np.arange(100, 164), np.array([5, 9, 599_999, 300_001, 7])):
        want = seeding.cell_seeds(cells, slots, iteration, total, 6)
        got = seeding.cell_seeds_device(cells, slots, iteration, total, 6,
                                        "cpu", cells_per_hash=3)
        np.testing.assert_array_equal(got.numpy(), want.view(np.int32))


@pytest.fixture(scope="module")
def sim():
    cfg = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                      max_bounces=200, seed=6)
    return pipeline.Simulator(cfg=cfg, device="cpu", persistent_slots=128)


@pytest.mark.parametrize("cells,cpb,iteration", [
    (np.arange(36), 1, 0), (np.arange(8, 20), 1, 2),
    (np.array([0, 1, 2, 30, 31, 35]), 1, 1), (np.arange(36), 2, 1),
    (np.arange(12, 24), 4, 0)])
def test_simulator_seed_blocks_equal_host_seeds(sim, cells, cpb, iteration):
    """``_device_ray_blocks``: the seed contract for contiguous and scattered
    batches and under the (C / cpb, cpb * RT, 128) reshape."""
    slots = 128
    _, got = sim._device_ray_blocks(cells, slots, iteration, cpb=cpb)
    want = seeding.cell_seeds(cells, slots, iteration, 36, 6).view(np.int32)
    assert tuple(got.shape) == (len(cells) // cpb, cpb, 128)
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(len(cells) // cpb, cpb, 128))


@pytest.mark.parametrize("cpb", [1, 4])
def test_sweep_seed_block_equals_host_seeds(cpb):
    cfg = dataclasses.replace(TraceConfig(num_fov_x=4, num_fov_y=3), seed=11)
    got = design_sweep.shared_seed_block(cfg, 256, cpb, device="cpu")
    want = seeding.cell_seeds(np.arange(36), 256, 0, 36, 11).view(np.int32)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  want.reshape(36 // cpb, -1, 128))
