"""PyTorch port, parity bar P1: RNG seeds, pupil samples, kernel rows and ray
tiles are bitwise equal to the JAX package's."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    seeding as jseeding,
    trace_pallas as jrows,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.ops import rng as jrng

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    seeding,
    trace_rows,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.ops import rng

M, N = 4, 3


@pytest.fixture(scope="module")
def fixture():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom, simplify_tol=0.05)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=600, seed=6)
    return geom, tables, tgeom, cfg


def test_seed_fast_bitwise():
    idx = np.concatenate([np.arange(5000, dtype=np.uint64),
                          np.array([2**32 - 1, 2**32, 2**40 + 7], np.uint64)])
    for seed in (0, 6, 12345):
        np.testing.assert_array_equal(rng.seed_fast(idx, seed),
                                      jrng.seed_fast(idx, seed))
    np.testing.assert_array_equal(rng.seed_parity(idx[:5000]),
                                  jrng.seed_parity(idx[:5000]))


def test_xorshift_and_draw24_match_jax():
    s = jrng.seed_fast(np.arange(4096, dtype=np.uint64), 3)
    s_j = jnp.asarray(s)
    s_t = torch.from_numpy(s.astype(np.int64))
    for _ in range(4):
        s_j = jrng.xorshift32_step(s_j)
        s_t = rng.xorshift32_step(s_t)
        np.testing.assert_array_equal(s_t.numpy().astype(np.uint32),
                                      np.asarray(s_j))
        np.testing.assert_array_equal(
            rng.draw24(s_t).numpy(),
            np.asarray(jrows._draw24(s_j)))


@pytest.mark.parametrize("sampling,shared,rng_mode", [
    ("uniform", True, "fast"), ("r2", True, "fast"), ("uniform", False, "fast"),
    ("uniform", True, "parity")])
def test_build_ray_batch_bitwise(fixture, sampling, shared, rng_mode):
    geom, _, _, cfg = fixture
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128, seed=6,
                      pupil_sampling=sampling, shared_pupil_samples=shared,
                      rng_mode=rng_mode)
    cells = np.array([0, 5, 17, 35])
    for it in ((0,) if rng_mode == "parity" else (0, 2)):
        a = seeding.build_ray_batch(geom, cfg, cell_ids=cells, iteration=it)
        b = jseeding.build_ray_batch(geom, cfg, cell_ids=cells, iteration=it)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype, k
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_cell_seeds_match_jax_device_hash():
    """The persistent path's per-slot seeds: global index
    (iteration * cells + cid) * slots + slot, as the JAX pipeline hashes it."""
    cells, slots, total = np.arange(40, 76), 256, 900
    for it in (0, 3):
        idx = ((jnp.uint32(it * total)
                + jnp.asarray(cells.astype(np.uint32))[:, None])
               * jnp.uint32(slots) + jnp.arange(slots, dtype=jnp.uint32)[None, :])
        want = np.asarray(jrng.seed_fast_device(idx, 6))
        np.testing.assert_array_equal(
            seeding.cell_seeds(cells, slots, it, total, 6), want)


def test_cell_rows_and_ray_tiles_bitwise(fixture):
    geom, tables, tgeom, cfg = fixture
    np.testing.assert_array_equal(
        trace_rows.build_kernel_cell_params(tables, geom.eyebox_range),
        jrows.build_kernel_cell_params(tables, geom.eyebox_range))
    np.testing.assert_array_equal(trace_rows.build_kernel_geom(tgeom),
                                  jrows.build_kernel_geom(tgeom))
    batch = jseeding.build_ray_batch(geom, cfg)
    for rt in (1, 2):
        got = trace_rows.pack_ray_blocks(batch, 3 * M * N, 128, rt)
        want = jrows.pack_ray_blocks(batch, 3 * M * N, 128, rt)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_rows_to_device_carries_rows_unchanged(fixture):
    geom, tables, tgeom, cfg = fixture
    cp = jrows.build_kernel_cell_params(tables, geom.eyebox_range)
    gr = jrows.build_kernel_geom(tgeom)[None, :]
    cpt, grt = trace_rows.rows_to_device(cp, gr, "cpu")
    assert cpt.dtype == grt.dtype == torch.float32
    assert tuple(grt.shape) == (1, trace_rows.PG)
    np.testing.assert_array_equal(cpt.numpy(), cp)
    np.testing.assert_array_equal(grt.numpy(), gr)
    rays, seeds = jrows.pack_ray_blocks(
        jseeding.build_ray_batch(geom, cfg), 3 * M * N, 128, 1)
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    assert st.dtype == torch.int32
    np.testing.assert_array_equal(st.numpy().view(np.uint32), seeds)
    np.testing.assert_array_equal(rt.numpy(), rays)


def test_geometry_row_paper_design_full_grid():
    """The geometry row at the main path's size: the paper design on the
    100 x 75 FoV grid, with the kernels' 0.05 simplification tolerance."""
    tgeom = build_trace_geometry(generate_geometry(num_fov_x=100, num_fov_y=75),
                                 simplify_tol=0.05)
    np.testing.assert_array_equal(trace_rows.build_kernel_geom(tgeom),
                                  jrows.build_kernel_geom(tgeom))
    assert trace_rows.edge_counts(tgeom) == (len(tgeom.hull_hp),
                                             len(tgeom.r1_hp), len(tgeom.r2_hp))
    assert (tgeom.num_fc, tgeom.num_oc) == (7, 6)
    assert jax.devices()[0].platform == "cpu"
