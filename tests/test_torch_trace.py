"""PyTorch port: the persistent trace against the JAX persistent kernel.

The plain PyTorch version runs here; the JAX kernel runs in interpret mode in
the main path's mode (exact "fma" selection, count spawn, no phase gating).
The CUDA kernel itself runs only on a card: see ``test_torch_cuda.py``."""

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
    trace_pallas_persistent as jpers,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    build,
    trace_persistent as tp,
    trace_rows,
)

M, N, RT, MAX_ITERS = 4, 3, 1, 600
C = 3 * M * N
BINS = (80, 120)


@pytest.fixture(scope="module")
def rows():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom, simplify_tol=0.05)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=MAX_ITERS, seed=6)
    cp = jrows.build_kernel_cell_params(tables, geom.eyebox_range)
    gr = jrows.build_kernel_geom(tgeom)[None, :]
    rays, seeds = jrows.pack_ray_blocks(jseeding.build_ray_batch(geom, cfg),
                                        C, 128, RT)
    ec = (len(tgeom.hull_hp), len(tgeom.r1_hp), len(tgeom.r2_hp))
    kw = dict(num_fc=tgeom.num_fc, num_oc=tgeom.num_oc, edge_counts=ec,
              eyebox_bins=BINS, max_iters=MAX_ITERS)
    return cfg, cp, gr, rays, seeds, kw


@pytest.fixture(scope="module")
def traced(rows):
    cfg, cp, gr, rays, seeds, kw = rows
    fn = jpers.make_persistent_trace_fn(
        cfg, kw["num_fc"], kw["num_oc"], RT, gens=1, interpret=True,
        phase_gating=False, max_iters=MAX_ITERS, edge_counts=kw["edge_counts"],
        accum_mode="fma", count_spawn=True)
    hj, nbj = fn(cp, gr, rays, seeds, jnp.asarray([512, 0], jnp.int32))
    cpt, grt = trace_rows.rows_to_device(cp, gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    ht, nbt = tp.persistent_trace_reference(
        cpt, grt, rt, st, torch.tensor([512, 0], dtype=torch.int32), **kw)
    return (np.asarray(hj)[:, :, :BINS[1]], np.asarray(nbj),
            ht.numpy(), nbt.numpy())


def test_plain_trace_matches_jax_kernel(traced):
    """Tolerances: bounces and spawned within 1 %, deposits within
    max(10, 2 %), per colour within max(10, 3 %).  XLA fuses multiply-adds
    and rounds rsqrt differently from ``1/sqrt``, so a ray within an ulp of a
    threshold may branch differently.  Measured on this fixture: identical
    (586 deposits, 114,069 bounces, 18,737 spawned; every cell's tile equal)."""
    hj, nbj, ht, nbt = traced
    assert ht.shape == hj.shape == (C, *BINS)
    assert nbt.shape == (C, 4) and nbt.dtype == np.int32
    b_j, b_t = int(nbj[:, 0].sum()), int(nbt[:, 0].sum())
    s_j, s_t = int(nbj[:, 2].sum()), int(nbt[:, 2].sum())
    assert abs(b_t - b_j) <= 0.01 * b_j
    assert abs(s_t - s_j) <= 0.01 * s_j
    d_j, d_t = hj.sum(), ht.sum()
    assert d_j > 100
    assert abs(d_t - d_j) <= max(10, 0.02 * d_j)
    for l in range(3):
        pj = hj[l * M * N:(l + 1) * M * N].sum()
        pt = ht[l * M * N:(l + 1) * M * N].sum()
        assert abs(pt - pj) <= max(10, 0.03 * pj), (l, pt, pj)
    assert (nbt[:, 3] == 0).all()


def test_count_spawn_meets_target(traced):
    """Every cell spawns at least its target, overshooting by less than one
    iteration's worth of slots."""
    _, _, ht, nbt = traced
    assert (nbt[:, 2] >= 512).all()
    assert (nbt[:, 2] < 512 + 128).all()
    assert (nbt[:, 1] < MAX_ITERS).all()   # every cell drained before the bound
    assert np.isfinite(ht).all() and (ht >= 0).all()


def test_shared_tile_equals_per_cell_tiles(rows):
    """One (1, 6, RT, 128) launch tile broadcast to every cell gives the same
    result as the same tile repeated per cell."""
    cfg, cp, gr, rays, seeds, kw = rows
    cpt, grt = trace_rows.rows_to_device(cp[:6], gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays[:1], seeds[:6], "cpu")
    ctrl = torch.tensor([256, 0], dtype=torch.int32)
    h1, nb1 = tp.persistent_trace(cpt, grt, rt, st, ctrl, **kw)
    h6, nb6 = tp.persistent_trace(cpt, grt, rt.expand(6, -1, -1, -1).contiguous(),
                                  st, ctrl, **kw)
    assert torch.equal(h1, h6) and torch.equal(nb1, nb6)


def test_hist_tiles_to_histogram_matches_jax(traced):
    """The port's device assembler (the pipeline's) against the JAX host one,
    for every cell and for a scattered subset of cells."""
    hj, _, ht, _ = traced
    padded = np.pad(hj, ((0, 0), (0, 0), (0, 8)))
    for cells in (np.arange(C), np.array([3, 0, 17, 35, 20])):
        want = jpers.hist_tiles_to_histogram(padded[:len(cells)], cells,
                                             3, M, N, *BINS)
        got = tp.hist_tiles_to_histogram(
            torch.from_numpy(padded[:len(cells)].copy()), cells, 3, M, N, *BINS)
        assert got.shape == (3, N, M, *BINS)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "ctrl", "strips"])
def test_wrapper_rejects_bad_inputs(rows, bad):
    cfg, cp, gr, rays, seeds, kw = rows
    cpt, grt = trace_rows.rows_to_device(cp[:2], gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays[:2], seeds[:2], "cpu")
    ctrl = torch.tensor([128, 0], dtype=torch.int32)
    kw = dict(kw)
    if bad == "dtype":
        st = st.to(torch.int64)
    elif bad == "shape":
        grt = grt[:, :100]
    elif bad == "contiguous":
        rt = rt.transpose(2, 3)
    elif bad == "ctrl":
        ctrl = ctrl[:1]
    else:
        kw["num_fc"] = tp.MAX_FC + 1
    with pytest.raises((TypeError, ValueError)):
        tp.persistent_trace(cpt, grt, rt, st, ctrl, **kw)


def test_block_layout_fits_hopper_shared_memory():
    """The main path's 2,048 slots fit one block's shared memory with an
    80 x 120 tile; every slot count that is a multiple of 128 gets a block
    size dividing it."""
    assert tp.shared_bytes(2048, (80, 120)) <= tp._SMEM_LIMIT
    for slots in range(128, 4097, 128):
        t = tp.block_threads(slots)
        assert slots % t == 0 and t in (128, 256, 512)


def test_nvcc_missing_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
