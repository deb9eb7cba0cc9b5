"""PyTorch port: the persistent trace against the JAX persistent kernel.

The plain PyTorch version runs here; the JAX kernel runs in interpret mode
with exact "fma" selection and no phase gating, in count spawn (the main
path), gens spawn, saturating spawn and with per-design geometry rows (the
sweep).  The CUDA kernel itself runs only on a card: see
``test_torch_cuda.py``."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    TraceConfig,
    WaveguideDesign,
)
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

# MAX_ITERS is a multiple of 8: the JAX kernel tests its bound only every
# cond_interval = 8 iterations, the port after every iteration
M, N, RT, MAX_ITERS = 4, 3, 1, 600
C = 3 * M * N
BINS = (80, 120)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


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


def _assert_matches_jax(hj, nbj, ht, nbt):
    """Tolerances: bounces and spawned within 1 %, deposits within
    max(10, 2 %), each run of M*N cells (a colour of one design) within
    max(10, 3 %); the iteration column is not compared.  XLA fuses
    multiply-adds and rounds rsqrt differently from ``1/sqrt``, so a ray
    within an ulp of a threshold may branch differently."""
    n = hj.shape[0]
    assert n % C == 0 and ht.shape == hj.shape == (n, *BINS)
    assert nbt.shape == (n, 4) and nbt.dtype == np.int32
    b_j, b_t = int(nbj[:, 0].sum()), int(nbt[:, 0].sum())
    s_j, s_t = int(nbj[:, 2].sum()), int(nbt[:, 2].sum())
    assert abs(b_t - b_j) <= 0.01 * b_j
    assert abs(s_t - s_j) <= 0.01 * s_j
    d_j, d_t = hj.sum(), ht.sum()
    assert d_j > 100
    assert abs(d_t - d_j) <= max(10, 0.02 * d_j)
    for l in range(n // (M * N)):
        pj = hj[l * M * N:(l + 1) * M * N].sum()
        pt = ht[l * M * N:(l + 1) * M * N].sum()
        assert abs(pt - pj) <= max(10, 0.03 * pj), (l, pt, pj)
    assert (nbt[:, 3] == 0).all()


def test_plain_trace_matches_jax_kernel(traced):
    """Count spawn.  Measured on this fixture: identical (586 deposits,
    114,069 bounces, 18,737 spawned; every cell's tile equal)."""
    _assert_matches_jax(*traced)


def test_count_spawn_meets_target(traced):
    """Every cell spawns at least its target, overshooting by less than one
    iteration's worth of slots."""
    _, _, ht, nbt = traced
    assert (nbt[:, 2] >= 512).all()
    assert (nbt[:, 2] < 512 + 128).all()
    assert (nbt[:, 1] < MAX_ITERS).all()   # every cell drained before the bound
    assert np.isfinite(ht).all() and (ht >= 0).all()


@pytest.fixture(scope="module")
def rows_two_designs(rows):
    """D = 2 designs of 36 cells each: the fixture's design, with its rows,
    launch tile and per-cell seed block, and the same design at 396 nm
    gratings.  Per-design geometry rows and launch tiles; one (36, RT, 128)
    seed block shared by both designs."""
    cfg, cp, gr, rays, seeds, kw = rows
    d2 = dataclasses.replace(WaveguideDesign(), lambda_ic=396.0, lambda_oc=396.0)
    geom = generate_geometry(d2, num_fov_x=M, num_fov_y=N)
    tgeom = build_trace_geometry(geom, simplify_tol=0.05)
    cp2 = jrows.build_kernel_cell_params(
        build_cell_tables(geom, make_synthetic_luts(geom)), geom.eyebox_range)
    rays2, _ = jrows.pack_ray_blocks(jseeding.build_ray_batch(geom, cfg),
                                     C, 128, RT)
    ec = tuple(max(a, b) for a, b in zip(
        kw["edge_counts"],
        (len(tgeom.hull_hp), len(tgeom.r1_hp), len(tgeom.r2_hp))))
    # shared pupil samples: every cell of a design has the same launch tile
    assert (rays == rays[:1]).all()
    return (np.concatenate([cp, cp2]),
            np.concatenate([gr, jrows.build_kernel_geom(tgeom)[None, :]]),
            np.concatenate([rays[:1], rays2[:1]]), seeds,
            dict(kw, edge_counts=ec))


@pytest.fixture(scope="module")
def jax_gens_fn(rows, rows_two_designs):
    """The JAX kernel with ``count_spawn=False``, built (and compiled) once
    for every gens-mode case."""
    cfg = rows[0]
    kw = rows_two_designs[-1]
    return jpers.make_persistent_trace_fn(
        cfg, kw["num_fc"], kw["num_oc"], RT, gens=1, interpret=True,
        phase_gating=False, max_iters=MAX_ITERS, edge_counts=kw["edge_counts"],
        accum_mode="fma", count_spawn=False)


@pytest.fixture(scope="module", params=[[2, 0], [1, 64]], ids=["gens", "saturating"])
def traced_modes(request, rows_two_designs, jax_gens_fn):
    """The JAX kernel and the plain version in gens mode, on D = 2 geometry
    rows with per-design tiles and a shared seed block: two generations per
    slot (``ctrl = [2, 0]``), and saturating spawn (``[1, 64]``)."""
    cp, gr, rays, seeds, kw = rows_two_designs
    ctrl = request.param
    hj, nbj = jax_gens_fn(cp, gr, rays, seeds, jnp.asarray(ctrl, jnp.int32))
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    ht, nbt = tp.persistent_trace(
        torch.from_numpy(cp), torch.from_numpy(gr), rt, st,
        torch.tensor(ctrl, dtype=torch.int32), spawn_mode="gens", **kw)
    return (ctrl, np.asarray(hj)[:, :, :BINS[1]], np.asarray(nbj),
            ht.numpy(), nbt.numpy())


def test_gens_modes_match_jax_kernel(traced_modes):
    """Gens and saturating spawn over D = 2 geometry rows against the JAX
    kernel, with the tolerances of :func:`_assert_matches_jax`; the spawn
    count is the sum of the slots' generations."""
    ctrl, hj, nbj, ht, nbt = traced_modes
    _assert_matches_jax(hj, nbj, ht, nbt)
    if ctrl[1] == 0:
        # every slot runs exactly two generations before its cell stops
        assert (nbt[:, 2] == 2 * RT * 128).all()
        assert (nbj[:, 2] == 2 * RT * 128).all()
    else:
        # saturating spawn: lanes respawn until iteration 64
        assert (nbt[:, 2] > RT * 128).all()
        assert (nbt[:, 1] >= 64).all()


def test_design_rows_equal_single_design_runs(rows, traced_modes):
    """The first design's half of the D = 2 launch equals a one-design
    launch (one geometry row, a tile per cell, a seed block per cell, its own
    edge counts) of the fixture, bit for bit."""
    cfg, cp, gr, rays, seeds, kw = rows
    ctrl, _, _, ht, nbt = traced_modes
    cpt, grt = trace_rows.rows_to_device(cp, gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    h1, nb1 = tp.persistent_trace(cpt, grt, rt, st,
                                  torch.tensor(ctrl, dtype=torch.int32),
                                  spawn_mode="gens", **kw)
    np.testing.assert_array_equal(h1.numpy(), ht[:C])
    np.testing.assert_array_equal(nb1.numpy(), nbt[:C])


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


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "ctrl", "strips",
                                 "designs", "rays_rows", "rng_rows",
                                 "spawn_mode"])
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
    elif bad == "designs":      # 2 cells over 3 designs
        grt = grt.expand(3, -1).contiguous()
    elif bad == "rays_rows":    # neither 1, D nor C tiles
        cpt, st = cpt.repeat(3, 1), st.repeat(3, 1, 1)
    elif bad == "rng_rows":     # neither C nor C / D seed blocks
        grt = grt.expand(2, -1).contiguous()
        st = st.repeat(2, 1, 1)
    elif bad == "spawn_mode":
        kw["spawn_mode"] = "saturating"
    else:
        kw["num_fc"] = tp.MAX_FC + 1
    with pytest.raises((TypeError, ValueError)):
        tp.persistent_trace(cpt, grt, rt, st, ctrl, **kw)


def test_wrapper_accepts_design_layouts(rows):
    """Per-design rows with one tile per cell, per design or for all, and
    seeds per cell or per design: the same cells give the same result
    whichever layout carries the same values."""
    cfg, cp, gr, rays, seeds, kw = rows
    cpt, grt = trace_rows.rows_to_device(cp[:4], gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays[:1], seeds[:2], "cpu")
    gr2 = grt.expand(2, -1).contiguous()
    ctrl = torch.tensor([1, 8], dtype=torch.int32)
    kw = dict(kw, max_iters=64, spawn_mode="gens")
    want = tp.persistent_trace(cpt, grt, rt.expand(4, -1, -1, -1).contiguous(),
                               st.repeat(2, 1, 1), ctrl, **kw)
    for rays_in in (rt, rt.expand(2, -1, -1, -1).contiguous()):
        got = tp.persistent_trace(cpt, gr2, rays_in, st, ctrl, **kw)
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_block_layout_fits_hopper_shared_memory():
    """The main path's 2,048 slots fit one block's shared memory (9 words of
    state and two uint16 list entries per slot, the histogram in device
    memory: 86,048 B), the sweep's 256 slots many blocks per SM (14,368 B;
    registers hold them to four); every slot count that is a multiple of 128
    gets a block size dividing it."""
    assert tp.shared_bytes(2048) == 86_048 <= tp._SMEM_LIMIT
    assert tp.shared_bytes(256) == 14_368
    assert tp.shared_bytes(256, gens=True) == 14_368 + 4 * 256
    assert 4 * (14_368 + tp._STATIC_SMEM + 1_024) <= 233_472   # an H100 SM
    for slots in range(128, 4097, 128):
        t = tp.block_threads(slots)
        assert slots % t == 0 and t in (128, 256, 512)


@pytest.mark.parametrize("mode", [
    dict(), dict(packed_words=14 * trace_rows.SEL_NW),
    dict(packed_words=14 * trace_rows.SEL_NW, transit_jump=True),
    dict(cells_per_block=2, packed_words=14 * trace_rows.SEL_NW),
    dict(gens=True)], ids=["exact", "packed", "packed_jump", "packed_k2", "gens"])
def test_main_path_block_fits_two_to_an_sm(mode):
    """The main path's block (2,048 slots, 80 x 120 bins, each selection;
    packed with the paper design's 14 records) needs at most 115,712 B with
    its static part: an SM's 228 KB, less the 1 KB the hardware keeps per
    block, halved."""
    assert tp.check_block_fits(2048, **mode) <= (233_472 - 2 * 1_024) // 2


def test_launch_argtypes_match_the_c_signature():
    """The ctypes bindings declare the C parameters of the launch and of the
    occupancy query in order (a pointer for every pointer, or the call would
    cut it to 32 bits; an int for every int; none missing), and the
    wrapper's shared-memory size uses the kernel's words of slot state."""
    import ctypes
    import re

    src = (build.CSRC / "persistent_trace.cu").read_text()
    sig = re.search(r'extern "C" int persistent_trace_launch\((.*?)\)\s*\{',
                    src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in sig.split(",")]
    assert tp.LAUNCH_ARGTYPES == want
    sig = re.search(r'extern "C" int persistent_trace_occupancy\((.*?)\)\s*\{',
                    src, re.S).group(1)
    assert tp.OCCUPANCY_ARGTYPES == [
        ctypes.c_void_p if "*" in p else ctypes.c_int for p in sig.split(",")]
    assert f"constexpr int STATE_WORDS = {tp._STATE_WORDS};" in src


def test_nvcc_missing_raises_clearly(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.delenv("CUDA_PATH", raising=False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc_path()
