"""PyTorch port: the per-cell trace, its segment scheduler and
``Simulator(engine="cell")`` against the JAX per-cell kernel.

The plain PyTorch version runs here; the JAX kernel runs in interpret mode,
one compiled kernel per distinct (mode, budget), shared by the cases.  The
CUDA kernel itself runs only on a card: see ``test_torch_cuda.py``.

Fixture: 5 x 4 FoV x 3 wavelengths = 60 cells, 256 rays per cell (RT = 2),
a 400-iteration budget, seed 9; every input is made by numpy on the host.
"""

import ctypes
import dataclasses
import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU here)

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    pallas_segments as jsegments,
    pipeline as jpipeline,
    seeding as jseeding,
    trace_pallas as jcell,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import (
    config as pconfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry as pgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    build,
    cell_segments,
    pipeline,
    trace_cell as tc,
    trace_persistent as tp,
    trace_rows,
)

M, N, RPC, BUDGET, SEG = 5, 4, 256, 400, 32
RT = RPC // 128
C = 3 * M * N
BINS = (80, 120)
H100_SMS = 132
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def setup():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom, simplify_tol=0.05)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=RPC,
                      max_bounces=BUDGET, rng_mode="fast", ic_test="circle",
                      seed=9)
    cp = jcell.build_kernel_cell_params(tables, geom.eyebox_range)
    gr = jcell.build_kernel_geom(tgeom)[None, :]
    rays, seeds = jcell.pack_ray_blocks(jseeding.build_ray_batch(geom, cfg),
                                        C, RPC, RT)
    kw = dict(num_fc=tgeom.num_fc, num_oc=tgeom.num_oc,
              edge_counts=(len(tgeom.hull_hp), len(tgeom.r1_hp),
                           len(tgeom.r2_hp)), eyebox_bins=BINS)
    return geom, cfg, cp, gr, rays, seeds, kw


@pytest.fixture(scope="module")
def jax_fn(setup):
    """The JAX kernel in interpret mode, compiled once per (mode, budget)."""
    _, cfg, _, _, _, _, kw = setup
    fns = {}

    def get(mode, budget):
        if (mode, budget) not in fns:
            fns[mode, budget] = jcell.make_pallas_trace_fn(
                dataclasses.replace(cfg, max_bounces=budget), kw["num_fc"],
                kw["num_oc"], RT, interpret=True, mode=mode)
        return fns[mode, budget]

    return get


def _np(outs):
    return tuple(np.array(o) for o in outs)


def _port(setup, rays, seeds, state=None, *, budget):
    """The port's plain version on numpy inputs -> numpy outputs (the RNG
    streams as uint32)."""
    _, _, cp, gr, _, _, kw = setup
    cpt, grt = trace_rows.rows_to_device(cp, gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    state_t = None if state is None else trace_rows.state_to_device(state, "cpu")
    dep, nb, ro, so, rgo = tc.cell_trace(cpt, grt, rt, st, state_t,
                                         max_bounces=budget, **kw)
    return (dep.numpy(), nb.numpy(), ro.numpy(), so.numpy(),
            rgo.numpy().view(np.uint32))


@pytest.fixture(scope="module")
def jax_full(setup, jax_fn):
    _, _, cp, gr, rays, seeds, _ = setup
    return _np(jax_fn("full", BUDGET)(cp, gr, rays, seeds))


@pytest.fixture(scope="module")
def jax_seg(setup, jax_fn):
    """The JAX kernel's own outputs after 32 iterations."""
    _, _, cp, gr, rays, seeds, _ = setup
    return _np(jax_fn("full", SEG)(cp, gr, rays, seeds))


@pytest.fixture(scope="module")
def port_full(setup):
    _, _, _, _, rays, seeds, _ = setup
    return _port(setup, rays, seeds, budget=BUDGET)


@pytest.fixture(scope="module")
def port_seg(setup):
    _, _, _, _, rays, seeds, _ = setup
    return _port(setup, rays, seeds, budget=SEG)


def _assert_matches_jax(jax_out, port_out):
    """Tolerances (the bars of the JAX package's own kernel-against-engine
    test): at least 99.5 % of the rays report the same deposit code, the
    deposit total within max(3, 2 %), the bounce total within 2 %.  XLA's
    CPU code fuses multiply-adds and rounds rsqrt differently from
    ``1 / sqrt``, so a ray within an ulp of a threshold may branch
    differently.  The iteration column is never compared: the JAX kernel
    rounds it up to its condition interval.  Returns the agreement."""
    dep_j, nb_j = jax_out[:2]
    dep_t, nb_t = port_out[:2]
    assert dep_t.shape == dep_j.shape == (C, RT, 128) and dep_t.dtype == np.int32
    assert nb_t.shape == (C, 2) and nb_t.dtype == np.int32
    agree = (dep_j == dep_t).mean()
    assert agree >= 0.995, agree
    d_j, d_t = int((dep_j >= 0).sum()), int((dep_t >= 0).sum())
    assert abs(d_t - d_j) <= max(3, 0.02 * d_j), (d_t, d_j)
    b_j, b_t = int(nb_j[:, 0].sum()), int(nb_t[:, 0].sum())
    assert b_j > 0 and abs(b_t - b_j) <= 0.02 * b_j, (b_t, b_j)
    # what was observed (shown by pytest -s / -rP)
    print(f"agreement with the JAX kernel: {int((dep_j == dep_t).sum())} of "
          f"{dep_j.size} deposit codes, deposits {d_t} vs {d_j}, bounces "
          f"{b_t} vs {b_j}, states "
          f"{int((jax_out[3] == port_out[3]).sum())}, RNG streams "
          f"{int((jax_out[4] == port_out[4]).sum())}")
    return agree


def test_full_mode_matches_jax_kernel(jax_full, port_full):
    """Full mode, the whole budget.  Measured on this fixture: every output
    of every ray identical (deposit codes, states, streams, bounce counts)."""
    assert _assert_matches_jax(jax_full, port_full) >= 0.995
    assert (port_full[0] >= 0).sum() > 100
    # the same rays end the same way, with the same RNG stream
    assert (jax_full[3] == port_full[3]).mean() >= 0.995
    assert (jax_full[4] == port_full[4]).mean() >= 0.995
    assert (port_full[3] == 6).all()       # every ray drained within the budget


def test_resume_mode_matches_jax_kernel(setup, jax_fn, jax_seg):
    """Resume mode from the JAX kernel's own 32-iteration state (its 9-field
    block, states and streams carried into the port as numpy) against the
    JAX kernel's resume mode on the same state: same bars."""
    _, _, cp, gr, _, _, _ = setup
    _, _, ro, so, rgo = jax_seg
    assert (so < 6).sum() > 50              # survivors to resume
    want = _np(jax_fn("resume", BUDGET - SEG)(cp, gr, ro, so, rgo))
    got = _port(setup, ro, rgo, so, budget=BUDGET - SEG)
    _assert_matches_jax(want, got)
    live = so < 6
    # dead rays report nothing in a resumed segment; live ones end the same
    assert (got[0][~live] == -1).all()
    assert (want[3] == got[3]).mean() >= 0.995
    assert (want[4] == got[4]).mean() >= 0.995


def test_first_segment_state_matches_jax_kernel(jax_seg, port_seg):
    """After 32 iterations: same bars, and the 9 float fields of the rays
    still alive agree to 1e-5 (relative to the field's largest value) for
    at least 99.5 % of them."""
    _assert_matches_jax(jax_seg, port_seg)
    live = (jax_seg[3] < 6) & (port_seg[3] < 6)
    assert live.sum() > 50
    for k in range(9):
        a, b = jax_seg[2][:, k][live], port_seg[2][:, k][live]
        close = np.abs(a - b) <= 1e-5 * max(1.0, np.abs(a).max())
        assert close.mean() >= 0.995, k


def test_exact_budget_matches_jax_kernel(setup, jax_fn):
    """A budget of 13, not a multiple of the JAX kernel's condition interval
    of 8: no ray runs past it in either, and the bars hold."""
    _, _, cp, gr, rays, seeds, _ = setup
    want = _np(jax_fn("full", 13)(cp, gr, rays, seeds))
    got = _port(setup, rays, seeds, budget=13)
    _assert_matches_jax(want, got)
    assert want[1][:, 1].max() <= 13
    assert got[1][:, 1].max() == 13
    assert (got[3] < 6).any()                # rays cut by the budget
    # a ray that began every one of the 13 iterations alive counts 13 bounces
    assert got[1][:, 0].max() <= 13 * RT * 128


def test_segments_sum_to_the_whole(setup, port_full, port_seg):
    """Within the port, exactly: full(32) + resume(368) = full(400) in
    every output of every ray."""
    _, _, ro, so, rgo = port_seg
    rest = _port(setup, ro, rgo, so, budget=BUDGET - SEG)
    merged = np.where(port_seg[0] >= 0, port_seg[0], rest[0])
    np.testing.assert_array_equal(merged, port_full[0])
    assert not ((port_seg[0] >= 0) & (rest[0] >= 0)).any()
    np.testing.assert_array_equal(port_seg[1][:, 0] + rest[1][:, 0],
                                  port_full[1][:, 0])
    for k in (2, 3, 4):
        np.testing.assert_array_equal(rest[k], port_full[k])


@pytest.mark.parametrize("threads", [1, 3])
def test_segments_sum_to_the_whole_under_thread_counts(setup, port_full,
                                                      threads):
    """The same exact identity with every run under ``threads`` intra-op
    threads, and the whole run equal to the module's (default threads).
    torch's float32 ``sqrt`` on the CPU is split between threads in chunks
    and is not correctly rounded: in some processes one thread's chunk came
    out rounded otherwise, which broke this identity now and then (F4).
    The plain version now takes the root in float64."""
    _, _, _, _, rays, seeds, _ = setup
    keep = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        full = _port(setup, rays, seeds, budget=BUDGET)
        seg = _port(setup, rays, seeds, budget=SEG)
        rest = _port(setup, seg[2], seg[4], seg[3], budget=BUDGET - SEG)
    finally:
        torch.set_num_threads(keep)
    for k in range(5):
        np.testing.assert_array_equal(full[k], port_full[k])
    for k in (2, 3, 4):
        np.testing.assert_array_equal(rest[k], full[k])
    np.testing.assert_array_equal(seg[1][:, 0] + rest[1][:, 0], full[1][:, 0])


@pytest.fixture(scope="module")
def port_tensors(setup):
    _, _, cp, gr, rays, seeds, _ = setup
    return (*trace_rows.rows_to_device(cp, gr, "cpu"),
            *trace_rows.blocks_to_device(rays, seeds, "cpu"))


def test_plain_version_ray_iterations(setup, port_tensors):
    """``ray_iterations=True`` appends each ray's iteration count: they sum
    to the cell's bounces and their largest is its iterations; the lane
    occupancy of one thread per ray follows from them."""
    *out, its = tc.cell_trace_reference(*port_tensors, max_bounces=40,
                                        ray_iterations=True, **setup[-1])
    assert its.shape == port_tensors[3].shape and its.dtype == torch.int32
    flat = its.reshape(its.shape[0], -1)
    assert torch.equal(flat.sum(dim=1), out[1][:, 0])
    assert torch.equal(flat.max(dim=1).values, out[1][:, 1])
    occ = tc.lane_occupancy(its)
    assert 0.0 < occ < 1.0
    warps = flat.reshape(-1, 32).to(torch.int64)
    assert occ == float(warps.sum()) / float(32 * warps.max(dim=1).values.sum())
    assert tc.lane_occupancy(torch.full((2, 32), 3)) == 1.0


@pytest.mark.parametrize("segment_bounces", [SEG, 8])
@pytest.mark.parametrize("form", ["deposit_list", "hist_base"])
def test_segmented_equals_monolithic(setup, port_tensors, port_full, form,
                                     segment_bounces):
    """Segment-and-compact scheduling reproduces the monolithic trace
    exactly, histogram and bounces, in both return forms: in segments of 32
    iterations (two segments: the fixture's slowest ray lives 51) and of 8
    (seven), on tiles that shrink from 2 rows to 1."""
    kw = setup[-1]
    hist_m = tc.deposits_to_histogram_cells(
        torch.from_numpy(port_full[0]), np.arange(C), 3, M, N, *BINS)
    seg = cell_segments.SegmentedCellTracer(
        max_bounces=BUDGET, segment_bounces=segment_bounces,
        hist_dims=(3, M, N), **kw)
    if form == "deposit_list":
        deps, bounces = seg.trace(*port_tensors)
        assert len(deps) == -(-51 // segment_bounces)
        assert deps[0].shape[1] == RT * 128
        assert deps[-1].shape[1] == 128      # the survivors fit one row
        hist_s = cell_segments.deps_to_histogram(deps, np.arange(C), 3, M, N,
                                                 *BINS)
    else:
        base = tc.cell_hist_base(np.arange(C), M, N, *BINS)
        hist_s, bounces = seg.trace(*port_tensors, hist_base=base)
    assert hist_s.shape == (3, N, M, *BINS)
    assert torch.equal(hist_s, hist_m)
    assert bounces == int(port_full[1][:, 0].sum())
    assert hist_m.sum() == (port_full[0] >= 0).sum()


def test_segmented_last_segment_gets_the_leftover_budget(setup, port_tensors):
    """Budget 45 in segments of 32: 32 + 13, equal to one trace of 45."""
    kw = setup[-1]
    seg = cell_segments.SegmentedCellTracer(max_bounces=45, segment_bounces=SEG,
                                            **kw)
    deps, bounces = seg.trace(*port_tensors)
    dep, nb, *_ = tc.cell_trace(*port_tensors, max_bounces=45, **kw)
    assert len(deps) == 2
    assert bounces == int(nb[:, 0].sum())
    assert sum(int((d >= 0).sum()) for d in deps) == int((dep >= 0).sum())


@pytest.mark.parametrize("cells", ["all", "scattered"])
def test_deposit_histograms_equal_jax_functions(port_full, cells):
    """``deposits_to_histogram_cells`` and ``deps_to_histogram`` against the
    JAX package's functions on the same deposit codes: bitwise equal."""
    dep = port_full[0]
    ids = np.arange(C) if cells == "all" else np.array([7, 0, 59, 21, 40])
    dep = dep[:len(ids)]
    want = np.asarray(jcell.deposits_to_histogram_cells(dep, ids, 3, M, N, *BINS))
    got = tc.deposits_to_histogram_cells(torch.from_numpy(dep), ids, 3, M, N,
                                         *BINS)
    assert got.shape == (3, N, M, *BINS) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    halves = [dep.reshape(len(ids), -1)[:, :128], dep.reshape(len(ids), -1)[:, 128:]]
    want2 = jsegments.deps_to_histogram(halves, ids, 3, M, N, *BINS)
    got2 = cell_segments.deps_to_histogram(
        [torch.from_numpy(np.ascontiguousarray(h)) for h in halves], ids,
        3, M, N, *BINS)
    np.testing.assert_array_equal(got2.numpy(), want2)
    np.testing.assert_array_equal(got2.numpy(), want)


@pytest.fixture(scope="module")
def sims(setup):
    geom, cfg = setup[:2]
    pcfg = pconfig.TraceConfig(**dataclasses.asdict(cfg))
    pgeom = pgenerate_geometry(num_fov_x=M, num_fov_y=N)
    port = pipeline.Simulator(cfg=pcfg, geom=pgeom, device="cpu",
                              engine="cell", geometry_simplify_tol=0.05)
    rp = port.run(rays_per_fov=RPC, num_iter=1, cells_per_batch=20)
    ref = jpipeline.Simulator(cfg=cfg, engine="pallas", interpret=True,
                              geom=geom, geometry_simplify_tol=0.05)
    rj = ref.run(rays_per_fov=RPC, num_iter=1, evaluate_metrics=False,
                 cells_per_batch=20)
    return port, rp, rj, pcfg, pgeom


def test_simulator_cell_engine_matches_jax_pallas_engine(sims):
    """``Simulator(engine="cell")`` against the JAX ``engine="pallas"``
    Simulator in 3 batches of 20 cells: sum |delta hist| / sum hist < 2 %,
    bounces within 2 %, efficiencies within 2 %, the same ray count."""
    _, rp, rj, _, _ = sims
    assert rp.histogram.shape == rj.histogram.shape == (3, N, M, *BINS)
    d = np.abs(rp.histogram - rj.histogram).sum()
    assert d / max(rj.histogram.sum(), 1) < 0.02
    assert abs(rp.total_bounces - rj.total_bounces) <= 0.02 * rj.total_bounces
    assert rp.rays_traced == rj.rays_traced == C * RPC
    for k in ("R", "G", "B"):
        assert rj.efficiencies[k] > 0
        assert abs(rp.efficiencies[k] / rj.efficiencies[k] - 1) <= 0.02, k
    # batching changes nothing: the run equals one batch of every cell
    h0, b0, n0 = sims[0].trace_batch(np.arange(C), RPC, 0)
    np.testing.assert_array_equal(h0.numpy(), rp.histogram)
    assert int(b0) == rp.total_bounces and n0 == rp.rays_traced
    assert np.isfinite([rp.metrics.delta_e, rp.metrics.u_fov,
                        rp.metrics.u_eyebox]).all()
    assert {"seed_s", "assemble_s", "metrics_s"} <= set(rp.timings)
    assert rp.cell_stats is None


def test_simulator_cell_engine_iterations_accumulate(sims):
    """``num_iter=2`` is two relaunches with fresh seeds: the histogram is
    the sum of the two iterations' batches, and the efficiencies keep their
    scale."""
    port, rp, _, _, _ = sims
    r2 = port.run(rays_per_fov=RPC, num_iter=2, cells_per_batch=32,
                  evaluate_metrics=False)
    h1, b1, n1 = port.trace_batch(np.arange(C), RPC, 1)
    assert n1 == C * RPC and r2.rays_traced == 2 * C * RPC
    np.testing.assert_array_equal(r2.histogram, rp.histogram + h1.numpy())
    assert r2.total_bounces == rp.total_bounces + int(b1)
    assert not np.array_equal(h1.numpy(), rp.histogram)
    for k in ("R", "G", "B"):
        assert abs(r2.efficiencies[k] / rp.efficiencies[k] - 1) < 0.25, k


def test_simulator_trace_batch_of_scattered_cells(sims):
    """A batch of cells in any order: each cell's slice of the histogram
    equals its slice of the whole run's, and the others stay empty."""
    port, rp, _, _, _ = sims
    ids = np.array([41, 3, 59, 20])
    hist, bounces, n = port.trace_batch(ids, RPC, 0)
    assert n == len(ids) * RPC and int(bounces) > 0
    want = np.zeros_like(rp.histogram)
    for cid in ids:
        l, m, n_ = cid // (M * N), cid % (M * N) // N, cid % N
        want[l, n_, m] = rp.histogram[l, n_, m]
    np.testing.assert_array_equal(hist.numpy(), want)
    assert want.sum() > 0


def test_simulator_segmented_equals_monolithic(sims):
    """``segmented=True`` gives the same histogram and bounces."""
    _, rp, _, pcfg, pgeom = sims
    seg = pipeline.Simulator(cfg=pcfg, geom=pgeom, device="cpu", engine="cell",
                             segmented=True, segment_bounces=SEG,
                             geometry_simplify_tol=0.05)
    rs = seg.run(rays_per_fov=RPC, num_iter=1, cells_per_batch=20,
                 evaluate_metrics=False)
    np.testing.assert_array_equal(rs.histogram, rp.histogram)
    assert rs.total_bounces == rp.total_bounces
    assert rs.efficiencies == rp.efficiencies


def test_cell_engine_equals_one_generation_of_the_persistent_kernel(sims):
    """The two plain kernels against each other: with as many rays per cell
    as the persistent path has slots, the cell engine traces exactly one
    generation of the persistent kernel (the same launch tile, the same
    per-ray seeds), so a one-design gens-spawn sweep with one generation per
    slot gives the same histogram and bounces bit for bit."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        run_design_sweep_persistent,
    )

    port, rp, _, pcfg, _ = sims
    sweep = run_design_sweep_persistent(
        [pconfig.WaveguideDesign()], pcfg, lut_seed=pcfg.seed + 1234,
        spawn_iters=0, spawn_mode="gens", slots=RPC, keep_histograms=True,
        device="cpu")
    np.testing.assert_array_equal(sweep.histograms[0], rp.histogram)
    assert int(sweep.bounces[0]) == rp.total_bounces
    np.testing.assert_allclose(sweep.efficiencies[0],
                               [rp.efficiencies[k] for k in "BGR"], rtol=1e-6)


def test_simulator_rejects_unknown_engine_and_misplaced_options(sims):
    _, _, _, pcfg, pgeom = sims
    with pytest.raises(ValueError, match="engine"):
        pipeline.Simulator(cfg=pcfg, geom=pgeom, device="cpu", engine="pallas")
    with pytest.raises(ValueError, match="segmented"):
        pipeline.Simulator(cfg=pcfg, geom=pgeom, device="cpu", segmented=True)
    pers = pipeline.Simulator(cfg=pcfg, geom=pgeom, device="cpu",
                              persistent_slots=128)
    with pytest.raises(ValueError, match="cell"):
        pers.trace_batch(np.arange(2), RPC, 0)


def test_simulator_cell_engine_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.Simulator(cfg=pconfig.TraceConfig(num_fov_x=2, num_fov_y=2),
                           engine="cell")


@pytest.mark.parametrize("bad", ["dtype", "shape", "contiguous", "fields",
                                 "state_shape", "state_dtype", "geom_rows",
                                 "strips", "budget", "rng_rows"])
def test_wrapper_rejects_bad_inputs(setup, port_tensors, bad):
    kw = dict(setup[-1], max_bounces=8)
    cpt, grt, rt, st = port_tensors
    cpt, rt, st = cpt[:2], rt[:2].contiguous(), st[:2].contiguous()
    state = None
    if bad == "dtype":
        st = st.to(torch.int64)
    elif bad == "shape":
        cpt = cpt[:, :100]
    elif bad == "contiguous":
        rt = rt.transpose(2, 3)
    elif bad == "fields":          # 6 fields with a state: resume wants 9
        state = torch.zeros_like(st)
    elif bad == "state_shape":
        rt = torch.zeros((2, 9, RT, 128))
        state = torch.zeros((2, 1, 128), dtype=torch.int32)
    elif bad == "state_dtype":
        rt = torch.zeros((2, 9, RT, 128))
        state = torch.zeros((2, RT, 128), dtype=torch.int64)
    elif bad == "geom_rows":       # one design per launch
        grt = grt.expand(2, -1).contiguous()
    elif bad == "strips":
        kw["num_oc"] = tp.MAX_OC + 1
    elif bad == "budget":
        kw["max_bounces"] = 0
    else:                          # seeds of another cell count
        st = st[:1]
    with pytest.raises((TypeError, ValueError)):
        tc.cell_trace(cpt, grt, rt, st, state, **kw)


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_never_runs_plain_version_for_cuda_tensor(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(tc, "cell_trace_reference",
                        lambda *a, **k: called.append(1))
    cp = torch.zeros((2, trace_rows.PC)).as_subclass(_ClaimsCuda)
    gr = torch.zeros((1, trace_rows.PG)).as_subclass(_ClaimsCuda)
    rays = torch.zeros((2, 6, 1, 128)).as_subclass(_ClaimsCuda)
    rng = torch.ones((2, 1, 128), dtype=torch.int32).as_subclass(_ClaimsCuda)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tc.cell_trace(cp, gr, rays, rng, num_fc=7, num_oc=6,
                      edge_counts=(14, 15, 21), eyebox_bins=BINS,
                      max_bounces=10)
    assert called == []


def test_launch_argtypes_match_the_c_signature():
    """The ctypes binding declares the kernel's C parameters in order (a
    pointer for every pointer, an int for every int, none missing), and
    every launch shape the wrapper's rule gives is one the launch accepts:
    at most the kernel's launch bounds, whole warps, one ray per block at
    least."""
    src = (build.CSRC / "cell_trace.cu").read_text()
    sig = re.search(r'extern "C" int cell_trace_launch\((.*?)\)\s*\{',
                    src, re.S).group(1)
    want = [ctypes.c_void_p if "*" in p else ctypes.c_int
            for p in sig.split(",")]
    assert tc.LAUNCH_ARGTYPES == want
    assert f"constexpr int MAX_THREADS = {tc.BLOCK_THREADS};" in src
    assert "__launch_bounds__(MAX_THREADS)" in src
    for C in (1, 3, 36, 144, 2048, 2112, 22500):
        for rt in (1, 2, 3, 4, 8, 16, 19, 40, 1000):
            S = rt * trace_rows.LANES
            threads, bpc = tc.launch_shape(C, S, H100_SMS)
            assert 32 <= threads <= tc.BLOCK_THREADS and threads % 32 == 0
            assert 1 <= bpc <= S and C * bpc < 2**31
            assert S / bpc / threads <= tc.MAX_RAYS_PER_LANE


@pytest.mark.parametrize("C,S,shape", [
    (2048, 5120, (128, 4)),   # the cell engine's batches
    (144, 5120, (128, 15)),   # chip_smoke phase 7
    (2048, 128, (64, 1)),     # segmented resume tiles of 1, 2, 4, 8 rows
    (2048, 256, (128, 1)),
    (2048, 512, (128, 2)),
    (2048, 1024, (128, 2)),
    (36, 256, (128, 1)),      # the card tests' fixtures
    (36, 384, (128, 1)),
    (36, 2048, (128, 8)),
    (1, 128, (64, 1)),
])
def test_launch_shape_rule(C, S, shape):
    """Threads per block and blocks per cell at the launch shapes the port
    makes, on an H100's 132 SMs: a lane has at least 2 rays at one block
    per cell; a block holds at most 10 rays per lane, and the grid at least
    16 blocks per SM unless a block would then hold fewer than 2 rays per
    lane."""
    assert tc.launch_shape(C, S, H100_SMS) == shape
    threads, bpc = shape
    assert 2 * threads <= S
    per_lane = S / bpc / threads
    assert per_lane <= tc.MAX_RAYS_PER_LANE
    if bpc > 1:
        assert per_lane >= tc.MIN_RAYS_PER_LANE
    assert tc.launch_shape(C, S, sms=1)[0] == threads
    with pytest.raises(ValueError):
        tc.launch_shape(0, S, H100_SMS)


def test_library_name_follows_the_shared_header(monkeypatch, tmp_path):
    """Both kernels include ``csrc/trace_common.cuh``: an edit there renames
    both libraries, so neither loads a stale build."""
    for f in build.CSRC.iterdir():
        (tmp_path / f.name).write_bytes(f.read_bytes())
    before = [build.library_path(n).name for n in ("persistent_trace",
                                                   "cell_trace")]
    monkeypatch.setattr(build, "CSRC", tmp_path)
    assert [build.library_path(n).name for n in ("persistent_trace",
                                                 "cell_trace")] == before
    with open(tmp_path / "trace_common.cuh", "a") as f:
        f.write("// edited\n")
    after = [build.library_path(n).name for n in ("persistent_trace",
                                                  "cell_trace")]
    assert all(a != b for a, b in zip(after, before))
    for name in ("persistent_trace", "cell_trace"):
        assert '#include "trace_common.cuh"' in (tmp_path / f"{name}.cu").read_text()


def test_cli_cell_engine_loads_no_jax(tmp_path):
    """``simulate --engine cell --device cpu`` in a fresh process loads
    neither jax nor any module of the JAX package."""
    code = (
        "import sys, json\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli\n"
        "rc = cli.main(['simulate', '--engine', 'cell', '--device', 'cpu', "
        "'--fov-x', '2', '--fov-y', '2', '--rays-per-fov', '128', "
        "'--num-iter', '2', '--max-bounces', '200', '--json', 'm.json'])\n"
        "assert rc == 0\n"
        "m = json.load(open('m.json'))\n"
        "assert m['rays_traced'] == 2 * 128 * 12, m\n"
        "assert m['total_bounces'] > 0 and m['efficiencies']['G'] > 0, m\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' "
        "or m.startswith(('jax.', 'gpu_ray_tracing_for_waveguide_based_ar_"
        "display_tpu')))\n"
        "print(bad or 'NOJAX')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "NOJAX"
