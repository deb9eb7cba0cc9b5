"""PyTorch port: the exact splitting engines (``engine/splitting.py``)
against the JAX package's ``engine/splitting.py``.

Fixture: the JAX splitting tests' (paper design, 3 x 2 FoV x 3 wavelengths
= 18 cells, ``rng_mode="fast"``, seed 2), 4 launch positions per cell,
threshold 1e-5, at most 300 steps; inputs made by numpy on the host, both
engines on the CPU.

Bars (the JAX tests' own, ``tests/test_splitting.py``): histograms within
rtol 2e-4 / atol 1e-10, ``pruned`` within 1e-4 relative, ``out_coupled``
within 1e-5 relative, ``steps`` (and per-cell ``peak_live``) equal.  The two
round ``1 / sqrt`` and their sums differently, so weights agree to float32
rounding, not bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    seeding,
    splitting as jsplit,
    trace_jnp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    splitting,
    trace_vector as tv,
)

M, N = 3, 2
P = 4
KW = dict(weight_threshold=1e-5, max_steps=300)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def setup():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=P,
                      max_bounces=400, rng_mode="fast", seed=2)
    return geom, tables, tgeom, cfg


def _batch(geom, cfg, cells, rpc):
    return seeding.build_ray_batch(geom, cfg, cell_ids=cells, rays_per_cell=rpc)


def _jax_rays(b):
    return trace_jnp.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                    b["cid"], b["idx"], b["rng"])


def _port_rays(b):
    return tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                             b["idx"], b["rng"], device="cpu")


def _seeds(geom, cfg):
    """The shared launch positions of the per-cell engine, float32 numpy."""
    b = _batch(geom, cfg, np.arange(1), P)
    te, tm = np.asarray(b["te"]), np.asarray(b["tm"])
    return {"x": np.asarray(b["x"], np.float32),
            "y": np.asarray(b["y"], np.float32),
            "ter": te.real.astype(np.float32), "tei": te.imag.astype(np.float32),
            "tmr": tm.real.astype(np.float32), "tmi": tm.imag.astype(np.float32)}


def _close(got, want, atol=1e-10):
    np.testing.assert_allclose(got.histogram, want.histogram, rtol=2e-4,
                               atol=atol)
    assert got.out_coupled == pytest.approx(want.out_coupled, rel=1e-5)
    assert got.pruned == pytest.approx(want.pruned, rel=1e-4)
    assert got.steps == want.steps


@pytest.fixture(scope="module")
def port_cells(setup):
    geom, tables, tgeom, cfg = setup
    seeds = {k: torch.from_numpy(v) for k, v in _seeds(geom, cfg).items()}
    return splitting.run_splitting_cells(
        tables, tgeom, cfg, np.arange(3 * M * N), seeds, capacity=8192,
        device="cpu", **KW)


def test_global_engine_matches_jax(setup):
    """The global-buffer engine at P = 4 over all 18 cells (a 32,768-slot
    wavefront that never fills): histogram, ``out_coupled``, ``pruned`` and
    ``steps`` against the JAX engine's."""
    geom, tables, tgeom, cfg = setup
    b = _batch(geom, cfg, np.arange(3 * M * N), P)
    want = jsplit.run_splitting(tables, tgeom, cfg, _jax_rays(b),
                                capacity=1 << 15, **KW)
    got = splitting.run_splitting(tables, tgeom, cfg, _port_rays(b),
                                  capacity=1 << 15, device="cpu", **KW)
    assert want.truncated == 0.0 and got.truncated == 0.0
    assert got.histogram.shape == (3, N, M, 80, 120)
    assert got.out_coupled > 0
    _close(got, want)
    assert got.histogram.sum() == pytest.approx(got.out_coupled, rel=1e-5)


@pytest.mark.parametrize("fast", [True, False])
def test_per_cell_engine_matches_jax(setup, port_cells, fast):
    """The per-cell engine (one 8,192-slot wavefront per cell) against the
    JAX per-cell engine in both its modes, its TPU lowering (``fast=True``)
    and the gather form (``fast=False``): the same bars, equal ``steps`` and
    ``peak_live``, nothing truncated."""
    geom, tables, tgeom, cfg = setup
    seeds = {k: jnp.asarray(v) for k, v in _seeds(geom, cfg).items()}
    want = jsplit.run_splitting_cells(tables, tgeom, cfg, np.arange(3 * M * N),
                                      seeds, capacity=8192, fast=fast, **KW)
    got = port_cells
    assert want.truncated == 0.0 and got.truncated == 0.0
    assert 0 < got.peak_live < 8192
    assert got.peak_live == want.peak_live
    _close(got, want)


def test_per_cell_equals_global(setup, port_cells):
    """In the port, the per-cell engine reproduces the global engine's
    expectation: equal steps, pruned within 1e-4, bins within rtol 2e-4."""
    geom, tables, tgeom, cfg = setup
    b = _batch(geom, cfg, np.arange(3 * M * N), P)
    glob = splitting.run_splitting(tables, tgeom, cfg, _port_rays(b),
                                   capacity=1 << 15, device="cpu", **KW)
    _close(port_cells, glob)


def test_tiny_capacity_is_accounted(setup, port_cells):
    """A 256-slot per-cell wavefront overflows, and the overflow is
    accounted: ``truncated`` > 0, deposited + truncated + pruned <= the
    launch weight, a ``peak_live`` above the capacity, every bin at most the
    untruncated one's; and the ledgers match the JAX engine's cumsum form
    (the same slots are kept), within the bars."""
    geom, tables, tgeom, cfg = setup
    cells = np.arange(3 * M * N)
    s = _seeds(geom, cfg)
    small = splitting.run_splitting_cells(
        tables, tgeom, cfg, cells, {k: torch.from_numpy(v) for k, v in s.items()},
        capacity=256, device="cpu", **KW)
    want = jsplit.run_splitting_cells(
        tables, tgeom, cfg, cells, {k: jnp.asarray(v) for k, v in s.items()},
        capacity=256, fast=False, **KW)
    launched = P * len(cells)
    assert small.truncated > 0 and small.peak_live > 256
    assert small.out_coupled < port_cells.out_coupled <= launched
    assert small.out_coupled + small.truncated + small.pruned <= launched
    assert (small.histogram <= port_cells.histogram + 1e-6).all()
    _close(small, want)
    assert small.truncated == pytest.approx(want.truncated, rel=1e-4)
    assert small.peak_live == want.peak_live


@pytest.mark.parametrize("mode", ["soft_binning", "fixed_steps"])
def test_global_forward_options_match_jax(setup, mode):
    """The forward pass of the differentiable options on 6 cells: bilinear
    deposits (``soft_binning``) and a fixed 12-step trace with no stop test
    (``fixed_steps``, which leaves weight in flight), against the JAX
    engine's; and ``table_arg`` (the tables as an argument) equal to the
    closed-over tables bit for bit.

    Bins within rtol 2e-4 or 1e-5 absolute (the weight threshold): a child
    whose weight rounds to either side of the threshold is kept by one engine
    and pruned by the other, and everything it would deposit weighs less
    than the threshold; bilinear deposits spread such a child over bins that
    hold little else (measured: 48 of 172,800 bins, at most 5.7e-8 apart)."""
    geom, tables, tgeom, cfg = setup
    cells = np.array([1, 4, 7, 10, 13, 16])
    b = _batch(geom, cfg, cells, P)
    kw = dict(capacity=8192, **KW)
    kw[mode] = True if mode == "soft_binning" else 12
    want = jsplit.run_splitting(tables, tgeom, cfg, _jax_rays(b), **kw)
    got = splitting.run_splitting(tables, tgeom, cfg, _port_rays(b),
                                  device="cpu", **kw)
    assert got.truncated == 0.0 and got.out_coupled > 0
    _close(got, want, atol=KW["weight_threshold"])
    if mode == "fixed_steps":
        assert got.steps == 12
    trace = splitting.make_splitting_trace_fn(tables, tgeom, cfg,
                                              table_arg=True, device="cpu",
                                              **kw)
    hist, out_w, trunc, pruned, steps = trace(_port_rays(b),
                                              tv.as_tables(tables))
    np.testing.assert_array_equal(
        hist.numpy().reshape(got.histogram.shape), got.histogram)
    assert float(pruned) == got.pruned and steps == got.steps


def test_per_cell_chunks_are_independent(setup, port_cells):
    """Each cell's tile does not depend on the other cells of its chunk:
    the 18 cells traced as chunks of 7, 7 and 4 give the one-chunk tiles bit
    for bit; per-cell seeds equal to the shared ones give them too."""
    geom, tables, tgeom, cfg = setup
    s = {k: torch.from_numpy(v) for k, v in _seeds(geom, cfg).items()}
    cells = np.arange(3 * M * N)
    trace = splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                              capacity=8192, device="cpu",
                                              **KW)
    tiles = torch.cat([trace(cells[i:i + 7], s)[0] for i in (0, 7, 14)])
    hist = splitting.cells_tiles_to_histogram(tiles, cells, 3, M, N, 80, 120)
    np.testing.assert_array_equal(hist.numpy(), port_cells.histogram)
    per = splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                            capacity=8192, device="cpu",
                                            per_cell_seeds=True, **KW)
    t2 = per(cells[:5], {k: v.expand(5, -1) for k, v in s.items()})[0]
    assert torch.equal(t2, tiles[:5])
    with pytest.raises(ValueError, match="seed children"):
        trace(cells[:2], {k: v.repeat(3000) for k, v in s.items()})
