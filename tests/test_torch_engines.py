"""PyTorch port: ``Simulator(engine="vector" | "splitting")``, the vector
design sweep and the new CLI outputs, against the JAX package.

Fixtures: the paper design at 3 x 2 FoV x 3 wavelengths = 18 cells on the
CPU; inputs made by numpy.  The JAX side runs as its own tests run it
(``jax.jit`` on the CPU).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU here)

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu import config as jconfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    pipeline as jpipeline,
    seeding as jseeding,
    splitting as jsplit,
    trace_jnp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry as jbuild_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import (
    make_synthetic_luts as jmake_synthetic_luts,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables as jbuild_cell_tables,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.sweep import (
    design_sweep as jsweep,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli, config
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import pipeline
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
    make_synthetic_luts,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    design_sweep,
)

M, N = 3, 2


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_vector_simulator_matches_jax_jnp_simulator():
    """``Simulator(engine="vector", segmented=True)`` against the JAX
    ``Simulator(engine="jnp")`` on one configuration (128 rays per cell, 2
    iterations, batches of 7 cells): the (L, N, M, ny, nx) histograms differ
    in at most 2 bins per disagreeing ray at the P2 bar (0.5 % of the rays),
    bounces within 2 %, the same geometry (the unsimplified regions: no
    simplification outside the kernel engines).  Measured: identical
    histograms and bounce totals."""
    cfg = jconfig.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                              num_iter=2, max_bounces=400, seed=5)
    pcfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                              num_iter=2, max_bounces=400, seed=5)
    ref = jpipeline.Simulator(cfg=cfg, engine="jnp")
    rj = ref.run(cells_per_batch=7)
    sim = pipeline.Simulator(cfg=pcfg, device="cpu", engine="vector",
                             segmented=True, segment_bounces=8)
    np.testing.assert_array_equal(sim.tgeom.r1_hp, ref.tgeom.r1_hp)
    rp = sim.run(cells_per_batch=7)
    assert rp.histogram.shape == rj.histogram.shape == (3, N, M, 80, 120)
    assert rp.rays_traced == rj.rays_traced == 2 * 18 * 128
    diff = np.abs(rp.histogram - np.asarray(rj.histogram)).sum()
    assert diff <= 2 * 0.005 * rj.rays_traced
    assert abs(rp.total_bounces - rj.total_bounces) <= 0.02 * rj.total_bounces
    assert rp.deposits == int(rp.histogram.sum()) > 0
    for k in ("R", "G", "B"):
        assert rp.efficiencies[k] == pytest.approx(rj.efficiencies[k],
                                                   rel=0.02, abs=2e-3)
    assert rp.metrics.delta_e == pytest.approx(rj.metrics.delta_e, rel=0.02)
    assert len(rp.timings["batch_steps"]) == 2 * 3
    assert rp.timings["syncs"] >= rp.timings["steps"]


@pytest.fixture(scope="module")
def split_ref():
    """The JAX global splitting engine over the 18 cells at 4 positions
    (threshold 1e-5, a wavefront that never fills): the exact expectation
    the JAX ``Simulator(engine="splitting")`` is held to in the JAX tests."""
    cfg = jconfig.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=4,
                              max_bounces=400, rng_mode="fast", seed=2)
    geom = jgenerate_geometry(num_fov_x=M, num_fov_y=N)
    luts = jmake_synthetic_luts(geom)
    b = jseeding.build_ray_batch(geom, cfg)
    rays = trace_jnp.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                    b["cid"], b["idx"], b["rng"])
    return jsplit.run_splitting(
        jbuild_cell_tables(geom, luts), jbuild_trace_geometry(geom), cfg,
        rays, capacity=1 << 15, weight_threshold=1e-5, max_steps=300)


def test_splitting_simulator_matches_jax(split_ref):
    """``Simulator(engine="splitting")`` (per-cell wavefronts, the default)
    gives the JAX engine's expectation within its tests' bars (rtol 2e-4 /
    atol 1e-10) with nothing truncated and pruned weight under 2 % of the
    launch weight; its batches are independent: 7 cells per batch give the
    same histogram bit for bit; the shared-wavefront mode agrees within the
    bars, and its launch rays must fit the wavefront."""
    cfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=4,
                             max_bounces=400, rng_mode="fast", seed=2)
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    kw = dict(cfg=cfg, geom=geom, luts=make_synthetic_luts(geom),
              device="cpu", engine="splitting", splitting_threshold=1e-5,
              splitting_max_steps=300)
    sim = pipeline.Simulator(**kw)
    assert sim._split_capacity == 8192
    res = sim.run(num_iter=1, cells_per_batch=18)
    assert sim.split_truncated == 0.0
    assert 0 < sim.split_peak_live < 8192
    assert sim.split_pruned / res.rays_traced < 0.02
    assert res.deposits is None and res.metrics is not None
    np.testing.assert_allclose(res.histogram, split_ref.histogram, rtol=2e-4,
                               atol=1e-10)
    assert res.total_bounces == split_ref.steps
    res7 = sim.run(num_iter=1, cells_per_batch=7, evaluate_metrics=False)
    np.testing.assert_array_equal(res7.histogram, res.histogram)
    glob = pipeline.Simulator(splitting_percell=False,
                              splitting_capacity=1 << 15, **kw)
    rg = glob.run(num_iter=1, cells_per_batch=18, evaluate_metrics=False)
    assert glob.split_truncated == 0.0
    np.testing.assert_allclose(rg.histogram, split_ref.histogram, rtol=2e-4,
                               atol=1e-10)
    small = pipeline.Simulator(splitting_percell=False,
                               splitting_capacity=64, **kw)
    with pytest.raises(ValueError, match="cannot even seed"):
        small.run(num_iter=1, cells_per_batch=18)


def test_splitting_batches_hold_a_bounded_wavefront(monkeypatch):
    """A per-cell splitting run's batches hold at most
    ``SPLIT_SLOT_BUDGET`` slots: with a budget of 4 wavefronts, 18 cells run
    in 5 batches whatever ``cells_per_batch`` asks."""
    cfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=2,
                             max_bounces=400, seed=2)
    sim = pipeline.Simulator(cfg=cfg, device="cpu", engine="splitting",
                             splitting_capacity=256,
                             splitting_threshold=1e-3)
    monkeypatch.setattr(pipeline, "SPLIT_SLOT_BUDGET", 4 * 256)
    sizes = []
    trace = sim._trace_splitting
    monkeypatch.setattr(sim, "_trace_splitting",
                        lambda b, c, p: sizes.append(len(c)) or trace(b, c, p))
    sim.run(num_iter=1, cells_per_batch=2048, evaluate_metrics=False)
    assert sizes == [4, 4, 4, 4, 2]


def _designs(pkg):
    return [dataclasses.replace(pkg.WaveguideDesign(), lambda_ic=p,
                                lambda_oc=p) for p in (380.0, 388.0, 396.0)]


def test_vector_sweep_matches_jax_and_each_design_its_solo_sweep():
    """``run_design_sweep`` over 3 coupler periods (128 rays per cell,
    400-bounce bound) against the JAX sweep: histograms, efficiencies and
    bounces within the P2 bars (measured: equal); in the port, each design
    equals its solo sweep bit for bit, and the sweep in one loop to the end
    equals the compacted one."""
    cfg = jconfig.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                              max_bounces=400)
    pcfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                              max_bounces=400)
    want = jsweep.run_design_sweep(_designs(jconfig), cfg)
    got = design_sweep.run_design_sweep(_designs(config), pcfg, device="cpu",
                                        segment_bounces=16)
    assert got.histograms.shape == want.histograms.shape
    rays = 3 * M * N * 128
    for d in range(3):
        diff = np.abs(got.histograms[d] - want.histograms[d]).sum()
        assert diff <= 2 * 0.005 * rays
        assert abs(int(got.bounces[d]) - int(want.bounces[d])) <= (
            0.02 * int(want.bounces[d]))
    np.testing.assert_allclose(got.efficiencies, want.efficiencies,
                               atol=2 * 0.005 * 3)
    assert got.timings["segments"] >= 1
    mono = design_sweep.run_design_sweep(_designs(config), pcfg, device="cpu",
                                         segment_bounces=None)
    np.testing.assert_array_equal(mono.histograms, got.histograms)
    np.testing.assert_array_equal(mono.bounces, got.bounces)
    for d, des in enumerate(_designs(config)):
        solo = design_sweep.run_design_sweep([des], pcfg, device="cpu")
        np.testing.assert_array_equal(solo.histograms[0], got.histograms[d])
        assert solo.bounces[0] == got.bounces[d]
        np.testing.assert_array_equal(solo.efficiencies[0],
                                      got.efficiencies[d])


def test_cli_vector_engine_writes_the_heatmaps(tmp_path, capsys, monkeypatch):
    """``simulate --engine vector --heatmaps PNG`` on the CPU: the report,
    the JSON and a decodable 3-panel PNG."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    png = tmp_path / "heat.png"
    out = tmp_path / "m.json"
    assert cli.main(["simulate", "--device", "cpu", "--engine", "vector",
                     "--fov-x", "3", "--fov-y", "2", "--rays-per-fov", "64",
                     "--num-iter", "1", "--max-bounces", "200", "--image", "",
                     "--heatmaps", str(png), "--json", str(out)]) == 0
    assert "FoV efficiency heatmaps written" in capsys.readouterr().out
    w, h = Image.open(png).size
    assert w > 2 * h > 0
    assert out.exists()


def test_cli_splitting_engine_and_the_matplotlib_check(tmp_path, capsys,
                                                       monkeypatch):
    """``simulate --engine splitting`` runs on the CPU; without matplotlib,
    ``--heatmaps`` fails before the simulator is built."""
    import sys

    monkeypatch.chdir(tmp_path)
    assert cli.main(["simulate", "--device", "cpu", "--engine", "splitting",
                     "--fov-x", "2", "--fov-y", "2", "--rays-per-fov", "2",
                     "--num-iter", "1", "--image", ""]) == 0
    assert "Efficiency (Green)" in capsys.readouterr().out
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    built = []
    monkeypatch.setattr(pipeline, "Simulator", lambda *a, **k: built.append(1))
    with pytest.raises(SystemExit, match="matplotlib is required for "
                                         "--heatmaps"):
        cli.main(["simulate", "--device", "cpu", "--image", "",
                  "--heatmaps", "h.png"])
    assert not built


def test_cli_plot_design_writes_three_pngs(tmp_path, capsys):
    prefix = tmp_path / "d"
    assert cli.main(["plot-design", "--fov-x", "4", "--fov-y", "3",
                     "--prefix", str(prefix)]) == 0
    printed = capsys.readouterr().out
    for name in ("kspace", "layout", "angular"):
        path = tmp_path / f"d_{name}.png"
        assert path.stat().st_size > 1000 and str(path) in printed


def test_cli_sweep_vector_engine(capsys):
    """``sweep --engine vector`` ranks the designs; ``--metrics`` belongs to
    the persistent engine and is refused with exit code 2."""
    assert cli.main(["sweep", "--device", "cpu", "--engine", "vector",
                     "--fov-x", "2", "--fov-y", "2", "--rays-per-fov", "32",
                     "--max-bounces", "200", "--num-designs", "3"]) == 0
    out = capsys.readouterr().out
    assert "3 designs in" in out and "best mean efficiency" in out
    assert cli.main(["sweep", "--device", "cpu", "--engine", "vector",
                     "--metrics"]) == 2
