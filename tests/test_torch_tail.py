"""PyTorch port: the run surface of the Simulator on the CPU.

Device perception and the dense scan against the JAX package's jnp
functions (plain jit, no Pallas); within the port: the device tail against
the host tail, gens spawn against the plain persistent trace, wavelength
subsets and checkpoint/resume on both engines, the jackknife, the refusals,
and the CLI's flags.  Fixture: the paper design at 4 x 3 FoV x 3
wavelengths, 128 slots, seeded from numpy."""

import dataclasses
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    EvalConfig as JEvalConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval import (
    metrics as jmetrics,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    EvalConfig,
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    trace_persistent as tp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import metrics

M, N = 4, 3
CFG = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128, num_iter=2,
                  max_bounces=400, seed=4)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _hist(seed=5, shape=(3, N, M, 80, 120)):
    rng = np.random.default_rng(seed)
    h = rng.poisson(0.8, size=shape).astype(np.float32)
    h[:, 0, 0, :30] = 0.0        # a starved corner
    return h


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def test_eye_perceived_torch_matches_jax_and_host():
    """(L, fy, fx, 80, 120) -> (L, fy, fx, 7, 8), within float32 association
    of the JAX package's window sums and of the float64 host sampler."""
    h = _hist()
    got = metrics.eye_perceived_torch(torch.from_numpy(h)).numpy()
    assert got.shape == (3, N, M, 7, 8) and got.dtype == np.float32
    want_j = np.asarray(jmetrics.eye_perceived_jnp(jnp.asarray(h),
                                                   JEvalConfig()))
    want_h = metrics.eye_perceived(h.astype(np.float64), EvalConfig())
    np.testing.assert_allclose(got, want_j, rtol=2e-6, atol=1e-3)
    np.testing.assert_allclose(got, want_h, rtol=2e-6, atol=1e-3)


@pytest.mark.parametrize("stride", [(1, 1), (3, 5)])
def test_eye_perceived_conv_matches_jax(stride):
    h = _hist(6, (2, 2, 3, 40, 60))
    cfg = EvalConfig(pupil_mask_bins=10, eye_step_y=7, eye_step_x=9)
    jcfg = JEvalConfig(pupil_mask_bins=10, eye_step_y=7, eye_step_x=9)
    got = metrics.eye_perceived_conv(torch.from_numpy(h), cfg, stride).numpy()
    want = np.asarray(jmetrics.eye_perceived_conv_jnp(jnp.asarray(h), jcfg,
                                                      stride))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=2e-6, atol=1e-4)


@pytest.mark.parametrize("chunk_rows", [0, 8])
def test_evaluate_dense_matches_jax(chunk_rows):
    """The dense scan (51 x 91 eye positions) in float32, chunked and not:
    every metric within 1e-4 relative of the JAX package's, the luminance
    map within float32 tolerance, the starved positions equal."""
    h = _hist(7) / 512.0
    got = metrics.evaluate_dense(torch.from_numpy(h), EvalConfig(), norm=3.0,
                                 chunk_rows=chunk_rows)
    want = jmetrics.evaluate_dense(jnp.asarray(h), JEvalConfig(), norm=3.0,
                                   chunk_rows=chunk_rows)
    assert got.eye_luminance.shape == (51, 91)
    for k in ("delta_e", "u_fov", "u_eyebox"):
        assert _rel(getattr(got, k), getattr(want, k)) <= 1e-4, k
    np.testing.assert_allclose(got.eye_luminance, want.eye_luminance,
                               rtol=1e-4, atol=1e-9)
    assert got.starved_eye_positions == want.starved_eye_positions > 0
    if chunk_rows:
        whole = metrics.evaluate_dense(torch.from_numpy(h), EvalConfig(),
                                       norm=3.0)
        assert _rel(got.delta_e, whole.delta_e) <= 1e-5
        np.testing.assert_allclose(got.eye_luminance, whole.eye_luminance,
                                   rtol=1e-5)


@pytest.fixture(scope="module")
def sim():
    """Count spawn with folding: the path these tests were written for."""
    return pipeline.Simulator(cfg=CFG, device="cpu", persistent_slots=128,
                              spawn_mode="count", fold_iterations=True)


@pytest.fixture(scope="module")
def host_run(sim):
    return sim.run()


def test_device_tail_equals_host_tail(sim, host_run):
    """One Simulator, three tails: the host's, the device histogram with the
    stack pulled for the host colorimetry, and device metrics.  Histograms
    identical, efficiencies within 1e-6 relative, metrics within 1e-4, the
    eye-view images (the device colorimetry's too) within the JAX package's
    bar (rtol 2e-3, atol 1e-5) of the host image."""
    stack = sim.run(histogram_device=True)
    dev = sim.run(histogram_device=True, metrics_device=True)
    for r in (stack, dev):
        assert isinstance(r.histogram, torch.Tensor)
        np.testing.assert_array_equal(r.histogram.numpy(), host_run.histogram)
        for k, v in host_run.efficiencies.items():
            assert _rel(r.efficiencies[k], v) <= 1e-6, k
        for k in ("delta_e", "u_fov", "u_eyebox"):
            assert _rel(getattr(r.metrics, k),
                        getattr(host_run.metrics, k)) <= 1e-4, k
        assert r.rays_traced == host_run.rays_traced
    for r in (stack, dev):
        np.testing.assert_allclose(r.metrics.output_image,
                                   host_run.metrics.output_image, rtol=2e-3,
                                   atol=1e-5)
    assert "pull_s" in stack.timings and "metrics_s" in dev.timings


def test_gens_spawn_equals_plain_trace(sim):
    """Gens spawn, unfolded: each iteration's histogram is the plain trace's
    on the same blocks (two generations of 128 slots for 256 rays), with no
    renormalisation."""
    gens = pipeline.Simulator(cfg=dataclasses.replace(CFG, max_bounces=160),
                              device="cpu", persistent_slots=128,
                              spawn_mode="gens", fold_iterations=False)
    res = gens.run(rays_per_fov=256, evaluate_metrics=False)
    cells = np.arange(36)
    want = torch.zeros((36, 80, 120))
    spawned = 0
    for it in range(2):
        rays_in, rng_in = gens._device_ray_blocks(cells, 128, it)
        tr = gens.tracer
        hist, nb = tp.persistent_trace_reference(
            tr.cell_params, tr.geom_row, rays_in, rng_in,
            torch.tensor([2, 0], dtype=torch.int32), num_fc=tr.num_fc,
            num_oc=tr.num_oc, edge_counts=tr.edge_counts,
            eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters,
            spawn_mode="gens")
        want += hist
        spawned += int(nb[:, 2].sum())
    want = tp.hist_tiles_to_histogram(want, cells, 3, M, N, 80, 120)
    np.testing.assert_array_equal(res.histogram, want.numpy())
    assert spawned == 36 * 256 * 2
    assert res.rays_traced == 36 * 256 * 2
    assert (res.cell_stats[:, 2] == 512).all()


def test_default_simulator_is_gens_spawn_unfolded():
    """With no spawn arguments the Simulator runs the path above (gens
    spawn, one relaunch per iteration), bit for bit."""
    cfg = dataclasses.replace(CFG, max_bounces=160)
    runs = [pipeline.Simulator(cfg=cfg, device="cpu", persistent_slots=128,
                               **kw).run(rays_per_fov=256,
                                         evaluate_metrics=False)
            for kw in ({}, dict(spawn_mode="gens", fold_iterations=False))]
    default, gens = runs
    np.testing.assert_array_equal(default.histogram, gens.histogram)
    np.testing.assert_array_equal(default.cell_stats, gens.cell_stats)
    assert default.rays_traced == gens.rays_traced == 36 * 256 * 2
    assert default.total_bounces == gens.total_bounces
    assert default.efficiencies == gens.efficiencies


@pytest.mark.parametrize("engine", ["persistent", "cell"])
def test_wavelength_subset_rows_equal_full_rows(engine, host_run):
    """Rows 0 and 2 of a ``wavelengths=(0, 2)`` run are the full run's; row
    1 is zero and so is its efficiency."""
    if engine == "persistent":
        s, full = pipeline.Simulator(cfg=CFG, device="cpu",
                                     persistent_slots=128, spawn_mode="count",
                                     fold_iterations=True), host_run
    else:
        s = pipeline.Simulator(cfg=CFG, device="cpu", engine="cell")
        full = s.run(rays_per_fov=128, num_iter=1, evaluate_metrics=False)
    kw = {} if engine == "persistent" else dict(rays_per_fov=128, num_iter=1)
    sub = s.run(wavelengths=(0, 2), evaluate_metrics=False,
                cells_per_batch=10, **kw)
    for l in (0, 2):
        np.testing.assert_array_equal(sub.histogram[l], full.histogram[l])
    assert not sub.histogram[1].any() and full.histogram[1].any()
    assert sub.efficiencies["G"] == 0.0
    assert sub.efficiencies["B"] == full.efficiencies["B"]


@pytest.mark.parametrize("engine,spawn_mode", [("persistent", "count"),
                                               ("persistent", "gens"),
                                               ("cell", "count")])
def test_checkpoint_resume_is_bitwise(tmp_path, engine, spawn_mode):
    """Unfolded: three iterations uninterrupted equal two iterations
    checkpointed and resumed to three, histogram, bounces and rays; a
    checkpoint of another configuration is not taken up."""
    s = pipeline.Simulator(cfg=CFG, device="cpu", persistent_slots=128,
                           engine=engine, spawn_mode=spawn_mode,
                           fold_iterations=False)
    kw = dict(rays_per_fov=128, evaluate_metrics=False, cells_per_batch=16)
    path = str(tmp_path / "ck.npz")
    full = s.run(num_iter=3, **kw)
    part = s.run(num_iter=2, checkpoint_path=path, **kw)
    resumed = s.run(num_iter=3, checkpoint_path=path, **kw)
    np.testing.assert_array_equal(resumed.histogram, full.histogram)
    assert resumed.total_bounces == full.total_bounces > part.total_bounces
    assert resumed.rays_traced == full.rays_traced
    assert resumed.efficiencies == full.efficiencies
    other = pipeline.Simulator(cfg=TraceConfig(
        num_fov_x=M, num_fov_y=N, rays_per_fov=256, num_iter=2,
        max_bounces=400, seed=5), device="cpu", persistent_slots=128,
        engine=engine)
    fresh = other.run(num_iter=1, checkpoint_path=path, **kw)
    assert fresh.total_bounces < part.total_bounces


def test_error_groups_jackknife(sim):
    """Unfolded count spawn with error groups: finite, positive standard
    errors, each efficiency's below the efficiency; the histogram is the
    unfolded run's."""
    res = sim.run(error_groups=True, histogram_device=True)
    unfolded = pipeline.Simulator(cfg=CFG, device="cpu", persistent_slots=128,
                                  spawn_mode="count",
                                  fold_iterations=False).run(
        evaluate_metrics=False)
    np.testing.assert_array_equal(res.histogram.numpy(), unfolded.histogram)
    se = res.metric_stderr
    assert set(se) == {"eff_B", "eff_G", "eff_R", "delta_e", "u_fov",
                       "u_eyebox"}
    for k in ("B", "G", "R"):
        assert 0.0 < se[f"eff_{k}"] < res.efficiencies[k], k
    assert all(np.isfinite(v) and v >= 0 for v in se.values())
    assert se["delta_e"] > 0


def test_run_refusals(sim):
    """The cell engine takes ``histogram_device`` and ``metrics_device``
    (tests/test_torch_device_tail.py holds them to the host tail) and
    refuses ``error_groups``."""
    cell = pipeline.Simulator(cfg=CFG, device="cpu", engine="cell")
    for kw in (dict(histogram_device=True),
               dict(histogram_device=True, metrics_device=True)):
        res = cell.run(num_iter=1, **kw)
        assert isinstance(res.histogram, torch.Tensor)
        # float32 from the device colorimetry, float64 from the host's
        assert res.metrics.output_image.dtype == (
            np.float32 if "metrics_device" in kw else np.float64)
        assert "pull_s" in res.timings
    with pytest.raises(ValueError, match="persistent"):
        cell.run(num_iter=2, error_groups=True)
    with pytest.raises(ValueError, match="num_iter"):
        sim.run(num_iter=1, error_groups=True)
    with pytest.raises(ValueError, match="histogram_device"):
        sim.run(metrics_device=True)
    with pytest.raises(ValueError, match="spawn_mode"):
        pipeline.Simulator(cfg=CFG, device="cpu", spawn_mode="saturate")


def test_dense_metrics_on_both_engines(sim):
    res = sim.run(dense_metrics=True, histogram_device=True,
                  metrics_device=True)
    cell = pipeline.Simulator(cfg=CFG, device="cpu", engine="cell").run(
        rays_per_fov=128, num_iter=1, dense_metrics=True)
    for r in (res, cell):
        assert r.dense.eye_luminance.shape == (51, 91)
        assert np.isfinite([r.dense.delta_e, r.dense.u_fov]).all()
        assert "Dense scan (51x91" in pipeline.format_report(r)
    want = metrics.evaluate_dense(res.histogram, EvalConfig(),
                                  norm=CFG.rays_per_fov * CFG.num_iter,
                                  chunk_rows=8)
    assert res.dense.delta_e == want.delta_e


@pytest.mark.parametrize("flags,checks", [
    (["--error-bars", "--image", ""], ("metric_stderr",)),
    (["--dense-eyebox", "-", "--image", ""], ("dense",)),
    (["--wavelengths", "0,2"], ()),
    (["--spawn-mode", "count", "--fold-iterations", "--image", ""], ()),
    (["--engine", "cell", "--dense-eyebox", "--wavelengths", "1"],
     ("dense",)),
])
def test_cli_flags_on_cpu(tmp_path, monkeypatch, capsys, flags, checks):
    monkeypatch.chdir(tmp_path)
    out = tmp_path / "m.json"
    argv = ["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y", "2",
            "--rays-per-fov", "128", "--num-iter", "2", "--max-bounces",
            "200", "--slots", "128", "--json", str(out),
            "--checkpoint", str(tmp_path / "ck.npz")] + flags
    assert cli.main(argv) == 0
    data = json.loads(out.read_text())
    for key in ("metric_stderr", "efficiencies", "rays_traced"):
        assert key in data
    for key in checks:
        assert data[key], key
    text = capsys.readouterr().out
    if "--error-bars" in flags:
        assert "MC standard errors" in text
        assert set(data["metric_stderr"]) >= {"eff_G", "delta_e"}
    if "dense" in checks:
        assert data["dense"]["eye_positions"] == [51, 91]
    if "--wavelengths" in flags:
        assert sum(v > 0 for v in data["efficiencies"].values()) == len(
            flags[flags.index("--wavelengths") + 1].split(","))
    assert (tmp_path / "ck.npz").exists()
    assert (tmp_path / "Eyebox Center View.png").exists() == (
        "--image" not in flags)


def test_cli_dense_png_without_matplotlib_fails_before_the_trace(
        monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    built = []
    monkeypatch.setattr(pipeline, "Simulator", lambda *a, **k: built.append(1))
    with pytest.raises(SystemExit, match="matplotlib"):
        cli.main(["simulate", "--device", "cpu", "--image", "",
                  "--dense-eyebox", "map.png"])
    assert not built


def test_cli_pulls_the_device_histogram_only_to_save_it(tmp_path,
                                                        monkeypatch):
    """The persistent engine's CLI run keeps the histogram on the device
    (a CPU tensor here) and saves it as the (L, FoVy, FoVx, 80, 120) .npy."""
    monkeypatch.chdir(tmp_path)
    seen = {}
    run = pipeline.Simulator.run

    def spy(self, *a, **k):
        seen.update(k)
        return run(self, *a, **k)

    monkeypatch.setattr(pipeline.Simulator, "run", spy)
    hist = tmp_path / "h.npy"
    assert cli.main(["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y",
                     "2", "--rays-per-fov", "128", "--num-iter", "1",
                     "--max-bounces", "200", "--slots", "128", "--image", "",
                     "--save-histogram", str(hist)]) == 0
    assert seen["histogram_device"] and seen["metrics_device"]
    assert np.load(hist).shape == (3, 2, 2, 80, 120)
