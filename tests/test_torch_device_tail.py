"""PyTorch port: ``simulate``'s tail on the device for every engine, on the
CPU.

- ``evaluate_torch(with_image=True)`` against the JAX package's
  ``evaluate_jnp(with_image=True)`` (plain ``jax.jit``) and the float64
  host ``evaluate`` on ``tests/test_eval.py``'s fixture (rng 5, a starved
  eye position and one empty bin), with TF32 off inside the colorimetry;
- ``run(histogram_device=True, metrics_device=True)`` against ``run()`` on
  one Simulator of each general engine (cell, vector, splitting);
- ``simulate --engine cell`` through the CLI: the device tail, and its PNG
  against the host tail's;
- the boost hybrid's device splice against its host splice.

Bars: the image within the JAX package's own (rtol 2e-3, atol 1e-5,
``tests/test_eval.py``), the metrics within 1e-4 relative, the starved
positions equal, the efficiencies within 1e-6 relative.  Fixture: the
paper design at 4 x 3 FoV x 3 wavelengths, 128 rays per FoV (the splitting
engine: 2 launch positions), seeded from numpy."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval import (
    metrics as jmetrics,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    EvalConfig,
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    hybrid,
    pipeline,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
    image,
    metrics,
)

M, N = 4, 3
CFG = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128, num_iter=2,
                  max_bounces=400, seed=4)
IMAGE_BAR = dict(rtol=2e-3, atol=1e-5)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(a, b):
    return abs(a - b) / max(abs(b), 1e-30)


def _same_metrics(got, want):
    """Metrics within 1e-4 relative, starved positions equal, the eye-view
    image within the JAX package's bar."""
    for k in ("delta_e", "u_fov", "u_eyebox"):
        assert _rel(getattr(got, k), getattr(want, k)) <= 1e-4, k
    assert got.starved_eye_positions == want.starved_eye_positions
    np.testing.assert_allclose(got.eye_luminance, want.eye_luminance,
                               rtol=1e-4)
    assert got.output_image.shape == want.output_image.shape
    np.testing.assert_allclose(got.output_image, want.output_image,
                               **IMAGE_BAR)


def _eval_fixture():
    """``tests/test_eval.py``'s stack: a fully starved eye position and one
    empty (FoV, eye) bin."""
    rng = np.random.default_rng(5)
    perc = rng.random((3, 10, 12, 4, 5)) * 1e-3
    perc[:, :, :, 0, 0] = 0.0
    perc[0, 2, 3, 1, 1] = 0.0
    return perc


def test_evaluate_torch_image_matches_jax_and_host():
    perc = _eval_fixture()
    host = metrics.evaluate(None, perceive=perc / 2.0)
    got = metrics.evaluate_torch(torch.from_numpy(perc.astype(np.float32)),
                                 norm=2.0, with_image=True)
    want = jmetrics.evaluate_jnp(jnp.asarray(perc, jnp.float32), norm=2.0,
                                 with_image=True)
    assert got.output_image.dtype == np.float32
    assert got.starved_eye_positions == 1
    for ref in (host, want):
        _same_metrics(got, ref)
    split = metrics.result_to_host(
        metrics.colorimetry_torch(torch.from_numpy(perc.astype(np.float32)),
                                  norm=2.0, with_image=True), 4, 5)
    np.testing.assert_array_equal(split.output_image, got.output_image)
    assert metrics.evaluate_torch(
        torch.from_numpy(perc.astype(np.float32))).output_image is None


def test_colorimetry_runs_with_tf32_off(monkeypatch):
    """TF32 is off for the (3, 3) colour products (cuBLAS on the card) of the
    device colorimetry, and the caller's settings come back after it."""
    seen = []
    matmul = torch.Tensor.__matmul__

    def spy(a, b):
        seen.append((torch.backends.cuda.matmul.allow_tf32,
                     torch.backends.cudnn.allow_tf32))
        return matmul(a, b)

    monkeypatch.setattr(torch.Tensor, "__matmul__", spy)
    keep = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    try:
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.backends.cudnn.allow_tf32 = True
        metrics.evaluate_torch(torch.from_numpy(
            _eval_fixture().astype(np.float32)), with_image=True)
        assert seen == [(False, False)] * 2
        assert torch.backends.cuda.matmul.allow_tf32
        assert torch.backends.cudnn.allow_tf32
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = keep


ENGINE_RUN = {"cell": {}, "vector": {},
              # launch positions per cell, each followed exactly
              "splitting": dict(rays_per_fov=2)}


@pytest.mark.parametrize("engine", list(ENGINE_RUN))
def test_general_engine_device_tail_equals_host_tail(engine):
    """One Simulator, two tails: histograms identical, efficiencies within
    1e-6 relative, the metrics and image within the bars; the deposits are
    the float64 sum of the device histogram (the splitting engine's: the
    weight it deposited)."""
    sim = pipeline.Simulator(cfg=CFG, device="cpu", engine=engine)
    kw = ENGINE_RUN[engine]
    host = sim.run(**kw)
    out_coupled = sim.split_out_coupled if engine == "splitting" else None
    dev = sim.run(histogram_device=True, metrics_device=True, **kw)
    assert isinstance(host.histogram, np.ndarray)
    assert isinstance(dev.histogram, torch.Tensor)
    np.testing.assert_array_equal(dev.histogram.numpy(), host.histogram)
    for k, v in host.efficiencies.items():
        assert v > 0 and _rel(dev.efficiencies[k], v) <= 1e-6, k
    _same_metrics(dev.metrics, host.metrics)
    assert (dev.total_bounces, dev.rays_traced) == (host.total_bounces,
                                                    host.rays_traced)
    total = float(dev.histogram.sum(dtype=torch.float64))
    if engine == "splitting":
        assert dev.deposits is None
        assert _rel(total, sim.split_out_coupled - out_coupled) <= 1e-5
    else:
        assert dev.deposits == host.deposits == total > 0
    assert {"pull_s", "metrics_s", "assemble_s"} <= set(dev.timings)


def test_cli_cell_engine_writes_the_device_image(tmp_path, monkeypatch):
    """``simulate --engine cell`` keeps the histogram on the device and runs
    the device colorimetry (spied), and writes its PNG; the host tail's
    image of the same run, written as the CLI writes it, differs by at most
    1 in any uint8 channel."""
    from PIL import Image

    monkeypatch.chdir(tmp_path)
    seen, hosts = {}, []
    run = pipeline.Simulator.run

    def spy(self, *a, **k):
        seen.update(k)
        hosts.append(run(self, *a, **dict(k, histogram_device=False,
                                          metrics_device=False)))
        return run(self, *a, **k)

    monkeypatch.setattr(pipeline.Simulator, "run", spy)
    assert cli.main(["simulate", "--engine", "cell", "--device", "cpu",
                     "--fov-x", str(M), "--fov-y", str(N), "--rays-per-fov",
                     "128", "--num-iter", "1", "--max-bounces", "200",
                     "--image", "dev.png"]) == 0
    assert seen["histogram_device"] and seen["metrics_device"]
    image.save_eyebox_center_view(str(tmp_path / "host.png"),
                                  hosts[0].metrics.output_image)
    dev_png, host_png = (np.asarray(Image.open(tmp_path / f), np.int16)
                         for f in ("dev.png", "host.png"))
    assert dev_png.shape == (N, M, 3) and dev_png.any()
    assert np.abs(dev_png - host_png).max() <= 1


def test_boost_hybrid_device_splice_equals_host_splice():
    """The boost hybrid's splice on the device against its host splice (the
    JAX package's), on one bulk run: the replaced Monte-Carlo rows equal,
    the metrics and image within the bars, the efficiencies within 1e-6."""
    cfg = dataclasses.replace(CFG, rays_per_fov=256, num_iter=1,
                              max_bounces=200, seed=0)
    sim = pipeline.Simulator(cfg=cfg, device="cpu", persistent_slots=128,
                             spawn_mode="count", fold_iterations=True)
    hy = hybrid.TailBoostHybrid(sim, eval_cfg=EvalConfig(pupil_mask_bins=60),
                                tau_select=5.0, tau_target=2.0,
                                max_boost=16.0)
    host, _ = hy.run(cells_per_batch=64)
    host_rows = hy.last_mc_rows
    dev, d = hy.run(cells_per_batch=64, metrics_device=True)
    assert 0 < d.selected_cells < 3 * M * N
    np.testing.assert_allclose(hy.last_mc_rows, host_rows, rtol=1e-6)
    np.testing.assert_array_equal(dev.histogram.numpy(),
                                  host.histogram.numpy())
    for k, v in host.efficiencies.items():
        assert _rel(dev.efficiencies[k], v) <= 1e-6, k
    _same_metrics(dev.metrics, host.metrics)
