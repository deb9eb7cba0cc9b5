"""PyTorch port: the Simulator against the JAX persistent Simulator, the
no-JAX import contract, and no silent fallback off the GPU."""

import json
import os
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
    pipeline as jpipeline,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    trace_persistent as tp,
    trace_rows,
)

M, N = 4, 3
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sims():
    """The port's Simulator and the JAX persistent Simulator (count spawn,
    folding, 128 slots, 36 cells in one batch) on one configuration; every
    JAX run below keeps that batch shape, so its interpret kernel compiles
    once."""
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=256, num_iter=2,
                      max_bounces=600, seed=6)
    port = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                              persistent_slots=128, spawn_mode="count",
                              fold_iterations=True)
    ref = jpipeline.Simulator(cfg=cfg, geom=geom, engine="pallas_persistent",
                              interpret=True, spawn_mode="count",
                              fold_iterations=True, persistent_slots=128)
    return port, ref


@pytest.fixture(scope="module")
def runs(sims):
    port, ref = sims
    rp = port.run(rays_per_fov=256, num_iter=2)
    rj = ref.run(rays_per_fov=256, num_iter=2)
    return port, rp, rj


def test_simulator_matches_jax_persistent_simulator(runs):
    """Efficiencies within 3 % relative, delta E within 2 %, bounces within
    1 %, the same rays_traced semantics (rays spawned, within 1 %) and the
    (L, N, M, ny, nx) layout.  The bars allow for XLA's fused multiply-adds.
    Measured on this fixture: 18,799 vs 18,798 rays spawned, 120,716 vs
    120,713 bounces, B efficiency 8e-5 relative apart, G and R equal, delta E
    2e-5 relative apart."""
    _, rp, rj = runs
    assert rp.histogram.shape == rj.histogram.shape == (3, N, M, 80, 120)
    assert abs(rp.rays_traced - rj.rays_traced) <= 0.01 * rj.rays_traced
    assert rp.rays_traced >= 512 * 3 * M * N
    assert abs(rp.total_bounces - rj.total_bounces) <= 0.01 * rj.total_bounces
    for k in ("R", "G", "B"):
        assert rj.efficiencies[k] > 0
        assert abs(rp.efficiencies[k] / rj.efficiencies[k] - 1) <= 0.03, k
    assert abs(rp.metrics.delta_e / rj.metrics.delta_e - 1) <= 0.02
    assert np.isfinite([rp.metrics.u_fov, rp.metrics.u_eyebox]).all()


def test_run_options_match_jax_persistent_simulator(sims):
    """Two unfolded iterations (error groups suspend folding) with the
    device histogram, device metrics, jackknife standard errors and the
    dense scan, against the JAX Simulator's same run: efficiencies within 3
    %, delta E within 2 %, standard errors within 5 %, dense metrics within
    2 %.  Measured on this fixture: 19,213 rays and 124,858 bounces in
    both, efficiencies at most 1.8e-7 relative apart, delta E 1.3e-7,
    standard errors at most 2.6e-5 (eff_B), dense delta E 1.1e-5 and dense
    u_fov 1.8e-9; u_fov's and u_eyebox's standard errors and both
    u_eyebox are 0 in both (starved eye positions)."""
    port, ref = sims
    kw = dict(rays_per_fov=256, num_iter=2, error_groups=True,
              histogram_device=True, metrics_device=True, dense_metrics=True)
    rp, rj = port.run(**kw), ref.run(**kw)
    assert isinstance(rp.histogram, torch.Tensor)
    assert rp.histogram.shape == tuple(rj.histogram.shape)

    def rel(a, b):
        return abs(a - b) / abs(b) if b else abs(a)

    for k in ("R", "G", "B"):
        assert rel(rp.efficiencies[k], rj.efficiencies[k]) <= 0.03, k
    assert rel(rp.metrics.delta_e, rj.metrics.delta_e) <= 0.02
    assert set(rp.metric_stderr) == set(rj.metric_stderr)
    for k, v in rj.metric_stderr.items():
        assert rel(rp.metric_stderr[k], v) <= 0.05, (k, rp.metric_stderr[k], v)
    for k in ("delta_e", "u_fov", "u_eyebox"):
        assert rel(getattr(rp.dense, k), getattr(rj.dense, k)) <= 0.02, k
    assert rp.dense.eye_luminance.shape == rj.dense.eye_luminance.shape
    assert rp.rays_traced == pytest.approx(rj.rays_traced, rel=0.01)


def test_simulator_histogram_renormalised_to_target(runs):
    """Each cell's tile is scaled to the nominal 512 rays, so the histogram
    sum equals sum(efficiencies) / L x nominal rays (the golden relation)."""
    port, rp, _ = runs
    nominal = 512 * M * N * 3
    want = sum(rp.efficiencies.values()) / 3 * nominal
    assert abs(rp.histogram.sum() - want) <= 1e-5 * want
    assert rp.cell_stats.shape == (3 * M * N, 4)
    assert (rp.cell_stats[:, 2] >= 512).all()
    assert rp.rays_traced == int(rp.cell_stats[:, 2].sum())
    assert "seed_s" in rp.timings and "metrics_s" in rp.timings
    report = pipeline.format_report(rp)
    assert "Efficiency (Green)" in report and "Color dispersion" in report


def test_batching_invariance(runs):
    """Cells are independent: splitting the grid into batches changes
    nothing."""
    port, rp, _ = runs
    rb = port.run(rays_per_fov=256, num_iter=2, cells_per_batch=7,
                  evaluate_metrics=False)
    np.testing.assert_array_equal(rb.histogram, rp.histogram)
    assert rb.total_bounces == rp.total_bounces


def test_import_and_cpu_run_load_no_jax(tmp_path):
    """A process that imports the port and runs a CPU Simulator (exact, and
    packed with transit jumps) and a CPU sweep (packed, two cells per block,
    with metrics) loads neither jax, ml_dtypes nor any module of the JAX
    package."""
    code = (
        "import sys\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine "
        "import pipeline\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config "
        "import TraceConfig, WaveguideDesign\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep "
        "import run_design_sweep_persistent\n"
        "cfg = TraceConfig(num_fov_x=2, num_fov_y=2, rays_per_fov=128, "
        "num_iter=1, max_bounces=200, seed=1)\n"
        "r = pipeline.Simulator(cfg=cfg, device='cpu', persistent_slots=128)"
        ".run()\n"
        "assert r.rays_traced >= 128 * 12, r.rays_traced\n"
        "r = pipeline.Simulator(cfg=cfg, device='cpu', persistent_slots=128, "
        "pers_accum_mode='packed', pers_transit_jump=True).run()\n"
        "assert r.rays_traced >= 128 * 12, r.rays_traced\n"
        "s = run_design_sweep_persistent([WaveguideDesign()] * 2, cfg, "
        "spawn_iters=8, evaluate_metrics=True, device='cpu', "
        "accum_mode='packed', cells_per_block=2)\n"
        "assert (s.efficiencies > 0).all() and len(s.metrics) == 2\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes') "
        "or m.startswith(('jax.', 'gpu_ray_tracing_for_waveguide_based_ar_"
        "display_tpu')))\n"
        "print(bad or 'NOJAX')\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "NOJAX"


def test_simulator_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        pipeline.Simulator(cfg=TraceConfig(num_fov_x=2, num_fov_y=2),
                           device="cuda")


def test_cli_default_device_cuda_raises_without_card(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)   # the default --image writes here
    out = tmp_path / "m.json"
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["simulate", "--fov-x", "2", "--fov-y", "2",
                  "--rays-per-fov", "128", "--num-iter", "1",
                  "--json", str(out)])
    assert not out.exists()


def test_cli_cpu_writes_json(tmp_path, capsys, monkeypatch):
    monkeypatch.chdir(tmp_path)   # the default --image writes here
    out = tmp_path / "m.json"
    hist = tmp_path / "h.npy"
    assert cli.main(["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y",
                     "2", "--rays-per-fov", "128", "--num-iter", "1",
                     "--max-bounces", "200", "--slots", "128",
                     "--json", str(out), "--save-histogram", str(hist)]) == 0
    data = json.loads(out.read_text())
    assert data["device"] == "cpu" and data["rays_traced"] >= 128 * 12
    assert np.load(hist).shape == (3, 2, 2, 80, 120)
    assert "Rays traced" in capsys.readouterr().out


def test_cli_writes_the_eye_view_png_by_default(tmp_path, capsys,
                                                monkeypatch):
    """With no ``--image``, ``simulate`` writes ``Eyebox Center View.png``
    into the working directory, as the JAX CLI does; it decodes to the
    eye view of the run's metrics."""
    from PIL import Image

    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval.image import (
        eye_view_uint8,
    )

    monkeypatch.chdir(tmp_path)
    results = []
    run = pipeline.Simulator.run
    monkeypatch.setattr(pipeline.Simulator, "run",
                        lambda self, *a, **k: results.append(
                            run(self, *a, **k)) or results[-1])
    assert cli.main(["simulate", "--device", "cpu", "--fov-x", "3", "--fov-y",
                     "2", "--rays-per-fov", "128", "--num-iter", "1",
                     "--max-bounces", "200", "--slots", "128"]) == 0
    png = tmp_path / "Eyebox Center View.png"
    assert f"written to {png.name}" in capsys.readouterr().out
    want = eye_view_uint8(results[0].metrics.output_image)
    assert want.shape == (2, 3, 3) and want.any()
    got = np.asarray(Image.open(png).convert("RGB"))
    np.testing.assert_array_equal(got, want)
    assert cli.build_parser().parse_args(["simulate"]).image == png.name


def test_cli_without_image_writer_fails_before_the_trace(monkeypatch):
    """Without cv2 and PIL the default PNG cannot be written: ``simulate``
    says so before it builds the simulator, not after the trace."""
    monkeypatch.setitem(sys.modules, "cv2", None)
    monkeypatch.setitem(sys.modules, "PIL", None)
    built = []
    monkeypatch.setattr(pipeline, "Simulator",
                        lambda *a, **k: built.append(1))
    with pytest.raises(SystemExit, match="needs cv2 or PIL"):
        cli.main(["simulate", "--device", "cpu"])
    assert not built


class _ClaimsCuda(torch.Tensor):
    """A CPU tensor that reports a CUDA device."""

    @property
    def device(self):
        return torch.device("cuda")


def test_wrapper_never_runs_plain_version_for_cuda_tensor(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    called = []
    monkeypatch.setattr(tp, "persistent_trace_reference",
                        lambda *a, **k: called.append(1))
    C, S = 2, 128
    cp = torch.zeros((C, trace_rows.PC)).as_subclass(_ClaimsCuda)
    gr = torch.zeros((1, trace_rows.PG)).as_subclass(_ClaimsCuda)
    rays = torch.zeros((1, 6, 1, 128)).as_subclass(_ClaimsCuda)
    rng = torch.ones((C, 1, 128), dtype=torch.int32).as_subclass(_ClaimsCuda)
    ctrl = torch.tensor([S, 0], dtype=torch.int32).as_subclass(_ClaimsCuda)
    assert cp.device.type == "cuda"
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tp.persistent_trace(cp, gr, rays, rng, ctrl, num_fc=7, num_oc=6,
                            edge_counts=(14, 15, 21), eyebox_bins=(80, 120),
                            max_iters=10)
    assert called == []
