"""PyTorch port: the design sweep against the JAX persistent-kernel sweep.

The port's sweep runs on the CPU (the plain trace); the JAX sweep runs its
Pallas kernel in interpret mode.  Designs and config as the JAX package's own
sweep tests: the paper design at 380 / 388 / 396 nm coupler periods, 4 x 3
FoV, 128 rays per FoV, a 256-bounce bound."""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    TraceConfig as JTraceConfig,
    WaveguideDesign as JWaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval.metrics import (
    evaluate_jnp_batch,
    pupil_conv as jpupil_conv,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.sweep import (
    run_design_sweep_persistent as jsweep,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    EvalConfig,
    TraceConfig,
    WaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval.metrics import (
    evaluate,
    evaluate_batch,
    pupil_conv,
    pupil_mask,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    run_design_sweep_persistent as sweep,
)

PERIODS = (380.0, 388.0, 396.0)
CFG = dict(num_fov_x=4, num_fov_y=3, rays_per_fov=128, max_bounces=256, seed=5)
# spawn mode -> spawn_iters, as the JAX package's sweep tests run them
MODES = {"gens": 64, "count": 0}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _designs(cls):
    return [dataclasses.replace(cls(), lambda_ic=p, lambda_oc=p) for p in PERIODS]


def _port(mode, designs=None, **kw):
    return sweep(designs or _designs(WaveguideDesign), TraceConfig(**CFG),
                 spawn_iters=MODES[mode], spawn_mode=mode, device="cpu", **kw)


@pytest.fixture(scope="module", params=sorted(MODES))
def runs(request):
    """(mode, port sweep, JAX interpret sweep), histograms kept; the port's
    with its device metrics."""
    mode = request.param
    ref = jsweep(_designs(JWaveguideDesign), JTraceConfig(**CFG), interpret=True,
                 spawn_iters=MODES[mode], spawn_mode=mode, keep_histograms=True)
    return mode, _port(mode, keep_histograms=True, evaluate_metrics=True), ref


def test_sweep_matches_jax_sweep(runs):
    """Efficiencies within 3 %, bounces within 1 % (XLA contracts
    multiply-adds; a ray within an ulp of a threshold may branch otherwise).
    Measured on these fixtures: identical histograms and bounces in both
    modes, efficiencies equal to float32 rounding of the sums."""
    mode, res, ref = runs
    assert res.efficiencies.shape == ref.efficiencies.shape == (3, 3)
    assert res.histograms.shape == ref.histograms.shape == (3, 3, 3, 4, 80, 120)
    assert (ref.efficiencies > 0).all()
    np.testing.assert_allclose(res.efficiencies, ref.efficiencies, rtol=0.03)
    np.testing.assert_allclose(res.bounces, ref.bounces, rtol=0.01)
    assert not np.allclose(res.efficiencies[0], res.efficiencies[2])


def test_sweep_metrics_match_host_evaluate(runs):
    """Device metrics (float32) against host ``evaluate`` (float64) of the
    kept histograms at the sweep's nominal normalisation."""
    mode, res, _ = runs
    nominal = 128      # count: rays_per_fov; gens: slots x gens = 128 x 1
    assert len(res.metrics) == 3
    for d in range(3):
        host = evaluate(res.histograms[d] / nominal, with_image=False)
        got = res.metrics[d]
        assert abs(got.delta_e - host.delta_e) < 2e-3 * max(1, host.delta_e)
        assert abs(got.u_fov - host.u_fov) < 1e-4
        assert abs(got.u_eyebox - host.u_eyebox) < 1e-4
        assert got.starved_eye_positions == host.starved_eye_positions
    assert res.metrics[0].delta_e != res.metrics[2].delta_e


def test_evaluate_batch_matches_jax(runs):
    """``pupil_conv`` and ``evaluate_batch`` against the JAX package's
    ``pupil_conv`` and ``evaluate_jnp_batch`` on the same float32 stack:
    perception within 1e-5 relative of its largest value (float32 sums in
    another order), delta E within 1e-4 relative, uniformities within 1e-5,
    the same starved positions."""
    _, res, _ = runs
    ec = EvalConfig()
    h = res.histograms.astype(np.float32)
    mask = pupil_mask(ec.pupil_mask_bins)
    stride = (ec.eye_step_y, ec.eye_step_x)
    perc = pupil_conv(torch.from_numpy(h), torch.from_numpy(mask), stride)
    jperc = np.asarray(jpupil_conv(jnp.asarray(h), jnp.asarray(mask, jnp.float32),
                                   stride))
    assert perc.shape == jperc.shape == (3, 3, 3, 4, 7, 8)
    np.testing.assert_allclose(perc.numpy(), jperc, rtol=0,
                               atol=1e-5 * float(np.abs(jperc).max()))
    got = evaluate_batch(perc, norm=128)
    want = evaluate_jnp_batch(jnp.asarray(perc.numpy()), norm=128)
    for g, w in zip(got, want):
        assert abs(g.delta_e / w.delta_e - 1) < 1e-4
        assert abs(g.u_fov - w.u_fov) < 1e-5
        assert abs(g.u_eyebox - w.u_eyebox) < 1e-5
        assert g.starved_eye_positions == w.starved_eye_positions
        np.testing.assert_allclose(g.eye_luminance, w.eye_luminance,
                                   rtol=1e-5, atol=1e-12)


def test_design_equals_solo_and_chunked_equals_whole(runs):
    """The port's own bars, bit for bit: the middle design of a sweep equals
    a solo sweep of it; chunks of 2 designs equal one launch of 3; per-cell
    host-built tiles and seeds equal the shared tile and seed block."""
    mode, res, _ = runs
    solo = _port(mode, _designs(WaveguideDesign)[1:2], keep_histograms=True)
    np.testing.assert_array_equal(solo.histograms[0], res.histograms[1])
    np.testing.assert_array_equal(solo.efficiencies[0], res.efficiencies[1])
    assert solo.bounces[0] == res.bounces[1]
    for kw in (dict(designs_per_batch=2), dict(_force_host_blocks=True)):
        other = _port(mode, keep_histograms=[0, 2], **kw)
        np.testing.assert_array_equal(other.histograms, res.histograms[[0, 2]])
        np.testing.assert_array_equal(other.efficiencies, res.efficiencies)
        np.testing.assert_array_equal(other.bounces, res.bounces)
        assert other.timings["launches"] == 0   # the CPU runs the plain trace


def test_packed_jump_sweep_matches_jax_sweep():
    """The sweep with packed selection and transit jumps (gens spawn
    saturated to iteration 64) against the JAX interpret sweep with the same
    options: efficiencies within 3 %, bounces within 1 %.  Measured on
    this fixture: identical bounces (382,220 / 386,483 / 390,880)."""
    kw = dict(accum_mode="packed", transit_jump=True)
    ref = jsweep(_designs(JWaveguideDesign), JTraceConfig(**CFG),
                 interpret=True, spawn_iters=MODES["gens"], spawn_mode="gens",
                 **kw)
    res = _port("gens", **kw)
    print(f"packed + jump sweep: bounces {res.bounces.tolist()} vs "
          f"{np.asarray(ref.bounces).tolist()}")
    assert (ref.efficiencies > 0).all()
    np.testing.assert_allclose(res.efficiencies, ref.efficiencies, rtol=0.03)
    np.testing.assert_allclose(res.bounces, ref.bounces, rtol=0.01)
    # jumps do more bounces in the same 64 iterations than single hops
    assert (res.bounces > _port("gens", accum_mode="packed").bounces).all()


@pytest.mark.parametrize("mode", sorted(MODES))
def test_sweep_cells_per_block_equals_one(mode):
    """Four (and two) cells per block give each design's histogram,
    efficiencies and bounces of the one-cell-per-block packed sweep, bit for
    bit."""
    one = _port(mode, accum_mode="packed", keep_histograms=True)
    assert one.histograms.sum() > 0
    for k in (4, 2):
        many = _port(mode, accum_mode="packed", cells_per_block=k,
                     keep_histograms=True)
        np.testing.assert_array_equal(many.histograms, one.histograms)
        np.testing.assert_array_equal(many.efficiencies, one.efficiencies)
        np.testing.assert_array_equal(many.bounces, one.bounces)


@pytest.mark.parametrize("kw", [
    dict(cells_per_block=2), dict(transit_jump=True),
    dict(accum_mode="packed", cells_per_block=2, _force_host_blocks=True),
    dict(accum_mode="packed", cells_per_block=5),
    dict(accum_mode="packed", cells_per_block=2, transit_jump=True),
    dict(accum_mode="bf16")],
    ids=["k_fma", "jump_fma", "k_host_blocks", "k_divides", "jump_k", "bf16"])
def test_sweep_refuses_bad_mode_combinations(kw):
    with pytest.raises(ValueError):
        _port("gens", **kw)


def test_cli_sweep_cpu(capsys):
    assert cli.main(["sweep", "--device", "cpu", "--fov-x", "2", "--fov-y", "2",
                     "--rays-per-fov", "128", "--max-bounces", "128",
                     "--spawn-iters", "16", "--num-designs", "2",
                     "--metrics"]) == 0
    out = capsys.readouterr().out
    assert "2 designs in" in out and "lowest color dispersion" in out


def test_sweep_cuda_without_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        sweep(_designs(WaveguideDesign)[:1], TraceConfig(**CFG))
