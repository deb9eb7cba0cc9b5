"""PyTorch port: the differentiable analytic tables (``design/diff.py``),
autograd through the splitting trace and the grating optimiser
(``opt/grating_opt.py``) against the JAX package's, on the CPU.

Fixtures: ``test_opt.py``'s (paper design, 3 x 2 FoV, 8 rays per FoV,
seed 5, wavefronts of 1,024 slots, 32 fixed steps) and
``test_diff_design.py``'s (4 x 3 FoV, LUT seed 77, geometry simplified at
1e-3, 8 rays, threshold 1e-9, 2,048 slots, 40 steps), seeded from numpy.

Tolerances: the analytic tables within rtol 2e-5 / atol 2e-6 of the JAX
ones and of the numpy-packed tables (the JAX test's bar); losses within
2e-5 relative; apodization gradients within rtol 1e-3 / atol 2e-6 (the two
trees round ``1 / sqrt`` and their sums differently); grating gradients
within 3 % (the packages' trigonometric functions round the analytic tables
a few ulps apart, and bilinear deposits move with the hop vectors), and the
JAX test's finite-difference check (h = 1e-4, rel 0.3); an Adam trajectory
within 1e-4 relative of optax's.
"""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    TraceConfig as JTraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    diff as jdiff,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
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
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.opt import (
    grating_opt as jopt,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    diff,
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    seeding,
    splitting,
    trace_vector as tv,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
    make_synthetic_luts,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
    build_cell_tables,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt import (
    grating_opt as opt,
)

APOD = dict(capacity=1024, fixed_steps=32, pupil_bins=6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _both(M, N, cfg_kw, lut_seed=None, simplify=0.0):
    """(port, JAX) tuples of (geometry, tables, trace geometry, config,
    launch rays) of one fixture."""
    out = []
    for gen, luts, tables, tgeom, cfg_t in (
            (generate_geometry, make_synthetic_luts, build_cell_tables,
             build_trace_geometry, TraceConfig),
            (jgenerate_geometry, jmake_synthetic_luts, jbuild_cell_tables,
             jbuild_trace_geometry, JTraceConfig)):
        geom = gen(num_fov_x=M, num_fov_y=N)
        lk = {} if lut_seed is None else {"seed": lut_seed}
        out.append((geom, tables(geom, luts(geom, **lk)),
                    tgeom(geom, simplify_tol=simplify), cfg_t(**cfg_kw)))
    (pg, pt, ptg, pc), (jg, jt, jtg, jc) = out
    b = seeding.build_ray_batch(pg, pc)
    prays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                              b["idx"], b["rng"], device="cpu")
    jrays = trace_jnp.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                     b["cid"], b["idx"], b["rng"])
    return (pg, pt, ptg, pc, prays), (jg, jt, jtg, jc, jrays)


@pytest.fixture(scope="module")
def apod():
    """``test_opt.py``'s fixture in both packages."""
    return _both(3, 2, dict(num_fov_x=3, num_fov_y=2, rays_per_fov=8,
                            max_bounces=64, rng_mode="fast", seed=5))


@pytest.fixture(scope="module")
def grating():
    """``test_diff_design.py``'s fixture in both packages."""
    return _both(4, 3, dict(num_fov_x=4, num_fov_y=3, rays_per_fov=8,
                            max_bounces=200, seed=5, rng_mode="fast",
                            ic_test="circle"), lut_seed=77, simplify=1e-3)


def test_analytic_tables_match_jax_and_host(grating):
    (pg, pt, ptg, _, _), (jg, _, _, _, _) = grating
    d = pg.design
    got = diff.analytic_cell_tables(diff.design_params(d, device="cpu"), d,
                                    4, 3, ptg.num_fc, ptg.num_oc)
    want_j = jdiff.analytic_cell_tables(jdiff.design_params(jg.design),
                                        jg.design, 4, 3, ptg.num_fc,
                                        ptg.num_oc)
    host = tv.as_tables(pt)
    assert set(got) == set(want_j)
    for key, v in got.items():
        assert v.dtype == torch.float32, key
        for want in (np.asarray(want_j[key]), host[key].numpy()):
            assert tuple(v.shape) == want.shape, key
            np.testing.assert_allclose(v.numpy(), want, rtol=2e-5, atol=2e-6,
                                       err_msg=key)


def test_apodization_identity_and_scaling(apod):
    (_, pt, ptg, _, _), _ = apod
    T = tv.as_tables(pt)
    T1 = opt.apply_apodization(T, torch.ones(ptg.num_fc),
                               torch.ones(ptg.num_oc))
    assert torch.equal(T1["fc_jones"], T["fc_jones"])
    assert torch.equal(T1["oc_jones"], T["oc_jones"])
    T2 = opt.apply_apodization(T, torch.full((ptg.num_fc,), 0.5),
                               torch.full((ptg.num_oc,), 0.5))
    assert torch.equal(T2["fc_jones"][0], T["fc_jones"][0])
    assert torch.equal(T2["fc_jones"][1], 0.5 * T["fc_jones"][1])
    assert torch.equal(T2["oc_jones"][0], T["oc_jones"][0])
    assert torch.equal(T2["oc_jones"][1:], 0.5 * T["oc_jones"][1:])


def test_fixed_steps_trace_equals_while_trace(apod):
    """The differentiable configuration (a fixed step count, the tables as
    an argument, grad mode on and tables that require grad) reproduces the
    stop-tested trace bit for bit; the graph reaches the tables."""
    (_, pt, ptg, pc, rays), _ = apod
    kw = dict(capacity=2048, weight_threshold=1e-4, device="cpu")
    h0, out0, _, _, steps0 = splitting.make_splitting_trace_fn(
        pt, ptg, pc, **kw)(rays)
    assert not h0.requires_grad
    T = {k: (v.requires_grad_() if v.is_floating_point() else v)
         for k, v in tv.as_tables(pt).items() if torch.is_tensor(v)}
    h1, *_ = splitting.make_splitting_trace_fn(
        pt, ptg, pc, table_arg=True, fixed_steps=steps0 + 8, **kw)(rays, T)
    assert h1.requires_grad
    assert torch.equal(h0, h1.detach())
    h1.sum().backward()
    assert float(T["oc_jones"].grad.abs().sum()) > 0


@pytest.fixture(scope="module")
def jax_apod_vg(apod):
    """The JAX apodization loss's jitted ``value_and_grad``."""
    _, (jg, jt, jtg, jc, jrays) = apod
    loss, _ = jopt.make_apodization_loss(jt, jtg, jc, jrays, **APOD)
    return jax.jit(jax.value_and_grad(loss, has_aux=True))


def test_apodization_loss_and_grads_match_jax(apod, jax_apod_vg):
    """The pupil-integrated apodization loss (``pupil_bins=6``), its aux and
    its gradients at theta = 2 against ``jax.value_and_grad``."""
    (_, pt, ptg, pc, rays), _ = apod
    theta0 = {"fc": np.full(ptg.num_fc, 2.0, np.float32),
              "oc": np.full(ptg.num_oc, 2.0, np.float32)}
    (jv, jaux), jg = jax_apod_vg({k: jnp.asarray(v)
                                  for k, v in theta0.items()})
    loss, _ = opt.make_apodization_loss(pt, ptg, pc, rays, **APOD)
    theta = {k: torch.tensor(v, requires_grad=True)
             for k, v in theta0.items()}
    v, aux = opt.value_and_grad(loss, theta)
    assert v == pytest.approx(float(jv), rel=2e-5)
    for a, b in zip(aux, jaux):
        assert a == pytest.approx(float(b), rel=2e-5)
    for k in theta:
        g = theta[k].grad.numpy()
        assert np.isfinite(g).all() and np.abs(g).max() > 0, k
        np.testing.assert_allclose(g, np.asarray(jg[k]), rtol=1e-3,
                                   atol=2e-6, err_msg=k)


def test_three_adam_steps_match_optax(apod, jax_apod_vg):
    """``optimize_apodization`` (torch Adam) against optax ``adam`` on the
    JAX loss, three steps from the same start: loss history and final
    amplitudes."""
    (pg, pt, ptg, pc, _), _ = apod
    theta = {"fc": jnp.full((ptg.num_fc,), 2.0, jnp.float32),
             "oc": jnp.full((ptg.num_oc,), 2.0, jnp.float32)}
    adam = optax.adam(0.15)
    state = adam.init(theta)
    hist = []
    for _ in range(3):
        (v, _), g = jax_apod_vg(theta)
        hist.append(float(v))
        upd, state = adam.update(g, state)
        theta = optax.apply_updates(theta, upd)
    (v, _), _ = jax_apod_vg(theta)
    hist.append(float(v))
    res = opt.optimize_apodization(pg, pt, ptg, pc, rays_per_fov=8, steps=3,
                                   device="cpu", **APOD)
    np.testing.assert_allclose(res.loss_history, hist, rtol=1e-4)
    np.testing.assert_allclose(res.s_fc, np.asarray(jax.nn.sigmoid(
        theta["fc"])), rtol=1e-4)
    np.testing.assert_allclose(res.s_oc, np.asarray(jax.nn.sigmoid(
        theta["oc"])), rtol=1e-4)
    assert res.loss_history[-1] < res.loss_history[0]


def test_grating_grads_match_jax_and_finite_differences(grating):
    """``test_diff_design.py``'s check: autograd through the analytic tables
    and the soft-binned trace against ``jax.value_and_grad`` and against
    central finite differences of the port's own loss."""
    (pg, pt, ptg, pc, rays), (jg, jt, jtg, jc, jrays) = grating
    kw = dict(opt_params=("lambda_ic", "phi_ic"), capacity=2048,
              fixed_steps=40, weight_threshold=1e-9)
    jloss, _ = jopt.make_grating_loss(jt, jtg, jc, jrays, jg.design, **kw)
    (jv, _), jgr = jax.value_and_grad(jloss, has_aux=True)(
        {"lambda_ic": jnp.zeros(()), "phi_ic": jnp.zeros(())})
    loss, _ = opt.make_grating_loss(pt, ptg, pc, rays, pg.design, **kw)
    theta = {k: torch.zeros((), requires_grad=True)
             for k in ("lambda_ic", "phi_ic")}
    v, _ = opt.value_and_grad(loss, theta)
    assert v == pytest.approx(float(jv), rel=2e-5)
    for k in theta:
        g = float(theta[k].grad)
        assert np.isfinite(g), k
        assert g == pytest.approx(float(jgr[k]), rel=0.03), k
    ad = float(theta["lambda_ic"].grad)
    assert abs(ad) > 1.0
    h = 1e-4
    with torch.no_grad():
        f = [float(loss({"lambda_ic": torch.tensor(s * h),
                         "phi_ic": torch.tensor(0.0)})[0]) for s in (1, -1)]
    assert ad == pytest.approx((f[0] - f[1]) / (2 * h), rel=0.3)


def test_tied_knobs_trust_region_and_joint_mode(apod):
    """``lambda_tied`` / ``phi_tied`` move both couplers as one, inside the
    tanh trust region, jointly with the apodization knobs; the parameter
    map itself at a saturated knob."""
    (pg, pt, ptg, pc, _), _ = apod
    d = pg.design
    res = opt.optimize_grating(pg, pt, ptg, pc,
                               opt_params=("lambda_tied", "phi_tied"),
                               rays_per_fov=4, steps=2, learning_rate=0.02,
                               capacity=1024, fixed_steps=32, apodize=True,
                               device="cpu")
    assert set(res.params) == {"lambda_ic", "lambda_oc", "phi_ic", "phi_oc"}
    assert (res.params["lambda_ic"] / d.lambda_ic
            == pytest.approx(res.params["lambda_oc"] / d.lambda_oc,
                             abs=1e-12))
    assert (res.params["phi_ic"] - d.phi_ic
            == pytest.approx(res.params["phi_oc"] - d.phi_oc, abs=1e-12))
    assert res.params["lambda_ic"] != d.lambda_ic
    assert 0.94 * d.lambda_ic < res.params["lambda_ic"] < 1.06 * d.lambda_ic
    assert len(res.s_fc) == ptg.num_fc and len(res.s_oc) == ptg.num_oc
    assert np.abs(res.s_fc - 0.8808).max() > 1e-5
    assert np.isfinite(res.loss_history).all() and len(res.loss_history) == 3
    base = diff.design_params(d, device="cpu")
    p = opt._moved_params(base, {"lambda_tied": torch.tensor(50.0),
                                 "phi_ic": torch.tensor(-50.0)},
                          ("lambda_tied", "phi_ic"), 0.05)
    assert float(p["lambda_ic"]) == pytest.approx(d.lambda_ic * np.exp(0.05),
                                                  rel=1e-6)
    assert float(p["lambda_oc"]) == pytest.approx(d.lambda_oc * np.exp(0.05),
                                                  rel=1e-6)
    assert float(p["phi_ic"]) == pytest.approx(d.phi_ic - 0.05, abs=1e-6)
    assert p["phi_oc"] is base["phi_oc"]


def test_pupil_for_refuses_a_single_eye_position():
    assert opt._pupil_for(0, 12, 16, "cpu") is None
    assert tuple(opt._pupil_for(6, 12, 16, "cpu").shape) == (6, 6)
    with pytest.raises(ValueError, match="valid eye positions"):
        opt._pupil_for(30, 12, 12, "cpu")


@pytest.mark.parametrize("params", ["apodization", "lambda_ic,phi_ic"])
def test_cli_optimize_on_cpu(tmp_path, capsys, params):
    out = tmp_path / "o.json"
    assert cli.main(["optimize", "--device", "cpu", "--fov-x", "2",
                     "--fov-y", "2", "--rays-per-fov", "4", "--steps", "1",
                     "--capacity", "512", "--trace-steps", "8", "--params",
                     params, "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "1 Adam steps in" in text and f"wrote {out}" in text
    data = json.loads(out.read_text())
    assert len(data["loss_history"]) == 2
    assert np.isfinite(data["loss_history"]).all()
    if params == "apodization":
        assert "s_fc:" in text and len(data["s_oc"]) > 0
    else:
        assert set(data["params"]) == {"lambda_ic", "phi_ic"}
