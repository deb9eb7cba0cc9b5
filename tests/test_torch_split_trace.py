"""PyTorch port: the global splitting engine's plain forward
(``splitting.split_trace_reference``) with its tape, and the hand-written
plain backward (``splitting.split_trace_backward_reference``) that the
kernels of ``csrc/split_trace.cu`` are held to on the card, on the CPU.

Fixtures: ``test_torch_opt.py``'s apodization fixture (paper design, 3 x 2
FoV x 3 wavelengths, 8 rays per FoV, seed 5, 1,024 slots, 32 fixed steps,
threshold 1e-4; its wavefront truncates) and its grating fixture with soft
binning (4 x 3 FoV, LUT seed 77, geometry simplified at 1e-3, 8 rays,
threshold 1e-9, 2,048 slots, 40 steps).  Histogram adjoints are seeded
from numpy.  One plain ``jax.jit`` (the JAX engine's forward and its
``jax.value_and_grad`` in one function); torch on one thread.

Bars: the JAX engine's histogram within ``test_torch_splitting.py``'s
(rtol 2e-4, atol 1e-10; ``out_coupled`` 1e-5, ``pruned`` 1e-4, steps
equal); the hand-written backward against ``torch.autograd`` through the
plain forward within rtol 1e-4 / atol 1e-6 x ``max|grad|`` (the same chain
rule rounded in another order); the table gradients carried back to the
``as_tables`` dict against ``jax.value_and_grad`` within
``test_torch_opt.py``'s apodization bar (rtol 1e-3 / atol 2e-6).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    TraceConfig as JTraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
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

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    seeding,
    splitting,
    trace_persistent as tp,
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

APOD = dict(capacity=1024, fixed_steps=32, weight_threshold=1e-4)
GRATING = dict(capacity=2048, fixed_steps=40, weight_threshold=1e-9,
               soft_binning=True)
# the tables pack_tables reads, the differentiable inputs of a trace
TABLES = tuple(splitting._TABLE_CELL_AXIS)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _fixture(M, N, cfg_kw, kw, lut_seed=None, simplify=0.0):
    """The port's (tables, trace geometry, config, launch rays, trace
    function) of one fixture."""
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    lk = {} if lut_seed is None else {"seed": lut_seed}
    tables = build_cell_tables(geom, make_synthetic_luts(geom, **lk))
    tgeom = build_trace_geometry(geom, simplify_tol=simplify)
    cfg = TraceConfig(**cfg_kw)
    b = seeding.build_ray_batch(geom, cfg)
    rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                             b["idx"], b["rng"], device="cpu")
    trace = splitting.make_splitting_trace_fn(tables, tgeom, cfg,
                                              table_arg=True, device="cpu",
                                              **kw)
    return tables, tgeom, cfg, rays, trace


@pytest.fixture(scope="module")
def apod():
    return _fixture(3, 2, dict(num_fov_x=3, num_fov_y=2, rays_per_fov=8,
                               max_bounces=64, rng_mode="fast", seed=5), APOD)


@pytest.fixture(scope="module")
def grating():
    return _fixture(4, 3, dict(num_fov_x=4, num_fov_y=3, rays_per_fov=8,
                               max_bounces=200, seed=5, rng_mode="fast",
                               ic_test="circle"), GRATING, lut_seed=77,
                    simplify=1e-3)


@pytest.fixture(scope="module")
def apod_run(apod):
    """The apodization fixture's arguments and its plain forward, with and
    without a tape."""
    tables, _, _, rays, trace = apod
    a = trace.args(rays, tv.as_tables(tables))
    return (a, splitting.split_trace_reference(a),
            splitting.split_trace_reference(a, keep_tape=True))


def _adjoint(a, seed=0):
    rng = np.random.default_rng(seed)
    return torch.from_numpy(rng.standard_normal(a.hist_size).astype(
        np.float32))


@pytest.fixture(scope="module")
def jax_apod(apod):
    """The JAX global engine at the apodization fixture: its histogram and
    the gradient of ``sum(hist * g)`` in the tables, one jitted call."""
    tables, tgeom, cfg, _, trace = apod
    jg = jgenerate_geometry(num_fov_x=3, num_fov_y=2)
    jt = jbuild_cell_tables(jg, jmake_synthetic_luts(jg))
    jc = JTraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=8,
                      max_bounces=64, rng_mode="fast", seed=5)
    b = seeding.build_ray_batch(generate_geometry(num_fov_x=3, num_fov_y=2),
                                cfg)
    jrays = trace_jnp.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                     b["cid"], b["idx"], b["rng"])
    jtrace = jsplit.make_splitting_trace_fn(
        jt, jbuild_trace_geometry(jg), jc, table_arg=True, **APOD)
    T0 = trace_jnp._as_jnp(jt)
    g = jnp.asarray(_adjoint(trace.args(apod[3], tv.as_tables(tables))
                             ).numpy())

    def f(Tf):
        hist, out_w, trunc, pruned, steps = jtrace(jrays, {**T0, **Tf})
        return jnp.sum(hist * g), (hist, out_w, pruned, steps)

    (_, aux), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(
        {k: T0[k] for k in TABLES})
    return ({k: np.asarray(v) for k, v in zip(
        ("hist", "out_w", "pruned", "steps"), aux)},
            {k: np.asarray(v) for k, v in grads.items()})


def test_tape_changes_nothing_and_forward_matches_jax(apod_run, jax_apod):
    """(a) The plain forward with and without a tape gives the same
    histogram and ledgers bit for bit, and equals the JAX global engine
    within ``test_torch_splitting.py``'s bars."""
    a, out, taped = apod_run
    assert out.tape is None and taped.tape is not None
    assert torch.equal(out.hist, taped.hist)
    assert float(out.trunc) == float(taped.trunc) > 0
    assert float(out.pruned) == float(taped.pruned)
    assert out.steps == taped.steps == APOD["fixed_steps"]
    want, _ = jax_apod
    np.testing.assert_allclose(out.hist.numpy(), want["hist"], rtol=2e-4,
                               atol=1e-10)
    assert float(out.hist.sum()) == pytest.approx(float(want["out_w"]),
                                                  rel=1e-5)
    assert float(out.pruned) == pytest.approx(float(want["pruned"]),
                                              rel=1e-4)
    assert out.steps == int(want["steps"])


def test_tape_provenance_rebuilds_each_wavefront(apod_run):
    """(b) Each tape row is its step's children gathered by the next row's
    provenance, bit for bit: row 0 from the launch rays' children, row
    t + 1 from step t's children of row t."""
    a, _, taped = apod_run
    tape = taped.tape
    G, S, (split_init, split_step, _), T = splitting._trace_setup(a)
    widths = tape.widths.tolist()
    assert len(widths) == a.fixed_steps + 1 and max(widths) == a.capacity
    r0 = {k: a.rays[i] for i, k in enumerate(("x", "y", "ter", "tei", "tmr",
                                              "tmi"))}
    r0["cid"] = a.cid.long()
    w0 = r0["ter"].abs() + r0["tei"].abs() + r0["tmr"].abs() + r0["tmi"].abs()
    r0["w"] = torch.where(w0 > 0, 1.0, 0.0)
    kids, _ = split_init(T, S, G, r0["cid"], r0)
    for t in range(len(widths)):
        if t > 0:
            buf = splitting.tape_buffer(tape.fields[t - 1], widths[t - 1])
            ch_a, ch_b, _, _ = split_step(T, S, G, buf["cid"], buf)
            kids = (ch_a, ch_b)
        children = {k: torch.cat([kids[0][k], kids[1][k]])
                    for k in splitting._KEYS}
        got = splitting.tape_buffer(tape.fields[t], widths[t])
        for k in splitting._KEYS:
            v = children[k][got["src"]]
            assert torch.equal(v.to(got[k].dtype), got[k]), (t, k)
        assert (got["state"] < tv.DEAD).all()


@pytest.mark.parametrize("case", ["hard", "soft", "truncating"])
def test_backward_matches_autograd(apod, grating, case):
    """(c) The hand-written backward against ``torch.autograd.grad``
    through the plain forward, of a seeded linear functional of the
    histogram: ``d_rec``, ``d_cell`` and ``d_dirs`` (the deposit
    rectangle's rows too), in hard and soft binning and in a wavefront cut
    to 128 slots (e)."""
    tables, _, _, rays, trace = grating if case == "soft" else apod
    a = trace.args(rays, tv.as_tables(tables))
    if case == "truncating":
        a = dataclasses.replace(a, capacity=128)
    out = splitting.split_trace_reference(a, keep_tape=True)
    g = _adjoint(a, seed=3)
    got = splitting.split_trace_backward_reference(a, out.tape, g)
    ins = [t.clone().requires_grad_() for t in (a.rec, a.cell, a.dirs)]
    ref = splitting.split_trace_reference(
        dataclasses.replace(a, rec=ins[0], cell=ins[1], dirs=ins[2]))
    assert torch.equal(ref.hist.detach(), out.hist)
    if case == "truncating":
        assert float(out.trunc) > 0
    want = torch.autograd.grad((ref.hist * g).sum(), ins)
    for name, x, y in zip(("rec", "cell", "dirs"), got, want):
        assert x.shape == y.shape, name
        m = float(y.abs().max())
        assert m > 0, name
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-4,
                                   atol=1e-6 * m, err_msg=name)


def test_table_gradients_match_jax(apod, jax_apod):
    """(d) The gradient of ``sum(hist * g)`` carried back through
    ``pack_tables`` to the ``as_tables`` dict (the Function's route, on
    the CPU the hand-written backward) against the JAX engine's
    ``jax.value_and_grad``."""
    tables, _, _, rays, trace = apod
    T = tv.as_tables(tables)
    for k in TABLES:
        T[k] = T[k].clone().requires_grad_()
    hist, *_ = trace(rays, T)
    (hist * _adjoint(trace.args(rays, tv.as_tables(tables)))).sum().backward()
    _, want = jax_apod
    for k in TABLES:
        g = T[k].grad
        assert g is not None and g.shape == want[k].shape, k
        np.testing.assert_allclose(g.numpy(), want[k], rtol=1e-3, atol=2e-6,
                                   err_msg=k)
    assert float(T["oc_jones"].grad.abs().max()) > 0


def test_ledgers_carry_no_gradient_and_cpu_routing(apod):
    """(e) Through ``SplitTraceFunction`` at a capacity that truncates the
    histogram is differentiable and the truncated and pruned ledgers and
    the step count are not; on the CPU no kernel is launched, and the
    launchers refuse CPU tensors."""
    tables, _, _, rays, trace = apod
    a = trace.args(rays, tv.as_tables(tables))
    a = dataclasses.replace(a, capacity=128)
    ins = [t.clone().requires_grad_() for t in (a.rec, a.cell, a.dirs)]
    n0 = dict(tp.launch_counts)
    hist, trunc, pruned, steps = splitting.SplitTraceFunction.apply(*ins, a)
    assert hist.requires_grad
    assert float(trunc) > 0
    assert not (trunc.requires_grad or pruned.requires_grad
                or steps.requires_grad)
    assert int(steps) == APOD["fixed_steps"]
    hist.sum().backward()
    assert all(t.grad is not None for t in ins)
    assert float(ins[0].grad.abs().max()) > 0
    assert tp.launch_counts == n0
    with pytest.raises(ValueError, match="runs on cuda"):
        splitting.launch_split_trace(a)
    out = splitting.split_trace_reference(a, keep_tape=True)
    with pytest.raises(ValueError, match="runs on cuda"):
        splitting.launch_split_trace_backward(a, out.tape, hist.detach())
