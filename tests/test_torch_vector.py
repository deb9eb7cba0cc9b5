"""PyTorch port: the vector Monte-Carlo tracer (``engine/trace_vector.py``)
against the JAX package's ``engine/trace_jnp.py`` and its numpy oracle.

Fixture: the paper design at 3 x 2 FoV x 3 wavelengths = 18 cells, 256 rays
per cell, ``rng_mode="fast"``, seed 2, a 400-bounce bound (the JAX
splitting tests' fixture); every input is made by numpy on the host and
both tracers run on the CPU.  The JAX trace compiles once for the module.

Bars: per-ray agreement of deposits and states >= 99.5 % and bounce totals
within 2 % (P2: the bar of ``tests/test_pallas.py`` and
``tests/test_trace_parity.py``); the two round ``1 / sqrt`` differently, so
a draw that lands within rounding of a branch threshold may flip.
"""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU here)

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    seeding,
    trace_jnp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.oracle import (
    OracleTracer,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.ops import rng as jrng

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    trace_vector as tv,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.ops import rng

M, N = 3, 2
RPC = 256


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
    luts = make_synthetic_luts(geom)
    tables = build_cell_tables(geom, luts)
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=RPC,
                      max_bounces=400, rng_mode="fast", seed=2)
    batch = seeding.build_ray_batch(geom, cfg)
    return geom, luts, tables, tgeom, cfg, batch


def _port_state(batch, **kw):
    return tv.make_ray_state(batch["x"], batch["y"], batch["te"], batch["tm"],
                             batch["cid"], batch["idx"], batch["rng"],
                             device="cpu", **kw)


@pytest.fixture(scope="module")
def traces(setup):
    """(JAX final state, JAX bounces, port final state, port bounces,
    port stats) of the whole fixture batch."""
    _, _, tables, tgeom, cfg, batch = setup
    rays = trace_jnp.make_ray_state(batch["x"], batch["y"], batch["te"],
                                    batch["tm"], batch["cid"], batch["idx"],
                                    batch["rng"])
    rj, bj = trace_jnp.make_trace_fn(tables, tgeom, cfg)(rays)
    stats = {}
    rp, bp = tv.make_trace_fn(tables, tgeom, cfg, device="cpu")(
        _port_state(batch), stats=stats)
    return ({k: np.asarray(v) for k, v in rj.items()}, int(bj),
            {k: v.numpy() for k, v in rp.items()}, int(bp), stats)


def test_as_tables_equal_as_jnp(setup):
    """``as_tables`` gives the arrays of the JAX ``_as_jnp`` bit for bit;
    ``geom_tensors`` those of ``_geom_jnp``."""
    _, _, tables, tgeom, _, _ = setup
    want = trace_jnp._as_jnp(tables)
    got = tv.as_tables(tables)
    assert want.keys() == got.keys()
    for k, v in want.items():
        if isinstance(v, (int, np.integer)):
            assert got[k] == v, k
            continue
        w = np.asarray(v)
        assert got[k].numpy().dtype == w.dtype, k
        np.testing.assert_array_equal(got[k].numpy(), w, err_msg=k)
    gw = trace_jnp._geom_jnp(tgeom)
    gg = tv.geom_tensors(tgeom)
    assert gw.keys() == gg.keys()
    for k, v in gw.items():
        np.testing.assert_array_equal(gg[k].numpy(), np.asarray(v), err_msg=k)


def test_trace_matches_jax_trace_jnp(traces):
    """Per ray: deposit codes and final states agree for >= 99.5 % of the
    rays, RNG streams too; bounce totals within 2 %, deposit totals within
    2 %.  Measured on this fixture: every deposit, state and stream equal,
    the bounce totals equal (29,507 each)."""
    rj, bj, rp, bp, stats = traces
    assert rp["dep"].shape == rj["dep"].shape == (3 * M * N * RPC,)
    assert (rp["dep"] == rj["dep"]).mean() >= 0.995
    assert (rp["state"] == rj["state"]).mean() >= 0.995
    assert (rp["rng"] == rj["rng"].astype(np.int64)).mean() >= 0.995
    assert abs(bp - bj) <= 0.02 * bj
    dj, dp = (rj["dep"] >= 0).sum(), (rp["dep"] >= 0).sum()
    assert dj > 0 and abs(int(dp) - int(dj)) <= max(3, 0.02 * dj)
    # two reads from the device per step (the stop test and the positions
    # the containment grids leave open), plus the one that ends the loop
    assert stats["syncs"] == 2 * stats["steps"] + 1


def test_f64_trace_matches_oracle(setup):
    """At float64, against the JAX package's scalar numpy oracle (parity
    seeding, polygon in-coupler test, 18 cells x 24 rays): per-ray deposit
    agreement >= 99.5 %, bounces within 2 %."""
    geom, luts, tables, tgeom, _, _ = setup
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=24,
                      max_bounces=500, rng_mode="parity", ic_test="polygon")
    batch = seeding.build_ray_batch(geom, cfg)
    rays_f, bounces = tv.make_trace_fn(tables, tgeom, cfg, precision="f64",
                                       device="cpu")(
        _port_state(batch, precision="f64"))
    assert rays_f["x"].dtype == torch.float64
    oracle = OracleTracer(geom, luts, max_bounces=500)
    cid = batch["cid"]
    o_rays = dict(x=batch["x"], y=batch["y"], m=(cid % (M * N)) // N,
                  n=cid % N, lmd=cid // (M * N),
                  te=np.abs(batch["te"]).astype(float),
                  tm=np.abs(batch["tm"]).astype(float),
                  delta=np.zeros(len(cid)))
    oracle.trace(o_rays, batch["rng"].astype(np.int64).copy())
    dep = rays_f["dep"].numpy()
    assert (dep == oracle.outcomes).mean() >= 0.995
    assert (dep >= 0).sum() > 0
    assert abs(int(bounces) - oracle.total_bounces) <= 0.02 * oracle.total_bounces


def test_full_then_resume_equals_one_full_trace(setup, traces):
    """A full-mode trace of 5 bounces, then a resume-mode trace of the
    rest, equals one full trace of the whole budget in every field, bit for
    bit; the bounce counts add up."""
    _, _, tables, tgeom, cfg, batch = setup
    _, _, rp, bp, _ = traces
    T = {k: v for k, v in tv.pack_tables(tv.as_tables(tables),
                                         tv.geom_tensors(tgeom)).items()}
    G = tv.add_region_grids(tv.stack_geoms([tv.geom_tensors(tgeom)]))
    full = tv.make_trace_fn_dynamic(cfg, tgeom.num_fc, tgeom.num_oc)
    resume = tv.make_trace_fn_dynamic(cfg, tgeom.num_fc, tgeom.num_oc,
                                      mode="resume")
    r1, b1 = full(_port_state(batch), T, G, max_bounces=5)
    assert (r1["state"] < tv.DEAD).any()
    r2, b2 = resume(r1, T, G, max_bounces=cfg.max_bounces - 5)
    for k, v in rp.items():
        np.testing.assert_array_equal(r2[k].numpy(), v, err_msg=k)
    assert int(b1) + int(b2) == bp


def test_compacted_equals_monolithic():
    """``Simulator(engine="vector")``: ``trace_batch_compacted`` (segments
    of 8 and of 3 bounces, survivors gathered between them) equals
    ``trace_batch`` bit for bit, histogram and bounces; so does ``run()``
    with ``segmented=True`` against ``segmented=False``."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig as PTraceConfig,
    )

    cfg = PTraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                       max_bounces=300, seed=4)
    sim = pipeline.Simulator(cfg=cfg, device="cpu", engine="vector")
    cells = np.array([0, 3, 4, 9, 17])
    h, b, n = sim.trace_batch(cells, 128, 1)
    assert n == 5 * 128 and float(h.sum()) > 0
    for seg in (8, 3):
        sim.stats = {}
        hc, bc, _ = sim.trace_batch_compacted(cells, 128, 1,
                                              segment_bounces=seg)
        assert torch.equal(hc, h) and int(bc) == int(b), seg
        assert sim.stats["segments"] >= 2
    seg_sim = pipeline.Simulator(cfg=cfg, device="cpu", engine="vector",
                                 segmented=True, segment_bounces=4)
    ra = sim.run(num_iter=1, evaluate_metrics=False)
    rb = seg_sim.run(num_iter=1, evaluate_metrics=False)
    np.testing.assert_array_equal(ra.histogram, rb.histogram)
    assert ra.total_bounces == rb.total_bounces
    assert ra.deposits == rb.deposits == int(ra.histogram.sum())
    assert rb.timings["segments"] > ra.timings.get("segments", 0)


@pytest.mark.parametrize("cells", ["all", "scattered"])
def test_histogram_layout_equals_jax(cells):
    """``deposits_to_histogram`` gives the JAX function's (L, N, M, ny, nx)
    histogram for random deposit codes (some -1) and cell ids."""
    rs = np.random.default_rng(5)
    L, Mx, Ny, ny, nx = 3, 4, 3, 80, 120
    n = 4000
    cid = (np.arange(n) % (L * Mx * Ny) if cells == "all"
           else rs.choice([1, 7, 20, 35], n)).astype(np.int32)
    dep = rs.integers(-1, ny * nx, n).astype(np.int32)
    want = np.asarray(trace_jnp.deposits_to_histogram(
        jax.numpy.asarray(dep), jax.numpy.asarray(cid), L, Mx, Ny, ny, nx))
    got = tv.deposits_to_histogram(torch.from_numpy(dep),
                                   torch.from_numpy(cid).long(), L, Mx, Ny,
                                   ny, nx)
    assert got.shape == (L, Ny, Mx, ny, nx)
    np.testing.assert_array_equal(got.numpy(), want)


def test_half_plane_test_is_the_float32_formula(setup):
    """The exact containment test is numpy's float32 ``x * a + y * b - c <=
    1e-6`` over every edge, on points scattered over the design and on
    points within a few float32 ulps of the edges; passes smaller than the
    batch change nothing."""
    _, _, _, tgeom, _, _ = setup
    G = tv.stack_geoms([tv.geom_tensors(tgeom)])
    hp = G["r1_hp"]
    rs = np.random.default_rng(8)
    e = np.asarray(tgeom.r1_hp)
    k = rs.integers(0, len(e), 5000)
    t = rs.uniform(-5, 5, 5000)
    px = np.concatenate([rs.uniform(-30, 30, 20000),
                         e[k, 0] * e[k, 2] - e[k, 1] * t])
    py = np.concatenate([rs.uniform(-30, 30, 20000),
                         e[k, 1] * e[k, 2] + e[k, 0] * t])
    x = torch.tensor(px, dtype=torch.float32)[None]
    y = torch.tensor(py, dtype=torch.float32)[None]
    x = torch.cat([x, torch.nextafter(x, x + 1)], 1)
    y = torch.cat([y, y], 1)
    a32, b32, c32 = (hp[0, :, i].numpy() for i in range(3))
    xs, ys = x[0].numpy()[:, None], y[0].numpy()[:, None]
    want = ((xs * a32 + ys * b32 - c32) <= np.float32(1e-6)).all(axis=1)
    got = tv._hp_inside(hp, x, y)
    assert want.any() and (~want).any()
    np.testing.assert_array_equal(got[0].numpy(), want)
    keep = tv._HP_PAIRS
    try:
        tv._HP_PAIRS = 1000
        assert torch.equal(tv._hp_inside(hp, x, y), got)
    finally:
        tv._HP_PAIRS = keep


def test_draw_uniform_matches_jax():
    """``draw_uniform`` against the JAX ``ops/rng.draw_uniform``: zero
    states reseed from the ray index, the state advances only where asked,
    the draws are equal."""
    rs = np.random.default_rng(11)
    state = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    state[::7] = 0
    idx = rs.integers(0, 2**32, 4096, dtype=np.uint64).astype(np.uint32)
    idx[:3] = [0, 2**32 - 1, 2**31]
    state[:3] = 0
    adv = rs.random(4096) < 0.6
    uj, sj = jrng.draw_uniform(jax.numpy.asarray(state), jax.numpy.asarray(idx),
                               jax.numpy.asarray(adv))
    up, sp = rng.draw_uniform(torch.from_numpy(state.astype(np.int64)),
                              torch.from_numpy(idx.astype(np.int64)),
                              torch.from_numpy(adv))
    np.testing.assert_array_equal(up.numpy(), np.asarray(uj))
    np.testing.assert_array_equal(sp.numpy(), np.asarray(sj).astype(np.int64))


def test_region_grids_give_the_exact_test(setup):
    """The containment grids (a table lookup where rounding cannot matter,
    the exact test elsewhere) give the exact test's booleans for r1, the
    hull and r2 of two designs: on points over and beyond the window, on
    points within a few float32 ulps of every edge and of every vertex; the
    lookup decides most uniform points by itself."""
    geom, _, _, tgeom, _, _ = setup
    import dataclasses as dc

    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
        WaveguideDesign,
    )

    other = build_trace_geometry(generate_geometry(
        dc.replace(WaveguideDesign(), lambda_ic=392.0, lambda_oc=392.0),
        num_fov_x=M, num_fov_y=N))
    G = tv.add_region_grids(tv.stack_geoms([tv.geom_tensors(tgeom),
                                            tv.geom_tensors(other)]))
    rs = np.random.default_rng(12)
    pts = []
    for d, tg in enumerate((tgeom, other)):
        lo = np.array([float(G["grid_x0"][d]), float(G["grid_y0"][d])])
        span = 256 / np.array([float(G["grid_inv_hx"][d]),
                               float(G["grid_inv_hy"][d])])
        u = lo - 0.1 * span + rs.random((30000, 2)) * 1.2 * span
        for hp in (tg.r1_hp, tg.hull_hp, tg.r2_hp):
            e = np.asarray(hp, np.float64)
            k = rs.integers(0, len(e), 3000)
            t = rs.uniform(-3, 3, 3000)
            n2 = e[k, 0] ** 2 + e[k, 1] ** 2
            on = np.stack([e[k, 0] * e[k, 2] / n2 - e[k, 1] * t,
                           e[k, 1] * e[k, 2] / n2 + e[k, 0] * t], 1)
            v = tv._vertices(torch.tensor(e)).numpy()
            near = v[rs.integers(0, len(v), 1000)] + rs.normal(0, 1e-5,
                                                               (1000, 2))
            u = np.concatenate([u, on, near])
        pts.append(u[:40000])
    x = torch.tensor(np.stack([p[:, 0] for p in pts]), dtype=torch.float32)
    y = torch.tensor(np.stack([p[:, 1] for p in pts]), dtype=torch.float32)
    x = torch.cat([x, torch.nextafter(x, x + 1), torch.nextafter(x, x - 1)], 1)
    y = torch.cat([y, y, torch.nextafter(y, y + 1)], 1)
    stats = {}
    got = tv.regions_inside(G, x, y, torch.ones_like(x, dtype=torch.bool),
                            stats)
    for key, g in zip(("r1_hp", "hull_hp", "r2_hp"), got):
        want = tv._hp_inside(G[key], x, y)
        assert want.any() and (~want).any()
        assert torch.equal(g, want), key
    assert stats["syncs"] == 1
    code = G["grid_code"].to(torch.int32)
    assert code.shape == (2, tv.GRID_N, tv.GRID_N)
    assert ((code & 3) == 2).float().mean() < 0.1
