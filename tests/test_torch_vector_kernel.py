"""PyTorch port: the vector engine's plain version, through the arguments
its CUDA kernel (``csrc/vector_trace.cu``) takes.

Fixture: the paper design at 3 x 2 FoV x 3 wavelengths = 18 cells, 64 rays
per cell, a 400-bounce bound, seed 3, and a second design (coupler periods
at 392 nm) whose trace geometry is simplified at 0.05, so that the two
designs' half-plane packs have different edge counts; inputs made by numpy
on the host, every trace on the CPU.  No JAX: the JAX bar stays with
``tests/test_torch_vector.py::test_trace_matches_jax_trace_jnp``, which
runs through the same plain version.

:func:`vector_trace_reference` is held bit for bit, in every field, to the
trace loop as it ran on the engine's own table and geometry dicts before
the kernel's arguments existed (:func:`_dict_trace` below: the same steps
over the unpacked dicts): in full mode, in resume mode after a 3-step
budget, and with two designs in one call, each also equal to its solo
trace.  The kernel itself runs only on a card (``tests/test_torch_cuda.py``).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
    WaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    seeding,
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

M, N = 3, 2
RPC = 64
GRID = 64


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _design(i: int, cfg: TraceConfig):
    """(tables, trace geometry, (R,) ray state) of fixture design ``i``."""
    d = WaveguideDesign() if i == 0 else dataclasses.replace(
        WaveguideDesign(), lambda_ic=392.0, lambda_oc=392.0)
    geom = generate_geometry(d, num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom, simplify_tol=0.05 if i else 0.0)
    b = seeding.build_ray_batch(geom, cfg)
    rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                             b["idx"], b["rng"], device="cpu")
    return tables, tgeom, rays


def _pack(designs, dtype=torch.float32):
    """(T, G) of several designs, as ``VectorTracer`` packs them, with
    64 x 64 region grids (the grid only decides where the exact test is
    run, so its size changes no result; 256 x 256 takes ~1.3 s a design
    here)."""
    Gs = [tv.geom_tensors(tg, dtype) for _, tg, _ in designs]
    T = tv.stack_tables([tv.pack_tables(tv.as_tables(t, dtype), G)
                         for (t, _, _), G in zip(designs, Gs)])
    return T, tv.add_region_grids(tv.stack_geoms(Gs), n=GRID)


@pytest.fixture(scope="module")
def designs():
    """The two designs and their packs: both, and each alone."""
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=RPC, seed=3)
    ds = [_design(i, cfg) for i in range(2)]
    return ds, {"both": _pack(ds), 0: _pack(ds[:1]), 1: _pack(ds[1:])}


@pytest.fixture(params=["polygon", "circle"])
def fixture(request, designs):
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=RPC,
                      max_bounces=400, seed=3, ic_test=request.param)
    return (cfg,) + designs


def _args(cfg, designs, rays, T, G, mode="full", budget=None):
    return tv.vector_trace_args(
        rays, T, G, mode=mode,
        max_bounces=cfg.max_bounces if budget is None else budget,
        num_fc=designs[0][1].num_fc, num_oc=designs[0][1].num_oc,
        eyebox_bins=cfg.eyebox_bins, circle=cfg.ic_test == "circle")


def _dict_trace(cfg, designs, rays, T, G, mode="full", budget=None):
    """The trace loop on the table and geometry dicts themselves (no
    packed geometry rows): ``(rays, bounces, steps)``."""
    r = dict(rays)
    D = r["x"].shape[0]
    num_fc, num_oc = designs[0][1].num_fc, designs[0][1].num_oc
    circle = cfg.ic_test == "circle"
    budget = cfg.max_bounces if budget is None else budget
    C = T["cell"].shape[1] // D
    g = r["cid"] + C * torch.arange(D)[:, None]
    S = tv._col(G, D, 2)
    if mode == "full":
        r = tv._init_step(r, T, S, g, G, circle)
    bounces = torch.zeros(D, dtype=torch.int64)
    it = 0
    while it < budget:
        n_alive = (r["state"] < tv.DEAD).sum(dim=1)
        if not bool(n_alive.any()):
            break
        bounces += n_alive
        r = tv._bounce_step(r, T, S, g, G, {}, num_fc, num_oc, circle)
        it += 1
    out = r["dep"] == tv._OUT
    ebr = tv._take(T["cell"][tv._C_EBR:tv._C_EBR + 4], g)
    in_quad, b = tv.deposit_bin(ebr, r["x"], r["y"], *cfg.eyebox_bins)
    r["dep"] = torch.where(out, torch.where(in_quad, b, -1),
                           r["dep"]).to(torch.int32)
    return r, bounces, it


def _assert_same(got: dict, want: dict):
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == v.dtype, k
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("mode", ["full", "resume_after_3"])
def test_reference_equals_the_dict_trace(fixture, mode):
    """One design: the plain version on the kernel's arguments equals the
    loop on the dicts bit for bit in every field, bounces and steps; in
    resume mode after a full-mode budget of 3 steps too (rays alive after
    the 3 steps, and resumed to the same end as one full trace)."""
    cfg, designs, packs = fixture
    T, G = packs[0]
    rays = tv.stack_ray_states([designs[0][2]])
    if mode == "full":
        out = tv.vector_trace_reference(_args(cfg, designs, rays, T, G))
        r, b, it = _dict_trace(cfg, designs, rays, T, G)
    else:
        first = tv.vector_trace_reference(
            _args(cfg, designs, rays, T, G, budget=3))
        r3, b3, it3 = _dict_trace(cfg, designs, rays, T, G, budget=3)
        _assert_same(first.rays, r3)
        assert torch.equal(first.bounces, b3) and int(first.steps) == it3 == 3
        assert (r3["state"] < tv.DEAD).any()
        out = tv.vector_trace_reference(
            _args(cfg, designs, first.rays, T, G, mode="resume"))
        r, b, it = _dict_trace(cfg, designs, r3, T, G, mode="resume")
        whole, bw, _ = _dict_trace(cfg, designs, rays, T, G)
        _assert_same(r, whole)
        assert torch.equal(b3 + b, bw)
    _assert_same(out.rays, r)
    assert torch.equal(out.bounces, b) and int(out.steps) == it > 0
    assert out.steps.dtype == torch.int32 and out.bounces.dtype == torch.int64
    assert (r["dep"] >= 0).sum() > 0 and (r["state"] == tv.DEAD).all()


def test_designs_equal_their_solo_traces(fixture):
    """Two designs with unequal edge counts in one call (the packs padded
    with always-true half-planes): each design's rows equal its solo trace
    (its own unpadded geometry) bit for bit, and each equals the dict loop
    of the stacked call."""
    cfg, designs, packs = fixture
    edges = [tuple(int(getattr(tg, k).shape[0]) for k in tv.GEOM_HP)
             for _, tg, _ in designs]
    assert edges[0] != edges[1]
    T, G = packs["both"]
    rays = tv.stack_ray_states([d[2] for d in designs])
    out = tv.vector_trace_reference(_args(cfg, designs, rays, T, G))
    r, b, it = _dict_trace(cfg, designs, rays, T, G)
    _assert_same(out.rays, r)
    assert torch.equal(out.bounces, b) and int(out.steps) == it
    for d in range(2):
        Td, Gd = packs[d]
        solo = tv.vector_trace_reference(_args(
            cfg, designs, tv.stack_ray_states([designs[d][2]]), Td, Gd))
        _assert_same({k: v[d:d + 1] for k, v in out.rays.items()},
                     solo.rays)
        assert int(out.bounces[d]) == int(solo.bounces[0])


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_geometry_rows_round_trip(designs, dtype):
    """The geometry rows (``add_region_grids``' ``geom_rows``) hold every
    scalar and half-plane pack of each design in its float type, the packs
    padded with (0, 0, 1); unpacked with the grids they give the stacked
    geometry back bit for bit."""
    designs, packs = designs
    G = (packs["both"] if dtype == torch.float32
         else _pack(designs, dtype))[1]
    rows, grid, edges = tv.pack_geometry(G)
    assert torch.equal(rows, G["geom_rows"])
    assert rows.dtype == dtype and grid.dtype == torch.uint8
    assert rows.shape == (2, len(tv.GEOM_SCALARS) + 3 * sum(edges))
    assert grid.shape == (2, GRID, GRID)
    back = tv.unpack_geometry(rows, grid, edges)
    for k, v in back.items():
        assert torch.equal(v, G[k].reshape(v.shape).to(v.dtype)), k
    for k in tv.GEOM_HP:
        n = min(int(getattr(tg, k).shape[0]) for _, tg, _ in designs)
        short = int(np.argmin([getattr(tg, k).shape[0]
                               for _, tg, _ in designs]))
        pad = back[k][short, n:]
        assert torch.equal(pad, pad.new_tensor([0.0, 0.0, 1.0]).expand_as(pad))


def test_inputs_are_not_mutated(fixture):
    """Neither the plain version nor the routed trace writes its inputs:
    the rays, tables and geometry are bit for bit what they were."""
    cfg, designs, packs = fixture
    T, G = packs["both"]
    rays = tv.stack_ray_states([d[2] for d in designs])
    keep = [{k: v.clone() for k, v in d.items()} for d in (rays, T, G)]
    a = _args(cfg, designs, rays, T, G)
    tv.vector_trace_reference(a)
    r3, _ = tv.make_trace_fn_dynamic(cfg, designs[0][1].num_fc,
                                     designs[0][1].num_oc)(rays, T, G,
                                                           max_bounces=3)
    tv.make_trace_fn_dynamic(cfg, designs[0][1].num_fc, designs[0][1].num_oc,
                             mode="resume")(r3, T, G)
    for d, k in zip((rays, T, G), keep):
        for key, v in k.items():
            assert torch.equal(d[key], v), key
    assert a.rays["state"] is rays["state"]


def test_cpu_routing_launches_no_kernel(designs):
    """``launch_counts`` has the kernel's key and the reset clears it; CPU
    traces (the routed call, ``make_trace_fn``, ``VectorTracer``) run the
    plain version and count no launch, with the CPU's reads (two a step
    and the one that ends the loop); the launcher refuses CPU tensors; a
    float64 trace on a GPU is refused before any card is asked for.
    ``simulate --engine vector`` runs segments on the CPU and one trace
    call a batch on a GPU."""
    designs, packs = designs
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=RPC,
                      max_bounces=400, seed=3)
    assert "vector_trace" in tp.launch_counts
    tp.launch_counts["vector_trace"] = 4
    tp.reset_launch_counts()
    assert tp.launch_counts["vector_trace"] == 0
    tables, tgeom, rays = designs[0]
    T, G = packs[0]
    a = _args(cfg, designs, tv.stack_ray_states([rays]), T, G)
    stats = {}
    out = tv.vector_trace(a, stats)
    assert stats["syncs"] == 2 * int(out.steps) + 1
    st2 = {}
    r, b = tv.make_trace_fn(tables, tgeom, cfg, device="cpu")(rays,
                                                              stats=st2)
    assert st2["steps"] == int(out.steps)
    assert st2["syncs"] == 2 * st2["steps"] + 1
    _assert_same({k: v[None] for k, v in r.items()}, out.rays)
    tracer = tv.VectorTracer([tables], [tgeom], cfg, device="cpu")
    r, b2 = tracer(tv.stack_ray_states([rays]))
    _assert_same(r, out.rays)
    assert int(b) == int(b2.sum()) == int(out.bounces.sum())
    assert tp.launch_counts["vector_trace"] == 0
    with pytest.raises(ValueError, match="runs on cuda"):
        tv.launch_vector_trace(a)
    with pytest.raises(ValueError, match="float32"):
        tv.make_trace_fn(tables, tgeom, cfg, precision="f64", device="cuda")
    with pytest.raises(ValueError, match="float32"):
        tv.VectorTracer([tables], [tgeom], cfg, dtype=torch.float64,
                        device="cuda")
    assert cli.vector_segmented("cpu") and not cli.vector_segmented("cuda")
