"""PyTorch port: the refined region grids that the vector kernel
(``csrc/vector_trace.cu``) reads, one per design, on the CPU.

- ``trace_vector.region_subgrids_stacked``: every design's grid refined
  where it leaves a region open, the designs' subcell rows one after
  another; design 0's are ``region_subgrids``' own, bit for bit.
- Looked up as the kernel looks them up (``region_code_fine`` in
  ``csrc/step_common.cuh``, written out here in float32 PyTorch), every
  region a code decides is what the exact half-plane test gives, at seeded
  positions over each design's window and within 1e-4 mm of every edge of
  its regions.
- ``VectorTracer`` holds them as buffers, and its traces on the CPU are the
  plain version's, which does not read them.

No JAX: all of it is port-side.  One torch thread (module fixture).
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    seeding,
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
REGIONS = ("r1_hp", "hull_hp", "r2_hp")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def swept():
    """The first and last designs of the CLI's default sweep, stacked as
    the vector sweep stacks them (trace geometry simplified at 1e-3), in a
    ``VectorTracer`` on the CPU, with a seeded ray batch of each."""
    args = cli.build_parser().parse_args(["sweep", "--engine", "vector"])
    designs, _ = cli.sweep_designs(args)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=24,
                      max_bounces=300, seed=4, ic_test="polygon")
    tables, tgeoms, states = [], [], []
    for d in (designs[0], designs[-1]):
        geom = generate_geometry(d, num_fov_x=M, num_fov_y=N)
        tables.append(build_cell_tables(geom, make_synthetic_luts(geom)))
        tgeoms.append(build_trace_geometry(geom, simplify_tol=1e-3))
        b = seeding.build_ray_batch(geom, cfg)
        states.append(tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                        b["cid"], b["idx"], b["rng"],
                                        device="cpu"))
    tracer = tv.VectorTracer(tables, tgeoms, cfg, device="cpu")
    return cfg, tracer, tv.stack_ray_states(states)


def edge_points(hp: torch.Tensor, per_edge: int, rng) -> tuple:
    """float32 positions within 1e-4 mm of every edge of the convex region
    of half-planes ``hp`` (E, 3): ``per_edge`` points along each side of
    its polygon, each moved off the side by up to 1e-4 mm either way."""
    v = tv._vertices(hp.double())
    c = v.mean(dim=0)
    v = v[torch.argsort(torch.atan2(v[:, 1] - c[1], v[:, 0] - c[0]))]
    a, b = v, torch.roll(v, -1, dims=0)
    side = b - a
    keep = side.norm(dim=1) > 1e-9
    a, side = a[keep], side[keep]
    normal = torch.stack([side[:, 1], -side[:, 0]], 1) / side.norm(
        dim=1, keepdim=True)
    t = torch.from_numpy(rng.random((len(a), per_edge)))
    off = torch.from_numpy(rng.uniform(-1e-4, 1e-4, (len(a), per_edge)))
    p = (a[:, None] + t[..., None] * side[:, None]
         + off[..., None] * normal[:, None]).reshape(-1, 2)
    return p[:, 0].float(), p[:, 1].float()


def region_code_fine(G, fine, codes, d, x, y):
    """The kernel's region code of design ``d``'s float32 positions
    (``region_code_fine`` in ``csrc/step_common.cuh``), with the same
    float32 operations; 0x2A (every region open) outside the window."""
    n = fine.shape[1]
    fx = (x - G["grid_x0"][d]) * G["grid_inv_hx"][d]
    fy = (y - G["grid_y0"][d]) * G["grid_inv_hy"][d]
    ix, iy = torch.floor(fx), torch.floor(fy)
    inwin = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
    v = fine[d][iy.clamp(0, n - 1).long(), ix.clamp(0, n - 1).long()].long()
    sub = codes.shape[1]
    su = torch.floor((fx - ix) * sub).long().clamp(0, sub - 1)
    sv = torch.floor((fy - iy) * sub).long().clamp(0, sub - 1)
    row = (-1 - v).clamp(min=0, max=max(len(codes) - 1, 0))
    code = torch.where(v < 0, codes[row, sv, su].long(), v)
    return torch.where(inwin, code, torch.full_like(code, 0x2A))


def test_stacked_subgrids_follow_region_subgrids(swept):
    """Design 0's refined grid and rows are ``region_subgrids``' own bit for
    bit; design 1's rows follow them, its grid numbering them from there."""
    _, tracer, _ = swept
    G = tracer.geometry()
    fine, codes = G["fine"], G["sub_codes"]
    n = G["grid_code"].shape[1]
    assert fine.dtype == torch.int16 and fine.shape == (2, n, n)
    assert codes.dtype == torch.uint8
    assert codes.shape[1:] == (tv.SUBGRID, tv.SUBGRID)
    f0, c0 = tv.region_subgrids(G)
    m0 = len(c0)
    assert torch.equal(fine[0], f0) and torch.equal(codes[:m0], c0)
    f1, c1 = tv.region_subgrids(G, 1, m0)
    assert torch.equal(fine[1], f1) and torch.equal(codes[m0:], c1)
    # the offset numbers the rows and changes nothing else
    g1, d1 = tv.region_subgrids(G, 1)
    assert torch.equal(d1, c1)
    assert torch.equal(torch.where(g1 < 0, g1 - m0, g1), f1)
    rows = -1 - fine[fine < 0].long()
    assert torch.equal(torch.sort(rows).values, torch.arange(len(codes)))
    # both designs leave cells open, and a decided cell keeps its code
    assert m0 > 0 and len(c1) > 0
    code = G["grid_code"].long()
    assert torch.equal(fine[fine >= 0].long(), code[fine >= 0])


@pytest.mark.parametrize("where", ["window", "open_cells", "edges"])
def test_stacked_subgrids_agree_with_exact_test(swept, where):
    """Per design, every region a refined code decides is what the exact
    half-plane test gives: at seeded float32 positions over the design's
    grid window, over the cells its coarse grid leaves open, and within
    1e-4 mm of every edge of r1, the hull and r2."""
    _, tracer, _ = swept
    G = tracer.geometry()
    fine, codes = G["fine"], G["sub_codes"]
    n = fine.shape[1]
    rng = np.random.default_rng(21)
    for d in range(fine.shape[0]):
        if where != "edges":
            u = torch.from_numpy(rng.random((2, 200_000)))
            if where == "window":
                u = u * n
            else:
                cells = torch.nonzero(fine[d] < 0).flip(1).T.double()
                u = u + cells[:, torch.from_numpy(
                    rng.integers(0, cells.shape[1], u.shape[1]))]
            x = (G["grid_x0"][d].double() + u[0]
                 / G["grid_inv_hx"][d].double()).float()
            y = (G["grid_y0"][d].double() + u[1]
                 / G["grid_inv_hy"][d].double()).float()
        else:
            pts = [edge_points(G[key][d], 200, rng) for key in REGIONS]
            x = torch.cat([p[0] for p in pts])
            y = torch.cat([p[1] for p in pts])
        code = region_code_fine(G, fine, codes, d, x, y)
        decided = 0
        for k, key in enumerate(REGIONS):
            cls = (code >> (2 * k)) & 3
            exact = tv._hp_inside(G[key][d:d + 1], x[None], y[None])[0]
            dec = cls != 2
            decided += int(dec.sum())
            assert torch.equal((cls == 1)[dec], exact[dec]), (d, key)
            if where == "edges":
                # both sides of the edges are reached
                assert exact.any() and not exact.all(), (d, key)
        # within 1e-4 mm of an edge its region stays open (the margin is
        # 1e-3 mm), and the exact test decides it
        assert decided > (len(x) // 2 if where == "edges" else 2 * len(x))


def test_vector_tracer_traces_as_the_plain_version(swept):
    """``VectorTracer`` on the CPU holds the refined grids as buffers (on
    its device, as ``region_subgrids_stacked`` builds them from its
    geometry) and its trace is the plain version's, which reads the
    coarse grids alone: every field, the bounces and the steps."""
    cfg, tracer, rays = swept
    G = tracer.geometry()
    buffers = dict(tracer.named_buffers())
    assert "G_fine" in buffers and "G_sub_codes" in buffers
    fine, codes = tv.region_subgrids_stacked(G)
    assert torch.equal(fine, G["fine"]) and torch.equal(codes,
                                                        G["sub_codes"])
    stats = {}
    got, bounces = tracer(rays, stats=stats)
    a = tv.vector_trace_args(rays, tracer.tables(), G, mode="full",
                             max_bounces=cfg.max_bounces,
                             num_fc=tracer.num_fc, num_oc=tracer.num_oc,
                             eyebox_bins=cfg.eyebox_bins, circle=False)
    ref = tv.vector_trace_reference(dataclasses.replace(a, fine=None,
                                                        sub_codes=None))
    for k in tv.RAY_KEYS:
        assert torch.equal(got[k], ref.rays[k]), k
    assert torch.equal(bounces, ref.bounces)
    assert stats["steps"] == int(ref.steps) > 0
    assert int((got["dep"] >= 0).sum()) > 0
