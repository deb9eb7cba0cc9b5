"""PyTorch port: the host side of the per-cell splitting kernel's launch
(``csrc/split_cells.cu``), on the CPU.

- ``splitting.cluster_size``: the blocks that share each cell of a chunk,
  from the chunk's size and capacity and the card's SMs and resident blocks
  alone (the outputs do not depend on it; ``tests/test_torch_cuda.py``
  holds that on the card).
- ``trace_vector.region_subgrids``: the region grid refined where it leaves
  a region open, which the kernel reads: every subcell code of 0 or 1 is
  what the exact half-plane test gives at every float32 position the
  kernel's lookup sends to it.

No JAX: both are port-side.  One torch thread (module fixture).
"""

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    splitting,
    trace_vector as tv,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
    build_trace_geometry,
)

H100 = dict(threads=256, sms=132, blocks_per_sm=2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: the suite runs several workers on
    the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("cells,capacity,want", [
    (4, 8192, 4),        # a few cells: each spread over four SMs
    (128, 32768, 4),     # ExactTailHybrid's chunk: 512 blocks, two waves
    (132, 8192, 4),      # one cell an SM at most two waves of four blocks
    (133, 8192, 2),      # past it, pairs
    (256, 8192, 2),      # simulate --engine splitting's chunk
    (264, 8192, 2),
    (265, 8192, 1),
    (512, 8192, 1),      # simulate --tail-exact's chunk
    (4, 64, 1),          # a pass of 512 would pass the 64-slot capacity
    (4, 512, 2),
    (4, 1024, 4),
    (1, 255, 1),
])
def test_cluster_size_by_shape(cells, capacity, want):
    """The largest of 1, 2, 4 whose pass fits the capacity and whose blocks
    fill at most two waves of the card."""
    q = splitting.cluster_size(cells, capacity, **H100)
    assert q == want
    assert q in splitting.CLUSTER_SIZES
    assert q == 1 or (cells * q <= 2 * H100["sms"] * H100["blocks_per_sm"]
                      and q * H100["threads"] <= capacity)


def test_cluster_size_on_other_cards():
    """The rule reads the card's SMs and blocks per SM, nothing else."""
    assert splitting.cluster_size(100, 8192, 256, 66, 2) == 2
    assert splitting.cluster_size(100, 8192, 256, 66, 4) == 4
    assert splitting.cluster_size(100, 8192, 256, 10, 2) == 1


@pytest.fixture(scope="module")
def refined():
    """The paper design's geometry with its region grid and the refined
    grid, as the per-cell engine builds them."""
    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    G, _ = splitting._geometry(build_trace_geometry(geom), "cpu")
    fine, codes = tv.region_subgrids(G)
    return G, fine, codes


def _lookup(G, fine, codes, x, y):
    """The kernel's region code of float32 positions (region_code_fine in
    csrc/step_common.cuh), with the same float32 operations."""
    n = fine.shape[0]
    x0, y0 = G["grid_x0"][0], G["grid_y0"][0]
    fx = (x - x0) * G["grid_inv_hx"][0]
    fy = (y - y0) * G["grid_inv_hy"][0]
    ix, iy = torch.floor(fx), torch.floor(fy)
    inwin = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
    v = fine[iy.clamp(0, n - 1).long(), ix.clamp(0, n - 1).long()].long()
    sub = codes.shape[1]
    su = torch.floor((fx - ix) * sub).long().clamp(0, sub - 1)
    sv = torch.floor((fy - iy) * sub).long().clamp(0, sub - 1)
    code = torch.where(v < 0, codes[(-1 - v).clamp(min=0), sv, su].long(), v)
    return torch.where(inwin, code, torch.full_like(code, 0x2A))


def test_region_subgrids_layout(refined):
    """Each open cell of the grid has its row of subcells; a decided cell
    keeps its code; a subcell keeps every region its cell decides."""
    G, fine, codes = refined
    code = G["grid_code"][0].long()
    n = code.shape[0]
    assert fine.dtype == torch.int16 and fine.shape == (n, n)
    assert codes.dtype == torch.uint8
    assert codes.shape[1:] == (tv.SUBGRID, tv.SUBGRID)
    open_ = torch.zeros_like(code, dtype=torch.bool)
    for k in range(3):
        open_ |= ((code >> (2 * k)) & 3) == 2
    assert torch.equal(fine < 0, open_)
    assert torch.equal(fine[~open_].long(), code[~open_])
    rows = (-1 - fine[open_].long())
    assert torch.equal(torch.sort(rows).values, torch.arange(len(codes)))
    sub = codes[rows].long()
    cell = code[open_][:, None, None]
    for k in range(3):
        c = (cell >> (2 * k)) & 3
        s = (sub >> (2 * k)) & 3
        assert torch.equal(torch.where(c == 2, s, c), s)
    # the refinement decides most of what the grid leaves open
    assert int((sub == code[open_][:, None, None]).sum()) < sub.numel() // 4


def test_region_subgrids_agree_with_exact_test(refined):
    """At float32 positions spread over the grid's open cells (and hugging
    their subcell borders), every region a subcell code decides is what the
    exact half-plane test gives, as the kernel looks it up."""
    G, fine, codes = refined
    rng = np.random.default_rng(20)
    cells = torch.nonzero(fine < 0)
    m = 200_000
    pick = cells[torch.from_numpy(rng.integers(0, len(cells), m))]
    sub = codes.shape[1]
    # a uniform position in the cell, and one within 1e-7 cell of a
    # subcell border
    u = rng.random((2, m))
    edge = (rng.integers(0, sub + 1, (2, m)) / sub
            + rng.uniform(-1e-7, 1e-7, (2, m)))
    u = np.where(rng.random((2, m)) < 0.5, u, np.clip(edge, 0.0, 1.0))
    x = (G["grid_x0"][0].double()
         + (pick[:, 1].double() + torch.from_numpy(u[0]))
         / G["grid_inv_hx"][0].double()).float()
    y = (G["grid_y0"][0].double()
         + (pick[:, 0].double() + torch.from_numpy(u[1]))
         / G["grid_inv_hy"][0].double()).float()
    code = _lookup(G, fine, codes, x, y)
    decided = 0
    for k, key in enumerate(("r1_hp", "hull_hp", "r2_hp")):
        cls = (code >> (2 * k)) & 3
        exact = tv._hp_inside(G[key], x[None], y[None])[0]
        dec = cls != 2
        decided += int(dec.sum())
        assert torch.equal((cls == 1)[dec], exact[dec]), key
    assert decided > 2 * m
