"""PyTorch port: the per-cell splitting engine's plain version, through the
argument packing its CUDA kernel (``csrc/split_cells.cu``) takes, against
the JAX package's per-cell engine in its ``fast=False`` form.

Fixture: ``tests/test_torch_splitting.py``'s (paper design, 3 x 2 FoV x 3
wavelengths = 18 cells, 4 launch positions per cell, threshold 1e-5, at most
300 steps); inputs made by numpy on the host, both engines on the CPU.  The
port's trace packs each chunk into :class:`SplitCellsArgs` (the kernel's
arguments) and runs :func:`split_cells_reference` on them, so these tests
hold what the kernel is handed, too.

Bars (``tests/test_splitting.py``'s): tiles within rtol 2e-4 / atol 1e-10,
``pruned`` within 1e-4 relative, ``out_coupled`` within 1e-5 relative;
``steps`` and per-cell ``peak`` equal; truncation equal where it is 0 and
within 1e-4 relative where the capacity cuts (the two sum the dropped
weights in different orders).  The kernel itself runs only on a card
(``tests/test_torch_cuda.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    seeding,
    splitting as jsplit,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    splitting,
    trace_persistent as tp,
)

M, N = 3, 2
P = 4
CELLS = np.arange(3 * M * N)
KW = dict(weight_threshold=1e-5, max_steps=300)
FIELDS = ("x", "y", "ter", "tei", "tmr", "tmi")


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
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=P,
                      max_bounces=400, rng_mode="fast", seed=2)
    return geom, tables, tgeom, cfg


def _seeds(geom, cfg, per_cell: bool) -> dict:
    """Float32 numpy launch seeds: (P,) shared by every cell (cell 0's), or
    (C, P) with each cell's own pupil positions."""
    cells = CELLS if per_cell else np.arange(1)
    b = seeding.build_ray_batch(geom, cfg, cell_ids=cells, rays_per_cell=P)
    te, tm = np.asarray(b["te"]), np.asarray(b["tm"])
    vals = (b["x"], b["y"], te.real, te.imag, tm.real, tm.imag)
    shape = (len(CELLS), P) if per_cell else (P,)
    return {k: np.asarray(v, np.float32).reshape(shape)
            for k, v in zip(FIELDS, vals)}


@pytest.mark.parametrize("per_cell,capacity", [
    (False, 8192), (True, 8192), (False, 256)])
def test_plain_version_through_kernel_args_matches_jax(setup, per_cell,
                                                       capacity):
    """Shared and per-cell seeds at 8,192 slots (nothing truncated), and a
    256-slot wavefront that truncates (peak above the capacity): the
    port's per-cell engine on the CPU, whose chunks go through the
    kernel's packed arguments, against the JAX engine (``fast=False``)."""
    geom, tables, tgeom, cfg = setup
    s = _seeds(geom, cfg, per_cell)
    want = jsplit.run_splitting_cells(
        tables, tgeom, cfg, CELLS, {k: jnp.asarray(v) for k, v in s.items()},
        capacity=capacity, per_cell_seeds=per_cell, fast=False, **KW)
    got = splitting.run_splitting_cells(
        tables, tgeom, cfg, CELLS, {k: torch.from_numpy(v)
                                    for k, v in s.items()},
        capacity=capacity, per_cell_seeds=per_cell, device="cpu", **KW)
    np.testing.assert_allclose(got.histogram, want.histogram, rtol=2e-4,
                               atol=1e-10)
    assert got.out_coupled == pytest.approx(want.out_coupled, rel=1e-5)
    assert got.pruned == pytest.approx(want.pruned, rel=1e-4)
    assert (got.steps, got.peak_live) == (want.steps, want.peak_live)
    assert got.out_coupled > 0
    if capacity >= 8192:
        assert got.truncated == want.truncated == 0.0
        assert 0 < got.peak_live < capacity
    else:
        assert got.peak_live > capacity and got.truncated > 0
        assert got.truncated == pytest.approx(want.truncated, rel=1e-4)


def test_chunk_outputs_per_cell(setup):
    """The plain version's per-cell outputs of one chunk: per-cell steps
    that end when the cell's wavefront drains (the chunk's steps are the
    largest), the stepped widths summed, per-cell peaks equal to the JAX
    engine's, and ``trace`` returning the tiles' sums as ``out_w``."""
    geom, tables, tgeom, cfg = setup
    s = _seeds(geom, cfg, False)
    trace = splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                              capacity=8192, device="cpu",
                                              **KW)
    seeds = {k: torch.from_numpy(v) for k, v in s.items()}
    a = trace.args(CELLS, seeds)
    assert (a.C, a.P, a.capacity) == (len(CELLS), P, 8192)
    assert a.rec.shape == (26, len(CELLS) * 2 * (1 + tgeom.num_fc
                                                 + tgeom.num_oc))
    out = splitting.split_cells_reference(a)
    tiles, out_w, trunc, pruned, steps, peak = trace(CELLS, seeds)
    assert torch.equal(out.tiles, tiles) and torch.equal(out.pruned, pruned)
    assert torch.equal(out_w, tiles.sum(dim=(1, 2)))
    assert steps == int(out.steps.max()) and (out.steps > 0).all()
    assert (out.work >= out.steps).all() and (out.work <= out.steps
                                              * 8192).all()
    jt = jsplit.make_splitting_cells_fn(
        tables, tgeom, cfg, capacity=8192, fast=False, **KW)(
            jnp.asarray(CELLS), {k: jnp.asarray(v) for k, v in s.items()})
    np.testing.assert_array_equal(peak.numpy(), np.asarray(jt[5]))
    assert steps == int(jt[4])


def test_geometry_packing_round_trip(setup):
    """The flat geometry the kernel reads unpacks to the engine's geometry
    bit for bit: every scalar, half-plane pack and the region grid."""
    geom, tables, tgeom, cfg = setup
    G, _ = splitting._geometry(tgeom, "cpu")
    flat, grid, edges = splitting.pack_geometry(G)
    assert flat.dtype == torch.float32 and grid.dtype == torch.uint8
    assert flat.numel() == (len(splitting.GEOM_SCALARS)
                            + 3 * sum(edges))
    back = splitting.unpack_geometry(flat, grid, edges)
    for k, v in back.items():
        assert torch.equal(v, G[k].reshape(v.shape)), k


def test_launch_count_key_and_cpu_routing(setup):
    """``launch_counts`` has the kernel's key and the reset clears it; a CPU
    chunk runs the plain version and counts no launch; the launcher refuses
    CPU tensors; a CUDA request without a card raises (no fallback)."""
    geom, tables, tgeom, cfg = setup
    assert "split_cells" in tp.launch_counts
    tp.launch_counts["split_cells"] = 3
    tp.reset_launch_counts()
    assert tp.launch_counts["split_cells"] == 0
    trace = splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                              capacity=1024, device="cpu",
                                              **KW)
    seeds = {k: torch.from_numpy(v)
             for k, v in _seeds(geom, cfg, False).items()}
    a = trace.args(CELLS[:2], seeds)
    out = splitting.split_cells(a)
    assert tp.launch_counts["split_cells"] == 0
    assert out.tiles.shape == (2, 80, 120) and out.tiles.sum() > 0
    with pytest.raises(ValueError, match="runs on cuda"):
        splitting.launch_split_cells(a)
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the no-card refusal does not "
                    "apply")
    with pytest.raises(RuntimeError, match="cuda"):
        splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                          device="cuda", **KW)
