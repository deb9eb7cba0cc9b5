"""PyTorch port on the card: the CUDA kernels against their plain versions.

Every test here needs an NVIDIA GPU, carries the ``cuda`` marker and skips
without one.  The file imports neither JAX nor the JAX package, so it also
runs where JAX is absent:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import dataclasses

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
    WaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    trace_cell as tc,
    trace_persistent as tp,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    run_design_sweep_persistent,
)

M, N = 4, 3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=256, num_iter=2,
                      max_bounces=600, seed=6)
    return geom, cfg


@pytest.mark.cuda
@pytest.mark.parametrize("slots", [128, 512])
def test_kernel_equals_plain_version_on_card(small, cuda_device, slots):
    """Same float32 operations, no fused multiply-add: identical results."""
    geom, cfg = small
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=slots, spawn_mode="count",
                             fold_iterations=True)
    assert tp._LIB is not None   # built and bound by Simulator.__init__
    cells = np.arange(3 * M * N)
    rays_in, rng_in = sim._device_ray_blocks(cells, slots)
    ctrl = sim._pers_ctrl(512)
    tr = sim.tracer
    args = (tr.cell_params, tr.geom_row, rays_in, rng_in, ctrl)
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters)
    n0 = tp.launch_counts["persistent_trace"]
    hk, nbk = tp.persistent_trace(*args, **kw)
    torch.cuda.synchronize()
    assert tp.launch_counts["persistent_trace"] == n0 + 1
    hr, nbr = tp.persistent_trace_reference(*args, **kw)
    assert hk.sum() > 0
    assert torch.equal(hk, hr)
    assert torch.equal(nbk, nbr)


@pytest.mark.cuda
def test_simulator_on_card_equals_cpu(small, cuda_device):
    """The kernel on the card and the plain version on the CPU give the same
    histogram (IEEE float32 without contraction on both)."""
    geom, cfg = small
    pin = dict(spawn_mode="count", fold_iterations=True)
    rg = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                            persistent_slots=128, **pin).run(
        cells_per_batch=16)
    rc = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                            persistent_slots=128, **pin).run(
        cells_per_batch=16)
    np.testing.assert_array_equal(rg.histogram, rc.histogram)
    assert rg.total_bounces == rc.total_bounces
    assert rg.rays_traced == rc.rays_traced
    assert rg.efficiencies == rc.efficiencies


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["packed", "jump_pow2", "jump_cos", "k2",
                                  "k2_gens", "jump_pow2_gens"])
def test_packed_modes_equal_plain_version_on_card(small, cuda_device, mode):
    """Packed selection, transit jumps in both phases and two cells per
    block, in count and gens spawn: kernel and plain version give identical
    tiles and counts; with two cells per block each cell's tile, bounces and
    spawns also equal its one-cell-per-block launch."""
    geom, cfg = small
    jump = mode.startswith("jump")
    sim = pipeline.Simulator(
        cfg=cfg, geom=geom, device=cuda_device, persistent_slots=128,
        pers_accum_mode="packed", pers_transit_jump=jump,
        pers_jump_phase="cos" if "cos" in mode else "pow2")
    k = 2 if mode.startswith("k2") else 1
    gens = mode.endswith("gens")
    cells = np.arange(3 * M * N)
    tr = sim.tracer
    ctrl = torch.tensor([2, 0] if gens else [512, 0], dtype=torch.int32,
                        device=cuda_device)
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters,
              spawn_mode="gens" if gens else "count", accum_mode="packed",
              transit_jump=jump, jump_phase=tr.jump_phase,
              cell_params_packed=tr.cell_params_packed)

    def both(cpb):
        rays_in, rng_in = sim._device_ray_blocks(cells, 128, cpb=cpb)
        args = (tr.cell_params, tr.geom_row, rays_in, rng_in, ctrl)
        n0 = tp.launch_counts["persistent_trace"]
        hk, nbk = tp.persistent_trace(*args, cells_per_block=cpb, **kw)
        torch.cuda.synchronize()
        assert tp.launch_counts["persistent_trace"] == n0 + 1
        hr, nbr = tp.persistent_trace_reference(*args, cells_per_block=cpb,
                                                **kw)
        assert hk.sum() > 0
        assert torch.equal(hk, hr)
        assert torch.equal(nbk, nbr)
        return hk, nbk

    hk, nbk = both(k)
    if k > 1:
        h1, nb1 = both(1)
        assert torch.equal(hk, h1)
        assert torch.equal(nbk[:, [0, 2]], nb1[:, [0, 2]])


def _launch_both(sim, slots, k, ctrl, spawn_mode, max_iters=None):
    """One launch of the Simulator's tracer on every cell of the fixture,
    ``k`` cells of ``slots`` slots each per block, and the plain version on
    the same inputs: both outputs."""
    tr = sim.tracer
    cells = np.arange(3 * M * N)
    rays_in, rng_in = sim._device_ray_blocks(cells, slots, cpb=k)
    args = (tr.cell_params, tr.geom_row, rays_in, rng_in,
            torch.tensor(ctrl, dtype=torch.int32, device=rays_in.device))
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins,
              max_iters=max_iters or tr.max_iters, spawn_mode=spawn_mode,
              accum_mode=tr.accum_mode, cells_per_block=k,
              transit_jump=tr.transit_jump, jump_phase=tr.jump_phase,
              cell_params_packed=tr.cell_params_packed)
    n0 = tp.launch_counts["persistent_trace"]
    out = tp.persistent_trace(*args, **kw)
    torch.cuda.synchronize()
    assert tp.launch_counts["persistent_trace"] == n0 + 1
    return out, tp.persistent_trace_reference(*args, **kw)


_INSTANTIATIONS = {   # selection -> (Simulator keywords, cells per block)
    "exact": (dict(), 1),
    "packed": (dict(pers_accum_mode="packed"), 1),
    "packed_k2": (dict(pers_accum_mode="packed"), 2),
    "jump_pow2": (dict(pers_accum_mode="packed", pers_transit_jump=True), 1),
    "jump_cos": (dict(pers_accum_mode="packed", pers_transit_jump=True,
                      pers_jump_phase="cos"), 1),
}


@pytest.mark.cuda
@pytest.mark.parametrize("sel,spawn,gens", [
    *((sel, spawn, 1) for spawn in ("count", "gens") for sel in _INSTANTIATIONS),
    ("exact", "gens", 10)])
def test_instantiations_equal_plain_version_in_the_drain(small, cuda_device,
                                                         sel, spawn, gens):
    """Every instantiation at a drain-heavy fixture, 2,048 slots per block:
    each slot spawns once (count target = slots per cell, or one generation
    per slot), so most iterations run a shrinking work list; and exact
    selection with ten generations per slot.  Histograms and all of ``nb``
    identical to the plain version's."""
    geom, cfg = small
    kw, k = _INSTANTIATIONS[sel]
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=2048, **kw)
    slots = 2048 // k
    ctrl = [gens, 0] if spawn == "gens" else [slots, 0]
    (hk, nbk), (hr, nbr) = _launch_both(sim, slots, k, ctrl, spawn)
    assert hk.sum() > 0
    assert torch.equal(hk, hr)
    assert torch.equal(nbk, nbr)
    assert int(nbk[:, 2].sum()) == 3 * M * N * slots * gens


@pytest.mark.cuda
@pytest.mark.parametrize("slots,k,sel,spawn", [
    (2048, 1, "packed", "count"), (2048, 1, "jump_pow2", "count"),
    (1024, 2, "packed", "count"), (256, 1, "jump_pow2", "gens"),
    (2048, 1, "packed", "gens"), (256, 1, "packed", "gens"),
    (256, 4, "packed", "gens"), (2048, 2, "packed", "count")],
    ids=["packed", "jump", "k2", "jump_256", "packed_gens", "packed_256",
         "k4_256", "k2_2048"])
def test_launch_shapes_still_launch(small, cuda_device, slots, k, sel, spawn):
    """The launch shapes of the card smoke test's packed phase and of the
    CPU layout test (slots per cell, cells per block) launch, 16 iterations
    each, and equal the plain version; so do two cells of 2,048 slots."""
    geom, cfg = small
    kw, _ = _INSTANTIATIONS[sel]
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=slots, **kw)
    (hk, nbk), (hr, nbr) = _launch_both(
        sim, slots, k, [2, 0] if spawn == "gens" else [slots, 0], spawn,
        max_iters=16)
    assert torch.equal(hk, hr)
    assert torch.equal(nbk, nbr)


@pytest.mark.cuda
def test_packed_sweep_on_card_equals_cpu_and_cells_per_block(cuda_device):
    """A packed sweep with transit jumps equals the CPU sweep bit for bit,
    and a packed sweep with four cells per block equals the one with one."""
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=256, seed=5)
    designs = [dataclasses.replace(WaveguideDesign(), lambda_ic=p, lambda_oc=p)
               for p in (380.0, 396.0)]
    kw = dict(spawn_iters=64, keep_histograms=True, accum_mode="packed")
    jump = run_design_sweep_persistent(designs, cfg, device=cuda_device,
                                       transit_jump=True, **kw)
    cpu = run_design_sweep_persistent(designs, cfg, device="cpu",
                                      transit_jump=True, **kw)
    np.testing.assert_array_equal(cpu.histograms, jump.histograms)
    np.testing.assert_array_equal(cpu.bounces, jump.bounces)
    one = run_design_sweep_persistent(designs, cfg, device=cuda_device, **kw)
    four = run_design_sweep_persistent(designs, cfg, device=cuda_device,
                                       cells_per_block=4, **kw)
    np.testing.assert_array_equal(one.histograms, four.histograms)
    np.testing.assert_array_equal(one.bounces, four.bounces)
    assert one.histograms.sum() > 0


def _design_rows(cfg, periods, device):
    """Cell rows, geometry rows and launch tiles of one design per coupler
    period (one Simulator each), and the first design's per-cell seeds as
    the seed block every design shares."""
    rows, grs, tiles, ecs = [], [], [], []
    for p in periods:
        d = dataclasses.replace(WaveguideDesign(), lambda_ic=p, lambda_oc=p)
        sim = pipeline.Simulator(design=d, cfg=cfg, device=device,
                                 persistent_slots=128)
        rows.append(sim.tracer.cell_params)
        grs.append(sim.tracer.geom_row)
        tile, _ = sim._device_ray_blocks(np.arange(1), 128)
        tiles.append(tile)
        ecs.append(sim.tracer.edge_counts)
    seeds = sim._device_ray_blocks(np.arange(3 * M * N), 128)[1]
    ec = tuple(max(c) for c in zip(*ecs))
    return (torch.cat(rows), torch.cat(grs), torch.cat(tiles), seeds,
            dict(num_fc=sim.tracer.num_fc, num_oc=sim.tracer.num_oc,
                 edge_counts=ec, eyebox_bins=cfg.eyebox_bins, max_iters=600))


@pytest.mark.cuda
@pytest.mark.parametrize("mode,ctrl", [("gens", [2, 0]), ("gens", [1, 64]),
                                       ("count", [512, 0])],
                         ids=["gens", "saturating", "count"])
def test_kernel_modes_equal_plain_version_on_card(small, cuda_device, mode,
                                                  ctrl):
    """Gens spawn, saturating spawn and count spawn over D = 3 geometry rows
    with per-design tiles and a shared seed block: identical results."""
    geom, cfg = small
    cp, gr, tiles, seeds, kw = _design_rows(cfg, (380.0, 388.0, 396.0),
                                            cuda_device)
    args = (cp, gr, tiles, seeds,
            torch.tensor(ctrl, dtype=torch.int32, device=cuda_device))
    n0 = tp.launch_counts["persistent_trace"]
    hk, nbk = tp.persistent_trace(*args, spawn_mode=mode, **kw)
    torch.cuda.synchronize()
    assert tp.launch_counts["persistent_trace"] == n0 + 1
    hr, nbr = tp.persistent_trace_reference(*args, spawn_mode=mode, **kw)
    assert hk.shape == (9 * M * N, 80, 120) and hk.sum() > 0
    assert torch.equal(hk, hr)
    assert torch.equal(nbk, nbr)


@pytest.mark.cuda
@pytest.mark.parametrize("mode,spawn_iters", [("gens", 64), ("count", 0)])
def test_sweep_design_equals_solo_on_card(cuda_device, mode, spawn_iters):
    """On the card a sweep's middle design equals its solo sweep bit for
    bit, and the CPU sweep gives the same histograms."""
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=256, seed=5)
    designs = [dataclasses.replace(WaveguideDesign(), lambda_ic=p, lambda_oc=p)
               for p in (380.0, 388.0, 396.0)]
    kw = dict(spawn_iters=spawn_iters, spawn_mode=mode, keep_histograms=True)
    res = run_design_sweep_persistent(designs, cfg, device=cuda_device, **kw)
    solo = run_design_sweep_persistent(designs[1:2], cfg, device=cuda_device,
                                       **kw)
    cpu = run_design_sweep_persistent(designs, cfg, device="cpu", **kw)
    assert res.timings["launches"] == 1
    np.testing.assert_array_equal(solo.histograms[0], res.histograms[1])
    assert solo.bounces[0] == res.bounces[1]
    np.testing.assert_array_equal(cpu.histograms, res.histograms)
    np.testing.assert_array_equal(cpu.bounces, res.bounces)


@pytest.mark.cuda
@pytest.mark.parametrize("rays_per_cell", [256, 300, 128, 2048])
def test_cell_kernel_equals_plain_version_on_card(small, cuda_device,
                                                  rays_per_cell):
    """The per-cell kernel in full mode, in resume mode from its own
    outputs, and with the whole budget: every output identical to the plain
    version's (300 rays per cell leave 84 padding slots that die at init;
    128 is a tile of one row, 64 threads per block; at 2,048 each cell
    spans 8 blocks), and full(16) + resume(rest) = full(whole)."""
    geom, cfg = small
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             engine="cell")
    assert tc._LIB is not None   # built and bound by Simulator.__init__
    cells = np.arange(3 * M * N)
    rays_in, rng_in = sim._cell_blocks(cells, rays_per_cell, 0)
    tr = sim.tracer
    rows = tr.rows(cells)

    def both(rays, rng, state, budget):
        args = (rows, tr.geom_row, rays, rng, state)
        n0 = tp.launch_counts["cell_trace"]
        outk = tc.cell_trace(*args, max_bounces=budget, **tr.kw)
        torch.cuda.synchronize()
        assert tp.launch_counts["cell_trace"] == n0 + 1
        outp = tc.cell_trace_reference(*args, max_bounces=budget, **tr.kw)
        for k, p in zip(outk, outp):
            assert torch.equal(k, p)
        return outk

    a = both(rays_in, rng_in, None, 16)
    b = both(a[2], a[4], a[3], cfg.max_bounces - 16)
    c = both(rays_in, rng_in, None, cfg.max_bounces)
    assert (a[3] < 6).any() and (c[0] >= 0).sum() > 0
    assert torch.equal(torch.where(a[0] >= 0, a[0], b[0]), c[0])
    assert torch.equal(a[1][:, 0] + b[1][:, 0], c[1][:, 0])
    for k in (2, 3, 4):
        assert torch.equal(b[k], c[k])


@pytest.mark.cuda
def test_cell_simulator_on_card_segmented_equals_monolithic_and_cpu(
        small, cuda_device):
    """On the card the segmented run equals the monolithic run, and both
    equal the plain version's run on the CPU (IEEE float32 without
    contraction on both)."""
    geom, cfg = small
    kw = dict(cfg=cfg, geom=geom, engine="cell")
    run = dict(cells_per_batch=16, evaluate_metrics=False)
    mono = pipeline.Simulator(device=cuda_device, **kw).run(**run)
    seg = pipeline.Simulator(device=cuda_device, segmented=True,
                             segment_bounces=8, **kw).run(**run)
    cpu = pipeline.Simulator(device="cpu", **kw).run(**run)
    for other in (seg, cpu):
        np.testing.assert_array_equal(other.histogram, mono.histogram)
        assert other.total_bounces == mono.total_bounces
        assert other.deposits == mono.deposits
        assert other.efficiencies == mono.efficiencies
    assert mono.histogram.sum() == mono.deposits > 0
    assert "kernel_ms" in mono.timings and "compact_ms" in seg.timings


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["budget_1", "dead_after_live",
                                  "odd_launch_shape"])
def test_cell_kernel_edge_launches_equal_plain_version_on_card(
        small, cuda_device, monkeypatch, case):
    """Every output identical to the plain version's at the launches that
    strain the refill: a budget of one iteration; a compacted resume tile
    (the segmented scheduler's) whose dead rays follow the live ones; and a
    launch shape outside the wrapper's rule, 96 threads and 3 blocks per
    cell, so that ranges start and end inside warps."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        cell_segments,
    )

    geom, cfg = small
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             engine="cell")
    cells = np.arange(3 * M * N)
    rays_in, rng_in = sim._cell_blocks(cells, 1000, 0)
    tr = sim.tracer
    rows = tr.rows(cells)
    state, budget = None, cfg.max_bounces
    if case == "budget_1":
        budget = 1
    elif case == "dead_after_live":
        _, _, ro, so, rgo = tc.cell_trace(rows, tr.geom_row, rays_in, rng_in,
                                          max_bounces=8, **tr.kw)
        alive = so.reshape(len(cells), -1) < 6
        n_alive = int(alive.sum(dim=1).max())
        rows_kept = min(1 << (-(-n_alive // 128) - 1).bit_length(), 8)
        rays_in, state, rng_in = cell_segments._compact(ro, so, rgo, alive,
                                                        rows_kept * 128)
        assert 0 < n_alive and bool((state[:, -1] >= 6).any())
    else:
        monkeypatch.setattr(tc, "launch_shape", lambda C, S, sms=0: (96, 3))
    args = (rows, tr.geom_row, rays_in, rng_in, state)
    outk = tc.cell_trace(*args, max_bounces=budget, **tr.kw)
    torch.cuda.synchronize()
    outp = tc.cell_trace_reference(*args, max_bounces=budget, **tr.kw)
    for k, p in zip(outk, outp):
        assert torch.equal(k, p)
    assert int(outk[1][:, 0].sum()) > 0
    if case == "budget_1":
        assert int(outk[1][:, 1].max()) == 1 and bool((outk[3] < 6).any())


@pytest.mark.cuda
def test_device_seeds_equal_host_seeds_on_card(cuda_device):
    """The int64 splitmix64 on the card, bit for bit the numpy hash, from
    2^32 on included, and the int32 view wraps as the host's does."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.ops import rng

    idx = np.concatenate([np.arange(1_000_000), np.arange(2**32 - 5000,
                                                          2**32 + 5000),
                          np.array([2**40, 2**63 - 1])]).astype(np.uint64)
    for seed in (0, 6, 2**31 - 1):
        got = rng.seed_fast_device(
            torch.from_numpy(idx.astype(np.int64)).to(cuda_device), seed)
        want = rng.seed_fast(idx, seed)
        np.testing.assert_array_equal(got.cpu().numpy().astype(np.uint32),
                                      want)
        np.testing.assert_array_equal(rng.as_int32_bits(got).cpu().numpy(),
                                      want.view(np.int32))
    cells = np.array([3, 4, 5, 70_000, 1])
    got = seeding.cell_seeds_device(cells, 2048, 3, 700_000, 9, cuda_device,
                                    cells_per_hash=2)
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        seeding.cell_seeds(cells, 2048, 3, 700_000, 9).view(np.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [np.arange(5, 29), np.array([0, 7, 3, 35])])
def test_device_built_batches_equal_host_batches_on_card(small, cuda_device,
                                                         cells):
    """The cell engine's blocks and the vector engine's ray state built on
    the card (contiguous cells made there, scattered ones copied from pinned
    memory) equal the host-seeded batch, field for field, at 200 rays per
    cell (padding) and at iteration 3."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding,
        trace_rows,
        trace_vector,
    )

    geom, cfg = small
    for rpc, it in ((200, 0), (256, 3)):
        b = seeding.build_ray_batch(geom, cfg, cell_ids=cells,
                                    rays_per_cell=rpc, iteration=it)
        want = trace_rows.blocks_to_device(*trace_rows.pack_ray_blocks(
            b, len(cells), rpc, -(-rpc // 128)), cuda_device)
        pts = seeding.to_device(seeding.shared_points(geom, cfg, rpc, it),
                                cuda_device)
        got = seeding.ray_blocks_device(pts, cells, it, 3 * M * N, cfg.seed)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
        want = trace_vector.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                           b["cid"], b["idx"], b["rng"],
                                           device=cuda_device)
        got = seeding.ray_state_device(pts, cells, it, 3 * M * N, cfg.seed)
        assert list(got) == list(want)
        assert all(got[k].dtype == want[k].dtype
                   and torch.equal(got[k], want[k]) for k in want)


@pytest.mark.cuda
def test_device_tail_equals_host_tail_on_card(small, cuda_device):
    """Host tail, pulled stack and device metrics of one Simulator on the
    card: histograms identical, efficiencies within 1e-6 relative, metrics
    within 1e-4; the card's run equals the CPU's."""
    geom, cfg = small
    pin = dict(spawn_mode="count", fold_iterations=True)
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=128, **pin)
    host = sim.run()
    stack = sim.run(histogram_device=True)
    dev = sim.run(histogram_device=True, metrics_device=True,
                  dense_metrics=True)
    cpu = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                             persistent_slots=128, **pin).run(
        evaluate_metrics=False)
    np.testing.assert_array_equal(host.histogram, cpu.histogram)
    for r in (stack, dev):
        assert r.histogram.is_cuda
        np.testing.assert_array_equal(r.histogram.cpu().numpy(),
                                      host.histogram)
        for k, v in host.efficiencies.items():
            assert abs(r.efficiencies[k] / v - 1) <= 1e-6, k
        for k in ("delta_e", "u_fov"):
            a, b = getattr(r.metrics, k), getattr(host.metrics, k)
            assert abs(a - b) <= 1e-4 * abs(b), k
    assert dev.dense.eye_luminance.shape == (51, 91)


@pytest.mark.cuda
@pytest.mark.parametrize("engine", ["persistent", "cell"])
def test_wavelengths_and_checkpoint_on_card(small, cuda_device, tmp_path,
                                            engine):
    """A ``wavelengths=(0, 2)`` run's rows are the full run's and row 1 is
    zero; two unfolded iterations checkpointed and resumed to three equal
    three uninterrupted."""
    geom, cfg = small
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                             persistent_slots=128, engine=engine,
                             spawn_mode="count", fold_iterations=False)
    kw = dict(rays_per_fov=128, evaluate_metrics=False, cells_per_batch=16)
    full = sim.run(num_iter=3, **kw)
    sub = sim.run(num_iter=3, wavelengths=(0, 2), **kw)
    for l in (0, 2):
        np.testing.assert_array_equal(sub.histogram[l], full.histogram[l])
    assert not sub.histogram[1].any()
    path = str(tmp_path / "ck.npz")
    sim.run(num_iter=2, checkpoint_path=path, **kw)
    resumed = sim.run(num_iter=3, checkpoint_path=path, **kw)
    np.testing.assert_array_equal(resumed.histogram, full.histogram)
    assert resumed.total_bounces == full.total_bounces
    assert resumed.rays_traced == full.rays_traced


# ---------------------------------------------------------------------------
# the vector and splitting engines (plain PyTorch on the card)


@pytest.mark.cuda
def test_vector_engine_on_card_matches_cpu(small, cuda_device):
    """The vector tracer on the card against the same code on the CPU: per
    ray, deposits and states agree for >= 99.5 % of the rays and bounces
    within 2 % (the P2 bar: the card's float32 and the CPU's may round a few
    operations differently); on the card the compacted trace equals the
    monolithic one bit for bit."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    geom, cfg = small
    sims = {d: pipeline.Simulator(cfg=cfg, geom=geom, engine="vector",
                                  device=d) for d in ("cpu", cuda_device)}
    cells = np.arange(3 * M * N)
    rays = {d: s._vector_rays(cells, 256, 0) for d, s in sims.items()}
    out = {d: sims[d].tracer(r) for d, r in rays.items()}
    (rc, bc), (rg, bg) = out["cpu"], out[cuda_device]
    for k in ("dep", "state"):
        assert (rg[k].cpu() == rc[k]).float().mean() >= 0.995, k
    assert abs(int(bg.sum()) - int(bc.sum())) <= 0.02 * int(bc.sum())
    sim = sims[cuda_device]
    h, b, _ = sim.trace_batch(cells, 256, 1)
    hc, bcmp, _ = sim.trace_batch_compacted(cells, 256, 1, segment_bounces=6)
    assert torch.equal(h, hc) and int(b) == int(bcmp)
    assert h.is_cuda and float(h.sum()) > 0
    assert tv.DEAD == 6


@pytest.mark.cuda
def test_splitting_engine_on_card_matches_cpu(cuda_device):
    """The per-cell splitting engine on the card against the CPU (4 cells,
    4 positions, threshold 1e-5): tiles within rtol 2e-4 / atol 1e-10, equal
    steps and peak widths, nothing truncated; on the card, chunks of 1 and 3
    cells give the tiles of one chunk of 4 bit for bit (deterministic
    accumulation)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
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
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding,
    )

    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4, seed=2)
    b = seeding.build_ray_batch(geom, cfg, cell_ids=np.arange(1),
                                rays_per_cell=4)
    seeds = {"x": b["x"], "y": b["y"], "ter": b["te"].real,
             "tei": b["te"].imag, "tmr": b["tm"].real, "tmi": b["tm"].imag}
    seeds = {k: torch.tensor(v, dtype=torch.float32) for k, v in seeds.items()}
    cells = np.array([1, 5, 9, 16])
    kw = dict(capacity=8192, weight_threshold=1e-5, max_steps=300)
    res = {d: splitting.run_splitting_cells(tables, tgeom, cfg, cells, seeds,
                                            device=d, **kw)
           for d in ("cpu", cuda_device)}
    c, g = res["cpu"], res[cuda_device]
    assert c.truncated == g.truncated == 0.0
    np.testing.assert_allclose(g.histogram, c.histogram, rtol=2e-4,
                               atol=1e-10)
    assert (g.steps, g.peak_live) == (c.steps, c.peak_live)
    assert g.out_coupled == pytest.approx(c.out_coupled, rel=1e-5)
    trace = splitting.make_splitting_cells_fn(tables, tgeom, cfg,
                                              device=cuda_device, **kw)
    whole = trace(cells, seeds)[0]
    parts = torch.cat([trace(cells[:1], seeds)[0], trace(cells[1:], seeds)[0]])
    assert torch.equal(whole, parts)


HYBRID_CFG = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=256,
                         num_iter=1, max_bounces=200, seed=0)


@pytest.fixture(scope="module")
def boosted_tail():
    """The JAX ``test_hybrid.py`` fixture on the card: one boost tail (8 x 6
    FoV x 3 wavelengths, 256 rays per FoV, count spawn with folding, 256
    slots, tiers up to 64x) and two independent long references of the
    selected cells at 256x and 512x the budget, whose seed tags lie above
    every tier's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid,
    )

    sim = pipeline.Simulator(cfg=HYBRID_CFG, device="cuda",
                             persistent_slots=256, spawn_mode="count",
                             fold_iterations=True)
    hy = hybrid.TailBoostHybrid(sim, tau_select=35.0, tau_target=25.0,
                                max_boost=64.0)
    n0 = tp.launch_counts["persistent_trace"]
    hy.build_tail(cells_per_batch=64)
    launches = tp.launch_counts["persistent_trace"] - n0
    sel, rows, sums, frag = hy.tail
    n1 = 256 * HYBRID_CFG.rays_per_fov
    n2 = 512 * HYBRID_CFG.rays_per_fov
    ref1_rows, ref1_sums, _ = hy._tail_pass(sel, n1)
    ref2_rows, ref2_sums, _ = hy._tail_pass(sel, n2)
    return dict(hy=hy, sel=sel, rows=rows, sums=sums, frag=frag, n1=n1,
                n2=n2, ref1_rows=ref1_rows, ref1_sums=ref1_sums,
                ref2_sums=ref2_sums, launches=launches)


@pytest.mark.cuda
def test_boost_tail_unbiased_means_match_on_card(boosted_tail):
    """The JAX ``test_boost_tail_unbiased_means_match``: each selected
    cell's boosted tile sum agrees with the pooled 256x + 512x reference
    within its standard error (|z| < 8, mean z within 5 / sqrt(C)), the
    overdispersion calibrated from the two references; the pilot and the
    tail ran on the kernel (the pilot's batches, one launch per tier)."""
    bt = boosted_tail
    pilot_batches = -(-3 * 8 * 6 // 64)
    assert bt["launches"] == pilot_batches + len(bt["frag"]["tiers"])
    sums, n1, n2 = bt["sums"], bt["n1"], bt["n2"]
    r1, r2 = bt["ref1_sums"], bt["ref2_sums"]
    n_cell = (np.asarray(bt["frag"]["cell_tier"]) * HYBRID_CFG.rays_per_fov
              * HYBRID_CFG.num_iter)
    assert n_cell.shape == sums.shape and (n_cell > 0).all()
    pooled = (r1 * n1 + r2 * n2) / (n1 + n2)
    rate = np.maximum(pooled, 1.0 / n2)
    phi = np.mean((r1 - r2) ** 2 / (rate * (1.0 / n1 + 1.0 / n2)))
    assert 0.2 < phi < 50.0, phi
    phi = max(phi, 1.0)
    z = (sums - pooled) / np.sqrt(
        phi * rate * (1.0 / n_cell + 1.0 / (n1 + n2)))
    assert np.abs(z).max() < 8.0, (z.min(), z.max(), phi)
    assert abs(z.mean()) < 5.0 / np.sqrt(len(z)), (z.mean(), phi)


@pytest.mark.cuda
def test_boost_rows_positive_where_reference_positive_on_card(boosted_tail):
    """The JAX ``test_boost_rows_positive_where_reference_positive``: the
    boosted rows are positive in every lambda-combined window the 256x
    reference reaches with at least 80 counts."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid,
    )

    bt = boosted_tail
    rows, ref_rows, n_ref = bt["rows"], bt["ref1_rows"], bt["n1"]
    assert bt["frag"]["tail_rays"] > 0
    sim = bt["hy"].sim
    _, n, m = hybrid._cell_lnm(bt["sel"], sim.M, sim.N)
    gid = n * sim.M + m
    gids = np.unique(gid)
    gi = np.searchsorted(gids, gid)
    comb = np.zeros((len(gids),) + rows.shape[1:])
    ref_comb = np.zeros_like(comb)
    np.add.at(comb, gi, rows)
    np.add.at(ref_comb, gi, ref_rows)
    substantial = ref_comb * n_ref >= 80.0
    assert substantial.any()
    assert (comb[substantial] > 0.0).all(), int(
        (comb[substantial] == 0).sum())


@pytest.mark.cuda
def test_apodization_gradients_on_card_equal_cpu(cuda_device):
    """The apodization loss and its gradients at ``test_opt.py``'s fixture
    (3 x 2 FoV, 8 rays, 1,024 slots, 32 steps, pupil term on) on the card
    against the plain run on the CPU: loss within 1e-5, gradients within
    rtol 1e-3 / atol 2e-6; two backward passes on the card bit for bit
    (gradients under deterministic algorithms)."""
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

    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=8,
                      max_bounces=64, rng_mode="fast", seed=5)
    got = {}
    for d in ("cpu", cuda_device, cuda_device):
        rays = opt._launch_rays(geom, cfg, 8, None, d)
        loss, _ = opt.make_apodization_loss(tables, tgeom, cfg, rays,
                                            capacity=1024, fixed_steps=32,
                                            pupil_bins=6)
        theta = {k: torch.full((n,), 2.0, device=d, requires_grad=True)
                 for k, n in (("fc", tgeom.num_fc), ("oc", tgeom.num_oc))}
        v, _ = opt.value_and_grad(loss, theta)
        got.setdefault(str(d), []).append(
            (v, {k: t.grad.cpu().numpy() for k, t in theta.items()}))
    (vc, gc), = got["cpu"]
    (vg, gg), (vg2, gg2) = got[str(cuda_device)]
    assert vg == pytest.approx(vc, rel=1e-5)
    for k in gc:
        assert np.abs(gg[k]).max() > 0, k
        np.testing.assert_allclose(gg[k], gc[k], rtol=1e-3, atol=2e-6,
                                   err_msg=k)
        np.testing.assert_array_equal(gg[k], gg2[k])
    assert vg == vg2


def _host_rows(geoms, seed, bins):
    """The host route's rows: synthetic LUTs -> cell tables -> rows."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
        packing,
    )

    return trace_rows.build_kernel_cell_params(
        packing.build_cell_tables_synthetic_batch(geoms, seed=seed),
        np.stack([g.eyebox_range for g in geoms]), bins)


@pytest.mark.cuda
@pytest.mark.parametrize("n_glass", [(1.9,), (1.9, 2.0), (1.9, 1.8)])
def test_cell_rows_kernel_equals_plain_and_host_on_card(cuda_device, n_glass):
    """The rows' kernel, its plain version on the card and the host route
    give the same rows, as int32; one launch counted.  n_glass 1.8 leaves
    an order evanescent at a corner of the 7 x 5 FoV: its NaN rows are NaN
    on the card and on the host alike, but the card's arithmetic does not
    keep x86's NaN sign and payload bits (ROADMAP F8), so there the host
    comparison holds every other entry bitwise and the NaNs in place."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        cell_rows,
    )

    geoms = [generate_geometry(dataclasses.replace(WaveguideDesign(),
                                                   n_glass=n), 7, 5)
             for n in n_glass]
    eb = np.stack([g.eyebox_range for g in geoms])
    inputs = cell_rows.synthetic_row_inputs(geoms, 21, pinned=True)
    n0 = tp.launch_counts["cell_rows"]
    got = cell_rows.cell_rows(inputs, eb, (80, 120), cuda_device)
    torch.cuda.synchronize()
    assert tp.launch_counts["cell_rows"] == n0 + 1
    assert got.is_cuda and got.shape == (len(geoms) * 105, 704)
    plain = cell_rows.cell_rows_reference(inputs, eb, (80, 120), cuda_device)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    host = _host_rows(geoms, 21, (80, 120))
    rows = got.cpu().numpy()
    nan = np.isnan(host)
    assert nan.any() == (1.8 in n_glass)
    np.testing.assert_array_equal(np.isnan(rows), nan)
    np.testing.assert_array_equal(rows.view(np.int32)[~nan],
                                  host.view(np.int32)[~nan])


@pytest.mark.cuda
@pytest.mark.parametrize("fov,designs,num_fc,num_oc", [
    ((1, 1), 1, 7, 6), ((5, 1), 1, 0, 0), ((3, 2), 1, 7, 6),
    ((1, 1), 17, 3, 2), ((7, 5), 2, 1, 6), ((4, 3), 3, 7, 0)])
def test_cell_rows_kernel_tiles_and_strips_on_card(cuda_device, fov, designs,
                                                   num_fc, num_oc):
    """Row counts off the kernel's tile of 32 (3, 15, 18, 51, 210 and 108),
    one design and several (cell-major rows across tiles), strip counts
    from none to the largest branch count (7 FC, 6 OC: 70 branches): the
    kernel's rows equal its plain version's as int32, and the host
    route's where it builds them (it needs a strip of each kind), and its
    grid is the Python rule's."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        cell_rows,
    )

    geoms = [generate_geometry(dataclasses.replace(
        WaveguideDesign(), num_fc=num_fc, num_oc=num_oc,
        lambda_ic=388.0 + 2.0 * d), *fov) for d in range(designs)]
    eb = np.stack([g.eyebox_range for g in geoms])
    inputs = cell_rows.synthetic_row_inputs(geoms, 5, pinned=True)
    total = designs * 3 * fov[0] * fov[1]
    n0 = tp.launch_counts["cell_rows"]
    got = cell_rows.cell_rows(inputs, eb, (80, 120), cuda_device)
    torch.cuda.synchronize()
    assert tp.launch_counts["cell_rows"] == n0 + 1
    assert got.shape == (total, 704)
    plain = cell_rows.cell_rows_reference(inputs, eb, (80, 120), cuda_device)
    assert torch.equal(got.view(torch.int32), plain.view(torch.int32))
    if num_fc and num_oc:
        host = _host_rows(geoms, 5, (80, 120))
        rows = got.cpu().numpy()
        nan = np.isnan(host)
        np.testing.assert_array_equal(np.isnan(rows), nan)
        np.testing.assert_array_equal(rows.view(np.int32)[~nan],
                                      host.view(np.int32)[~nan])
    shape = cell_rows.rows_shape(total)
    assert shape["grid"] == cell_rows.rows_grid(
        total, shape["blocks_per_sm"] * shape["sms"])
    assert shape["local_bytes"] == 0 and shape["blocks_per_sm"] >= 1


@pytest.mark.cuda
def test_synthetic_rows_built_only_by_the_kernel_on_card(small, cuda_device,
                                                         monkeypatch):
    """On the card, the kernel engines' Simulators and the sweep's chunks
    build synthetic rows through the rows' kernel alone: the host tables,
    the host row function and the plain version refuse to run, and the rows
    (and packed words) are the host route's."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        cell_rows, trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
        packing,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    geom, cfg = small
    host_rows_fn = trace_rows.build_kernel_cell_params

    def refuse(*a, **k):
        raise AssertionError("synthetic rows built off the kernel on cuda")

    for mod, name in ((pipeline, "build_cell_tables"),
                      (packing, "build_cell_tables"),
                      (packing, "build_cell_tables_synthetic_batch"),
                      (trace_rows, "build_kernel_cell_params"),
                      (cell_rows, "cell_rows_reference")):
        monkeypatch.setattr(mod, name, refuse)
    n0 = tp.launch_counts["cell_rows"]
    sims = [pipeline.Simulator(cfg=cfg, geom=geom, device=cuda_device,
                               engine=engine, **kw)
            for engine, kw in (("persistent", {}),
                               ("persistent", {"pers_accum_mode": "packed"}),
                               ("cell", {}))]
    designs = [WaveguideDesign(), dataclasses.replace(WaveguideDesign(),
                                                      lambda_ic=380.0)]
    chunk = design_sweep.prepare_chunk(designs, cfg, 128, lut_seed=4,
                                       packed=True, device=cuda_device)
    torch.cuda.synchronize()
    assert tp.launch_counts["cell_rows"] == n0 + 4
    assert sims[0].setup_timings["rows_ms"] > 0
    monkeypatch.undo()
    want = host_rows_fn(
        packing.build_cell_tables(geom, sims[0].luts), geom.eyebox_range,
        cfg.eyebox_bins)
    for sim in sims:
        assert sim.tracer.cell_params.is_cuda
        np.testing.assert_array_equal(
            sim.tracer.cell_params.view(torch.int32).cpu().numpy(),
            want.view(np.int32))
    words = trace_rows.pack_selection_params(want, sims[1].tgeom.num_fc,
                                             sims[1].tgeom.num_oc)
    np.testing.assert_array_equal(
        sims[1].tracer.cell_params_packed.cpu().numpy(), words)
    geoms = [generate_geometry(d, M, N) for d in designs]
    want = _host_rows(geoms, 4, cfg.eyebox_bins)
    assert chunk.cell_params.is_cuda and chunk.cell_params_packed.is_cuda
    np.testing.assert_array_equal(
        chunk.cell_params.view(torch.int32).cpu().numpy(), want.view(np.int32))
    np.testing.assert_array_equal(
        chunk.cell_params_packed.cpu().numpy(),
        trace_rows.pack_selection_params(want, chunk.tgeoms[0].num_fc,
                                         chunk.tgeoms[0].num_oc))


def _tail_histogram(device, shape=(3, 12, 16, 80, 120), seed=15):
    """A seeded float32 histogram with 20 % empty bins and an empty corner
    (eye position (0, 0) of FoV (0, 0) sees nothing)."""
    rng = np.random.default_rng(seed)
    h = rng.random(shape).astype(np.float32)
    h[h < 0.2] = 0.0
    h[:, 0, 0, :40, :40] = 0.0
    return torch.from_numpy(h).to(device)


def _window_case(case, device):
    """``(images, mask, stride, scale)`` of a window-sum case on the card:
    the tail histogram at both strides, the sweep's 128-lane tiles cut to
    120 with per-tile scales, odd shapes and discs, B = 1 and a B that
    fills no round, views whose strides or base break the bulk copies'
    16-byte rule, a disc row with an empty run, images staged in row
    bands; many units a block with fewer items than a warp (four windows
    an image, or one); a window row that fills one stage."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    kind, stride = case
    rng = np.random.default_rng([ord(c) for c in kind] + list(stride))

    def images(*shape):
        x = rng.random(shape).astype(np.float32) * 100.0
        x[x < 20.0] = 0.0
        return torch.from_numpy(x).to(device)

    def scales(n):
        return torch.from_numpy(rng.random(n).astype(np.float32) + 0.5).to(
            device)

    disc = metrics.pupil_mask(30)
    if kind == "histogram":
        return _tail_histogram(device), disc, stride, None
    if kind == "tiles_scaled":          # the sweep's per-design launch
        tiles = torch.zeros((48, 80, 128), device=device)
        tiles[:, :, :120] = _tail_histogram(device)[0, :3].reshape(48, 80,
                                                                   120)
        return tiles[:, :, :120], disc, stride, scales(48)
    if kind.startswith("odd_13x17_disc"):
        scaled = kind.endswith("_scaled")
        bins = int(kind.split("disc")[1].split("_")[0])
        return (images(5, 13, 17), metrics.pupil_mask(bins), stride,
                scales(5) if scaled else None)
    if kind == "odd_37x41_disc30":
        return images(4, 37, 41), disc, stride, None
    if kind == "odd_37x41_disc30_b6000":
        return images(6000, 37, 41), disc, stride, None
    if kind == "b1":
        return images(1, 80, 120), disc, stride, None
    if kind == "b2000":
        return images(2000, 80, 120), disc, stride, None
    if kind == "b1003_scaled":
        return images(1003, 80, 120), disc, stride, scales(1003)
    if kind == "row_stride_121":        # rows 484 B apart
        return images(50, 80, 121)[:, :, :120], disc, stride, None
    if kind == "base_offset":           # images 4 B past an aligned base
        flat = images(50 * 80 * 120 + 1)
        return flat[1:].view(50, 80, 120), disc, stride, scales(50)
    if kind == "empty_row":
        m = metrics.pupil_mask(9)
        m[4] = 0.0
        return images(6, 40, 44), m, stride, None
    if kind == "bands":                 # 300 x 256 does not fit twice
        return images(3, 300, 256), disc, stride, scales(3)
    if kind == "one_stage":             # 128 x 256 bins do not fit twice
        return images(3, 300, 256), metrics.pupil_mask(128), stride, None
    raise ValueError(kind)


WINDOW_CASES = [
    ("histogram", (8, 12)), ("histogram", (1, 1)),
    ("tiles_scaled", (8, 12)), ("tiles_scaled", (1, 1)),
    ("odd_13x17_disc1", (1, 1)), ("odd_13x17_disc5", (1, 1)),
    ("odd_13x17_disc5_scaled", (8, 12)), ("odd_13x17_disc5", (3, 5)),
    ("odd_13x17_disc1_scaled", (3, 5)), ("odd_37x41_disc30", (1, 1)),
    ("odd_37x41_disc30", (3, 5)), ("odd_37x41_disc30", (8, 12)),
    ("b1", (8, 12)), ("b1", (1, 1)), ("b1003_scaled", (8, 12)),
    ("row_stride_121", (8, 12)), ("row_stride_121", (1, 1)),
    ("base_offset", (8, 12)), ("base_offset", (1, 1)),
    ("empty_row", (1, 1)), ("empty_row", (2, 3)), ("empty_row", (3, 4)),
    ("bands", (1, 1)), ("bands", (8, 12)),
    ("b2000", (50, 90)), ("odd_37x41_disc30_b6000", (8, 12)),
    ("one_stage", (2, 2)),
]


@pytest.mark.cuda
@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=[f"{k}-{s[0]}x{s[1]}" for k, s in WINDOW_CASES])
def test_eye_perceive_kernel_equals_plain_version_on_card(cuda_device, case):
    """The perception kernel equals its plain version on the card bit for
    bit, with and without per-image scales (the sweep's Wald factors), on
    strided views (the sweep's 128-lane tiles cut to 120; rows or a base
    off the 16-byte grid, staged by loads), odd shapes and discs, a disc
    row with an empty run, B = 1, 1,003, 2,000 and 6,000, images staged
    in row bands or in one stage without a ring, and blocks that run many
    units with fewer items than a warp; one launch counted per call; the
    card's launch shape is the Python rule's."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    h, mask, stride, scale = _window_case(case, cuda_device)
    n0 = tp.launch_counts["eye_perceive"]
    got = metrics.pupil_window_sum(h, mask, stride, scale)
    torch.cuda.synchronize()
    assert tp.launch_counts["eye_perceive"] == n0 + 1
    want = metrics.eye_perceived_reference(h, mask, stride, scale)
    assert got.shape == want.shape and got.sum() > 0
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    shape = eye_tail.last_launch
    plan = eye_tail.window_sum_plan(*h.shape[-2:], *mask.shape, *stride,
                                    smem_limit=shape["smem_limit"])
    assert {k: shape[k] for k in plan if k in shape} == {
        k: plan[k] for k in plan if k in shape}
    assert shape["local_bytes"] == 0 and shape["blocks_per_sm"] >= 1
    # a ring's bulk copies where the base, the strides and the rows keep 16
    # bytes
    assert shape["bulk"] == (shape["stages"] > 1 and h.shape[-1] % 4 == 0
                             and case[0] not in ("row_stride_121",
                                                 "base_offset"))
    if case in (("b2000", (50, 90)), ("odd_37x41_disc30_b6000", (8, 12))):
        # more units a block than stages, fewer items a unit than a warp
        assert shape["units"] > shape["grid"] * shape["stages"]
        assert shape["active"] < 32 == shape["consumers"]
    if case[0] == "one_stage":
        assert shape["stages"] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("designs,with_image", [(1, True), (3, False)])
def test_colorimetry_kernel_within_bars_on_card(cuda_device, designs,
                                                with_image):
    """The colorimetry kernel against its plain version on the card: the
    metrics within 1e-5 relative, the image within rtol 1e-5 / atol 1e-6,
    ``u_eb``'s zeros equal; the design results independent of the other
    designs of the launch; one launch counted."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    perc = metrics.eye_perceived_torch(_tail_histogram(cuda_device))
    scales = torch.from_numpy(np.random.default_rng(4).random(
        (designs, 3, 12, 16, 1, 1)).astype(np.float32)).to(cuda_device)
    stack = (perc[None] * scales).contiguous()
    stack[-1, :, 2, 5] = 0.0
    inv_norm = metrics._inv_norm(5000.0)
    n0 = tp.launch_counts["colorimetry"]
    got = metrics.colorimetry_stack(stack, inv_norm, with_image)
    torch.cuda.synchronize()
    assert tp.launch_counts["colorimetry"] == n0 + 1
    want = metrics._make_eval_core(with_image)(stack, inv_norm)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    assert set(got) == set(want)
    for k in ("delta_e", "ratio_sum", "u_eb"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got["u_eb"] == 0, want["u_eb"] == 0)
    assert (got["u_eb"] == 0).any()
    if with_image:
        assert got["image"].shape == want["image"].shape
        np.testing.assert_allclose(got["image"], want["image"], rtol=1e-5,
                                   atol=1e-6)
    last = metrics.colorimetry_stack(stack[-1:].contiguous(), inv_norm,
                                     with_image)
    for k, v in last.items():
        np.testing.assert_array_equal(v.cpu().numpy()[0], got[k][-1])


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["one_position", "positions_off_32",
                                  "pixels_below_groups", "designs_8_image"])
def test_colorimetry_kernel_shapes_on_card(cuda_device, case):
    """The colorimetry kernel at shapes off its plan's tiles: one position,
    45 positions (a tile of 13), 4 pixels (fewer than a unit's 8 groups)
    and 8 designs with the image.  Within the bars of its plain version,
    ``u_eb``'s zeros equal; every design's outputs, the image included,
    equal its solo launch bit for bit."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    designs, fy, fx, epy, epx = {"one_position": (1, 12, 16, 1, 1),
                                 "positions_off_32": (2, 12, 16, 5, 9),
                                 "pixels_below_groups": (2, 2, 2, 7, 8),
                                 "designs_8_image": (8, 12, 16, 7, 8)}[case]
    rng = np.random.default_rng(24)
    stack = rng.random((designs, 3, fy, fx, epy, epx)).astype(np.float32)
    stack[stack < 0.1] = 0.0
    stack[-1, :, 0, 0, 0, 0] = 0.0          # a starved position
    stack = torch.from_numpy(stack).to(cuda_device)
    inv_norm = metrics._inv_norm(3.0)
    S, chunk = eye_tail.colorimetry_splits(epy * epx, fy * fx)
    assert (S - 1) * chunk < fy * fx <= S * chunk
    n0 = tp.launch_counts["colorimetry"]
    got = metrics.colorimetry_stack(stack, inv_norm, True)
    torch.cuda.synchronize()
    assert tp.launch_counts["colorimetry"] == n0 + 1
    want = metrics._make_eval_core(True)(stack, inv_norm)
    got = {k: v.cpu().numpy() for k, v in got.items()}
    want = {k: v.cpu().numpy() for k, v in want.items()}
    for k in ("delta_e", "ratio_sum", "u_eb"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=0)
    np.testing.assert_array_equal(got["u_eb"] == 0, want["u_eb"] == 0)
    assert (got["u_eb"] == 0).any()
    np.testing.assert_allclose(got["image"], want["image"], rtol=1e-5,
                               atol=1e-6)
    for d in range(designs):
        solo = metrics.colorimetry_stack(stack[d:d + 1].contiguous(),
                                         inv_norm, True)
        for k, v in solo.items():
            np.testing.assert_array_equal(v.cpu().numpy()[0].view(np.int32),
                                          got[k][d].view(np.int32))
    assert eye_tail.colorimetry_shape()["units_blocks_per_sm"] >= 5


def _split_fixture(capacity, per_cell):
    """The splitting tests' fixture (paper design, 3 x 2 FoV x 3
    wavelengths, 4 launch positions, threshold 1e-5): the per-cell trace on
    the card and the chunk's seeds, (4,) shared or (18, 4) per cell."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding, splitting,
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

    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4, seed=2)
    cells = np.arange(18)
    b = seeding.build_ray_batch(geom, cfg, cell_ids=cells if per_cell
                                else np.arange(1), rays_per_cell=4)
    shape = (18, 4) if per_cell else (4,)
    vals = (b["x"], b["y"], b["te"].real, b["te"].imag, b["tm"].real,
            b["tm"].imag)
    seeds = {k: torch.tensor(np.asarray(v).reshape(shape),
                             dtype=torch.float32)
             for k, v in zip(("x", "y", "ter", "tei", "tmr", "tmi"), vals)}
    trace = splitting.make_splitting_cells_fn(
        tables, build_trace_geometry(geom), cfg, capacity=capacity,
        weight_threshold=1e-5, max_steps=300, per_cell_seeds=per_cell,
        device="cuda")
    return trace, cells, seeds


@pytest.mark.cuda
@pytest.mark.parametrize("capacity,per_cell", [(8192, False), (8192, True),
                                               (64, False)])
def test_split_kernel_equals_plain_version_on_card(cuda_device, capacity,
                                                   per_cell):
    """The per-cell splitting kernel (one launch, counted) against its plain
    version on the same packed arguments: on the card per-cell steps, peak
    and stepped widths equal, truncation equal where 0 and else within
    1e-6, pruned and out-coupled weight within 1e-6 relative, tiles within
    rtol 1e-6 / atol 1e-12 with zeros at the same places; against the
    plain version on the CPU the tiles bit for bit.  At 64 slots the
    wavefronts truncate (peak above the capacity)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    trace, cells, seeds = _split_fixture(capacity, per_cell)
    a = trace.args(cells, seeds)
    n0 = tp.launch_counts["split_cells"]
    got = splitting.split_cells(a)
    torch.cuda.synchronize()
    assert tp.launch_counts["split_cells"] == n0 + 1
    for ref in (splitting.split_cells_reference(a),
                splitting.split_cells_reference(a.to("cpu"))):
        g = {f: getattr(got, f).to(ref.tiles.device)
             for f in ("tiles", "trunc", "pruned", "peak", "steps", "work")}
        for f in ("steps", "peak", "work"):
            assert torch.equal(g[f].long(), getattr(ref, f).long()), f
        assert torch.equal(g["trunc"] == 0, ref.trunc == 0)
        torch.testing.assert_close(g["trunc"], ref.trunc, rtol=1e-6, atol=0)
        torch.testing.assert_close(g["pruned"], ref.pruned, rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(g["tiles"].sum(dim=(1, 2)),
                                   ref.tiles.sum(dim=(1, 2)), rtol=1e-6,
                                   atol=0)
        torch.testing.assert_close(g["tiles"], ref.tiles, rtol=1e-6,
                                   atol=1e-12)
        assert torch.equal(g["tiles"] == 0, ref.tiles == 0)
    assert torch.equal(g["tiles"].view(torch.int32),
                       ref.tiles.view(torch.int32))
    assert got.tiles.sum() > 0
    if capacity == 64:
        assert int(got.peak.max()) > 64 and float(got.trunc.sum()) > 0
    else:
        assert float(got.trunc.sum()) == 0.0


@pytest.mark.cuda
def test_split_kernel_chunks_are_independent_on_card(cuda_device):
    """A cell's tile, ledgers and steps from the kernel do not depend on
    the other cells of its launch: chunks of 7, 7 and 4 cells give one
    18-cell chunk's outputs bit for bit, and a second launch repeats the
    first."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    trace, cells, seeds = _split_fixture(8192, False)
    whole = splitting.launch_split_cells(trace.args(cells, seeds))
    again = splitting.launch_split_cells(trace.args(cells, seeds))
    parts = [splitting.launch_split_cells(trace.args(cells[i:i + 7], seeds))
             for i in (0, 7, 14)]
    for f in ("tiles", "trunc", "pruned", "peak", "steps", "work"):
        cat = torch.cat([getattr(p, f) for p in parts])
        assert torch.equal(getattr(whole, f), cat), f
        assert torch.equal(getattr(whole, f), getattr(again, f)), f


_SPLIT_FIELDS = ("tiles", "trunc", "pruned", "peak", "steps", "work")


def _split_bits_equal(x, y) -> bool:
    """Every field of two ``SplitCellsOut`` equal bit for bit (on x's
    device)."""
    for f in _SPLIT_FIELDS:
        u, v = getattr(x, f), getattr(y, f).to(getattr(x, f).device)
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        if not torch.equal(u.long(), v.long()):
            return False
    return True


@pytest.mark.cuda
def test_split_kernel_crowded_bins_equal_plain_version_on_card(cuda_device):
    """A crowded fixture: 300 copies of one launch ray in every cell, so each
    position of a step is held by hundreds of slots and its deposits fall
    in one bin as one long run, across the passes of 256, 512 and 1,024
    slots (clusters of 1, 2 and 4) and the 8,192-slot cut.  Against the
    plain version on the card and the CPU: tiles, steps, peak and work bit
    for bit, the ledgers within 1e-6 relative, and the same outputs at
    every cluster size."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    trace, _, seeds = _split_fixture(8192, False)
    crowd = {k: v[:1].repeat(300) for k, v in seeds.items()}
    a = trace.args(np.array([0, 7, 15]), crowd)
    n0 = tp.launch_counts["split_cells"]
    got = splitting.split_cells(a)
    torch.cuda.synchronize()
    assert tp.launch_counts["split_cells"] == n0 + 1
    assert int(got.peak.max()) > 8192 and float(got.trunc.sum()) > 0
    for ref in (splitting.split_cells_reference(a),
                splitting.split_cells_reference(a.to("cpu"))):
        g = {f: getattr(got, f).to(ref.tiles.device) for f in _SPLIT_FIELDS}
        for f in ("tiles", "steps", "peak", "work"):
            u, v = g[f], getattr(ref, f)
            if u.dtype == torch.float32:
                u, v = u.view(torch.int32), v.view(torch.int32)
            assert torch.equal(u.long(), v.long()), f
        torch.testing.assert_close(g["trunc"], ref.trunc, rtol=1e-6, atol=0)
        torch.testing.assert_close(g["pruned"], ref.pruned, rtol=1e-6,
                                   atol=0)
    assert got.tiles.sum() > 0
    for q in splitting.CLUSTER_SIZES:
        assert _split_bits_equal(splitting.launch_split_cells(a, cluster=q),
                                 got), q


@pytest.mark.cuda
def test_split_kernel_many_waves_and_clusters_equal_on_card(cuda_device):
    """A chunk of 720 cells (the fixture's 18, forty times over) runs one
    block a cell in more waves than the card holds at once; a chunk of 4 of
    those cells runs each on a cluster of 4 blocks.  Every cell's outputs
    are the 18-cell chunk's bit for bit in both, and the large chunk equals
    the plain version on the card."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    trace, cells, seeds = _split_fixture(8192, False)
    base = splitting.launch_split_cells(trace.args(cells, seeds))
    many = np.tile(cells, 40)
    a = trace.args(many, seeds)
    big = splitting.launch_split_cells(a)
    torch.cuda.synchronize()
    shape = splitting.last_launch["split_cells"]
    assert shape["cluster"] == 1 and shape["grid"] > shape["resident_blocks"]
    assert shape["blocks_per_sm"] >= 2
    idx = torch.as_tensor(np.arange(len(many)) % len(cells),
                          device=cuda_device)
    for f in _SPLIT_FIELDS:
        u, v = getattr(big, f), getattr(base, f).index_select(0, idx)
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v), f
    ref = splitting.split_cells_reference(a)
    for f in ("tiles", "steps", "peak", "work"):
        u, v = getattr(big, f), getattr(ref, f)
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u.long(), v.long()), f
    four = np.array([2, 9, 11, 17])
    small = splitting.launch_split_cells(trace.args(four, seeds))
    torch.cuda.synchronize()
    assert splitting.last_launch["split_cells"]["cluster"] == 4
    pick = torch.as_tensor(four, device=cuda_device)
    for f in _SPLIT_FIELDS:
        u, v = getattr(small, f), getattr(big, f).index_select(0, pick)
        if u.dtype == torch.float32:
            u, v = u.view(torch.int32), v.view(torch.int32)
        assert torch.equal(u, v), f


# ---------------------------------------------------------------------------
# the vector engine's kernel (csrc/vector_trace.cu)


def _vector_fixture(n_designs: int, circle: bool):
    """``VectorTracer`` on the card over 1 or 3 designs (the paper design,
    then coupler periods at 392 and 380 nm; trace geometry simplified at
    1e-3, as the sweep builds it) and their (D, R) ray state: 4 x 3 FoV x 3
    wavelengths, 256 rays a cell, a 600-bounce bound."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding, trace_vector as tv,
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

    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=256,
                      max_bounces=600, seed=6,
                      ic_test="circle" if circle else "polygon")
    designs = [WaveguideDesign()] + [
        dataclasses.replace(WaveguideDesign(), lambda_ic=lam, lambda_oc=lam)
        for lam in (392.0, 380.0)]
    tables, tgeoms, states = [], [], []
    for d in designs[:n_designs]:
        geom = generate_geometry(d, num_fov_x=M, num_fov_y=N)
        tables.append(build_cell_tables(geom, make_synthetic_luts(geom)))
        tgeoms.append(build_trace_geometry(geom, simplify_tol=1e-3))
        b = seeding.build_ray_batch(geom, cfg)
        states.append(tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                        b["cid"], b["idx"], b["rng"],
                                        device="cuda"))
    tracer = tv.VectorTracer(tables, tgeoms, cfg, device="cuda")
    return cfg, tracer, tv.stack_ray_states(states)


@pytest.mark.cuda
@pytest.mark.parametrize("n_designs,circle", [(1, False), (3, False),
                                              (1, True), (3, True),
                                              (2, False), (2, True)])
def test_vector_kernel_equals_plain_version_on_card(cuda_device, n_designs,
                                                    circle):
    """The vector kernel (one launch a call, counted) against its plain
    version on the same arguments, on the card and on the CPU: every ray
    field, the per-design bounces and the steps bit for bit, in full mode
    with the whole budget, in full mode with a 3-step budget and in resume
    mode with the rest, which together equal the whole trace; the inputs
    are left as they were."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    cfg, tracer, rays = _vector_fixture(n_designs, circle)
    T, G = tracer.tables(), tracer.geometry()
    keep = {k: v.clone() for k, v in rays.items()}

    def args(r, mode, budget):
        return tv.vector_trace_args(
            r, T, G, mode=mode, max_bounces=budget, num_fc=tracer.num_fc,
            num_oc=tracer.num_oc, eyebox_bins=cfg.eyebox_bins, circle=circle)

    n0 = tp.launch_counts["vector_trace"]
    calls = [args(rays, "full", cfg.max_bounces), args(rays, "full", 3)]
    outs = [tv.vector_trace(a) for a in calls]
    calls.append(args(outs[1].rays, "resume", cfg.max_bounces - 3))
    outs.append(tv.vector_trace(calls[2]))
    torch.cuda.synchronize()
    assert tp.launch_counts["vector_trace"] == n0 + 3
    for got, a in zip(outs, calls):
        for ref in (tv.vector_trace_reference(a),
                    tv.vector_trace_reference(a.to("cpu"))):
            for k in tv.RAY_KEYS:
                assert got.rays[k].dtype == ref.rays[k].dtype, k
                assert torch.equal(got.rays[k].cpu(), ref.rays[k].cpu()), k
            assert torch.equal(got.bounces.cpu(), ref.bounces.cpu())
            assert int(got.steps) == int(ref.steps)
    whole, first, rest = outs
    for k in tv.RAY_KEYS:
        assert torch.equal(rest.rays[k], whole.rays[k]), k
    assert torch.equal(first.bounces + rest.bounces, whole.bounces)
    assert int(first.steps) == 3 and int(whole.steps) > 3
    assert (whole.rays["dep"] >= 0).sum() > 0
    assert whole.bounces.shape == (n_designs,)
    for k, v in keep.items():
        assert torch.equal(rays[k], v), k


def _vector_equal(got, ref) -> None:
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )

    for k in tv.RAY_KEYS:
        assert got.rays[k].dtype == ref.rays[k].dtype, k
        assert torch.equal(got.rays[k].cpu(), ref.rays[k].cpu()), k
    assert torch.equal(got.bounces.cpu(), ref.bounces.cpu())
    assert int(got.steps) == int(ref.steps)


@pytest.mark.cuda
@pytest.mark.parametrize("n_designs", [2, 3])
def test_vector_kernel_near_region_edges_on_card(cuda_device, n_designs):
    """Distinct designs with the polygon in-coupler, so the kernel reads
    each design's refined grid: full mode with 24 steps then resume mode
    with the rest equals the whole call; then every ray still alive after
    the 24 steps is moved to within 1e-4 mm of an edge of its design's r1,
    hull or r2 (where the grids leave the regions open and the warp's exact
    test decides) and resumed: each call one counted launch, every field,
    the bounces and the steps equal to the plain version's on the card and
    on the CPU bit for bit."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_vector as tv,
    )
    from test_torch_vector_subgrids import REGIONS, edge_points

    cfg, tracer, rays = _vector_fixture(n_designs, False)
    T, G = tracer.tables(), tracer.geometry()

    def args(r, mode, budget):
        return tv.vector_trace_args(
            r, T, G, mode=mode, max_bounces=budget, num_fc=tracer.num_fc,
            num_oc=tracer.num_oc, eyebox_bins=cfg.eyebox_bins, circle=False)

    n0 = tp.launch_counts["vector_trace"]
    whole = tv.vector_trace(args(rays, "full", cfg.max_bounces))
    first = tv.vector_trace(args(rays, "full", 24))
    rest = tv.vector_trace(args(first.rays, "resume", cfg.max_bounces - 24))
    torch.cuda.synchronize()
    assert tp.launch_counts["vector_trace"] == n0 + 3
    for k in tv.RAY_KEYS:
        assert torch.equal(rest.rays[k], whole.rays[k]), k
    assert torch.equal(first.bounces + rest.bounces, whole.bounces)
    assert int(first.steps) == 24
    rng = np.random.default_rng(12)
    moved = {k: v.clone() for k, v in first.rays.items()}
    R = moved["x"].shape[1]
    for d in range(n_designs):
        pts = [edge_points(G[key][d].cpu(), R // 8 + 1, rng)
               for key in REGIONS]
        x = torch.cat([p[0] for p in pts])
        y = torch.cat([p[1] for p in pts])
        pick = torch.from_numpy(rng.permutation(len(x))[:R])
        live = moved["state"][d] < 6
        moved["x"][d] = torch.where(live, x[pick].cuda(), moved["x"][d])
        moved["y"][d] = torch.where(live, y[pick].cuda(), moved["y"][d])
        assert int(live.sum()) > 0
    a = args(moved, "resume", cfg.max_bounces - 24)
    got = tv.vector_trace(a)
    torch.cuda.synchronize()
    assert tp.launch_counts["vector_trace"] == n0 + 4
    for ref in (tv.vector_trace_reference(a),
                tv.vector_trace_reference(a.to("cpu"))):
        _vector_equal(got, ref)
    assert int(got.bounces.sum()) > 0


# ---------------------------------------------------------------------------
# the global splitting engine's kernels (csrc/split_trace.cu)


def _trace_fixture(case):
    """``test_torch_opt.py``'s fixtures on the card as the kernels take
    them: the apodization fixture (3 x 2 FoV, 8 rays, 1,024 slots, 32
    fixed steps, hard binning; it truncates), the grating fixture with soft
    binning (4 x 3, 2,048 slots, 40 steps), the apodization fixture at 96
    slots, and the global engine's stop test (4,096 slots, at most 300
    steps); ``crowded``: 72 rays of 18 cells in 32,768 slots, stop-tested
    (``chip_smoke.py``'s phase 23 case: every table entry's run is long)."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        seeding, splitting, trace_vector as tv,
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

    if case == "crowded":
        cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4,
                          rng_mode="fast", seed=2)
        geom = generate_geometry(num_fov_x=3, num_fov_y=2)
        tables = build_cell_tables(geom, make_synthetic_luts(geom))
        b = seeding.build_ray_batch(geom, cfg)
        rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                                 b["idx"], b["rng"], device="cuda")
        trace = splitting.make_splitting_trace_fn(
            tables, build_trace_geometry(geom), cfg, capacity=1 << 15,
            weight_threshold=1e-5, max_steps=300, table_arg=True,
            device="cuda")
        return trace.args(rays, tv.as_tables(tables))
    soft = case == "soft"
    M, N = (4, 3) if soft else (3, 2)
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(
        geom, **({"seed": 77} if soft else {})))
    tgeom = build_trace_geometry(geom, simplify_tol=1e-3 if soft else 0.0)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=8,
                      max_bounces=64, rng_mode="fast", seed=5,
                      ic_test="circle" if soft else "polygon")
    b = seeding.build_ray_batch(geom, cfg)
    rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                             b["idx"], b["rng"], device="cuda")
    kw = {"hard": dict(capacity=1024, fixed_steps=32, weight_threshold=1e-4),
          "soft": dict(capacity=2048, fixed_steps=40, weight_threshold=1e-9,
                       soft_binning=True),
          "truncating": dict(capacity=96, fixed_steps=20,
                             weight_threshold=1e-4),
          "stop_test": dict(capacity=4096, max_steps=300,
                            weight_threshold=1e-4)}[case]
    trace = splitting.make_splitting_trace_fn(tables, tgeom, cfg,
                                              table_arg=True, device="cuda",
                                              **kw)
    return trace.args(rays, tv.as_tables(tables))


def _bits_equal(x, y):
    return torch.equal(x.contiguous().view(torch.int32),
                       y.contiguous().view(torch.int32))


def _assert_trace_calls_equal_plain(a, seed):
    """One forward and two backward calls of the kernels on ``a`` against
    the plain versions (see the test below); each call launches one kernel.
    Returns the forward's output."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting,
    )

    n0 = dict(tp.launch_counts)
    out = splitting.split_trace(a, keep_tape=True)
    torch.cuda.synchronize()
    assert tp.launch_counts["split_trace"] == n0["split_trace"] + 1
    assert (tp.launch_counts["split_trace_kernels"]
            == n0["split_trace_kernels"] + 1)
    ref = splitting.split_trace_reference(a, keep_tape=True)
    assert out.steps == ref.steps
    assert _bits_equal(out.hist, ref.hist)
    for k in ("trunc", "pruned"):
        assert float(getattr(out, k)) == pytest.approx(
            float(getattr(ref, k)), rel=1e-6), k
    widths = ref.tape.widths.cpu()
    assert torch.equal(out.tape.widths.cpu(), widths)
    for t, n in enumerate(widths.tolist()):
        assert _bits_equal(out.tape.fields[t, :, :n],
                           ref.tape.fields[t, :, :n]), t
    rng = np.random.default_rng(seed)
    gh = torch.from_numpy(rng.standard_normal(a.hist_size).astype(
        np.float32)).to(a.rec.device)
    got = splitting.split_trace_backward(a, out.tape, gh)
    again = splitting.launch_split_trace_backward(a, out.tape, gh)
    torch.cuda.synchronize()
    assert (tp.launch_counts["split_trace_backward"]
            == n0["split_trace_backward"] + 2)
    assert (tp.launch_counts["split_trace_backward_kernels"]
            == n0["split_trace_backward_kernels"] + 2)
    want = splitting.split_trace_backward_reference(a, ref.tape, gh)
    for x, y, z in zip(got, want, again):
        assert x.shape == y.shape
        assert _bits_equal(x, y)
        assert _bits_equal(x, z)
    assert float(got[0].abs().max()) > 0
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["hard", "soft", "truncating", "stop_test",
                                  "crowded"])
def test_split_trace_kernels_equal_plain_versions_on_card(cuda_device, case):
    """The global engine's forward kernel (one counted call, one kernel)
    against its plain version on the card: histogram, steps and tape (every
    kept slot's fields and provenance) bit for bit, the ledgers within 1e-6
    relative; the backward kernel (one counted call, one kernel) against
    the hand-written plain backward, bit for bit, and a second run
    identical.  Fixed-step and stop-tested traces alike; ``crowded`` adds
    the long runs of 18 cells sharing 32,768 slots."""
    out = _assert_trace_calls_equal_plain(_trace_fixture(case), 11)
    if case in ("hard", "truncating"):
        assert float(out.trunc) > 0


@pytest.mark.cuda
def test_split_trace_kernels_wrap_past_the_grid_on_card(cuda_device):
    """A wavefront wider than the co-resident grid (the apodization grid
    at 2 rays per FoV in 262,144 slots, 64 fixed steps): the grid-stride
    loops wrap, forward (children) and backward (contributions), and both
    kernels still equal their plain versions bit for bit."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.io import (
        load_or_synthesize,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt import (
        grating_opt as opt,
    )

    cfg = TraceConfig(num_fov_x=16, num_fov_y=12, rays_per_fov=2,
                      max_bounces=2048)
    geom = generate_geometry(num_fov_x=16, num_fov_y=12)
    tables = build_cell_tables(geom, load_or_synthesize(geom))
    rays = opt._launch_rays(geom, cfg, 2, None, cuda_device)
    trace = splitting.make_splitting_trace_fn(
        tables, build_trace_geometry(geom), cfg, capacity=1 << 18,
        fixed_steps=64, weight_threshold=1e-4, table_arg=True,
        device=cuda_device)
    out = _assert_trace_calls_equal_plain(
        trace.args(rays, tv.as_tables(tables)), 19)
    widest = int(out.tape.widths.max())
    threads = {k: v["grid"] * 256
               for k, v in splitting.last_launch.items()}
    assert 2 * widest > threads["split_trace"]
    assert 5 * widest > threads["split_trace_backward"]


@pytest.mark.cuda
def test_optimize_runs_the_trace_kernels_on_card(cuda_device):
    """``optimize_apodization`` on the card goes through the kernels: one
    forward call per Adam step and one for the final loss, one backward
    call per Adam step, and the loss falls."""
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

    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=8,
                      max_bounces=64, rng_mode="fast", seed=5)
    tp.reset_launch_counts()
    res = opt.optimize_apodization(geom, tables, build_trace_geometry(geom),
                                   cfg, rays_per_fov=8, steps=3,
                                   capacity=1024, fixed_steps=32,
                                   device=cuda_device)
    assert tp.launch_counts["split_trace"] == 4
    assert tp.launch_counts["split_trace_backward"] == 3
    assert tp.launch_counts["split_trace_kernels"] == 4
    assert tp.launch_counts["split_trace_backward_kernels"] == 3
    assert res.loss_history[-1] < res.loss_history[0]
