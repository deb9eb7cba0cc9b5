"""PyTorch port: packed selection, transit jumps and several cells per block
of the persistent trace, against the JAX persistent kernel.

The plain PyTorch version runs here; the JAX kernel runs in interpret mode
(``accum_mode="packed"``, no phase gating), once per mode: packed, packed +
jump by squaring, packed + jump by cos / sin, packed with two cells per
block, all in gens spawn with two generations per slot.  The CUDA kernel
itself runs only on a card: see ``test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU here)
import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import TraceConfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import generate_geometry
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    pipeline as jpipeline,
    seeding as jseeding,
    trace_pallas as jrows,
    trace_pallas_persistent as jpers,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import make_synthetic_luts
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
    build_cell_tables,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    build,
    pipeline,
    trace_persistent as tp,
    trace_rows,
)

# the fixture of tests/test_persistent.py: 36 cells of 128 slots, two
# generations per slot; every cell drains long before the bound
M, N, RT, MAX_ITERS = 4, 3, 1, 1300
C = 3 * M * N
BINS = (80, 120)
GENS = [2, 0]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread: the suite runs several workers on the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def rows():
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom, simplify_tol=0.05)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=600, rng_mode="fast", ic_test="circle",
                      seed=6)
    cp = jrows.build_kernel_cell_params(tables, geom.eyebox_range)
    gr = jrows.build_kernel_geom(tgeom)[None, :]
    rays, seeds = jrows.pack_ray_blocks(jseeding.build_ray_batch(geom, cfg),
                                        C, 128, RT)
    cpk = jpers.pack_selection_params(np.asarray(cp), tgeom.num_fc,
                                      tgeom.num_oc)
    ec = (len(tgeom.hull_hp), len(tgeom.r1_hp), len(tgeom.r2_hp))
    kw = dict(num_fc=tgeom.num_fc, num_oc=tgeom.num_oc, edge_counts=ec,
              eyebox_bins=BINS, max_iters=MAX_ITERS)
    return cfg, cp, gr, rays, seeds, cpk, kw


def _jax_trace(rows, rays, seeds, rt, **modes):
    """One JAX interpret kernel in packed selection, gens spawn."""
    cfg, cp, gr, _, _, cpk, kw = rows
    fn = jpers.make_persistent_trace_fn(
        cfg, kw["num_fc"], kw["num_oc"], rt, gens=2, interpret=True,
        phase_gating=False, max_iters=MAX_ITERS, edge_counts=kw["edge_counts"],
        accum_mode="packed", **modes)
    h, nb = fn(cp, gr, rays, seeds, jnp.asarray(GENS, jnp.int32),
               cell_params_packed=cpk)
    return np.asarray(h)[:, :, :BINS[1]], np.asarray(nb)


def _pair(rays, seeds):
    """Per-cell blocks -> blocks of two cells: the launch tiles stacked as
    row groups, the seeds by the contiguous reshape."""
    r = np.asarray(rays)
    return (np.ascontiguousarray(
                r.reshape(C // 2, 2, 6, RT, 128).transpose(0, 2, 1, 3, 4)
                .reshape(C // 2, 6, 2 * RT, 128)),
            np.asarray(seeds).reshape(C // 2, 2 * RT, 128))


def _plain(rows, ctrl=GENS, spawn_mode="gens", k=1, **modes):
    """The port's plain version in packed selection with the port's own
    packed words."""
    _, cp, gr, rays, seeds, _, kw = rows
    if k == 2:
        rays, seeds = _pair(rays, seeds)
    cpt, grt = trace_rows.rows_to_device(cp, gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays, seeds, "cpu")
    words = torch.from_numpy(trace_rows.pack_selection_params(
        np.asarray(cp), kw["num_fc"], kw["num_oc"]))
    h, nb = tp.persistent_trace(
        cpt, grt, rt, st, torch.tensor(ctrl, dtype=torch.int32),
        spawn_mode=spawn_mode, accum_mode="packed", cells_per_block=k,
        cell_params_packed=words, **kw, **modes)
    return h.numpy(), nb.numpy()


@pytest.fixture(scope="module")
def plain_packed(rows):
    return _plain(rows)


@pytest.fixture(scope="module", params=["pow2", "cos"])
def jump_runs(request, rows):
    """The JAX jump kernel and the plain version with the same phase."""
    phase = request.param
    _, _, _, rays, seeds, _, _ = rows
    hj, nbj = _jax_trace(rows, rays, seeds, RT, transit_jump=True,
                         jump_phase=phase)
    ht, nbt = _plain(rows, transit_jump=True, jump_phase=phase)
    return phase, hj, nbj, ht, nbt


def _special_rows(n=64):
    """Cell rows full of what rounding to bfloat16 must get right: ties (the
    16 low bits exactly 0x8000, after an even and after an odd mantissa),
    values just off a tie, both zeros, subnormals, the largest finite values
    (which round to infinity) and infinities."""
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2**32, size=(n, trace_rows.PC), dtype=np.uint64)
    bits = bits.astype(np.uint32)
    exp = (bits >> np.uint32(23)) & np.uint32(0xFF)
    bits[exp == 0xFF] &= np.uint32(0x807FFFFF)     # no NaN among the randoms
    bits[0::8] = (bits[0::8] & np.uint32(0xFFFF0000)) | np.uint32(0x8000)
    bits[1::8] = (bits[1::8] & np.uint32(0xFFFF0000)) | np.uint32(0x8001)
    bits[2::8] = (bits[2::8] & np.uint32(0xFFFF0000)) | np.uint32(0x7FFF)
    bits[3::8] &= np.uint32(0x807FFFFF)            # subnormals and zeros
    flat = bits.reshape(-1)
    flat[:8] = np.array([0x00000000, 0x80000000, 0x7F7FFFFF, 0xFF7FFFFF,
                         0x7F800000, 0xFF800000, 0x00000001, 0x80008000],
                        np.uint32)
    return bits.view(np.float32)


@pytest.mark.parametrize("source", ["fixture", "special"])
def test_pack_selection_params_equals_jax_words(rows, source):
    """(P1) The packed words are bitwise equal to the JAX packer's, and the
    branch-C words (17-24) of the IC and FC records are zero."""
    _, cp, _, _, _, cpk, kw = rows
    if source == "fixture":
        num_fc, num_oc, want = kw["num_fc"], kw["num_oc"], cpk
        cp = np.asarray(cp)
    else:
        num_fc, num_oc = 3, 2
        cp = _special_rows()
        want = jpers.pack_selection_params(cp, num_fc, num_oc)
    got = trace_rows.pack_selection_params(cp, num_fc, num_oc)
    n_rec = 1 + num_fc + num_oc
    assert got.dtype == np.int32
    assert got.shape == (cp.shape[0], n_rec * trace_rows.SEL_NW)
    np.testing.assert_array_equal(got, want)
    w = got.reshape(cp.shape[0], n_rec, trace_rows.SEL_NW)
    assert (w[:, :1 + num_fc, 17:] == 0).all()
    assert [r[0] for r in trace_rows.selection_row_offsets(num_fc, num_oc)] \
        == [r[0] for r in jpers.selection_row_offsets(num_fc, num_oc)]
    for mine, theirs in zip(trace_rows.selection_row_offsets(num_fc, num_oc),
                            jpers.selection_row_offsets(num_fc, num_oc)):
        assert mine[1] == theirs[1] and mine[2] == theirs[2]


def test_unpack_selection_reads_back_the_bf16_roundings(rows):
    """Widening the packed halves by a 16-bit shift gives the float32 value
    of each record parameter's bfloat16 rounding, at its cell-row offset."""
    _, cp, _, _, _, cpk, kw = rows
    cp = np.asarray(cp)
    table = tp.unpack_selection(torch.from_numpy(cpk), kw["num_fc"],
                                kw["num_oc"]).numpy()
    want = torch.from_numpy(cp).to(torch.bfloat16).to(torch.float32).numpy()
    for _, offs, qoffs in trace_rows.selection_row_offsets(kw["num_fc"],
                                                           kw["num_oc"]):
        for o in offs + (qoffs or []):
            np.testing.assert_array_equal(table[:, o], want[:, o])
    assert (table[:, trace_rows.PC:] == 0).all()


def _assert_close_to_jax(hj, nbj, ht, nbt, what):
    """Tolerances: bounces within 1 %, deposits within max(10, 2 %), spawned
    equal (gens spawn: every slot runs its quota).  XLA contracts the max
    chain's ``x*nx + (y*ny + mc)`` into fused multiply-adds, so a ray within
    an ulp of an edge may branch differently; says whether the run is exact.
    The iteration column is not compared.  Measured on this fixture: exact
    in packed, both jump phases and k = 2 (297 deposits, 58,465 bounces)."""
    assert ht.shape == hj.shape == (C, *BINS) and nbt.dtype == np.int32
    exact = (np.array_equal(hj, ht)
             and np.array_equal(nbj[:, [0, 2]], nbt[:, [0, 2]]))
    print(f"{what}: deposits {ht.sum():.0f} vs {hj.sum():.0f}, bounces "
          f"{int(nbt[:, 0].sum())} vs {int(nbj[:, 0].sum())}, "
          f"{'exact' if exact else 'not exact'}")
    b_j, b_t = int(nbj[:, 0].sum()), int(nbt[:, 0].sum())
    assert abs(b_t - b_j) <= 0.01 * b_j
    np.testing.assert_array_equal(nbt[:, 2], nbj[:, 2])
    d_j, d_t = hj.sum(), ht.sum()
    assert d_j > 100
    assert abs(d_t - d_j) <= max(10, 0.02 * d_j)
    assert (nbt[:, 3] == 0).all()


def test_plain_packed_matches_jax_kernel(rows, plain_packed):
    """Packed selection, single hops, against the JAX interpret kernel."""
    _, _, _, rays, seeds, _, _ = rows
    hj, nbj = _jax_trace(rows, rays, seeds, RT)
    _assert_close_to_jax(hj, nbj, *plain_packed, "packed")
    assert (plain_packed[1][:, 2] == 2 * RT * 128).all()


def test_plain_jump_matches_jax_jump_kernel(jump_runs):
    """Transit jumps in each phase against the JAX jump kernel of the same
    phase (the respawn schedule under jumps differs from single hops by
    design, so jump is held to jump)."""
    phase, hj, nbj, ht, nbt = jump_runs
    _assert_close_to_jax(hj, nbj, ht, nbt, f"jump {phase}")


def test_plain_jump_matches_plain_single_hop(jump_runs, plain_packed):
    """The JAX package's own bar for jumps against single hops, both packed:
    deposits within 5 %, bounces (skipped hops counted) within 0.2 %,
    strictly fewer iterations."""
    _, _, _, h1, nb1 = jump_runs
    h0, nb0 = plain_packed
    assert h0.sum() > 0
    assert abs(h1.sum() - h0.sum()) / h0.sum() < 0.05
    b0, b1 = int(nb0[:, 0].sum()), int(nb1[:, 0].sum())
    assert abs(b1 - b0) / b0 < 0.002, (b0, b1)
    assert nb1[:, 1].sum() < nb0[:, 1].sum()
    np.testing.assert_array_equal(nb1[:, 2], nb0[:, 2])


def test_jump_phases_agree(rows):
    """cos / sin against squaring: the same events and hop counts, deposits
    within 1e-4 (the JAX package's bar between its two phases)."""
    h1, nb1 = _plain(rows, transit_jump=True, jump_phase="cos")
    h2, nb2 = _plain(rows, transit_jump=True, jump_phase="pow2")
    assert int(nb2[:, 0].sum()) == int(nb1[:, 0].sum())
    assert abs(h2.sum() - h1.sum()) <= 1e-4 * h1.sum()


@pytest.mark.parametrize("spawn_mode,ctrl", [("count", [256, 0]),
                                             ("gens", GENS),
                                             ("gens", [1, 40])],
                         ids=["count", "gens", "saturating"])
def test_two_cells_per_block_equal_one_bitwise(rows, spawn_mode, ctrl):
    """Each cell of a two-cell block gives the tile, bounces and spawns of
    the same cell alone in its block; the iteration column is the block's:
    the larger of its two cells'."""
    h1, nb1 = _plain(rows, ctrl=ctrl, spawn_mode=spawn_mode)
    h2, nb2 = _plain(rows, ctrl=ctrl, spawn_mode=spawn_mode, k=2)
    assert h1.sum() > 0
    np.testing.assert_array_equal(h2, h1)
    np.testing.assert_array_equal(nb2[:, [0, 2, 3]], nb1[:, [0, 2, 3]])
    np.testing.assert_array_equal(
        nb2[:, 1], np.repeat(nb1[:, 1].reshape(-1, 2).max(axis=1), 2))


def test_two_cells_per_block_match_jax_kernel(rows):
    """k = 2 against the JAX interpret kernel with ``cells_per_block=2``."""
    _, _, _, rays, seeds, _, _ = rows
    hj, nbj = _jax_trace(rows, *_pair(rays, seeds), 2 * RT, cells_per_block=2)
    _assert_close_to_jax(hj, nbj, *_plain(rows, k=2), "k = 2")


@pytest.mark.parametrize("bad", [
    "jump_needs_packed", "jump_needs_k1", "k_needs_packed", "rows_split",
    "cells_split", "design_split", "packed_without_words",
    "words_without_packed", "words_shape", "bf16", "unknown_mode",
    "jump_phase", "k_range"])
def test_wrapper_refuses_bad_mode_combinations(rows, bad):
    _, cp, gr, rays, seeds, cpk, kw = rows
    n = 4
    cpt, grt = trace_rows.rows_to_device(np.asarray(cp)[:n], gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays[:n], seeds[:n], "cpu")
    words = torch.from_numpy(cpk[:n].copy())
    ctrl = torch.tensor(GENS, dtype=torch.int32)
    modes = dict(accum_mode="packed", cell_params_packed=words,
                 spawn_mode="gens")
    if bad == "jump_needs_packed":
        modes = dict(transit_jump=True)
    elif bad == "jump_needs_k1":
        modes.update(transit_jump=True, cells_per_block=2)
    elif bad == "k_needs_packed":
        modes = dict(cells_per_block=2)
    elif bad == "rows_split":       # RT = 1 row over 2 cells
        modes.update(cells_per_block=2)
        rt, st = rt[:2], st[:2]
    elif bad == "cells_split":      # 3 cells over blocks of 2
        modes.update(cells_per_block=2, cell_params_packed=words[:3])
        cpt = cpt[:3]
        rt = torch.cat([rt[:1], rt[:1]], dim=2)
        st = torch.cat([st[:2], st[:2]], dim=1)
    elif bad == "design_split":     # 2 designs of 3 cells, blocks of 2
        cpt = torch.cat([cpt, cpt[:2]])
        words = torch.cat([words, words[:2]])
        modes.update(cells_per_block=2, cell_params_packed=words)
        grt = grt.expand(2, -1).contiguous()
        rt = torch.cat([rt[:1], rt[:1]], dim=2)
        st = torch.cat([st[:3], st[:3]], dim=1)
    elif bad == "packed_without_words":
        modes.update(cell_params_packed=None)
    elif bad == "words_without_packed":
        modes.update(accum_mode="fma")
    elif bad == "words_shape":
        modes.update(cell_params_packed=words[:, :-25].contiguous())
    elif bad == "bf16":
        modes = dict(accum_mode="bf16")
    elif bad == "unknown_mode":
        modes = dict(accum_mode="half")
    elif bad == "jump_phase":
        modes.update(transit_jump=True, jump_phase="sin")
    elif bad == "k_range":
        modes.update(cells_per_block=tp.MAX_CPB + 1)
    match = "packed" if bad in ("packed_without_words", "words_without_packed",
                                "bf16") else None
    with pytest.raises(ValueError, match=match):
        tp.persistent_trace(cpt, grt, rt, st, ctrl, **kw, **modes)


def test_select_is_a_synonym_of_fma(rows):
    _, cp, gr, rays, seeds, _, kw = rows
    cpt, grt = trace_rows.rows_to_device(np.asarray(cp)[:4], gr, "cpu")
    rt, st = trace_rows.blocks_to_device(rays[:4], seeds[:4], "cpu")
    ctrl = torch.tensor(GENS, dtype=torch.int32)
    a = tp.persistent_trace(cpt, grt, rt, st, ctrl, spawn_mode="gens", **kw)
    b = tp.persistent_trace(cpt, grt, rt, st, ctrl, spawn_mode="gens",
                            accum_mode="select", **kw)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_block_layouts_that_fit_hopper_shared_memory():
    """With the paper design's 14 records (350 packed words; the 80 x 120
    histograms live in device memory): one cell of 2,048 slots fits, with
    jumps too; two cells of 1,024, four of 256 and now two of 2,048 fit; two
    cells of 4,096 do not, and the refusal states the bytes.  Thread groups
    stay whole warps, 512 threads at most."""
    pw = 14 * trace_rows.SEL_NW
    assert tp.check_block_fits(2048, 1, pw) == 87_448 + 272
    assert tp.check_block_fits(2048, 1, pw, True) == 87_960 + 272
    assert tp.check_block_fits(2048, 2, pw) == 91_696 + 272
    assert tp.check_block_fits(1024, 4, pw) == 59_232 + 272
    assert tp.check_block_fits(4096, 2, pw) == 173_616 + 272
    with pytest.raises(ValueError, match="337728 B"):
        tp.check_block_fits(8192, 2, pw)
    for k in range(1, tp.MAX_CPB + 1):
        for per_cell in range(128, 1025, 128):
            t = tp.block_threads(k * per_cell, k)
            assert t <= 512 and t % k == 0 and (t // k) % 32 == 0
            assert per_cell % (t // k) == 0
    with pytest.raises(ValueError):
        tp.block_threads(3 * 64, 3)


@pytest.fixture(scope="module")
def stacks():
    """The count-spawn, folded stack with packed selection, with and without
    jumps, through the port's Simulator, and with jumps through the JAX
    Simulator (interpret mode), at tests/test_pipeline.py's sizes."""
    cfg = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                      max_bounces=512, seed=0, rng_mode="fast")
    run = dict(num_iter=2, cells_per_batch=36, evaluate_metrics=False)
    port = {jump: pipeline.Simulator(
        cfg=cfg, device="cpu", geometry_simplify_tol=0.05,
        persistent_slots=256, spawn_mode="count", fold_iterations=True,
        pers_accum_mode="packed", pers_transit_jump=jump).run(**run)
        for jump in (False, True)}
    ref = jpipeline.Simulator(
        cfg=cfg, engine="pallas_persistent", interpret=True,
        geometry_simplify_tol=0.05, persistent_slots=256, spawn_mode="count",
        fold_iterations=True, pers_accum_mode="packed",
        pers_transit_jump=True).run(histogram_device=True, **run)
    return port, ref


def test_simulator_jump_stack_matches_jax_simulator(stacks):
    """Packed + jump by squaring + count spawn + folding: each colour's
    efficiency within 5 % and bounces per traced ray within 1 % of the JAX
    Simulator's; the nominal sample counts hold."""
    port, ref = stacks
    nominal = 4 * 3 * 3 * 2 * 256
    got = port[True]
    assert nominal <= got.rays_traced <= int(nominal * 1.25)
    for k, v in ref.efficiencies.items():
        assert v > 0
        assert abs(got.efficiencies[k] - v) / v < 0.05, k
    bpr_ref = ref.total_bounces / ref.rays_traced
    bpr = got.total_bounces / got.rays_traced
    print(f"jump stack: rays {got.rays_traced} vs {ref.rays_traced}, bounces "
          f"{got.total_bounces} vs {ref.total_bounces}")
    assert abs(bpr - bpr_ref) / bpr_ref < 0.01


def test_simulator_jump_stack_matches_packed_alone(stacks):
    """The JAX package's bar between its own two runs, for the port's."""
    port, _ = stacks
    for k, v in port[False].efficiencies.items():
        assert abs(port[True].efficiencies[k] - v) / max(v, 1e-12) < 0.05, k
    bpr0 = port[False].total_bounces / port[False].rays_traced
    bpr1 = port[True].total_bounces / port[True].rays_traced
    assert abs(bpr1 - bpr0) / bpr0 < 0.01
    assert (port[True].cell_stats[:, 1].sum()
            < port[False].cell_stats[:, 1].sum())


def test_simulator_cells_per_block_equals_one(stacks):
    """``pers_cells_per_block=2`` gives the packed run's histogram bit for
    bit, also when the last batch does not split into blocks."""
    port, _ = stacks
    cfg = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                      max_bounces=512, seed=0, rng_mode="fast")
    sim = pipeline.Simulator(cfg=cfg, device="cpu", geometry_simplify_tol=0.05,
                             persistent_slots=256, spawn_mode="count",
                             fold_iterations=True, pers_accum_mode="packed",
                             pers_cells_per_block=2)
    for cells_per_batch in (36, 7):
        res = sim.run(num_iter=2, cells_per_batch=cells_per_batch,
                      evaluate_metrics=False)
        np.testing.assert_array_equal(res.histogram, port[False].histogram)
        assert res.total_bounces == port[False].total_bounces


@pytest.mark.parametrize("kw", [
    dict(pers_transit_jump=True),
    dict(pers_transit_jump=True, pers_accum_mode="packed",
         pers_cells_per_block=2),
    dict(pers_cells_per_block=2),
    dict(pers_accum_mode="bf16"),
    dict(pers_transit_jump=True, pers_accum_mode="packed",
         pers_jump_phase="sin")],
    ids=["jump_fma", "jump_k2", "k2_fma", "bf16", "phase"])
def test_simulator_refuses_what_the_jax_simulator_refuses(kw):
    with pytest.raises(ValueError):
        pipeline.Simulator(cfg=TraceConfig(num_fov_x=2, num_fov_y=2,
                                           rays_per_fov=128),
                           device="cpu", **kw)


@pytest.mark.parametrize("cfg_kw,k", [
    (dict(rng_mode="parity"), 2), (dict(shared_pupil_samples=False), 2),
    (dict(), 0), (dict(), -2)],
    ids=["rng_parity", "own_pupil_samples", "k0", "k_negative"])
def test_simulator_never_quietly_runs_one_cell_per_block(cfg_kw, k):
    """Several cells per block off the shared-pupil, fast-seed path, or a
    count below 1, is refused at construction, not run with k = 1."""
    cfg = TraceConfig(num_fov_x=2, num_fov_y=2, rays_per_fov=128, **cfg_kw)
    with pytest.raises(ValueError, match="cells_per_block"):
        pipeline.Simulator(cfg=cfg, device="cpu", pers_accum_mode="packed",
                           pers_cells_per_block=k)


def test_wrapper_constants_are_the_kernels():
    """The wrapper's block-cell limit, shared-memory words and static
    counters are those of the CUDA source."""
    src = (build.CSRC / "persistent_trace.cu").read_text()
    common = (build.CSRC / "trace_common.cuh").read_text()
    assert f"constexpr int MAX_CPB = {tp.MAX_CPB};" in src
    assert f"constexpr int STATE_WORDS = {tp._STATE_WORDS};" in src
    assert f"constexpr int MAX_EDGES = {trace_rows.MAX_EDGES};" in common
    assert "JUMP_WORDS = 5 * MAX_EDGES + 8;" in src
    assert tp._JUMP_WORDS == 5 * trace_rows.MAX_EDGES + 8
    for counters in ("s_live[3][MAX_CPB]", "s_resp[3][MAX_CPB]",
                     "s_spawned[MAX_CPB]", "s_bounces[MAX_CPB]", "s_ctrl[2]"):
        assert f"__shared__ int {counters};" in src
    assert tp._STATIC_SMEM == 272 >= (3 + 3 + 1 + 1) * 4 * tp.MAX_CPB + 2 * 4


def test_cli_accum_mode_packed(tmp_path, capsys, monkeypatch):
    """``simulate --accum-mode packed`` runs the packed stack; the parser
    takes the JAX CLI's three choices."""
    monkeypatch.chdir(tmp_path)   # the default --image writes here
    argv = ["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y", "2",
            "--rays-per-fov", "128", "--num-iter", "1", "--max-bounces", "200",
            "--slots", "128"]
    assert cli.main(argv + ["--accum-mode", "packed"]) == 0
    assert "Rays traced" in capsys.readouterr().out
    assert cli.build_parser().parse_args(argv).accum_mode == "fma"
    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(argv + ["--accum-mode", "bf16"])
