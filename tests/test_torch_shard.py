"""PyTorch port: sharding over a ``torch.distributed`` device mesh
(``parallel/shard.py``), ``Simulator(mesh=)`` and the sweep's mesh, against
one rank and against the JAX package's ``parallel/shard.py``.

One world of 4 spawned gloo ranks on the CPU (a ``FileStore`` under the
test's temporary directory, one torch thread a rank, a 120 s bound on the
group's collectives and on the whole world) runs every multi-rank check on a
2 x 2 ``(cells, samples)`` mesh and its 2-rank sub-meshes; the ranks also
compute the one-rank references (split among them), so the comparisons are
bit for bit.  The fixtures are those of ``tests/test_shard.py`` and
``__graft_entry__.dryrun_multichip``.  JAX is imported only by the tests
that compare with it (the ranks import this module).
"""

import dataclasses
import functools
import hashlib
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig, WaveguideDesign,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline, seeding, trace_persistent, trace_rows, trace_vector,
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
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel import (
    shard,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel.spawn import (
    run_ranks,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    run_design_sweep_persistent,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.utils import (
    load_checkpoint,
)

TIMEOUT_S = 120.0


# ---------------------------------------------------------------------------
# fixtures, built the same way in the ranks and in the test process


def _k1(M, N, max_bounces, seed, gens, max_iters, accum_mode="fma"):
    """The persistent trace's inputs at a ``tests/test_shard.py`` fixture:
    rows, the per-cell launch tiles and seeds (numpy seeds too) and the
    plain trace with its keywords bound."""
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tg = build_trace_geometry(geom, simplify_tol=0.05)
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=128,
                      max_bounces=max_bounces, rng_mode="fast",
                      ic_test="circle", seed=seed)
    n_cells = 3 * M * N
    cp_np = trace_rows.build_kernel_cell_params(tables, geom.eyebox_range)
    rays_np, rng_np = trace_rows.pack_ray_blocks(
        seeding.build_ray_batch(geom, cfg), n_cells, 128, 1)
    rays_in, rng_in = trace_rows.blocks_to_device(rays_np, rng_np, "cpu")
    out = dict(
        cp=torch.from_numpy(cp_np),
        gr=torch.from_numpy(trace_rows.build_kernel_geom(tg)[None]),
        rays=rays_in, rng=rng_in, rng_np=rng_np,
        ctrl=torch.tensor([gens, 0], dtype=torch.int32),
        fn=functools.partial(
            trace_persistent.persistent_trace, num_fc=tg.num_fc,
            num_oc=tg.num_oc, edge_counts=trace_rows.edge_counts(tg),
            eyebox_bins=cfg.eyebox_bins, max_iters=max_iters,
            spawn_mode="gens", accum_mode=accum_mode))
    if accum_mode == "packed":
        out["cpk"] = torch.from_numpy(trace_rows.pack_selection_params(
            cp_np, tg.num_fc, tg.num_oc))
    return out


def _seed_blocks(rng_np, step, n):
    """``n`` distinct seed blocks: the fixture's seeds plus step * (d + 1)
    in uint32, as int32 bits."""
    blocks = np.stack([rng_np + np.uint32(step * (d + 1)) for d in range(n)])
    return torch.from_numpy(blocks.view(np.int32))


def _vector_setup():
    """``tests/test_shard.py``'s ``setup`` fixture: 4 x 3 FoV, 64 rays, 300
    bounces, seed 11."""
    geom = generate_geometry(num_fov_x=4, num_fov_y=3)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    cfg = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=64,
                      max_bounces=300, rng_mode="fast", seed=11)
    return tables, tgeom, cfg, seeding.build_ray_batch(geom, cfg)


def _vector_sharded(mesh, setup):
    tables, tgeom, cfg, batch = setup
    padded = shard.pad_rays_to(batch, mesh.size())
    rays = trace_vector.make_ray_state(
        padded["x"], padded["y"], padded["te"], padded["tm"], padded["cid"],
        padded["idx"], padded["rng"], device="cpu")
    hist, bounces = shard.make_sharded_trace_fn(tables, tgeom, cfg, mesh)(
        shard.shard_ray_batch(rays, mesh))
    return hist.numpy(), int(bounces)


def _vector_whole(setup):
    tables, tgeom, cfg, batch = setup
    rays = trace_vector.make_ray_state(
        batch["x"], batch["y"], batch["te"], batch["tm"], batch["cid"],
        batch["idx"], batch["rng"], device="cpu")
    rays_f, bounces = trace_vector.make_trace_fn(tables, tgeom, cfg,
                                                 device="cpu")(rays)
    hist = trace_vector.deposits_to_histogram(
        rays_f["dep"], rays_f["cid"], 3, cfg.num_fov_x, cfg.num_fov_y,
        *cfg.eyebox_bins)
    return hist.numpy(), int(bounces)


def _sweep_designs():
    """``__graft_entry__.dryrun_multichip``'s 16 coupler periods."""
    return [dataclasses.replace(WaveguideDesign(), lambda_ic=float(p),
                                lambda_oc=float(p))
            for p in np.linspace(370.0, 400.0, 16)]


SWEEP_KW = dict(cfg=TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=128,
                                max_bounces=48, seed=0),
                spawn_iters=0, spawn_mode="count", slots=128,
                designs_per_batch=6, keep_histograms=[3, 13],
                evaluate_metrics=True, device="cpu")


def _sweep_out(r):
    return dict(eff=r.efficiencies, bounces=r.bounces, hist=r.histograms,
                metrics=[(m.delta_e, m.u_fov, m.u_eyebox) for m in r.metrics])


def _catch(fn, *args, **kw):
    """The message of the ValueError ``fn`` raises (None if it returns)."""
    try:
        fn(*args, **kw)
    except ValueError as e:
        return str(e)
    return None


GUARD_CASES = [
    # (wrapper, cells, designs, ray rows, rng leading shape, packed)
    ("cell", 7, 1, 7, (7,), False),
    ("cell", 12, 3, 3, (12,), False),
    ("cell", 8, 2, 8, (8,), False),
    ("cell", 8, 1, 4, (8,), False),
    ("cell", 8, 1, 1, (4,), False),
    ("cell", 8, 1, 1, (3,), False),
    ("cell", 8, 1, 1, (8,), True),
    ("sample", 8, 1, 1, (1, 8), False),
    ("2d", 8, 2, 2, (2, 8), False),
    ("2d", 7, 1, 1, (2, 7), False),
    ("2d", 8, 1, 1, (1, 8), False),
]


def _guard_inputs(case, lib):
    """Numpy (JAX) or torch (port) inputs of a guard case: only the shapes
    matter, every wrapper checks them before it traces."""
    _, C, D, nr, rng_shape, _ = case
    arrays = (np.zeros((C, 4), np.float32), np.zeros((D, 3), np.float32),
              np.zeros((nr, 6, 1, 128), np.float32),
              np.zeros(rng_shape + (1, 128), np.int32),
              np.zeros(2, np.int32))
    return arrays if lib == "np" else tuple(torch.from_numpy(a) for a in arrays)


def _guards(mesh, make, lib):
    """Each guard case's message on a 2 x 2 (cells, samples) mesh."""
    out = []
    for case in GUARD_CASES:
        kind, *_, packed = case
        wrap = {"cell": lambda: make["cell"](None, mesh, axis="cells",
                                             packed=packed),
                "sample": lambda: make["sample"](None, mesh, axis="samples"),
                "2d": lambda: make["2d"](None, mesh)}[kind]()
        out.append(_catch(wrap, *_guard_inputs(case, lib)))
    return out


# ---------------------------------------------------------------------------
# the world of 4 ranks


def _digest(a) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


# the rank that computes each one-rank reference (they share no collective,
# so the four ranks split them)
REF_RANK = {"cells_fma": 0, "cells_packed": 0, "samples": 1, "2d": 1,
            "simulator": 2, "sweep": 2, "sweep_padded": 3, "vector": 3}


def _world_checks(rank: int, world: int, workdir: str) -> dict:
    """Every rank: the sharded results (rank 0 returns them, the others
    their digests) and, after them (a collective waits for its slowest
    rank), the one-rank references ``REF_RANK`` gives it."""
    mesh = shard.make_mesh((2, 2), ("cells", "samples"), "cpu",
                           timeout_s=TIMEOUT_S)
    cells = mesh["cells"]
    out = {"coord": tuple(mesh.get_coordinate())}
    refs = {}   # name -> a function computing the one-rank reference

    # ---- cell axis: the plain persistent trace, per-cell and shared tiles
    for mode in ("fma", "packed"):
        f = _k1(4, 2, 500, 9, 2, 1100, accum_mode=mode)
        kw = {"cell_params_packed": f["cpk"]} if mode == "packed" else {}
        traced = shard.make_sharded_cell_trace_fn(
            f["fn"], mesh, axis="cells", packed=mode == "packed")
        t, nb = traced(f["cp"], f["gr"], f["rays"], f["rng"], f["ctrl"], **kw)
        ts, nbs = traced(f["cp"], f["gr"], f["rays"][:1], f["rng"],
                         f["ctrl"], **kw)
        out[f"cells_{mode}"] = [(t.numpy(), nb.numpy()),
                                (ts.numpy(), nbs.numpy())]
        refs[f"cells_{mode}"] = functools.partial(
            lambda f, kw: tuple(x.numpy() for x in f["fn"](
                f["cp"], f["gr"], f["rays"], f["rng"], f["ctrl"], **kw)),
            f, kw)

    # ---- sample axis (2 seed blocks over samples) and both axes (cells x
    # samples on the 2 x 2 mesh)
    for name, fix, step, wrap in (
            ("samples", (2, 2, 500, 9, 1, 1100), 17,
             lambda fn: shard.make_sample_sharded_cell_trace_fn(
                 fn, mesh, axis="samples")),
            ("2d", (2, 2, 400, 11, 1, 900), 23,
             lambda fn: shard.make_2d_sharded_cell_trace_fn(fn, mesh))):
        f = _k1(*fix)
        blocks = _seed_blocks(f["rng_np"], step, 2)
        t, nb = wrap(f["fn"])(f["cp"], f["gr"], f["rays"], blocks, f["ctrl"])
        out[name] = (t.numpy(), nb.numpy())
        refs[name] = functools.partial(_seed_block_sums, f, blocks)

    # ---- Simulator(mesh=): 4 x 2 FoV, 128 rays, 128 slots, seed 5
    cfg = TraceConfig(num_fov_x=4, num_fov_y=2, rays_per_fov=128,
                      max_bounces=500, rng_mode="fast", ic_test="circle",
                      seed=5)
    geom = generate_geometry(num_fov_x=4, num_fov_y=2)

    def simulate(m):
        r = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                               persistent_slots=128, mesh=m).run(
            rays_per_fov=128, num_iter=1, evaluate_metrics=False,
            cells_per_batch=24)
        return r.histogram, r.total_bounces, r.cell_stats

    out["simulator"] = simulate(cells)
    refs["simulator"] = functools.partial(simulate, None)
    # with a mesh, rank 0 alone writes the checkpoint
    r = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                           persistent_slots=128, mesh=cells).run(
        rays_per_fov=128, num_iter=2, evaluate_metrics=False,
        cells_per_batch=24, checkpoint_path=str(Path(workdir) / "mesh.npz"))
    out["checkpoint"] = (r.histogram, r.total_bounces)

    # ---- the sweep: 16 designs in chunks of 6, whole designs per rank; 3
    # designs over 2 ranks: the chunk repeats its last design on rank 1
    designs = _sweep_designs()
    for name, ds, kw in (("sweep", designs, SWEEP_KW),
                         ("sweep_padded", designs[:3],
                          dict(SWEEP_KW, keep_histograms=[2]))):
        out[name] = _sweep_out(run_design_sweep_persistent(ds, mesh=cells,
                                                           **kw))
        refs[name] = functools.partial(
            lambda ds, kw: _sweep_out(run_design_sweep_persistent(ds, **kw)),
            ds, kw)

    # ---- the ray axis: 2 ranks (the cells sub-mesh) and the 2 x 2 mesh
    setup = _vector_setup()
    out["vector"] = [_vector_sharded(cells, setup),
                     _vector_sharded(mesh, setup)]
    refs["vector"] = functools.partial(_vector_whole, setup)

    # ---- guards: the wrappers' refusals
    out["guards"] = _guards(mesh, {
        "cell": shard.make_sharded_cell_trace_fn,
        "sample": shard.make_sample_sharded_cell_trace_fn,
        "2d": shard.make_2d_sharded_cell_trace_fn}, "torch")
    if rank:
        # the other ranks' results are held to rank 0's by digest
        out = {k: v if k in ("coord", "guards") else _tree_digest(v)
               for k, v in out.items()}
    return {"sharded": out, "refs": {k: fn() for k, fn in refs.items()
                                     if REF_RANK[k] == rank}}


def _seed_block_sums(f, blocks):
    """The one-rank runs of each seed block, summed."""
    parts = [f["fn"](f["cp"], f["gr"], f["rays"], blocks[d], f["ctrl"])
             for d in range(len(blocks))]
    return (sum(p[0] for p in parts).numpy(),
            sum(p[1] for p in parts).numpy())


def _tree_digest(v) -> str:
    return _digest(np.concatenate([np.ravel(np.asarray(x, float))
                                   for x in _leaves(v)]))


def _ref(world, name):
    return world[REF_RANK[name]]["refs"][name]


def _leaves(v):
    if isinstance(v, dict):
        for x in v.values():
            yield from _leaves(x)
    elif isinstance(v, (list, tuple)):
        for x in v:
            yield from _leaves(x)
    else:
        yield v


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    return tmp_path_factory.mktemp("world")


@pytest.fixture(scope="module")
def world(world_dir):
    return run_ranks(_world_checks, 4, (str(world_dir),), timeout_s=TIMEOUT_S,
                     workdir=str(world_dir))


def test_every_rank_returns_the_same_results(world):
    out = [r["sharded"] for r in world]
    assert [o["coord"] for o in out] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    want = {k: _tree_digest(v) for k, v in out[0].items()
            if k not in ("coord", "guards")}
    for o in out[1:]:
        assert {k: v for k, v in o.items()
                if k not in ("coord", "guards")} == want
        assert o["guards"] == out[0]["guards"]


@pytest.mark.parametrize("mode", ["fma", "packed"])
def test_cell_sharded_trace_equals_one_rank(world, mode):
    """Cells over the 2-rank cells axis, per-cell tiles and one shared
    tile, equal the unsharded plain trace tile for tile (the fixture of
    ``test_sharded_persistent_cells_bitwise`` / ``..._packed_bitwise``)."""
    (t, nb), (ts, nbs) = world[0]["sharded"][f"cells_{mode}"]
    t1, nb1 = _ref(world, f"cells_{mode}")
    np.testing.assert_array_equal(t, t1)
    np.testing.assert_array_equal(nb, nb1)
    np.testing.assert_array_equal(ts, t1)
    np.testing.assert_array_equal(nbs, nb1)
    assert t.shape == (24, 80, 120) and t.sum() > 0


@pytest.mark.parametrize("kind", ["samples", "2d"])
def test_sample_and_2d_sharded_traces_equal_the_one_rank_sums(world, kind):
    """Two seed blocks over the samples axis (and cells x samples on the
    2 x 2 mesh) equal the sum of the two one-rank runs, bitwise."""
    t, nb = world[0]["sharded"][kind]
    t_sum, nb_sum = _ref(world, kind)
    np.testing.assert_array_equal(t, t_sum)
    np.testing.assert_array_equal(nb, nb_sum)
    assert t.shape == (12, 80, 120) and t.sum() > 0


def test_simulator_mesh_equals_one_rank(world):
    """``Simulator(mesh=)`` on the 2-rank cells axis equals the mesh-less
    Simulator bit for bit (``test_simulator_mesh_persistent``'s fixture)."""
    h, b, stats = world[0]["sharded"]["simulator"]
    h1, b1, stats1 = _ref(world, "simulator")
    np.testing.assert_array_equal(h, h1)
    np.testing.assert_array_equal(stats, stats1)
    assert b == b1 and h.sum() > 0


@pytest.mark.parametrize("which,designs", [("sweep", 16),
                                           ("sweep_padded", 3)])
def test_sweep_mesh_equals_one_rank(world, which, designs):
    """The 16-design sweep over 2 ranks (chunks of 6, whole designs per
    rank), and 3 designs (rank 1 traces the last one twice), are bitwise the
    one-rank sweep: efficiencies, bounces, metrics and kept histograms."""
    m, one = world[0]["sharded"][which], _ref(world, which)
    np.testing.assert_array_equal(m["eff"], one["eff"])
    np.testing.assert_array_equal(m["bounces"], one["bounces"])
    np.testing.assert_array_equal(m["hist"], one["hist"])
    assert m["metrics"] == one["metrics"]
    assert m["eff"].shape == (designs, 3) and (m["eff"] > 0).all()
    assert m["hist"].shape[0] == (2 if designs == 16 else 1)


def test_mesh_checkpoint_is_the_run(world, world_dir):
    """With a mesh, rank 0 writes the checkpoint: the run's histogram,
    bounces and its two iterations (relaunched, the default)."""
    hist, bounces = world[0]["sharded"]["checkpoint"]
    cfg = TraceConfig(num_fov_x=4, num_fov_y=2, rays_per_fov=128,
                      max_bounces=500, rng_mode="fast", ic_test="circle",
                      seed=5)
    h, done, b = load_checkpoint(str(world_dir / "mesh.npz"),
                                 WaveguideDesign(), cfg)
    np.testing.assert_array_equal(h, hist)
    assert (done, b) == (2, bounces) and h.sum() > 0


@pytest.mark.parametrize("which", [0, 1], ids=["2_ranks", "2x2"])
def test_ray_sharded_vector_trace_equals_one_rank(world, which):
    hist, bounces = world[0]["sharded"]["vector"][which]
    hist1, bounces1 = _ref(world, "vector")
    np.testing.assert_array_equal(hist, hist1)
    assert bounces == bounces1 and hist.sum() > 0


# ---------------------------------------------------------------------------
# against the JAX package


@pytest.fixture(scope="module")
def jshard():
    pytest.importorskip("jax")
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.parallel import (
        shard as js,
    )
    return js


def test_guards_raise_as_jax(world, jshard):
    """Each wrapper refuses the same inputs with the same message as the
    JAX wrapper on a 2 x 2 mesh of the virtual CPU devices (the checks run
    before any trace: no compile)."""
    import jax

    jmesh = jshard.make_mesh(jax.devices()[:4], ("cells", "samples"), (2, 2))
    want = _guards(jmesh, {"cell": jshard.make_sharded_cell_trace_fn,
                           "sample": jshard.make_sample_sharded_cell_trace_fn,
                           "2d": jshard.make_2d_sharded_cell_trace_fn}, "np")
    assert all(want), want
    assert world[0]["sharded"]["guards"] == want


def test_classify_rays_as_jax(jshard):
    cp = np.zeros((8, 4))
    for D, nr, n in ((1, 8, 4), (1, 1, 4), (2, 2, 1), (2, 2, 2), (2, 2, 4),
                     (2, 8, 2), (1, 4, 4), (4, 4, 2)):
        args = (cp, np.zeros((D, 3)), np.zeros((nr, 6, 1, 128)), n)
        want = _catch(jshard._classify_rays, *args)
        if want is None:
            assert shard._classify_rays(*args) == jshard._classify_rays(*args)
        else:
            assert _catch(shard._classify_rays, *args) == want


def test_pad_rays_to_as_jax(jshard):
    """Bitwise JAX's on a seeding batch and on a ``make_ray_state`` dict;
    the port's own ray state pads ``dep`` with -1 and ``cos_th`` with 1."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
        trace_jnp,
    )

    _, _, _, batch = _vector_setup()
    jstate = {k: np.asarray(v) for k, v in trace_jnp.make_ray_state(
        batch["x"], batch["y"], batch["te"], batch["tm"], batch["cid"],
        batch["idx"], batch["rng"]).items()}
    for rays, m in ((batch, 7), (batch, 1), (jstate, 7), (jstate, 5)):
        got, want = shard.pad_rays_to(rays, m), jshard.pad_rays_to(rays, m)
        assert got.keys() == want.keys()
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])
    state = {k: v.numpy() for k, v in trace_vector.make_ray_state(
        batch["x"], batch["y"], batch["te"], batch["tm"], batch["cid"],
        batch["idx"], batch["rng"], device="cpu").items()}
    n = len(state["x"])
    padded = shard.pad_rays_to(state, 7)
    assert len(padded["x"]) % 7 == 0 and len(padded["x"]) > n
    np.testing.assert_array_equal(padded["dep"][n:], -1)
    np.testing.assert_array_equal(padded["cos_th"][n:], 1.0)
    np.testing.assert_array_equal(padded["ter"][n:], 0.0)


def test_ray_sharded_vector_trace_meets_p2_against_jax(world, jshard):
    """The port's ray-sharded vector trace over 2 gloo ranks against JAX's
    ``make_sharded_trace_fn`` over the 8 virtual CPU devices, same inputs:
    bar (P2), bounces within 2 % and at most 0.5 % of the rays deposited
    otherwise (a ray that moves changes two bins by one: half the histogram's
    L1 distance bounds the rays that differ).  The two vector tracers agree
    on every deposit at ``tests/test_torch_vector.py``'s fixtures."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
        generate_geometry as jgen,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
        seeding as jseeding, trace_jnp,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
        build_trace_geometry as jbtg,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import (
        make_synthetic_luts as jluts,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts.packing import (
        build_cell_tables as jtables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
        TraceConfig as JCfg,
    )

    geom = jgen(num_fov_x=4, num_fov_y=3)
    cfg = JCfg(num_fov_x=4, num_fov_y=3, rays_per_fov=64, max_bounces=300,
               rng_mode="fast", seed=11)
    batch = jseeding.build_ray_batch(geom, cfg)
    mesh = jshard.make_mesh()
    padded = jshard.pad_rays_to(batch, mesh.size)
    rays = jshard.shard_ray_batch(trace_jnp.make_ray_state(
        padded["x"], padded["y"], padded["te"], padded["tm"], padded["cid"],
        padded["idx"], padded["rng"]), mesh)
    jhist, jb = jshard.make_sharded_trace_fn(
        jtables(geom, jluts(geom)), jbtg(geom), cfg, mesh)(rays)
    jhist, jb = np.asarray(jhist), int(jb)
    hist, b = world[0]["sharded"]["vector"][0]
    assert abs(b - jb) <= 0.02 * jb
    assert np.abs(hist - jhist).sum() / 2 <= 0.005 * len(batch["x"])
    assert hist.sum() > 0
