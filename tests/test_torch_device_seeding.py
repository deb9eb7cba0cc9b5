"""PyTorch port: the cell and vector engines' launch batches built on the
device are the host's, bit for bit.

Under the default config (shared pupil samples, fast seeding)
``seeding.ray_blocks_device`` and ``seeding.ray_state_device`` build a
batch from its shared pupil points alone.  They are held, field for field
with ``torch.equal``, to the JAX package's numpy ``build_ray_batch`` packed
by its ``pack_ray_blocks`` (the cell kernel's blocks) and read by its
``trace_jnp.make_ray_state`` (the vector state); every other config keeps
the host path.  Fixture: the paper design at 4 x 3 FoV x 3 wavelengths =
36 cells, torch on the CPU with one thread.  No JAX jit and no Pallas
compile: the JAX side is numpy and ``jnp.asarray``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the JAX reference runs on the CPU here)

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu import config as jconfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    seeding as jseeding,
    trace_jnp,
    trace_pallas as jrows,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import config
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    pipeline,
    seeding,
    trace_rows,
    trace_vector,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    design_sweep,
)

M, N = 4, 3
C = 3 * M * N
CELLS = {"all": np.arange(C), "run": np.arange(7, 19),
         "scattered": np.array([0, 5, 6, 17, 35])}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def geoms():
    return (generate_geometry(num_fov_x=M, num_fov_y=N),
            jgenerate_geometry(num_fov_x=M, num_fov_y=N))


def _cfgs(**kw):
    return (config.TraceConfig(num_fov_x=M, num_fov_y=N, seed=6, **kw),
            jconfig.TraceConfig(num_fov_x=M, num_fov_y=N, seed=6, **kw))


def _jax_batch(jgeom, jcfg, cells, rpc, it):
    return jseeding.build_ray_batch(jgeom, jcfg, cell_ids=cells,
                                    rays_per_cell=rpc, iteration=it)


def _jax_blocks(batch, cells, rpc):
    """The JAX package's kernel blocks as the port's kernels take them: the
    float32 tiles and the uint32 seeds' int32 bits."""
    rays, seeds = jrows.pack_ray_blocks(batch, len(cells), rpc,
                                        -(-rpc // trace_rows.LANES))
    return (torch.from_numpy(rays),
            torch.from_numpy(seeds.view(np.int32)))


def _jax_state(batch) -> dict:
    """The JAX package's vector state as the port holds it: floats as they
    are, the integer fields as int64 values."""
    js = trace_jnp.make_ray_state(batch["x"], batch["y"], batch["te"],
                                  batch["tm"], batch["cid"], batch["idx"],
                                  batch["rng"])
    out = {}
    for k, v in js.items():
        v = np.array(v)
        if k in ("rng", "cid", "idx"):
            v = v.astype(np.int64)
        out[k] = torch.from_numpy(v)
    return out


def _assert_blocks(got, want):
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert torch.equal(g, w)


def _assert_state(got: dict, want: dict):
    assert list(got) == list(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("sampling", ["uniform", "r2"])
@pytest.mark.parametrize("rpc", [200, 256])
@pytest.mark.parametrize("cells", list(CELLS))
def test_device_blocks_and_state_equal_the_jax_batch(geoms, sampling, rpc,
                                                     cells):
    """Blocks and ray state built on the device from the shared points equal
    the JAX package's host batch, field for field, at iterations 0 and 3;
    200 rays per cell leave 56 padding rays in the second row of 128 (six
    zero fields, seed 1)."""
    geom, jgeom = geoms
    cfg, jcfg = _cfgs(pupil_sampling=sampling)
    ids = CELLS[cells]
    assert seeding.device_seeded(cfg)
    for it in (0, 3):
        pts = seeding.to_device(seeding.shared_points(geom, cfg, rpc, it),
                                "cpu")
        assert pts.shape == (rpc // 2, 2) and pts.dtype == torch.float64
        batch = _jax_batch(jgeom, jcfg, ids, rpc, it)
        blocks = seeding.ray_blocks_device(pts, ids, it, C, cfg.seed)
        _assert_blocks(blocks, _jax_blocks(batch, ids, rpc))
        if rpc % trace_rows.LANES:
            rays_in, rng_in = blocks
            assert not rays_in[:, :, -1, rpc % trace_rows.LANES:].any()
            assert (rng_in[:, -1, rpc % trace_rows.LANES:] == 1).all()
        _assert_state(seeding.ray_state_device(pts, ids, it, C, cfg.seed),
                      _jax_state(batch))


def test_the_hash_takes_the_whole_64_bit_index(geoms):
    """A tail tag's global indices pass 2^32: the device build hashes the
    64-bit index, and the state's ``idx`` keeps its low 32 bits, as the
    host batch does."""
    geom, jgeom = geoms
    cfg, jcfg = _cfgs()
    ids, rpc, it = CELLS["scattered"], 256, 1_000_004
    assert it * C * rpc >= 2**32
    pts = seeding.to_device(seeding.shared_points(geom, cfg, rpc, it), "cpu")
    batch = _jax_batch(jgeom, jcfg, ids, rpc, it)
    _assert_blocks(seeding.ray_blocks_device(pts, ids, it, C, cfg.seed),
                   _jax_blocks(batch, ids, rpc))
    _assert_state(seeding.ray_state_device(pts, ids, it, C, cfg.seed),
                  _jax_state(batch))


@pytest.fixture
def no_device_build(monkeypatch):
    """Make the device build fail loudly, to show that a path never takes
    it."""
    def refuse(*a, **k):
        raise AssertionError("the device build was taken")

    for name in ("ray_blocks_device", "ray_state_device", "launch_fields"):
        monkeypatch.setattr(seeding, name, refuse)


def _refuse_host_build(*a, **k):
    raise AssertionError("a batch was seeded on the host")


@pytest.fixture
def no_host_build(monkeypatch):
    monkeypatch.setattr(seeding, "build_ray_batch", _refuse_host_build)


@pytest.mark.parametrize("kw", [{"shared_pupil_samples": False},
                                {"rng_mode": "parity"}])
def test_other_configs_keep_the_host_path(geoms, kw, no_device_build):
    """Without shared pupil samples, or with parity seeding, the Simulators
    seed every ray on the host (the device build is never called) and
    still give the JAX package's batch."""
    geom, jgeom = geoms
    cfg, jcfg = _cfgs(**kw)
    assert not seeding.device_seeded(cfg)
    ids, rpc = CELLS["scattered"], 200
    batch = _jax_batch(jgeom, jcfg, ids, rpc, 0)
    cell = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu", engine="cell")
    _assert_blocks(cell._cell_blocks(ids, rpc, 0), _jax_blocks(batch, ids, rpc))
    vec = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                             engine="vector")
    got = vec._vector_rays(ids, rpc, 0)
    _assert_state({k: v[0] for k, v in got.items()}, _jax_state(batch))


@pytest.mark.parametrize("cells", ["run", "scattered"])
def test_simulators_build_the_default_batch_on_the_device(geoms, cells,
                                                          no_host_build):
    """Under the default config ``Simulator._cell_blocks`` and
    ``_vector_rays`` seed no ray on the host and equal the JAX package's
    host batch; the shared points are drawn once per (rays per cell,
    iteration)."""
    geom, jgeom = geoms
    cfg, jcfg = _cfgs()
    ids, rpc = CELLS[cells], 200
    cell = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu", engine="cell")
    vec = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                             engine="vector")
    for it in (0, 3):
        batch = _jax_batch(jgeom, jcfg, ids, rpc, it)
        _assert_blocks(cell._cell_blocks(ids, rpc, it),
                       _jax_blocks(batch, ids, rpc))
        pts = cell._points[1]
        assert cell._points[0] == (rpc, it)
        cell._cell_blocks(ids[:2], rpc, it)
        assert cell._points[1] is pts
        got = vec._vector_rays(ids, rpc, it)
        _assert_state({k: v[0] for k, v in got.items()}, _jax_state(batch))


def _host_seeded(monkeypatch):
    """Send every config down the host path, as before the device build."""
    monkeypatch.setattr(seeding, "device_seeded", lambda cfg: False)


@pytest.mark.parametrize("engine", ["cell", "vector"])
def test_a_run_equals_the_host_seeded_run(geoms, engine, monkeypatch):
    """One ``run()`` of each engine (2 iterations in batches of 16 cells)
    gives the histogram, bounces and deposits of the same run with every
    batch seeded on the host, bit for bit, and reports the device build's
    span."""
    geom = geoms[0]
    cfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=64,
                             max_bounces=300, seed=6)
    kw = dict(cfg=cfg, geom=geom, device="cpu", engine=engine)
    run_kw = dict(num_iter=2, cells_per_batch=16, evaluate_metrics=False)
    got = pipeline.Simulator(**kw).run(**run_kw)
    with monkeypatch.context() as m:
        _host_seeded(m)
        want = pipeline.Simulator(**kw).run(**run_kw)
    assert got.histogram.sum() > 0
    np.testing.assert_array_equal(got.histogram, want.histogram)
    assert got.total_bounces == want.total_bounces
    assert got.deposits == want.deposits
    assert got.rays_traced == want.rays_traced == 2 * C * 64
    assert got.timings["seed_s"] > 0


def test_the_splitting_engine_takes_the_shared_points(geoms, no_host_build):
    """The per-cell splitting engine with shared pupil samples launches from
    the cached points (no batch seeded on the host): its launch fields are
    the first cell's rays of the JAX batch."""
    geom, jgeom = geoms
    cfg, jcfg = _cfgs(rays_per_fov=4)
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                             engine="splitting", splitting_capacity=256)
    seeds = sim._split_seeds(CELLS["scattered"], 4, 2)
    batch = _jax_batch(jgeom, jcfg, CELLS["scattered"][:1], 4, 2)
    want = {"x": batch["x"], "y": batch["y"], "ter": batch["te"].real,
            "tei": batch["te"].imag, "tmr": batch["tm"].real,
            "tmi": batch["tm"].imag}
    assert list(seeds) == list(want)
    for k, v in want.items():
        assert torch.equal(seeds[k], torch.from_numpy(
            np.asarray(v, np.float64)).to(torch.float32)), k


def test_the_splitting_engine_is_unchanged(geoms, monkeypatch):
    """A per-cell splitting run (shared points) and a global-wavefront run
    (the device-built ray state) equal the same runs seeded on the host."""
    geom = geoms[0]
    cfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=2,
                             max_bounces=200, seed=6)
    sims = {"percell": dict(splitting_capacity=256),
            "global": dict(splitting_percell=False,
                           splitting_capacity=1 << 13)}
    for name, skw in sims.items():
        kw = dict(cfg=cfg, geom=geom, device="cpu", engine="splitting",
                  splitting_threshold=1e-3, splitting_max_steps=64, **skw)
        run_kw = dict(num_iter=2, cells_per_batch=12, evaluate_metrics=False)
        got = pipeline.Simulator(**kw).run(**run_kw)
        with monkeypatch.context() as m:
            _host_seeded(m)
            want = pipeline.Simulator(**kw).run(**run_kw)
        assert got.histogram.sum() > 0, name
        np.testing.assert_array_equal(got.histogram, want.histogram,
                                      err_msg=name)
        assert got.total_bounces == want.total_bounces, name


def test_the_vector_sweep_builds_its_states_on_the_device(monkeypatch):
    """The vector sweep's per-IC ray states are built on the device under
    the default config and give the host-seeded sweep's results bit for
    bit; designs that share an in-coupler share one state."""
    cfg = config.TraceConfig(num_fov_x=M, num_fov_y=N, rays_per_fov=32,
                             max_bounces=200)
    designs = [dataclasses.replace(config.WaveguideDesign(), lambda_oc=p)
               for p in (380.0, 392.0)]
    built = []
    state = design_sweep._ray_state
    monkeypatch.setattr(design_sweep, "_ray_state",
                        lambda g, c, d: built.append(g) or state(g, c, d))
    with monkeypatch.context() as m:
        m.setattr(seeding, "build_ray_batch", _refuse_host_build)
        got = design_sweep.run_design_sweep(designs, cfg, device="cpu")
    assert len(built) == 1
    assert {"prep_s", "seed_s", "upload_s"} <= set(got.timings)
    with monkeypatch.context() as m:
        _host_seeded(m)
        want = design_sweep.run_design_sweep(designs, cfg, device="cpu")
    assert got.histograms.sum() > 0
    np.testing.assert_array_equal(got.histograms, want.histograms)
    np.testing.assert_array_equal(got.bounces, want.bounces)
    np.testing.assert_array_equal(got.efficiencies, want.efficiencies)
    g = generate_geometry(designs[0], M, N)
    b = seeding.build_ray_batch(g, cfg)
    _assert_state(design_sweep._ray_state(g, cfg, "cpu"),
                  trace_vector.make_ray_state(
                      b["x"], b["y"], b["te"], b["tm"], b["cid"], b["idx"],
                      b["rng"], device="cpu"))
