"""PyTorch port: the native host pupil sampler (``engine/native.py``,
``csrc/host_sampler.cpp``) against the JAX package's binding of
``native/host_sampler.cpp``.

Both libraries are built here from the same source with the JAX Makefile's
flags (``-O3 -march=native ...``), so their points agree bit for bit; the
port's build raises where the JAX binding falls back to numpy.
"""

import dataclasses
from pathlib import Path

import numpy as np
import pytest

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    TraceConfig as JTraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    native as jnative,
    seeding as jseeding,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    native, pipeline, seeding,
)

REPO = Path(__file__).resolve().parents[1]
SQUARE = np.array([[0.0, 0.0], [2.0, 0.0], [2.0, 1.5], [0.0, 1.5]])


def _makefile_flags():
    """``CXXFLAGS`` of the JAX package's ``native/Makefile``."""
    for line in (REPO / "native" / "Makefile").read_text().splitlines():
        if line.startswith("CXXFLAGS"):
            return line.split("=", 1)[1].split()
    raise AssertionError("native/Makefile sets no CXXFLAGS")


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """The JAX binding over ``native/host_sampler.cpp`` built with its
    Makefile's flags, into this test's directory: the binding's own ``make``
    would write into ``native/``, where ``tests/test_native.py`` builds the
    same file."""
    import subprocess

    lib = tmp_path_factory.mktemp("jax_native") / "libhostsampler.so"
    subprocess.run(["g++", *_makefile_flags(), "-o", str(lib),
                    str(REPO / "native" / "host_sampler.cpp")], check=True)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jnative, "_LIB_PATH", str(lib))
        mp.setattr(jnative, "_lib", None)
        mp.setattr(jnative, "_build_attempted", True)
        assert jnative.available()
        yield


def test_source_and_flags_are_the_jax_packages():
    assert native.SOURCE.read_bytes() == (
        REPO / "native" / "host_sampler.cpp").read_bytes()
    assert native.CXX_FLAGS == _makefile_flags()
    assert native.library_path().parent == REPO / "build" / "native"


@pytest.mark.parametrize("seed", [0, 7, 7919, 2 ** 40 + 3])
@pytest.mark.parametrize("poly", ["paper", "square"])
def test_sample_points_bitwise_jax(jax_lib, seed, poly):
    ic = generate_geometry(num_fov_x=4, num_fov_y=3).ic
    pts_poly = ic if poly == "paper" else SQUARE
    got = native.sample_points_in_polygon(pts_poly, 777, seed=seed)
    want = jnative.sample_points_in_polygon(pts_poly, 777, seed=seed)
    assert got.dtype == np.float64 and got.shape == (777, 2)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,offset", [(42, 0), (3, 1 << 33)])
def test_fill_ray_blocks_bitwise_jax(jax_lib, seed, offset):
    pts = native.sample_points_in_polygon(SQUARE, 50, seed=1)
    cells = np.array([0, 5, 17, 35], np.int32)
    got = native.fill_ray_blocks(pts, cells, 100, 128, seed, offset)
    want = jnative.fill_ray_blocks(pts, cells, 100, 128, seed, offset)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("shared", [True, False])
def test_build_ray_batch_native_bitwise_jax(jax_lib, shared):
    """``pupil_sampler="native"`` seeds ``cfg.seed + 7919 * iteration`` (per
    cell: the first word of the cell's SeedSequence), as the JAX package."""
    kw = dict(num_fov_x=3, num_fov_y=2, rays_per_fov=64, seed=5,
              pupil_sampler="native", shared_pupil_samples=shared)
    cells = np.array([1, 4, 9])
    got = seeding.build_ray_batch(generate_geometry(num_fov_x=3, num_fov_y=2),
                                  TraceConfig(**kw), cell_ids=cells,
                                  iteration=2)
    want = jseeding.build_ray_batch(
        jgenerate_geometry(num_fov_x=3, num_fov_y=2), JTraceConfig(**kw),
        cell_ids=cells, iteration=2)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    numpy_batch = seeding.build_ray_batch(
        generate_geometry(num_fov_x=3, num_fov_y=2),
        TraceConfig(**dict(kw, pupil_sampler="numpy")), cell_ids=cells,
        iteration=2)
    assert not np.array_equal(got["x"], numpy_batch["x"])


def test_the_persistent_engine_seeds_its_tile_natively():
    """The persistent engine's shared launch tile comes from the native
    points; a run is finite and deposits."""
    cfg = TraceConfig(num_fov_x=2, num_fov_y=2, rays_per_fov=128,
                      max_bounces=300, pupil_sampler="native")
    sim = pipeline.Simulator(cfg=cfg, device="cpu", persistent_slots=128)
    tile, _ = sim._device_ray_blocks(np.arange(4), 128)
    pts = native.sample_points_in_polygon(sim.geom.ic, 64, seed=cfg.seed)
    np.testing.assert_array_equal(tile[0, 0, 0, :64].numpy(),
                                  pts[:, 0].astype(np.float32))
    res = sim.run(num_iter=1, evaluate_metrics=False)
    assert all(v > 0 for v in res.efficiencies.values())


def test_a_failed_build_raises(tmp_path, monkeypatch):
    bad = tmp_path / "host_sampler.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed to build"):
        native.sample_points_in_polygon(SQUARE, 4, seed=0)
    assert not native.available()
    monkeypatch.setattr(native, "CXX", "no-such-compiler-here")
    with pytest.raises(RuntimeError, match="not found"):
        native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_unknown_pupil_sampler_raises():
    cfg = dataclasses.replace(TraceConfig(num_fov_x=2, num_fov_y=2,
                                          rays_per_fov=8),
                              pupil_sampler="cuda")
    with pytest.raises(ValueError, match="pupil_sampler"):
        seeding.build_ray_batch(generate_geometry(num_fov_x=2, num_fov_y=2),
                                cfg)
