"""PyTorch port: its own copies of the JAX package's host modules compute
bitwise what the JAX package computes, on the paper design at 4 x 3 FoV.

Config and presets, design geometry, synthetic LUTs (and their files), cell
tables (single and design-batched), trace geometry, host metrics and the
eye-view image."""

import dataclasses

import numpy as np
import pytest

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu import config as jconfig
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.trace_geometry import (
    build_trace_geometry as jbuild_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval import (
    image as jimage,
    metrics as jmetrics,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import (
    io as jio,
    packing as jpacking,
    synthetic as jsynthetic,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.models import (
    presets as jpresets,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import config
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
    image,
    metrics,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
    io,
    packing,
    synthetic,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.models import presets

M, N = 4, 3
PERIODS = (380.0, 388.0, 396.0)


def assert_same(a, b, path="value"):
    """Recursive bitwise equality of dataclasses, dicts, sequences, arrays
    and scalars; dataclasses of the two packages compare field by field."""
    if dataclasses.is_dataclass(a):
        assert dataclasses.is_dataclass(b) and type(a).__name__ == type(b).__name__, path
        fa = [f.name for f in dataclasses.fields(a)]
        assert fa == [f.name for f in dataclasses.fields(b)], path
        for name in fa:
            assert_same(getattr(a, name), getattr(b, name), f"{path}.{name}")
    elif isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            assert_same(a[k], b[k], f"{path}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert isinstance(b, (list, tuple)) and len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            assert_same(x, y, f"{path}[{i}]")
    elif isinstance(a, np.ndarray):
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        assert a == b or (a != a and b != b), (path, a, b)


def _designs(pkg_design):
    return [dataclasses.replace(pkg_design(), lambda_ic=p, lambda_oc=p)
            for p in PERIODS]


@pytest.fixture(scope="module")
def geoms():
    """(port, JAX) geometry of the paper design and two grating variants."""
    port = [generate_geometry(d, M, N) for d in _designs(config.WaveguideDesign)]
    ref = [jgenerate_geometry(d, M, N) for d in _designs(jconfig.WaveguideDesign)]
    return port, ref


def test_config_and_presets_equal():
    for name in ("WaveguideDesign", "TraceConfig", "EvalConfig"):
        assert_same(getattr(config, name)(), getattr(jconfig, name)(), name)
    assert sorted(presets.PRESETS) == sorted(jpresets.PRESETS)
    for name in presets.PRESETS:
        assert_same(presets.get(name), jpresets.get(name), name)


def test_geometry_bitwise(geoms):
    port, ref = geoms
    for g, r in zip(port, ref):
        assert_same(g, r, "geometry")


def test_synthetic_luts_bitwise(geoms, tmp_path):
    """Synthetic LUTs, and the LUT files written by the JAX package read back
    by the port's loader."""
    port, ref = geoms
    lp = synthetic.make_synthetic_luts(port[1], seed=7)
    lr = jsynthetic.make_synthetic_luts(ref[1], seed=7)
    assert_same(lp, lr, "luts")
    jio.save_luts(lr, str(tmp_path))
    assert io.luts_available(str(tmp_path))
    assert_same(io.load_or_synthesize(port[1], directory=str(tmp_path)), lr,
                "loaded luts")


def test_cell_tables_bitwise(geoms):
    port, ref = geoms
    tp_ = packing.build_cell_tables(port[0], synthetic.make_synthetic_luts(port[0]))
    tr = jpacking.build_cell_tables(ref[0], jsynthetic.make_synthetic_luts(ref[0]))
    assert_same(tp_, tr, "tables")


def test_cell_tables_synthetic_batch_bitwise(geoms):
    """The design-batched table pipeline for 3 designs."""
    port, ref = geoms
    bp = packing.build_cell_tables_synthetic_batch(port, seed=11)
    br = jpacking.build_cell_tables_synthetic_batch(ref, seed=11)
    assert bp.num_cells == 3 * 3 * M * N
    assert_same(bp, br, "batched tables")


@pytest.mark.parametrize("tol", [0.0, 0.05])
def test_trace_geometry_bitwise(geoms, tol):
    port, ref = geoms
    for g, r in zip(port, ref):
        assert_same(build_trace_geometry(g, simplify_tol=tol),
                    jbuild_trace_geometry(r, simplify_tol=tol), "trace geometry")


def test_host_metrics_bitwise():
    """Host ``evaluate`` (with the eye views), ``efficiencies`` and the
    eye-view image on a seeded histogram."""
    rng = np.random.default_rng(3)
    hist = rng.poisson(0.6, size=(3, N, M, 80, 120)).astype(np.float32)
    hist[:, 0, 0, :40] = 0.0     # a starved corner
    assert_same(metrics.evaluate(hist / 512.0), jmetrics.evaluate(hist / 512.0),
                "evaluate")
    assert_same(metrics.efficiencies(hist, 512.0, 2),
                jmetrics.efficiencies(hist, 512.0, 2), "efficiencies")
    out = metrics.evaluate(hist / 512.0).output_image
    assert_same(image.eye_view_uint8(out, 1, 2), jimage.eye_view_uint8(out, 1, 2),
                "eye view")


def test_checkpoint_copy_and_file_format(tmp_path):
    """The port's ``utils/checkpoint.py`` is the JAX package's, fingerprints
    included: a checkpoint written by either package loads in the other for
    the same design and configuration, and not for another."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.utils import (
        checkpoint as jck,
    )

    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.utils import (
        checkpoint as ck,
    )

    cfg, jcfg = config.TraceConfig(seed=3), jconfig.TraceConfig(seed=3)
    d, jd = config.WaveguideDesign(), jconfig.WaveguideDesign()
    assert ck._fingerprint(d, cfg) == jck._fingerprint(jd, jcfg)
    assert ck._fingerprint(d, config.TraceConfig(seed=4)) != ck._fingerprint(
        d, cfg)
    hist = np.random.default_rng(1).poisson(
        1.0, size=(3, N, M, 80, 120)).astype(np.float32)
    for save, load, sd, sc, ld, lc in (
            (jck.save_checkpoint, ck.load_checkpoint, jd, jcfg, d, cfg),
            (ck.save_checkpoint, jck.load_checkpoint, d, cfg, jd, jcfg)):
        path = str(tmp_path / "ck.npz")
        save(path, hist, 2, sd, sc, 12345, extras={"total_rays": 77,
                                                   "total_spawned": 80})
        h, it, bounces, extras = load(path, ld, lc, with_extras=True)
        np.testing.assert_array_equal(h, hist)
        assert (it, bounces, extras) == (2, 12345, {"total_rays": 77,
                                                    "total_spawned": 80})
        assert load(path, ld, dataclasses.replace(lc, seed=4)) is None


def _code_without_imports_and_docstrings(path) -> str:
    """The module's syntax tree with its imports and docstrings left out."""
    import ast

    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if not isinstance(body, list):
            continue
        body[:] = [n for n in body
                   if not isinstance(n, (ast.Import, ast.ImportFrom))]
        if (body and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            body.pop(0)
    return ast.dump(tree)


def test_plotting_copy_is_the_jax_original():
    """The port's ``design/plotting.py`` is the JAX package's, changed only
    in its imports and docstrings: the same code."""
    import importlib.util

    def path(pkg):
        return importlib.util.find_spec(f"{pkg}.design.plotting").origin

    assert (_code_without_imports_and_docstrings(
        path("gpu_ray_tracing_for_waveguide_based_ar_display_torch"))
        == _code_without_imports_and_docstrings(
            path("gpu_ray_tracing_for_waveguide_based_ar_display_tpu")))


def test_new_engines_load_no_jax(tmp_path):
    """A process that runs the vector and splitting engines, the vector
    sweep, the design plots, the boost-tail hybrid, a joint grating
    optimisation step, a profiled run with the native pupil sampler
    beside the sharding module, and the kernel rows' plain version of the
    port on the CPU loads neither jax, ml_dtypes, optax nor any module of
    the JAX package."""
    import os
    import subprocess
    import sys
    from pathlib import Path

    code = (
        "import sys\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine "
        "import pipeline, splitting, trace_vector\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config "
        "import TraceConfig, WaveguideDesign\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep "
        "import run_design_sweep\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design "
        "import generate_geometry, plotting\n"
        "cfg = TraceConfig(num_fov_x=2, num_fov_y=2, rays_per_fov=32, "
        "num_iter=1, max_bounces=200, seed=1)\n"
        "r = pipeline.Simulator(cfg=cfg, device='cpu', engine='vector', "
        "segmented=True).run()\n"
        "assert r.deposits > 0, r.deposits\n"
        "r = pipeline.Simulator(cfg=cfg, device='cpu', engine='splitting', "
        "splitting_threshold=1e-4).run(rays_per_fov=2)\n"
        "assert sum(r.efficiencies.values()) > 0\n"
        "s = run_design_sweep([WaveguideDesign()] * 2, cfg, device='cpu')\n"
        "assert (s.efficiencies > 0).all()\n"
        "plotting.plot_design(generate_geometry(num_fov_x=2, num_fov_y=2), "
        "prefix='d')\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine "
        "import hybrid\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt "
        "import optimize_grating\n"
        "ps = pipeline.Simulator(cfg=cfg, device='cpu', persistent_slots=128)\n"
        "r, d = hybrid.TailBoostHybrid(ps, max_boost=2.0).run()\n"
        "assert d.tail_rays > 0 and r.metrics is not None\n"
        "o = optimize_grating(ps.geom, ps.tables, ps.tgeom, cfg, steps=1, "
        "rays_per_fov=2, capacity=256, fixed_steps=4, apodize=True, "
        "device='cpu')\n"
        "assert len(o.loss_history) == 2\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.parallel "
        "import shard\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.utils "
        "import profiling\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine "
        "import native\n"
        "with profiling.torch_trace('prof'):\n"
        "    n = pipeline.Simulator(cfg=TraceConfig(num_fov_x=2, num_fov_y=2, "
        "rays_per_fov=32, num_iter=1, max_bounces=200, "
        "pupil_sampler='native'), device='cpu', persistent_slots=128).run()\n"
        "assert native.available() and n.rays_traced > 0\n"
        "assert len(shard.pad_rays_to({'x': [0.0] * 5}, 4)['x']) == 8\n"
        "from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine "
        "import cell_rows\n"
        "g = generate_geometry(num_fov_x=2, num_fov_y=2)\n"
        "rows = cell_rows.cell_rows(cell_rows.synthetic_row_inputs([g], 3), "
        "g.eyebox_range, device='cpu')\n"
        "assert tuple(rows.shape) == (12, 704)\n"
        "bad = sorted(m for m in sys.modules if m in ('jax', 'ml_dtypes', "
        "'optax') "
        "or m.startswith(('jax.', 'gpu_ray_tracing_for_waveguide_based_ar_"
        "display_tpu')))\n"
        "print(bad or 'NOJAX')\n"
    )
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "NOJAX"
