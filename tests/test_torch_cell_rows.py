"""PyTorch port: the kernel engines' cell rows of synthetic LUTs, built from
host inputs by ``engine/cell_rows.py``, are the host rows bit for bit.

``cell_rows_reference`` (the plain version of ``csrc/cell_rows.cu``, what
every ``device="cpu"`` run uses) is held, as int32 views, to the port's
host route (synthetic LUTs -> cell tables -> rows) and to the JAX
package's numpy functions; ``synthetic_row_inputs``' draws to the JAX
package's ``_synth_quads``; ``prepare_chunk``'s rows and packed words and
the Simulator's rows to the JAX package's; the ``luts_dir`` and ``luts=``
routes stay on the host.  No JAX jit and no Pallas compile: the JAX side
is numpy.  Torch on the CPU with one thread.
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
    trace_pallas as jrows,
    trace_pallas_persistent as jpers,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import (
    packing as jpacking,
    synthetic as jsynthetic,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import config
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    cell_rows,
    pipeline,
    trace_persistent as tp,
    trace_rows,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (
    io,
    packing,
    synthetic,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
    design_sweep,
)

BINS = (80, 120)
# two grating periods and two glass indices: a chunk whose designs differ
# in geometry and in n_glass
CHUNK = (dict(), dict(n_glass=2.0), dict(n_glass=2.0, lambda_ic=380.0,
                                         lambda_oc=380.0))
# n_glass 1.8 leaves an order evanescent at a corner of the 5 x 4 FoV: NaN
# angles, so NaN rows
EVANESCENT = (dict(), dict(n_glass=1.8))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its tensors are small, and the
    suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(a) -> np.ndarray:
    a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
    return np.ascontiguousarray(a, np.float32).view(np.int32)


def _designs(mod, kws=CHUNK):
    return [dataclasses.replace(mod.WaveguideDesign(), **kw) for kw in kws]


@pytest.fixture(scope="module")
def paper():
    """The paper design at full width (100 x 75 FoV x 3 wavelengths)."""
    return generate_geometry(num_fov_x=100, num_fov_y=75)


@pytest.fixture(scope="module")
def chunk():
    """A D = 3 chunk at 5 x 4 FoV: port and JAX geometries."""
    return ([generate_geometry(d, 5, 4) for d in _designs(config)],
            [jgenerate_geometry(d, 5, 4) for d in _designs(jconfig)])


@pytest.mark.parametrize("case", ["paper", "chunk"])
def test_draws_equal_synth_quads(case, paper, chunk):
    """The host inputs' branches, in ``_synth_quads``' draw order: c * U
    formed from them in numpy equals the JAX package's Jones products bit
    for bit (so the two sources of the draw order cannot drift apart)."""
    geoms = [paper] if case == "paper" else chunk[0]
    jgeoms = ([jgenerate_geometry(num_fov_x=100, num_fov_y=75)]
              if case == "paper" else chunk[1])
    seed = 1234 if case == "paper" else 7
    inp = cell_rows.synthetic_row_inputs(geoms, seed)
    D, L, M, N = inp.D, inp.L, inp.M, inp.N
    shape = (D, L, M, N)
    extras = np.concatenate([np.ones((D, 1)), inp.glass], axis=1)

    def cplx(re, im):
        z = np.empty(re.shape, np.complex128)
        z.real, z.imag = re, im
        return z

    quads = list(jsynthetic._synth_quads(jsynthetic._stack_angles(jgeoms),
                                         seed))
    assert len(quads) == len(inp.table)
    for (key, want), (ci, co, ex, _), br in zip(quads, inp.table,
                                                inp.branch):
        p, cb, sb, e1r, e1i, e2r, e2i = (x.reshape(1, L, M, N) for x in br)
        cin = inp.cosines[:, ci].reshape(shape)
        cout = inp.cosines[:, co].reshape(shape)
        c = np.sqrt(p * cin / (cout * extras[:, ex].reshape(D, 1, 1, 1)))
        e1, e2 = cplx(e1r, e1i), cplx(e2r, e2i)
        got = (c * (cb * e1), c * (-sb * e2), c * (sb * e1), c * (cb * e2))
        for g, w in zip(got, want):
            assert np.array_equal(g.view(np.int64), w.view(np.int64)), key


def test_reference_rows_equal_host_rows_paper(paper):
    """The paper design at full width, D = 1: the plain version's rows are
    the port's host rows and the JAX package's, as int32."""
    got = cell_rows.cell_rows_reference(
        cell_rows.synthetic_row_inputs([paper], 1234), paper.eyebox_range,
        BINS)
    assert got.shape == (22500, trace_rows.PC) and got.dtype == torch.float32
    port = trace_rows.build_kernel_cell_params(
        packing.build_cell_tables(paper, synthetic.make_synthetic_luts(
            paper, seed=1234)), paper.eyebox_range, BINS)
    assert np.array_equal(_bits(got), _bits(port))
    jg = jgenerate_geometry(num_fov_x=100, num_fov_y=75)
    jax_rows = jrows.build_kernel_cell_params(
        jpacking.build_cell_tables(jg, jsynthetic.make_synthetic_luts(
            jg, seed=1234)), jg.eyebox_range, BINS)
    assert np.array_equal(_bits(got), _bits(jax_rows))


@pytest.mark.parametrize("designs,bins", [("chunk", BINS),
                                          ("chunk", (16, 24)),
                                          ("evanescent", BINS)])
def test_reference_rows_equal_host_rows_chunk(chunk, designs, bins):
    """A D = 3 chunk with two glass indices (and a D = 2 one whose rows hold
    NaN): the plain version's rows are the fused batch pipeline's (port and
    JAX) and the per-design host route's stacked, as int32."""
    geoms, jgeoms = chunk if designs == "chunk" else (
        [generate_geometry(d, 5, 4) for d in _designs(config, EVANESCENT)],
        [jgenerate_geometry(d, 5, 4) for d in _designs(jconfig, EVANESCENT)])
    eb = np.stack([g.eyebox_range for g in geoms])
    got = _bits(cell_rows.cell_rows_reference(
        cell_rows.synthetic_row_inputs(geoms, 7), eb, bins))
    port = trace_rows.build_kernel_cell_params(
        packing.build_cell_tables_synthetic_batch(geoms, seed=7), eb, bins)
    jax_rows = jrows.build_kernel_cell_params(
        jpacking.build_cell_tables_synthetic_batch(jgeoms, seed=7),
        np.stack([g.eyebox_range for g in jgeoms]), bins)
    solo = np.concatenate([trace_rows.build_kernel_cell_params(
        packing.build_cell_tables(g, synthetic.make_synthetic_luts(g, 7)),
        g.eyebox_range, bins) for g in geoms])
    for want in (port, jax_rows, solo):
        assert np.array_equal(got, _bits(want))
    # the designs differ, so the comparison covers the design axis
    C = got.shape[0] // len(geoms)
    assert not np.array_equal(got[:C], got[C:2 * C])
    assert np.isnan(got.view(np.float32)).any() == (designs == "evanescent")


def test_cell_rows_wrapper_on_cpu_and_without_card(chunk):
    """On the CPU the wrapper is the plain version and launches nothing; a
    CUDA device without a card raises, and the launch refuses CPU
    tensors: nothing falls back."""
    geoms = chunk[0]
    inp = cell_rows.synthetic_row_inputs(geoms, 3)
    eb = np.stack([g.eyebox_range for g in geoms])
    n0 = tp.launch_counts["cell_rows"]
    got = cell_rows.cell_rows(inp, eb, BINS, device="cpu")
    assert np.array_equal(_bits(got), _bits(cell_rows.cell_rows_reference(
        inp, eb, BINS)))
    assert tp.launch_counts["cell_rows"] == n0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            cell_rows.cell_rows(inp, eb, BINS, device="cuda")
    args = cell_rows.upload_inputs(inp, eb, "cpu")
    with pytest.raises(ValueError, match="runs on cuda"):
        cell_rows.launch_rows(args, inp, BINS)
    assert tp.launch_counts["cell_rows"] == n0


@pytest.mark.parametrize("shared", [True, False])
def test_prepare_chunk_rows_and_words_equal_jax(chunk, shared):
    """``prepare_chunk`` on the CPU: rows and packed selection words (now
    tensors on the chunk's device) are the JAX package's host rows and
    words, bit for bit; the launch tiles are unchanged."""
    designs = _designs(config)
    cfg = config.TraceConfig(num_fov_x=5, num_fov_y=4, rays_per_fov=256)
    rows = design_sweep.prepare_chunk(designs, cfg, 128, lut_seed=11,
                                      shared=shared, packed=True,
                                      device="cpu")
    assert isinstance(rows.cell_params, torch.Tensor)
    assert rows.cell_params.device.type == "cpu"
    assert set(rows.timings) == {"geometry_s", "host_rows_s", "rows_s",
                                 "tiles_s"} and rows.timer is None
    jgeoms = chunk[1]
    want = jrows.build_kernel_cell_params(
        jpacking.build_cell_tables_synthetic_batch(jgeoms, seed=11),
        np.stack([g.eyebox_range for g in jgeoms]), cfg.eyebox_bins)
    assert np.array_equal(_bits(rows.cell_params), _bits(want))
    words = jpers.pack_selection_params(want, rows.tgeoms[0].num_fc,
                                        rows.tgeoms[0].num_oc)
    assert rows.cell_params_packed.dtype == torch.int32
    assert np.array_equal(rows.cell_params_packed.numpy(), words)
    n_cells = 3 * 5 * 4
    assert rows.rays.shape[0] == (3 if shared else 3 * n_cells)
    assert (rows.rng is None) == shared


def test_pack_selection_params_of_a_tensor():
    """A tensor of rows packs to the same words as the array, as a tensor
    on the rows' device (NaN, infinities and ties included)."""
    rng = np.random.default_rng(5)
    cp = rng.standard_normal((6, trace_rows.PC)).astype(np.float32)
    cp[0, :8] = [np.nan, np.inf, -np.inf, 0.0, -0.0, 1.0 + 2 ** -8,
                 1.0 + 3 * 2 ** -8, 1e-40]
    want = trace_rows.pack_selection_params(cp, 3, 2)
    got = trace_rows.pack_selection_params(torch.from_numpy(cp), 3, 2)
    assert isinstance(got, torch.Tensor) and got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, jpers.pack_selection_params(cp, 3, 2))


@pytest.fixture(scope="module")
def small():
    geom = generate_geometry(num_fov_x=4, num_fov_y=3)
    jgeom = jgenerate_geometry(num_fov_x=4, num_fov_y=3)
    cfg = config.TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                             num_iter=1, max_bounces=300, seed=5)
    return geom, jgeom, cfg


def _jax_rows(jgeom, seed):
    return jrows.build_kernel_cell_params(
        jpacking.build_cell_tables(jgeom, jsynthetic.make_synthetic_luts(
            jgeom, seed=seed)), jgeom.eyebox_range, BINS)


@pytest.mark.parametrize("engine,mode", [("persistent", "fma"),
                                         ("persistent", "packed"),
                                         ("cell", None)])
def test_simulator_rows_unchanged_and_tables_lazy(small, engine, mode):
    """``Simulator(device="cpu")`` of a kernel engine on synthetic LUTs:
    its rows (and packed words) are the JAX package's host rows, built
    without the host LUTs or tables; ``luts`` and ``tables`` build at first
    read with the values the host route gives, and a shallow copy (the
    hybrids' pilot) shares them."""
    geom, jgeom, cfg = small
    kw = {"pers_accum_mode": mode} if mode else {}
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu", engine=engine,
                             persistent_slots=128, **kw)
    assert sim._host._luts is None and sim._host._tables is None
    assert {"geometry_s", "host_rows_s", "rows_s",
            "trace_geometry_s"} <= set(sim.setup_timings)
    want = _jax_rows(jgeom, cfg.seed + 1234)
    assert np.array_equal(_bits(sim.tracer.cell_params), _bits(want))
    if mode == "packed":
        assert np.array_equal(
            sim.tracer.cell_params_packed.numpy(),
            jpers.pack_selection_params(want, sim.tgeom.num_fc,
                                        sim.tgeom.num_oc))
    luts = synthetic.make_synthetic_luts(geom, seed=cfg.seed + 1234)
    for f in dataclasses.fields(luts):
        assert np.array_equal(getattr(sim.luts, f.name),
                              getattr(luts, f.name)), f.name
    tables = packing.build_cell_tables(geom, luts)
    for f in dataclasses.fields(tables):
        assert np.array_equal(getattr(sim.tables, f.name),
                              getattr(tables, f.name)), f.name
    import copy
    pilot = copy.copy(sim)
    pilot.cfg = dataclasses.replace(sim.cfg, seed=99)
    assert pilot.tables is sim.tables and pilot.luts is sim.luts


def test_synthetic_rows_skip_the_host_pipeline(small, monkeypatch):
    """The kernel engines and the sweep build synthetic rows without the
    host tables and row function (here their plain version; on a card the
    kernel, ``tests/test_torch_cuda.py``)."""
    geom, _, cfg = small

    def refuse(*a, **k):
        raise AssertionError("host tables or rows built for synthetic LUTs")

    for mod in (pipeline, packing):
        monkeypatch.setattr(mod, "build_cell_tables", refuse)
    monkeypatch.setattr(packing, "build_cell_tables_synthetic_batch", refuse)
    monkeypatch.setattr(trace_rows, "build_kernel_cell_params", refuse)
    for engine in ("persistent", "cell"):
        pipeline.Simulator(cfg=cfg, geom=geom, device="cpu", engine=engine,
                           persistent_slots=128)
    design_sweep.prepare_chunk(_designs(config)[:2], cfg, 128, device="cpu")


@pytest.mark.parametrize("route", ["luts_dir", "luts"])
def test_real_luts_keep_the_host_route(small, tmp_path, monkeypatch, route):
    """LUTs from ``luts_dir`` (validated) or given as ``luts=`` keep the host
    tables and rows: the rows' kernel and its plain version are not
    called, and the rows equal the host route's."""
    geom, _, cfg = small
    luts = synthetic.make_synthetic_luts(geom, seed=77)
    io.save_luts(luts, str(tmp_path))

    def refuse(*a, **k):
        raise AssertionError("cell_rows called for real LUTs")

    monkeypatch.setattr(cell_rows, "cell_rows", refuse)
    kw = ({"luts_dir": str(tmp_path)} if route == "luts_dir"
          else {"luts": luts})
    sim = pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                             persistent_slots=128, **kw)
    assert sim._host._tables is not None
    want = trace_rows.build_kernel_cell_params(
        packing.build_cell_tables(geom, luts), geom.eyebox_range, BINS)
    assert np.array_equal(_bits(sim.tracer.cell_params), _bits(want))
    if route == "luts_dir":
        bad = dataclasses.replace(luts, ic1=luts.ic1[..., :3])
        io.save_luts(bad, str(tmp_path))
        with pytest.raises(ValueError):
            pipeline.Simulator(cfg=cfg, geom=geom, device="cpu",
                               luts_dir=str(tmp_path))
