"""PyTorch port: the tail-patched hybrids (``engine/hybrid.py``) against the
JAX package's ``engine/hybrid.py``, on the CPU.

Fixture: the paper design at 4 x 3 FoV x 3 wavelengths, 256 rays per FoV x
1 iteration (a budget at which Monte Carlo starves eye windows), count spawn
with folding, 128 slots, a 200-bounce bound, seeded from numpy; a 60-bin (6
mm) pupil, so that the coarse grid holds groups of every kind (worst pilot
windows empty, thin and resolved) and the selection and tiers are partial.

- The boost tail: the JAX ``TailBoostHybrid`` runs around a test-side
  Simulator stub whose ``run`` and ``_trace_batch_tiles`` hand it the port's
  plain-version outputs for the same cells, so both take their selection,
  tiers and rows from the same Monte-Carlo samples.  Selection, tiers and
  per-cell tiers identical; the pilot and post-boost window counts within
  1e-6 relative and the rows and sums within float32 association (rtol
  2e-6; the two packages sum a pupil window in different orders); (P1) the
  port's tail seeds and launch tile bitwise those of the batch the JAX
  class builds at the tail iteration tags.
- The exact tail: the JAX ``ExactTailHybrid`` on a JAX ``engine="jnp"``
  bulk against the port's on an ``engine="vector"`` bulk.  The JAX class
  builds its per-cell splitting engine in its exact-gather form
  (``fast=False``, the form the port ports; ``test_torch_splitting.py``
  holds the JAX forms to each other): a CPU compile of the other form costs
  about 38 s.  Selection identical; exact rows within the splitting tests'
  bars (rtol 2e-4, atol 1e-10 on per-ray probabilities); patched metrics
  within 1e-4 relative.
"""

import dataclasses
import functools
import json

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.config import (
    EvalConfig as JEvalConfig,
    TraceConfig as JTraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine import (
    hybrid as jhybrid,
    splitting as jsplitting,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.pipeline import (
    Simulator as JSimulator,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    EvalConfig,
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    hybrid,
    pipeline,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import metrics

M, N = 4, 3
CFG_KW = dict(num_fov_x=M, num_fov_y=N, rays_per_fov=256, num_iter=1,
              max_bounces=200, seed=0)
CFG = TraceConfig(**CFG_KW)
EVAL = EvalConfig(pupil_mask_bins=60)
BOOST = dict(tau_select=5.0, tau_target=2.0, max_boost=16.0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One torch thread for this module: its small tensors gain nothing from
    more, and the suite runs several workers on the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def sim():
    return pipeline.Simulator(cfg=CFG, device="cpu", persistent_slots=128,
                              spawn_mode="count", fold_iterations=True)


def test_cell_lnm_roundtrip():
    M_, N_ = 7, 5
    cells = np.arange(3 * M_ * N_)
    l, n, m = hybrid._cell_lnm(cells, M_, N_)
    assert np.array_equal((l * M_ + m) * N_ + n, cells)
    for a, b in zip((l, n, m), jhybrid._cell_lnm(cells, M_, N_)):
        assert np.array_equal(a, b)


class _Stub:
    """The JAX hybrid's view of a persistent Simulator, answered by the
    port: ``run`` is the port Simulator's, its histogram handed over as
    numpy; ``_trace_batch_tiles`` returns the tiles the port's own tail pass
    traced for the same cells and target, after checking that the JAX
    batch carries the port's seeds."""

    engine = "pallas_persistent"

    def __init__(self, port_sim, launches=None):
        self.p = port_sim
        self.cfg = JTraceConfig(**CFG_KW)
        self.geom = jgenerate_geometry(num_fov_x=M, num_fov_y=N)
        self.L, self.M, self.N = port_sim.L, port_sim.M, port_sim.N
        self._spawn_iters = port_sim._spawn_iters
        self._spawn_mode = port_sim._spawn_mode
        self._slots_gens = port_sim._slots_gens
        self.launches = launches
        self.batches = []

    def run(self, **kw):
        res = self.p.run(**kw)
        return dataclasses.replace(res, histogram=res.histogram.numpy())

    def _trace_batch_tiles(self, batch, cell_ids, rays_per_cell):
        self.batches.append((np.asarray(cell_ids), rays_per_cell, batch))
        tiles, nb, n, _, _ = self.launches[(tuple(cell_ids), rays_per_cell)]
        return jnp.asarray(tiles.numpy()), jnp.asarray(nb.numpy()), n


@pytest.fixture(scope="module")
def boost(sim):
    """The port's boost hybrid, every tail launch recorded with the seeds
    and launch tile it traced, and the JAX hybrid around the stub."""
    hy = hybrid.TailBoostHybrid(sim, eval_cfg=EVAL, **BOOST)
    launches = {}
    blocks = sim._device_ray_blocks
    trace = sim.trace_batch_tiles
    seen = []

    def rec_blocks(cell_ids, slots, iteration=0, cpb=1):
        out = blocks(cell_ids, slots, iteration, cpb)
        seen.append((iteration, out))
        return out

    def rec_trace(cell_ids, rays_per_cell, iteration):
        out = trace(cell_ids, rays_per_cell, iteration)
        it, (tile, seeds) = seen[-1]
        assert it == iteration
        launches[(tuple(cell_ids), rays_per_cell)] = (*out, iteration,
                                                      (tile, seeds))
        return out

    sim._device_ray_blocks = rec_blocks
    sim.trace_batch_tiles = rec_trace
    try:
        res, diags = hy.run(cells_per_batch=64)
    finally:
        del sim._device_ray_blocks, sim.trace_batch_tiles
    jhy = jhybrid.TailBoostHybrid(
        _Stub(sim, launches), pilot_sim=_Stub(hy.pilot_sim),
        eval_cfg=JEvalConfig(pupil_mask_bins=60), **BOOST)
    jres, jdiags = jhy.run(cells_per_batch=64)
    return dict(hy=hy, res=res, diags=diags, launches=launches, jhy=jhy,
                jres=jres, jdiags=jdiags)


def test_boost_tail_matches_jax(boost):
    """Selection, tiers, rows and sums of the port's boost tail against the
    JAX hybrid's on the same pilot and tail samples; the patched metrics
    and efficiencies too."""
    sel, rows, sums, frag = boost["hy"].tail
    jsel, jrows, jsums, jfrag = boost["jhy"].tail
    assert len(sel) and len(sel) < 3 * M * N
    assert np.array_equal(sel, jsel)
    assert frag["tiers"] == jfrag["tiers"] and len(frag["tiers"]) >= 2
    assert np.array_equal(frag["cell_tier"], jfrag["cell_tier"])
    assert frag["tail_rays"] == jfrag["tail_rays"] > 0
    for k in ("min_pilot_count", "min_tail_expected"):
        assert frag[k] == pytest.approx(jfrag[k], rel=1e-6, abs=1e-12), k
    np.testing.assert_allclose(rows, jrows, rtol=2e-6, atol=1e-9)
    np.testing.assert_allclose(sums, jsums, rtol=2e-6, atol=1e-12)
    res, jres = boost["res"], boost["jres"]
    for k, v in jres.efficiencies.items():
        assert res.efficiencies[k] == pytest.approx(v, rel=1e-6), k
    for k in ("delta_e", "u_fov", "u_eyebox"):
        assert getattr(res.metrics, k) == pytest.approx(
            getattr(jres.metrics, k), rel=1e-4, abs=1e-9), k
    assert (res.metrics.starved_eye_positions
            == jres.metrics.starved_eye_positions)
    d = boost["diags"]
    assert d.tier_launches == {t: 1 for t in frag["tiers"]}
    assert 0 < d.max_tail_iterations <= CFG.max_bounces


def test_boost_tail_seeds_equal_jax_batches(boost):
    """(P1) every tail launch: the port's seeds (hashed by
    ``seed_fast_device`` at the tail iteration tag) and launch tile equal
    the ``rng`` and fields of the batch the JAX class builds for it."""
    stub = boost["jhy"].sim
    assert len(stub.batches) == len(boost["launches"]) >= 2
    for cells, rpc, batch in stub.batches:
        *_, it, (tile, seeds) = boost["launches"][(tuple(cells), rpc)]
        assert it == hybrid.tail_iteration(rpc) >= 1_000_004
        slots = pipeline.Simulator._slots_gens(boost["hy"].sim, rpc)[0]
        want = np.asarray(batch["rng"]).view(np.int32).reshape(
            len(cells), -1, 128)
        np.testing.assert_array_equal(seeds.numpy(), want)
        fields = tile.numpy()[0].reshape(6, slots)
        np.testing.assert_array_equal(
            fields[0], np.asarray(batch["x"][:slots], np.float32))
        np.testing.assert_array_equal(
            fields[2], np.asarray(batch["te"][:slots]).real)


def test_boost_splice_rowwise(boost, sim, monkeypatch):
    """Unselected rows of the patched stack are the Monte-Carlo rows bit for
    bit and selected rows are the tail rows; the metrics are those of the
    patched stack."""
    hy = boost["hy"]
    sel, rows, sums, _ = hy.tail
    seen = {}
    evaluate = hybrid.evaluate

    def spy(m, cfg, perceive):
        seen["perc"] = perceive.copy()
        return evaluate(m, cfg, perceive=perceive)

    monkeypatch.setattr(hybrid, "evaluate", spy)
    res, _ = hy.run(cells_per_batch=64)
    base = sim.run(histogram_device=True, evaluate_metrics=False,
                   cells_per_batch=64)
    perc_mc = metrics.eye_perceived_torch(base.histogram, EVAL).numpy() / (
        CFG.rays_per_fov * CFG.num_iter)
    l, n, m = hybrid._cell_lnm(sel, M, N)
    mask = np.zeros(perc_mc.shape[:3], bool)
    mask[l, n, m] = True
    np.testing.assert_array_equal(hy.last_mc_rows, perc_mc[l, n, m])
    np.testing.assert_array_equal(seen["perc"][~mask], perc_mc[~mask])
    np.testing.assert_array_equal(seen["perc"][l, n, m],
                                  rows.astype(np.float32))
    met = evaluate(None, EVAL, perceive=seen["perc"])
    assert met.u_eyebox == res.metrics.u_eyebox
    assert met.delta_e == res.metrics.delta_e
    mc = sim.run(cells_per_batch=64, eval_cfg=EVAL).metrics
    assert res.metrics.starved_eye_positions < mc.starved_eye_positions


def test_boost_tail_cache_and_share(boost, sim):
    """The tail is built once per design: a run reuses it, and a second
    hybrid handed ``tail=`` runs no pilot and gives the same metrics."""
    hy = boost["hy"]
    tail = hy.tail
    res, _ = hy.run(cells_per_batch=64)
    assert hy.tail is tail
    hy2 = hybrid.TailBoostHybrid(sim, tail=tail, eval_cfg=EVAL, **BOOST)
    hy2.pilot_sim.run = None      # never called
    res2, d2 = hy2.run(cells_per_batch=64)
    assert hy2.tail is tail
    assert res2.metrics.u_eyebox == res.metrics.u_eyebox
    assert d2.selected_cells == len(tail[0])


def test_pilot_shares_the_simulator(sim):
    """The pilot is the main Simulator's design at another seed: the same
    tables, trace geometry and bound tracer, nothing rebuilt."""
    hy = hybrid.TailBoostHybrid(sim, **BOOST)
    p = hy.pilot_sim
    assert p.cfg.seed == CFG.seed + 104729 and sim.cfg.seed == CFG.seed
    assert p.tracer is sim.tracer and p.tables is sim.tables
    assert p.tgeom is sim.tgeom and p.geom is sim.geom
    with pytest.raises(ValueError, match="persistent"):
        hybrid.TailBoostHybrid(
            pipeline.Simulator(cfg=CFG, device="cpu", engine="vector"))


@pytest.fixture(scope="module")
def exact_pair(monkeypatch_module):
    exact_kw = dict(tau=0.1, stride=2, pilot_points=1, exact_points=2,
                    points_per_pass=1, threshold=1e-5, capacity=8192,
                    max_steps=512)
    monkeypatch_module.setattr(
        jsplitting, "make_splitting_cells_fn",
        functools.partial(jsplitting.make_splitting_cells_fn, fast=False))
    jsim = JSimulator(cfg=JTraceConfig(**CFG_KW), engine="jnp")
    jhy = jhybrid.ExactTailHybrid(
        jsim, eval_cfg=JEvalConfig(pupil_mask_bins=60), **exact_kw)
    jres, jd = jhy.run()
    psim = pipeline.Simulator(cfg=CFG, device="cpu", engine="vector")
    hy = hybrid.ExactTailHybrid(psim, eval_cfg=EVAL, **exact_kw)
    res, d = hy.run()
    return hy, res, d, jhy, jres, jd


@pytest.fixture(scope="module")
def monkeypatch_module():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()


def test_exact_tail_matches_jax(exact_pair):
    hy, res, d, jhy, jres, jd = exact_pair
    sel, rows, sums, pruned, _ = hy._exact
    jsel, jrows, jsums, jpruned, _ = jhy._exact
    assert 0 < len(sel) < 3 * M * N
    assert np.array_equal(sel, jsel)
    assert d.min_pilot_count == pytest.approx(jd.min_pilot_count, rel=2e-4)
    np.testing.assert_allclose(rows, jrows, rtol=2e-4, atol=1e-10)
    np.testing.assert_allclose(sums, jsums, rtol=1e-5, atol=1e-10)
    assert pruned == pytest.approx(jpruned, rel=1e-4)
    assert res.metrics.starved_eye_positions == 0
    for k in ("delta_e", "u_eyebox", "u_fov"):
        assert getattr(res.metrics, k) == pytest.approx(
            getattr(jres.metrics, k), rel=1e-4), k
    for k, v in jres.efficiencies.items():
        assert res.efficiencies[k] == pytest.approx(v, rel=1e-4), k


@pytest.mark.parametrize("flags,msg", [
    (["--tail-boost", "--tail-exact"], "ONE of"),
    (["--tail-boost", "--engine", "vector"], "requires --engine persistent"),
    (["--tail-boost", "--error-bars"], "--error-bars"),
    (["--tail-exact", "--dense-eyebox"], "--dense-eyebox"),
    (["--tail-boost", "--checkpoint", "c.npz"], "--checkpoint"),
    (["--tail-exact", "--wavelengths", "1"], "--wavelengths"),
])
def test_cli_refusals(monkeypatch, flags, msg):
    """Refused before any Simulator is built, with the JAX CLI's messages."""
    built = []
    monkeypatch.setattr(pipeline, "Simulator", lambda *a, **k: built.append(1))
    with pytest.raises(SystemExit, match=msg):
        cli.main(["simulate", "--device", "cpu", "--image", ""] + flags)
    assert not built


def test_cli_tail_boost_on_cpu(tmp_path, capsys):
    out = tmp_path / "m.json"
    assert cli.main(["simulate", "--device", "cpu", "--fov-x", "2",
                     "--fov-y", "2", "--rays-per-fov", "32", "--num-iter",
                     "1", "--max-bounces", "200", "--slots", "128",
                     "--tail-boost", "--tail-max-boost", "4", "--image", "",
                     "--json", str(out)]) == 0
    text = capsys.readouterr().out
    assert "[tail boost:" in text and "boosted rays in tiers" in text
    tb = json.loads(out.read_text())["tail_boost"]
    assert tb["mode"] == "boost" and tb["selected_cells"] > 0
    assert tb["tail_rays"] > 0 and set(tb["tiers"]) <= {"2", "4"}
    d = hybrid.HybridDiagnostics(
        selected_cells=3, pilot_seconds=0.1, tail_seconds=0.2,
        mc_seconds=0.3, tail_rays=0, min_pilot_count=1.0,
        min_tail_expected=1.0, tiers={}, tau_select=30.0, tau_target=30.0,
        exact_pruned=1e-7)
    assert cli._tail_report(d).startswith("  [exact tail: 3 starvation-risk")
