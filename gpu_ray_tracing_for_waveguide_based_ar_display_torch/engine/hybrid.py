"""Tail-patched transport: re-resolve the Monte-Carlo-starved tail of the
eyebox-uniformity metric and splice it into the perception stack.

Port of ``engine/hybrid.py`` of the JAX package.  The reference's evaluation
zeroes ``u_eyebox`` whenever any (FoV cell, eye position) pupil window
receives no deposit, so at its default budget (5,000 rays per FoV x 4
iterations) the corner eye positions starve.  Those windows have per-ray
probabilities of about 1e-4 to 1e-6 and sit in a small tail of cells, so the
hybrid traces that tail again, better resolved, and replaces its rows of the
per-cell perception stack: a row assignment on the (L, N, M, epy, epx) stack,
never a histogram-sized scatter.

Two tail engines:

- :class:`TailBoostHybrid`: the tail rows come from boosted Monte-Carlo
  passes of the same persistent kernel (:mod:`.trace_persistent`); the
  per-cell spawn target is a launch argument, so tiers of 2x..``max_boost``x
  the budget run on the kernel the main run uses;
- :class:`ExactTailHybrid`: the tail rows are the zero-variance branch
  expectation of the per-cell splitting engine (:mod:`.splitting`).

Unbiasedness (both engines):

1. A pilot pass (an independent-seed Monte-Carlo run at the same budget, or
   an exact pass over a coarse FoV grid) estimates every (cell, window)
   expected count.
2. Selection and boost sizing read only the pilot, never the main run nor
   the tail pass, so the kept main-run rows are not conditioned on their own
   noise and the spliced rows are plain (boosted) Monte-Carlo or exact
   values.  Every cell's final value comes from exactly one source.
3. The Monte-Carlo roulette picks each branch with its energy fraction and
   deposits unit weights, so the splitting engine's weighted tiles per
   launch ray are per-ray deposit probabilities: the two tail engines
   estimate the same quantity.
"""

from __future__ import annotations

import copy
import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import EvalConfig
from ..eval.metrics import (
    evaluate, eye_perceived_torch, wavelength_channel_names,
)
from . import seeding, splitting
from .pipeline import evaluate_on_device
from .timing import EventTimer

# seeding iteration tag of the boost passes: displaced far beyond any main
# run's iteration index, one octave of the per-cell target per tag
TAIL_ITERATION = 1_000_003


def tail_iteration(rays_per_cell: int) -> int:
    """The seeding iteration of a boost pass at ``rays_per_cell``."""
    return TAIL_ITERATION + int(np.log2(max(rays_per_cell, 2)))


@dataclasses.dataclass
class HybridDiagnostics:
    selected_cells: int          # tail size (out of L*M*N)
    pilot_seconds: float
    tail_seconds: float
    mc_seconds: float
    tail_rays: int               # extra rays traced by the boost pass (0: exact)
    min_pilot_count: float       # smallest pilot window count over all cells
    min_tail_expected: float     # smallest post-boost expected window count
    tiers: dict                  # boost tier -> cell count (empty: exact)
    tau_select: float
    tau_target: float
    exact_pruned: float = 0.0    # splitting mode: sub-threshold pruned weight
    cell_tier: Optional[np.ndarray] = None   # per-selected-cell boost tier
    tier_launches: Optional[dict] = None     # boost tier -> kernel launches
    max_tail_iterations: int = 0             # largest nb[:, 1] of the tail
    # tail cells stopped by the iteration cap (cfg.max_bounces) before their
    # spawn target; their tiles are renormalised by target / spawned
    tail_cells_at_cap: int = 0


def _cell_lnm(cells: np.ndarray, M: int, N: int):
    """Flat cell id (l*M + m)*N + n -> (l, n, m) perceive-stack indices."""
    l = cells // (M * N)
    m = (cells % (M * N)) // N
    n = cells % N
    return l, n, m


def _device_hist(sim, hist) -> torch.Tensor:
    """A run's histogram on the Simulator's device (uploaded only when a
    caller ran the bulk with ``histogram_device=False``)."""
    if isinstance(hist, np.ndarray):
        return torch.from_numpy(np.ascontiguousarray(hist, np.float32)).to(
            sim.device)
    return hist


def _patched_result(sim, res, norm, selected, rows, sums, eval_cfg,
                    metrics_device=False):
    """Splice tail rows into the perception stack; re-evaluate the metrics
    (with the eye-view image) and the per-colour efficiencies.  ``rows`` /
    ``sums`` are per-ray units.  On the host (float64 colorimetry of the
    pulled stack), or with ``metrics_device`` on the device: the rows and
    sums uploaded once, spliced into the device stack, the colorimetry
    :func:`.pipeline.evaluate_on_device`'s, its spans and the splice's
    seconds (``metrics_s``) added to the result's timings.  Returns the
    patched result and the Monte-Carlo rows replaced."""
    hist = _device_hist(sim, res.histogram)
    l, n, m = _cell_lnm(selected, sim.M, sim.N)
    timings = dict(res.timings)
    if metrics_device:
        timer = EventTimer(sim.device)
        t0 = time.perf_counter()
        idx = tuple(torch.from_numpy(i).to(sim.device) for i in (l, n, m))
        with timer.span("perceive"):
            perc = eye_perceived_torch(hist, eval_cfg) / norm
        mc_rows = perc[idx].cpu().numpy()
        perc[idx] = torch.from_numpy(np.asarray(rows, np.float32)).to(
            sim.device)
        per_cell = hist.sum(dim=(3, 4), dtype=torch.float64) / norm
        per_cell[idx] = torch.from_numpy(np.asarray(sums, np.float64)).to(
            sim.device)
        met = evaluate_on_device(perc, 1.0, timer, timings)
        per_colour = per_cell.sum(dim=(1, 2)).cpu().numpy()
        timings["metrics_s"] = time.perf_counter() - t0
        timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
    else:
        perc = eye_perceived_torch(hist, eval_cfg).cpu().numpy() / norm
        per_cell = hist.sum(dim=(3, 4)).cpu().numpy() / norm    # (L, N, M)
        mc_rows = perc[l, n, m].copy()
        perc[l, n, m] = rows
        per_cell[l, n, m] = sums
        met = evaluate(None, eval_cfg, perceive=perc)
        per_colour = [per_cell[i].sum() for i in range(sim.L)]
    names = wavelength_channel_names(sim.L)
    # x L undoes the 1/L wavelength split of the launch budget
    # (eval.metrics.efficiencies semantics)
    eff = {names[i]: float(per_colour[i] / (sim.M * sim.N))
           for i in range(sim.L)}
    return dataclasses.replace(res, metrics=met, efficiencies=eff,
                               timings=timings), mc_rows


def _run_norm(sim, res, rays_per_fov, num_iter) -> float:
    """Mirror ``Simulator.run``'s histogram normalisation (rays per cell)."""
    iters = num_iter if num_iter is not None else sim.cfg.num_iter
    cells_traced = sim.L * sim.M * sim.N * iters
    total = res.rays_traced
    if (sim.engine == "persistent"
            and (sim._spawn_iters > 0 or sim._spawn_mode == "count")):
        # rays_traced reports actual spawns; tiles are renormalised to
        # nominal units (Simulator._renorm_tiles), so normalise by the
        # nominal target
        rpf = rays_per_fov if rays_per_fov is not None else sim.cfg.rays_per_fov
        total = rpf * cells_traced
    return total / cells_traced


def _bulk_run(sim, rays_per_fov, num_iter, run_kw):
    """The Monte-Carlo bulk run, its histogram kept on the device (unless
    ``run_kw`` says otherwise), metrics left to the splice."""
    run_kw.setdefault("histogram_device", True)
    run_kw["evaluate_metrics"] = False
    t0 = time.perf_counter()
    res = sim.run(rays_per_fov=rays_per_fov, num_iter=num_iter, **run_kw)
    if sim.device.type == "cuda":
        torch.cuda.synchronize(sim.device)
    iters = num_iter if num_iter is not None else sim.cfg.num_iter
    norm = _run_norm(sim, res, rays_per_fov, num_iter) * iters
    return res, norm, time.perf_counter() - t0


class TailBoostHybrid:
    """Monte-Carlo bulk + tier-boosted Monte-Carlo tail on the persistent
    kernel.

    ``sim`` must be a ``persistent`` Simulator.  ``pilot_sim`` (same design,
    another ``cfg.seed``) gives the selection pass; built by
    :meth:`make_pilot_sim` it shares ``sim``'s geometry, LUTs, tables and
    bound kernel.

    - ``tau_select``: a cell group is selected when its worst pilot window
      count is below this (pilot counts are about Poisson).
    - ``tau_target``: post-boost expected count floor of the worst window;
      the boost per group is ``1.5 * tau_target / pilot count`` rounded up
      to a power of ``tier_base``.  Zero-count windows, where the pilot
      gives no rate at all, go straight to ``max_boost``.
    - ``max_boost``: the tier cap; it bounds the tail's cost for windows
      that are dark by the physics.
    """

    def __init__(self, sim, pilot_sim=None, *, tau_select: float = 30.0,
                 tau_target: float = 20.0, tier_base: float = 2.0,
                 max_boost: float = 1024.0, cells_per_batch: int = 2048,
                 eval_cfg: EvalConfig = EvalConfig(),
                 pilot_seed_offset: int = 104729, tail=None):
        if sim.engine != "persistent":
            raise ValueError("TailBoostHybrid needs the persistent engine")
        self.sim = sim
        self.pilot_sim = pilot_sim or self.make_pilot_sim(
            sim, sim.cfg.seed + pilot_seed_offset)
        self.tau_select = tau_select
        self.tau_target = tau_target
        self.tier_base = tier_base
        self.max_boost = max_boost
        self.eval_cfg = eval_cfg
        self._cpb = cells_per_batch
        # the tail launches' largest nb[:, 1] and cells stopped by the cap
        self._iters = {"max": 0, "at_cap": 0}
        # (selected, rows, sums, diagnostics fragment).  ``tail`` is the
        # share handle: a previous ``build_tail()`` / ``.tail`` reused across
        # Simulators of the same design and pilot seed (runs sharing a tail
        # share its spliced components, so their u_eyebox spread understates
        # fully independent repetitions)
        self._tail = tail

    @property
    def tail(self):
        """The built tail (or None): a shareable (selected, rows, sums,
        diagnostics) tuple, valid for any Simulator with the same design and
        pilot seed; pass it to ``TailBoostHybrid(..., tail=...)``."""
        return self._tail

    @staticmethod
    def make_pilot_sim(sim, seed: int):
        """A Simulator of ``sim``'s design with ``cfg.seed = seed``: it
        shares the geometry, LUTs, tables and bound kernel (which do not
        depend on the seed) and builds none of its own.  As in the JAX
        package, the pilot runs one cell per block with no saturating
        spawn."""
        pilot = copy.copy(sim)
        pilot.cfg = dataclasses.replace(sim.cfg, seed=seed)
        pilot._tile = None
        pilot._points = None
        pilot.stats = {}
        pilot._spawn_iters = 0
        pilot._pers_cpb = 1
        return pilot

    # -- pilot + tier assignment ------------------------------------------
    def build_tail(self, rays_per_fov: Optional[int] = None,
                   num_iter: Optional[int] = None, **run_kw):
        """Pilot run -> selection -> boosted tail rows.  Cached per
        design."""
        sim, pilot = self.sim, self.pilot_sim
        rpf = rays_per_fov if rays_per_fov is not None else sim.cfg.rays_per_fov
        iters = num_iter if num_iter is not None else sim.cfg.num_iter
        budget = rpf * iters

        t0 = time.perf_counter()
        run_kw.setdefault("histogram_device", True)
        pres = pilot.run(rays_per_fov=rays_per_fov, num_iter=num_iter,
                         evaluate_metrics=False, **run_kw)
        # raw pilot counts (nominal-sample units: deposit counts up to the
        # spawn renormalisation)
        counts = eye_perceived_torch(_device_hist(pilot, pres.histogram),
                                     self.eval_cfg).cpu().numpy()
        pnorm = _run_norm(pilot, pres, rays_per_fov, num_iter) * iters
        counts = counts * (budget / pnorm)
        pilot_s = time.perf_counter() - t0

        # starvation is a property of the lambda-combined luminance (the
        # colorimetry sums the wavelength channels with positive drive
        # weights): one group = one (FoVy, FoVx) site, its L cells boosted
        # together
        comb = counts.sum(axis=0)                    # (fy, fx, py, px)
        worst = comb.min(axis=(2, 3)).reshape(-1)    # flat (fy=n, fx=m) groups
        gsel = np.where(worst < self.tau_select)[0]
        min_pilot = float(worst.min()) if len(worst) else 0.0

        # tier sizing: a pilot count w ~ Poisson(m) with w >= 1 gives
        # m >= w / 1.5 with overwhelming probability at the counts that
        # matter, so boost = 1.5 * tau_target / w puts the post-boost
        # expectation above tau_target; w == 0 (no rate information: the
        # starved windows this exists for) goes straight to max_boost
        wsel = worst[gsel]
        boost = np.where(
            wsel <= 0.0, self.max_boost,
            np.clip(1.5 * self.tau_target / np.where(wsel > 0.0, wsel, 1.0),
                    self.tier_base, self.max_boost))
        gtier = np.minimum(
            self.tier_base ** np.ceil(np.log(boost) / np.log(self.tier_base)),
            self.max_boost)

        # group (n, m) -> its L cell ids (l*M + m)*N + n
        L, M, N = sim.L, sim.M, sim.N
        gn, gm = gsel // M, gsel % M
        t0 = time.perf_counter()
        epy, epx = counts.shape[3:]
        rows = np.zeros((L * len(gsel), epy, epx), np.float64)
        sums = np.zeros(L * len(gsel), np.float64)
        cell_of = np.zeros(L * len(gsel), np.int64)
        tier_of = np.zeros(L * len(gsel), np.float64)
        tail_rays = 0
        tiers, tier_launches = {}, {}
        self._iters = {"max": 0, "at_cap": 0}
        min_exp = np.inf
        pos = 0
        for tier in np.unique(gtier):
            idx = np.where(gtier == tier)[0]
            cells = np.sort(np.concatenate([
                (l * M + gm[idx]) * N + gn[idx] for l in range(L)]))
            tiers[int(tier)] = int(len(idx))
            tier_rpf = int(tier * budget)
            t_rows, t_sums, n_rays = self._tail_pass(cells, tier_rpf)
            tier_launches[int(tier)] = -(-len(cells) // self._cpb)
            rows[pos:pos + len(cells)] = t_rows
            sums[pos:pos + len(cells)] = t_sums
            cell_of[pos:pos + len(cells)] = cells
            tier_of[pos:pos + len(cells)] = tier
            pos += len(cells)
            tail_rays += n_rays
            # post-boost combined worst-window expectation of this tier
            li, ni, mi = _cell_lnm(cells, M, N)
            order = np.argsort(ni * M + mi, kind="stable")
            gsum = t_rows[order].reshape(len(idx), L, epy, epx).sum(axis=1)
            min_exp = min(min_exp, float(gsum.min(axis=(1, 2)).min()
                                         * tier_rpf))
        tail_s = time.perf_counter() - t0
        order = np.argsort(cell_of, kind="stable")
        self._tail = (cell_of[order], rows[order], sums[order], dict(
            pilot_seconds=pilot_s, tail_seconds=tail_s, tail_rays=tail_rays,
            min_pilot_count=min_pilot,
            min_tail_expected=(0.0 if not len(gsel) else float(min_exp)),
            tiers=tiers, cell_tier=tier_of[order],
            tier_launches=tier_launches,
            max_tail_iterations=self._iters["max"],
            tail_cells_at_cap=self._iters["at_cap"]))
        return self._tail

    def _tail_pass(self, cells: np.ndarray, tier_rpf: int):
        """Boosted Monte-Carlo over ``cells`` at ``tier_rpf`` rays per cell
        -> per-ray (C, epy, epx) window rows, (C,) tile sums and the rays
        traced.  An independent sample stream: the seeding iteration tag
        (:func:`tail_iteration`) lies far beyond any main-run iteration."""
        sim = self.sim
        rows, sums, total = [], [], 0
        for s in range(0, len(cells), self._cpb):
            chunk = cells[s:s + self._cpb]
            tiles, nb, n = sim.trace_batch_tiles(chunk, tier_rpf,
                                                 tail_iteration(tier_rpf))
            nbh = nb.cpu().numpy()
            self._iters["max"] = max(self._iters["max"], int(nbh[:, 1].max()))
            self._iters["at_cap"] += int(((nbh[:, 1] >= sim.cfg.max_bounces)
                                          & (nbh[:, 2] < tier_rpf)).sum())
            perc = eye_perceived_torch(tiles, self.eval_cfg)
            rows.append(perc.cpu().numpy().astype(np.float64) / tier_rpf)
            sums.append(tiles.sum(dim=(1, 2)).cpu().numpy().astype(np.float64)
                        / tier_rpf)
            total += n
        return np.concatenate(rows), np.concatenate(sums), total

    # -- full hybrid run ----------------------------------------------------
    def run(self, rays_per_fov: Optional[int] = None,
            num_iter: Optional[int] = None, metrics_device: bool = False,
            **run_kw):
        """Main Monte-Carlo run + tail splice -> (SimulationResult,
        HybridDiagnostics).  The tail (pilot + boost passes) is built once
        per design and reused across runs: it depends only on (design,
        pilot seed).  ``metrics_device``: splice and evaluate on the device
        (:func:`_patched_result`); otherwise on the host, as the JAX
        package does."""
        if self._tail is None:
            self.build_tail(rays_per_fov, num_iter, **dict(run_kw))
        selected, rows, sums, frag = self._tail
        res, norm, mc_s = _bulk_run(self.sim, rays_per_fov, num_iter, run_kw)
        res, mc_rows = _patched_result(
            self.sim, res, norm, selected, rows, sums, self.eval_cfg,
            metrics_device)
        self.last_mc_rows = mc_rows
        self.last_selected = selected
        diags = HybridDiagnostics(
            selected_cells=int(len(selected)), mc_seconds=mc_s,
            tau_select=self.tau_select, tau_target=self.tau_target, **frag)
        return res, diags


class ExactTailHybrid:
    """Monte-Carlo bulk + zero-variance splitting tail (the exact branch
    expectation).

    The tail engine is :func:`.splitting.make_splitting_cells_fn` on the
    bulk Simulator's device; the pilot is an exact pass over a coarse FoV
    subgrid, min-pooled to the fine grid (conservative).

    - ``tau``: expected-count threshold on the pilot's worst window.
    - ``threshold``: the splitting prune threshold; a tree's peak width grows
      steeply below 1e-6, so ``capacity`` must track it.  The pruned weight
      is ledgered in the diagnostics: it bounds the tail rows' bias.
    """

    def __init__(self, sim, *, tau: float = 20.0, stride: int = 4,
                 pilot_points: int = 4, exact_points: int = 16,
                 points_per_pass: int = 4, threshold: float = 1e-6,
                 capacity: int = 32768, max_steps: int = 4096,
                 cells_per_batch: Optional[int] = None,
                 eval_cfg: EvalConfig = EvalConfig(), pilot_seed: int = 99991):
        self.sim = sim
        self.tau = tau
        self.stride = stride
        self.eval_cfg = eval_cfg
        self.pilot_points = pilot_points
        self.exact_points = exact_points
        # per-tree peak widths add across launch points traced together, so
        # points beyond this run as separate accumulation passes (each pass
        # is exact for its points; the mean over passes for the union)
        self.points_per_pass = points_per_pass
        self._seed = pilot_seed
        self._trace = splitting.make_splitting_cells_fn(
            sim.tables, sim.tgeom, sim.cfg, capacity=capacity,
            weight_threshold=threshold, max_steps=max_steps,
            device=sim.device)
        self._capacity = capacity
        self._cpb = cells_per_batch or max(1, (1 << 22) // capacity)
        self._exact = None

    def _seeds(self, num_points: int, seed: int) -> dict:
        """Shared RQMC pupil launch seeds (R2 lattice + Cranley-Patterson
        rotation, :func:`.seeding.sample_points_r2_disk`) in the Monte-Carlo
        seeder's TE-then-TM layout, float32 on the device."""
        rng = np.random.default_rng(seed)
        pts = seeding.sample_points_r2_disk(self.sim.geom.ic, num_points, rng)
        fields = seeding.launch_fields(seeding.to_device(pts, self.sim.device))
        return dict(zip(seeding.FIELDS, fields))

    def _exact_perceive(self, cells: np.ndarray, points: int, seed: int):
        """(C, epy, epx) per-ray window probabilities, (C,) tile sums and
        the pruned weight."""
        ppp = min(points, self.points_per_pass)
        rows, sums = [], []
        trunc = pruned = 0.0
        for s in range(0, len(cells), self._cpb):
            chunk = cells[s:s + self._cpb]
            tiles_acc = out_acc = None
            for g in range(0, points, ppp):
                seeds = self._seeds(min(ppp, points - g), seed + 31 * g)
                tiles, out_w, tr, pr, _steps, _peak = self._trace(chunk, seeds)
                tiles_acc = tiles if tiles_acc is None else tiles_acc + tiles
                out_acc = out_w if out_acc is None else out_acc + out_w
                trunc += float(tr.sum())
                pruned += float(pr.sum())
            rows.append(eye_perceived_torch(tiles_acc,
                                            self.eval_cfg).cpu().numpy())
            sums.append(out_acc.cpu().numpy())
        n_rays = 2 * points  # TE + TM branch trees per launch point
        rows = np.concatenate(rows, axis=0) / n_rays
        sums = np.concatenate(sums, axis=0) / n_rays
        if trunc > 0:
            raise RuntimeError(
                f"splitting wavefront truncated {trunc:.3g} weight at "
                f"capacity {self._capacity}: the exact-tail guarantee is "
                "void; raise capacity")
        return rows, sums, pruned

    def select(self) -> np.ndarray:
        """Starvation-risk cell ids: a pure function of (design, pilot
        seed), independent of every Monte-Carlo sample."""
        sim = self.sim
        L, M, N = sim.L, sim.M, sim.N
        ms = np.arange(0, M, self.stride)
        ns = np.arange(0, N, self.stride)
        if ms[-1] != M - 1:
            ms = np.append(ms, M - 1)
        if ns[-1] != N - 1:
            ns = np.append(ns, N - 1)
        ll, mm, nn = np.meshgrid(np.arange(L), ms, ns, indexing="ij")
        coarse = ((ll * M + mm) * N + nn).reshape(-1)
        t0 = time.perf_counter()
        rows, _sums, _pr = self._exact_perceive(
            coarse, self.pilot_points, self._seed)
        self._pilot_seconds = time.perf_counter() - t0
        epy, epx = rows.shape[1:]
        grid = rows.reshape(L, len(ms), len(ns), epy, epx)

        # conservative upsample: each fine (m, n) takes the elementwise min
        # of its bracketing coarse nodes; tau carries the curvature margin
        mi = np.searchsorted(ms, np.arange(M), side="right") - 1
        mi_hi = np.minimum(mi + 1, len(ms) - 1)
        ni = np.searchsorted(ns, np.arange(N), side="right") - 1
        ni_hi = np.minimum(ni + 1, len(ns) - 1)
        g = grid
        cand = np.minimum(
            np.minimum(g[:, mi][:, :, ni], g[:, mi][:, :, ni_hi]),
            np.minimum(g[:, mi_hi][:, :, ni], g[:, mi_hi][:, :, ni_hi]),
        )  # (L, M, N, epy, epx)
        budget = float(sim.cfg.rays_per_fov * sim.cfg.num_iter)
        expected = budget * cand.min(axis=(3, 4))
        self._min_expected = float(expected.min())
        # flat (l, m, n) order == the engine's cell-id layout
        return np.sort(np.where(
            (expected < self.tau).reshape(-1))[0]).astype(np.int64)

    def run(self, rays_per_fov: Optional[int] = None,
            num_iter: Optional[int] = None, exact_seed: int = 1_000_003,
            metrics_device: bool = False, **run_kw):
        """Monte-Carlo run + exact-tail splice -> (SimulationResult,
        HybridDiagnostics); ``metrics_device`` as in
        :meth:`TailBoostHybrid.run`."""
        if self._exact is None:
            selected = self.select()
            t0 = time.perf_counter()
            rows, sums, pruned = (
                self._exact_perceive(selected, self.exact_points, exact_seed)
                if len(selected) else
                (np.zeros((0, 1, 1)), np.zeros((0,)), 0.0))
            self._exact = (selected, rows, sums, pruned,
                           time.perf_counter() - t0)
        selected, rows, sums, pruned, exact_s = self._exact
        res, norm, mc_s = _bulk_run(self.sim, rays_per_fov, num_iter, run_kw)
        res, mc_rows = _patched_result(
            self.sim, res, norm, selected, rows, sums, self.eval_cfg,
            metrics_device)
        self.last_mc_rows = mc_rows
        self.last_selected = selected
        diags = HybridDiagnostics(
            selected_cells=int(len(selected)),
            pilot_seconds=self._pilot_seconds, tail_seconds=exact_s,
            mc_seconds=mc_s, tail_rays=0,
            min_pilot_count=self._min_expected,
            min_tail_expected=self._min_expected, tiers={},
            tau_select=self.tau, tau_target=self.tau, exact_pruned=pruned)
        return res, diags
