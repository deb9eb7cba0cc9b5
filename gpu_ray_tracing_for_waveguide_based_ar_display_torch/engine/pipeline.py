"""End-to-end simulation: design -> LUTs -> trace -> histogram -> metrics.

Port of ``engine/pipeline.py`` of the JAX package, restricted to two of its
engines:

- ``engine="persistent"`` (the default): its persistent count-spawn path with
  folded iterations (``engine="pallas_persistent", spawn_mode="count",
  fold_iterations=True``), through :func:`.trace_persistent.persistent_trace`,
  with its ``pers_accum_mode``, ``pers_cells_per_block``,
  ``pers_transit_jump`` and ``pers_jump_phase`` options;
- ``engine="cell"``: its per-cell path (``engine="pallas"``) with the general
  ``run()`` loop: ``num_iter`` relaunches, every ray seeded on the host, the
  histogram a sum of per-ray deposits; through :func:`.trace_cell.cell_trace`,
  to the end in one launch per batch or, with ``segmented=True``, under the
  segment-and-compact scheduler of :mod:`.cell_segments`.

The design geometry, LUTs, cell tables, trace geometry and host metrics are
the port's own copies of the JAX package's numpy modules; the trace runs on
``device``: the CUDA kernels on a GPU, their plain PyTorch versions on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Optional

import numpy as np
import torch

from ..config import EvalConfig, TraceConfig, WaveguideDesign
from ..design.geometry import DesignGeometry, generate_geometry
from ..eval.metrics import EvalResult, efficiencies, evaluate
from ..luts.io import load_or_synthesize
from ..luts.packing import build_cell_tables
from ..luts.schema import RcwaLuts
from . import seeding, trace_cell, trace_persistent, trace_rows
from .cell_segments import SegmentedCellTracer
from .timing import EventTimer
from .trace_cell import CellTracer
from .trace_geometry import build_trace_geometry
from .trace_persistent import PersistentTracer, hist_tiles_to_histogram

ENGINES = ("persistent", "cell")


@dataclasses.dataclass
class SimulationResult:
    histogram: np.ndarray        # (L, FoVy, FoVx, eb_y, eb_x) deposit counts
    efficiencies: dict           # {"B", "G", "R"} system efficiency
    metrics: Optional[EvalResult]
    rays_traced: int             # rays actually spawned (count spawn overshoots)
    total_bounces: int
    trace_seconds: float
    # persistent engine: (cells, 4) nb rows, cid order
    cell_stats: Optional[np.ndarray] = None
    deposits: Optional[int] = None   # cell engine: rays that deposited
    timings: dict = dataclasses.field(default_factory=dict)

    @property
    def bounces_per_second(self) -> float:
        return self.total_bounces / self.trace_seconds if self.trace_seconds else 0.0

    @property
    def rays_per_second(self) -> float:
        return self.rays_traced / self.trace_seconds if self.trace_seconds else 0.0


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device without a card raises."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {str(device)!r} requested but torch.cuda.is_available() "
                "is False; pass device='cpu' to run the plain PyTorch trace")
    elif dev.type != "cpu":
        raise ValueError(f"device must be cpu or cuda, got {dev}")
    return dev


class Simulator:
    """One design + LUT set + trace configuration on one device."""

    def __init__(self, design: WaveguideDesign = WaveguideDesign(),
                 cfg: TraceConfig = TraceConfig(),
                 luts: Optional[RcwaLuts] = None,
                 luts_dir: Optional[str] = None,
                 geom: Optional[DesignGeometry] = None,
                 geometry_simplify_tol: float = 0.0,
                 device="cuda", persistent_slots: int = 2048,
                 engine: str = "persistent", segmented: bool = False,
                 segment_bounces: int = 24, pers_accum_mode: str = "fma",
                 pers_cells_per_block: int = 1,
                 pers_transit_jump: bool = False,
                 pers_jump_phase: str = "pow2"):
        """``pers_*`` (persistent engine): ``pers_accum_mode="packed"`` reads
        bfloat16-rounded selection records; ``pers_cells_per_block = k``
        (packed, shared pupil samples and ``rng_mode="fast"`` only) puts k
        cells, each with ``persistent_slots`` slots, into one block, except
        in a batch whose length k does not divide; ``pers_transit_jump``
        (packed, k = 1) advances a slot on a pure TIR hop to its next event
        in one iteration, phased by ``pers_jump_phase``.  Packed selection is
        within Monte-Carlo tolerance of the exact trace, not bitwise.  Jumps
        are not an unbiased variant of single hops under count spawn: a slot
        respawns by its rays' lifetime in iterations, which jumps shorten,
        so the launch-point weights move and the efficiencies shift
        systematically, by up to about 2 % at the reference workload."""
        t0 = time.perf_counter()
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if segmented and engine != "cell":
            raise ValueError("segmented scheduling belongs to engine='cell'")
        # early errors; the launch's own checks own the refusals
        self._pers_cpb = int(pers_cells_per_block)
        trace_persistent.check_modes(pers_accum_mode, self._pers_cpb,
                                     pers_transit_jump, pers_jump_phase)
        if self._pers_cpb > 1 and not (cfg.shared_pupil_samples
                                       and cfg.rng_mode == "fast"):
            raise ValueError(
                "pers_cells_per_block > 1 requires shared_pupil_samples and "
                f"rng_mode='fast' (got {cfg.shared_pupil_samples}, "
                f"{cfg.rng_mode!r})")
        self.engine = engine
        self.device = resolve_device(device)
        self.design = design
        self.cfg = cfg
        self.geom = geom if geom is not None else generate_geometry(
            design, cfg.num_fov_x, cfg.num_fov_y)
        self.luts = luts if luts is not None else load_or_synthesize(
            self.geom, directory=luts_dir, seed=cfg.seed + 1234)
        self.tables = build_cell_tables(self.geom, self.luts)
        if geometry_simplify_tol == 0.0:
            # the kernel holds regions as <= MAX_EDGES half-planes
            geometry_simplify_tol = 0.05
        self.tgeom = build_trace_geometry(self.geom,
                                          simplify_tol=geometry_simplify_tol)
        self.L, self.M, self.N = self.geom.th_out_ic.shape
        self._persistent_slots = int(persistent_slots)
        cp = trace_rows.build_kernel_cell_params(
            self.tables, self.geom.eyebox_range, eyebox_bins=cfg.eyebox_bins)
        gr = trace_rows.build_kernel_geom(self.tgeom)
        kw = dict(num_fc=self.tgeom.num_fc, num_oc=self.tgeom.num_oc,
                  edge_counts=trace_rows.edge_counts(self.tgeom),
                  eyebox_bins=cfg.eyebox_bins)
        self._seg_tracer = None
        if engine == "persistent":
            self.tracer = PersistentTracer(
                cp, gr, max_iters=cfg.max_bounces, accum_mode=pers_accum_mode,
                transit_jump=pers_transit_jump, jump_phase=pers_jump_phase,
                **kw).to(self.device)
        else:
            self.tracer = CellTracer(cp, gr, max_bounces=cfg.max_bounces,
                                     **kw).to(self.device)
            if segmented:
                self._seg_tracer = SegmentedCellTracer(
                    max_bounces=cfg.max_bounces,
                    segment_bounces=segment_bounces,
                    hist_dims=(self.L, self.M, self.N), **kw)
        if self.device.type == "cuda":
            # build and bind the engine's kernel here, so nvcc counts as
            # setup and never falls inside a timed run()
            (trace_persistent if engine == "persistent"
             else trace_cell).load_kernel()
        self._tile = None   # (slots, shared launch tile on device)
        self.setup_seconds = time.perf_counter() - t0

    # ------------------------------------------------------------------
    def _slots_gens(self, rays_per_cell: int):
        lanes = trace_rows.LANES
        slots = min(self._persistent_slots, rays_per_cell)
        slots = max(lanes, (slots // lanes) * lanes)
        return slots, -(-rays_per_cell // slots)

    def _shared_blocks(self) -> bool:
        """One launch tile serves every cell and the seeds hash the ray
        index (the only path that takes several cells per block)."""
        return self.cfg.shared_pupil_samples and self.cfg.rng_mode == "fast"

    def _device_ray_blocks(self, cell_ids: np.ndarray, slots: int,
                           iteration: int = 0, cpb: int = 1):
        """Launch tiles and per-slot seeds of one batch, on the device.

        With shared pupil samples and fast seeding, one (1, 6, RT, 128) tile
        serves every cell and the seeds follow the contract global index
        ``(iteration * cells + cid) * slots + slot``; with ``cpb`` cells per
        block the tile is repeated ``cpb`` times along its rows (every cell
        of a block respawns from the same samples) and the (C, RT, 128) seeds
        reshape to (C / cpb, cpb * RT, 128), so each cell keeps its own seed
        block.  Otherwise the batch is seeded per cell on the host, as the
        JAX package's general path does.
        """
        rt = slots // trace_rows.LANES
        C = len(cell_ids)
        if self._shared_blocks():
            key = (slots, iteration, cpb)
            if self._tile is None or self._tile[0] != key:
                one = seeding.build_ray_batch(
                    self.geom, self.cfg, cell_ids=np.array([0]),
                    rays_per_cell=slots, iteration=iteration)
                tile, _ = trace_rows.pack_ray_blocks(one, 1, slots, rt)
                tile = np.concatenate([tile] * cpb, axis=2)
                self._tile = (key, torch.from_numpy(tile).to(self.device))
            seeds = seeding.cell_seeds(cell_ids, slots, iteration,
                                       self.L * self.M * self.N, self.cfg.seed)
            bits = torch.from_numpy(
                seeds.view(np.int32).reshape(C // cpb, cpb * rt, -1))
            return self._tile[1], bits.to(self.device)
        if cpb != 1:
            raise ValueError("several cells per block need shared pupil "
                             "samples and fast seeding")
        batch = seeding.build_ray_batch(self.geom, self.cfg, cell_ids=cell_ids,
                                        rays_per_cell=slots, iteration=iteration)
        rays_in, rng_in = trace_rows.pack_ray_blocks(batch, C, slots, rt)
        return trace_rows.blocks_to_device(rays_in, rng_in, self.device)

    def _pers_ctrl(self, rays_per_cell: int) -> torch.Tensor:
        """``[per-cell spawn target, spawn_iters]`` (count spawn, no
        saturation)."""
        return torch.tensor([rays_per_cell, 0], dtype=torch.int32,
                            device=self.device)

    @staticmethod
    def _renorm_tiles(tiles: torch.Tensor, nb: torch.Tensor,
                      nominal_per_cell: int) -> torch.Tensor:
        """Wald renormalisation: scale each cell's tile by target / spawned
        (the count overshoots the target by at most one iteration's deaths)."""
        spawned = torch.clamp(nb[:, 2], min=1).to(torch.float32)
        factor = torch.full_like(spawned, float(nominal_per_cell)) / spawned
        return tiles * factor[:, None, None]

    def run(self, rays_per_fov: Optional[int] = None,
            num_iter: Optional[int] = None, cells_per_batch: int = 2048,
            evaluate_metrics: bool = True,
            eval_cfg: EvalConfig = EvalConfig(),
            verbose: bool = False) -> SimulationResult:
        """Trace the full workload and reduce the metrics.

        Persistent engine: ``num_iter`` folds into the spawn target: one pass
        traces ``num_iter * rays_per_fov`` rays per cell with continued
        per-slot RNG streams (the reference's re-launch loop), paying the
        drain tail once.  Cell engine: ``num_iter`` relaunches of
        ``rays_per_fov`` rays per cell, each seeded anew.
        """
        rpf = rays_per_fov if rays_per_fov is not None else self.cfg.rays_per_fov
        iters = num_iter if num_iter is not None else self.cfg.num_iter
        if self.engine == "cell":
            return self._run_cell(rpf, iters, cells_per_batch,
                                  evaluate_metrics, eval_cfg, verbose)
        target = rpf * iters
        n_cells = self.L * self.M * self.N
        all_cells = np.arange(n_cells)
        slots, _ = self._slots_gens(target)
        ctrl = self._pers_ctrl(target)
        ny, nx = self.cfg.eyebox_bins
        timings = {"seed_s": 0.0}
        timer = EventTimer(self.device)

        t0 = time.perf_counter()
        tiles = torch.empty((n_cells, ny, nx), dtype=torch.float32,
                            device=self.device)
        nbs = []
        for start in range(0, n_cells, cells_per_batch):
            chunk = all_cells[start:start + cells_per_batch]
            # a batch that does not split evenly into blocks runs one cell
            # per block
            cpb = self._pers_cpb if len(chunk) % self._pers_cpb == 0 else 1
            ts = time.perf_counter()
            rays_in, rng_in = self._device_ray_blocks(chunk, slots, cpb=cpb)
            timings["seed_s"] += time.perf_counter() - ts
            with timer.span("kernel"):
                tile, nb = self.tracer(int(chunk[0]), len(chunk), rays_in,
                                       rng_in, ctrl, cells_per_block=cpb)
            tiles[start:start + len(chunk)] = self._renorm_tiles(tile, nb, target)
            nbs.append(nb)
            if verbose:
                print(f"batch cells {start}-{start + len(chunk)} dispatched")
        ta = time.perf_counter()
        hist_dev = hist_tiles_to_histogram(tiles, all_cells, self.L, self.M,
                                           self.N, ny, nx)
        histogram = hist_dev.cpu().numpy()
        cell_stats = torch.cat(nbs, dim=0).cpu().numpy()
        trace_seconds = time.perf_counter() - t0
        timings["assemble_s"] = time.perf_counter() - ta
        timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
        del tiles, hist_dev

        total_bounces = int(cell_stats[:, 0].astype(np.int64).sum())
        total_spawned = int(cell_stats[:, 2].astype(np.int64).sum())
        # histograms are renormalised to `target` rays per cell
        eff = efficiencies(histogram, float(target), 1)
        met = None
        if evaluate_metrics:
            tm = time.perf_counter()
            met = evaluate(histogram / float(target), eval_cfg)
            timings["metrics_s"] = time.perf_counter() - tm
        return SimulationResult(
            histogram=histogram, efficiencies=eff, metrics=met,
            rays_traced=total_spawned, total_bounces=total_bounces,
            trace_seconds=trace_seconds, cell_stats=cell_stats,
            timings=timings)

    # ------------------------------------------------------------------
    # engine="cell": the general loop over iterations and batches

    def _cell_blocks(self, cell_ids: np.ndarray, rays_per_cell: int,
                     iteration: int):
        """Every ray of one batch seeded on the host, as kernel blocks on the
        device: rays_in (C, 6, RT, 128), rng_in (C, RT, 128), RT =
        ceil(rays_per_cell / 128); padding rays die at init."""
        batch = seeding.build_ray_batch(self.geom, self.cfg, cell_ids=cell_ids,
                                        rays_per_cell=rays_per_cell,
                                        iteration=iteration)
        rt = -(-rays_per_cell // trace_rows.LANES)
        rays_in, rng_in = trace_rows.pack_ray_blocks(batch, len(cell_ids),
                                                     rays_per_cell, rt)
        return trace_rows.blocks_to_device(rays_in, rng_in, self.device)

    def _trace_blocks(self, cell_ids, rays_in, rng_in, out, timer):
        """Trace one batch's blocks and add its deposits to ``out``; returns
        the batch's bounce count (a device scalar, or an int when segmented)
        and its number of deposits."""
        base = torch.from_numpy(trace_cell.cell_hist_base(
            cell_ids, self.M, self.N, *self.cfg.eyebox_bins)).to(self.device)
        if self._seg_tracer is not None:
            _, bounces = self._seg_tracer.trace(
                self.tracer.rows(cell_ids), self.tracer.geom_row, rays_in,
                rng_in, hist_base=base, out=out, timer=timer)
            return bounces, self._seg_tracer.deposits
        with timer.span("kernel"):
            dep, nb, *_ = self.tracer(cell_ids, rays_in, rng_in)
        with timer.span("scatter"):
            deposits = trace_cell.scatter_deposits(out.view(-1), dep, base)
        return nb[:, 0].sum(), deposits

    def trace_batch(self, cell_ids: np.ndarray, rays_per_cell: int,
                    iteration: int):
        """Trace one batch of cells (cell engine); returns ``(histogram
        (L, N, M, ny, nx) on the device, bounce count, ray count)``."""
        if self.engine != "cell":
            raise ValueError("trace_batch belongs to engine='cell'")
        hist = torch.zeros((self.L, self.N, self.M, *self.cfg.eyebox_bins),
                           dtype=torch.float32, device=self.device)
        rays_in, rng_in = self._cell_blocks(cell_ids, rays_per_cell, iteration)
        bounces, _ = self._trace_blocks(cell_ids, rays_in, rng_in, hist,
                                        EventTimer("cpu"))
        return hist, bounces, len(cell_ids) * rays_per_cell

    def _run_cell(self, rpf: int, iters: int, cells_per_batch: int,
                  evaluate_metrics: bool, eval_cfg: EvalConfig,
                  verbose: bool) -> SimulationResult:
        n_cells = self.L * self.M * self.N
        all_cells = np.arange(n_cells)
        timings = {"seed_s": 0.0}
        timer = EventTimer(self.device)

        t0 = time.perf_counter()
        # the histogram accumulates on the device and is pulled once
        hist_dev = torch.zeros((self.L, self.N, self.M, *self.cfg.eyebox_bins),
                               dtype=torch.float32, device=self.device)
        total_bounces = 0
        total_rays = 0
        deposits = 0
        for it in range(iters):
            for start in range(0, n_cells, cells_per_batch):
                chunk = all_cells[start:start + cells_per_batch]
                ts = time.perf_counter()
                rays_in, rng_in = self._cell_blocks(chunk, rpf, it)
                timings["seed_s"] += time.perf_counter() - ts
                bounces, n_dep = self._trace_blocks(chunk, rays_in, rng_in,
                                                    hist_dev, timer)
                total_bounces = total_bounces + bounces
                deposits += n_dep
                total_rays += len(chunk) * rpf
                if verbose:
                    print(f"iter {it} cells {start}-{start + len(chunk)} "
                          "dispatched")
        ta = time.perf_counter()
        histogram = hist_dev.cpu().numpy()
        total_bounces = int(total_bounces)
        trace_seconds = time.perf_counter() - t0
        timings["assemble_s"] = time.perf_counter() - ta
        timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
        del hist_dev

        actual_rpf = total_rays / max(n_cells * iters, 1)
        eff = efficiencies(histogram, actual_rpf, iters)
        met = None
        if evaluate_metrics:
            tm = time.perf_counter()
            met = evaluate(histogram / actual_rpf / iters, eval_cfg)
            timings["metrics_s"] = time.perf_counter() - tm
        return SimulationResult(
            histogram=histogram, efficiencies=eff, metrics=met,
            rays_traced=total_rays, total_bounces=total_bounces,
            trace_seconds=trace_seconds, timings=timings, deposits=deposits)


def format_report(result: SimulationResult) -> str:
    """Human-readable metric report (the reference's printout)."""
    lines = [
        f"Rays traced          : {result.rays_traced:,}",
        f"Total ray bounces    : {result.total_bounces:,}",
        f"Trace wall-clock     : {result.trace_seconds:.2f} s",
        f"Throughput           : {result.rays_per_second:,.0f} rays/s, "
        f"{result.bounces_per_second:,.0f} bounces/s",
    ]
    long_name = {"R": "Red", "G": "Green", "B": "Blue"}
    for key in ("R", "G", "B"):
        if key in result.efficiencies:
            lines.append(f"Efficiency ({long_name[key]:<5})   : "
                         f"{result.efficiencies[key] * 100:8.3f} %")
    for key, val in result.efficiencies.items():
        if key not in ("R", "G", "B"):
            lines.append(f"Efficiency ({key})    : {val * 100:8.3f} %")
    if result.metrics is not None:
        lines += [
            f"Color dispersion     : {result.metrics.delta_e:8.2f}",
            f"FoV uniformity       : {result.metrics.u_fov * 100:8.2f} %",
            f"Eyebox uniformity    : {result.metrics.u_eyebox * 100:8.2f} %",
        ]
        if getattr(result.metrics, "starved_eye_positions", 0):
            n = result.metrics.starved_eye_positions
            lines.append(
                f"  [unconverged: {n} eye position(s) have empty (FoV, eye) "
                "bins at this sample budget; u_eyebox/u_fov are biased low — "
                "raise rays_per_fov or num_iter]")
    return "\n".join(lines)
