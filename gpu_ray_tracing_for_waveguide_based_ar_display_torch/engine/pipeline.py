"""End-to-end simulation: design -> LUTs -> trace -> histogram -> metrics.

Port of ``engine/pipeline.py`` of the JAX package, with four of its
engines:

- ``engine="persistent"`` (the default): its persistent path
  (``engine="pallas_persistent"``) through
  :func:`.trace_persistent.persistent_trace`, in gens spawn (the default,
  as in the JAX package) or count spawn, optionally saturated to
  ``spawn_iters``, with the relaunch loop (the default) or folded
  iterations, and its ``pers_accum_mode``, ``pers_cells_per_block``,
  ``pers_transit_jump`` and ``pers_jump_phase`` options;
- ``engine="cell"``: its per-cell path (``engine="pallas"``) with the general
  ``run()`` loop: ``num_iter`` relaunches, every ray seeded anew, the
  histogram a sum of per-ray deposits; through :func:`.trace_cell.cell_trace`,
  to the end in one launch per batch or, with ``segmented=True``, under the
  segment-and-compact scheduler of :mod:`.cell_segments`;
- ``engine="vector"``: its portable tracer (``engine="jnp"``) with the
  general loop, through :class:`.trace_vector.VectorTracer` (on a GPU one
  launch of ``csrc/vector_trace.cu`` per trace call, on the CPU its plain
  PyTorch version): to the end in one call per batch or, with
  ``segmented=True``, in bounce segments with the survivors gathered
  between them (:meth:`Simulator.trace_batch_compacted`);
- ``engine="splitting"``: its zero-variance engine
  (:mod:`.splitting`) with the general loop: every branch followed with its
  weight, ``rays_per_fov`` launch positions per cell, one wavefront per cell
  (``splitting_percell``, the default: on a GPU one launch of
  ``csrc/split_cells.cu`` per batch) or one shared by the batch (on a GPU
  one kernel of ``csrc/split_trace.cu`` per trace call).

``run()`` takes the JAX package's options: wavelength subsets, checkpoint
and resume, a histogram kept on the device with device perception or device
metrics (every engine), jackknife error bars over the iterations
(persistent engine) and the dense eye-position metrics.  ``mesh=`` (a
``torch.distributed`` device mesh, :mod:`..parallel.shard`) shards the
persistent engine's cell axis over the mesh's ranks.  The design
geometry, LUTs, cell tables, trace geometry and host metrics are the port's
own copies of the JAX package's numpy modules; the kernel engines' rows of
synthetic LUTs (:mod:`.cell_rows`), the trace, seed hashing and device tail
run on ``device``: the CUDA kernels on a GPU, their plain PyTorch versions
on the CPU.
"""

from __future__ import annotations

import dataclasses
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..config import EvalConfig, TraceConfig, WaveguideDesign
from ..design.geometry import DesignGeometry, generate_geometry
from ..eval import eye_tail
from ..eval.metrics import (
    EvalResult, colorimetry_torch, efficiencies, evaluate, evaluate_dense,
    eye_perceived_torch, result_to_host, wavelength_channel_names,
)
from ..luts.io import load_or_synthesize, luts_available
from ..luts.packing import build_cell_tables
from ..luts.schema import RcwaLuts
from ..parallel import shard
from ..utils.checkpoint import load_checkpoint, save_checkpoint
from . import (
    build, cell_rows, seeding, splitting, trace_cell, trace_persistent,
    trace_rows,
)
from . import trace_vector
from .device import resolve_device
from .cell_segments import SegmentedCellTracer
from .timing import EventTimer
from .trace_cell import CellTracer
from .trace_geometry import build_trace_geometry
from .trace_persistent import PersistentTracer, hist_tiles_to_histogram


class _HostTables:
    """A Simulator's host LUTs and cell tables, each built at first read and
    kept; shared by shallow copies of the Simulator (the hybrids' pilot), so
    they build once."""

    def __init__(self, geom: DesignGeometry, luts: Optional[RcwaLuts],
                 luts_dir: Optional[str], seed: int):
        self.geom, self.luts_dir, self.seed = geom, luts_dir, seed
        self._luts, self._tables = luts, None

    def luts(self) -> RcwaLuts:
        if self._luts is None:
            self._luts = load_or_synthesize(self.geom, directory=self.luts_dir,
                                            seed=self.seed)
        return self._luts

    def tables(self):
        if self._tables is None:
            self._tables = build_cell_tables(self.geom, self.luts())
        return self._tables


ENGINES = ("persistent", "cell", "vector", "splitting")
KERNEL_ENGINES = ("persistent", "cell")   # the engines that run a CUDA kernel
# slots (cells x capacity) of one per-cell splitting batch: bounds its
# device memory
SPLIT_SLOT_BUDGET = 1 << 21


@dataclasses.dataclass
class SimulationResult:
    histogram: object            # (L, FoVy, FoVx, eb_y, eb_x) deposit counts
                                 # (numpy, or a device tensor when the caller
                                 # asked run(histogram_device=True) to keep it
                                 # resident)
    efficiencies: dict           # {"B", "G", "R"} system efficiency
    metrics: Optional[EvalResult]
    rays_traced: int             # rays actually spawned (count spawn overshoots)
    total_bounces: int
    trace_seconds: float
    # persistent engine: (cells, 4) nb rows of the traced cells in cid
    # order, summed over this call's iterations
    cell_stats: Optional[np.ndarray] = None
    deposits: Optional[int] = None   # cell, vector engines: rays that deposited
    timings: dict = dataclasses.field(default_factory=dict)
    # Monte-Carlo standard errors at this run's sampling, from a delete-one
    # jackknife over the num_iter sample groups (run(..., error_groups=True));
    # keys: eff_<colour>, delta_e, u_fov, u_eyebox
    metric_stderr: Optional[dict] = None
    # the metrics at every valid eye position (run(..., dense_metrics=True));
    # eye_luminance is the full-resolution map
    dense: Optional[EvalResult] = None

    @property
    def bounces_per_second(self) -> float:
        return self.total_bounces / self.trace_seconds if self.trace_seconds else 0.0

    @property
    def rays_per_second(self) -> float:
        return self.rays_traced / self.trace_seconds if self.trace_seconds else 0.0


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
                 segment_bounces: int = 24, spawn_mode: str = "gens",
                 spawn_iters: int = 0, fold_iterations: bool = False,
                 pers_accum_mode: str = "fma",
                 pers_cells_per_block: int = 1,
                 pers_transit_jump: bool = False,
                 pers_jump_phase: str = "pow2",
                 splitting_capacity: Optional[int] = None,
                 splitting_threshold: float = 1e-6,
                 splitting_max_steps: int = 1024,
                 splitting_percell: bool = True, mesh=None):
        """Persistent engine: ``spawn_mode="gens"`` (the default) gives
        every slot a quota of generations, so every launch point of the tile
        traces as many rays and weighs equally; ``"count"`` respawns a
        cell's slots until the cell has spawned its target of rays (the
        histogram is then renormalised by target / spawned).  Count spawn
        is the fast option, not an equal-weight estimator: a slot whose
        rays die early respawns more often, so it weighs launch points by
        their rays' inverse lifetime and its efficiencies differ from the
        equal-weight engines' (on the paper design they sit lower).
        ``spawn_iters > 0`` keeps every slot
        respawning until that iteration (saturating spawn; renormalised
        like count spawn).  ``fold_iterations`` traces ``num_iter``
        iterations as one spawn target per cell with continued per-slot RNG
        streams, paying the drain tail once; otherwise (the default)
        ``run()`` relaunches once per iteration, each iteration seeded
        anew.  Both defaults are the JAX package's; ``spawn_mode="count",
        fold_iterations=True`` is the faster, biased path.  The engine's
        default is the one that differs: ``"persistent"`` runs the CUDA
        kernel that stands for the JAX ``"pallas_persistent"`` (whose Pallas
        kernel compiles only on a TPU, hence the JAX default ``"jnp"``; its
        counterpart here is ``"vector"``).

        ``pers_*``: ``pers_accum_mode="packed"`` reads bfloat16-rounded
        selection records; ``pers_cells_per_block = k`` (packed, shared pupil
        samples and ``rng_mode="fast"`` only) puts k cells, each with
        ``persistent_slots`` slots, into one block, except in a batch whose
        length k does not divide; ``pers_transit_jump`` (packed, k = 1)
        advances a slot on a pure TIR hop to its next event in one
        iteration, phased by ``pers_jump_phase``.  Packed selection is
        within Monte-Carlo tolerance of the exact trace, not bitwise.  Jumps
        are not an unbiased variant of single hops under count spawn: a slot
        respawns by its rays' lifetime in iterations, which jumps shorten,
        so the launch-point weights move and the efficiencies shift
        systematically, by up to about 2 % at the reference workload.

        ``segmented`` (cell and vector engines) traces each batch in bounce
        segments of ``segment_bounces``, compacting the survivors between
        them; the result is the same bit for bit.

        Splitting engine: ``rays_per_fov`` launch positions per cell, every
        branch followed while its weight exceeds ``splitting_threshold``,
        for at most ``splitting_max_steps`` steps; ``splitting_percell``
        (the default) gives every cell its own wavefront of
        ``splitting_capacity`` slots (default 8,192; 65,536 for the shared
        wavefront).  ``split_truncated``, ``split_pruned``,
        ``split_out_coupled`` and ``split_peak_live`` keep the weight lost to
        a full wavefront, the weight below the threshold, the weight
        deposited and the widest wavefront seen.

        ``mesh`` (persistent engine, one cell per block): every batch's
        cells split over the mesh's first axis; each rank hashes the seeds
        of its own cells, launches the trace on them and gathers the tiles
        and counters of the batch, so every later step sees the whole
        histogram and every rank returns the same result, bit for bit the
        one-rank run's.  A batch's cell count must divide over the axis."""
        t0 = time.perf_counter()
        if engine not in ENGINES:
            raise ValueError(f"engine must be one of {ENGINES}, got {engine!r}")
        if segmented and engine not in ("cell", "vector"):
            raise ValueError("segmented scheduling belongs to the cell and "
                             "vector engines")
        if spawn_mode not in trace_persistent.SPAWN_MODES:
            raise ValueError(f"spawn_mode must be one of "
                             f"{trace_persistent.SPAWN_MODES}, got {spawn_mode!r}")
        self._spawn_mode = spawn_mode
        self._spawn_iters = int(spawn_iters)
        self._fold_iterations = bool(fold_iterations)
        # early errors; the launch's own checks own the refusals
        self._pers_cpb = int(pers_cells_per_block)
        trace_persistent.check_modes(pers_accum_mode, self._pers_cpb,
                                     pers_transit_jump, pers_jump_phase)
        if self._pers_cpb > 1 and not seeding.device_seeded(cfg):
            raise ValueError(
                "pers_cells_per_block > 1 requires shared_pupil_samples and "
                f"rng_mode='fast' (got {cfg.shared_pupil_samples}, "
                f"{cfg.rng_mode!r})")
        if mesh is not None:
            if engine != "persistent":
                raise ValueError(
                    "mesh shards the persistent engine's cell axis; engine="
                    f"{engine!r} runs on one device (its ray-axis form is "
                    "parallel.shard.make_sharded_trace_fn)")
            if self._pers_cpb > 1:
                raise ValueError(
                    "pers_cells_per_block > 1 does not compose with a mesh "
                    "(cell-axis shards would split blocks)")
        self._mesh = mesh
        self.engine = engine
        self.device = resolve_device(device)
        if mesh is not None and mesh.device_type != self.device.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot drive "
                             f"device {self.device}")
        self.design = design
        self.cfg = cfg
        st = self.setup_timings = {}
        t1 = time.perf_counter()
        self.geom = geom if geom is not None else generate_geometry(
            design, cfg.num_fov_x, cfg.num_fov_y)
        st["geometry_s"] = time.perf_counter() - t1
        synthetic = luts is None and not (luts_dir is not None
                                          and luts_available(luts_dir))
        self._host = _HostTables(self.geom, luts, luts_dir, cfg.seed + 1234)
        # the kernel engines build synthetic rows from host inputs
        # (engine/cell_rows.py: the CUDA kernel on a GPU); every other route
        # reads host LUTs and tables, built (and real LUTs validated) here
        device_rows = synthetic and engine in KERNEL_ENGINES
        if not device_rows:
            t1 = time.perf_counter()
            self._host.tables()
            st["host_tables_s"] = time.perf_counter() - t1
        if geometry_simplify_tol == 0.0 and engine in KERNEL_ENGINES:
            # the kernels hold regions as <= MAX_EDGES half-planes
            geometry_simplify_tol = 0.05
        t1 = time.perf_counter()
        self.tgeom = build_trace_geometry(self.geom,
                                          simplify_tol=geometry_simplify_tol)
        st["trace_geometry_s"] = time.perf_counter() - t1
        self.L, self.M, self.N = self.geom.th_out_ic.shape
        self._persistent_slots = int(persistent_slots)
        self._segmented = bool(segmented)
        self._segment_bounces = int(segment_bounces)
        self._seg_tracer = None
        self._tile = None   # (key, shared launch tile on device)
        self._points = None  # (key, shared pupil points on device)
        self.stats = {}     # vector engine: steps, syncs, segments
        if self.device.type == "cuda":
            # build and bind every library this Simulator launches here, so
            # nvcc and the modules' loads count as setup and never fall
            # inside a timed run(); one nvcc process per source, side by
            # side.  Every engine's tail runs csrc/eye_tail.cu.
            t1 = time.perf_counter()
            libs = {"eye_tail": eye_tail.load_kernel}
            if engine == "persistent":
                libs["persistent_trace"] = trace_persistent.load_kernel
            elif engine == "cell":
                libs["cell_trace"] = trace_cell.load_kernel
            elif engine == "splitting" and splitting_percell:
                libs["split_cells"] = splitting.load_kernel
            elif engine == "splitting":
                libs["split_trace"] = splitting.load_trace_kernel
            elif engine == "vector":
                libs["vector_trace"] = trace_vector.load_kernel
            if device_rows:
                libs["cell_rows"] = cell_rows.load_kernel
            build.build_all(libs)
            for load in libs.values():
                load()
            st["kernel_build_s"] = time.perf_counter() - t1
        if engine == "vector":
            # the packed tables, the region grids and their refinement,
            # on the device by the end of the span
            t1 = time.perf_counter()
            self.tracer = trace_vector.VectorTracer(
                [self.tables], [self.tgeom], cfg, device=self.device)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
            st["vector_tracer_s"] = time.perf_counter() - t1
        elif engine == "splitting":
            if splitting_capacity is None:
                # one cell's widest wavefront, or the whole batch's
                splitting_capacity = 8192 if splitting_percell else 1 << 16
            self._split_capacity = int(splitting_capacity)
            self._split_percell = bool(splitting_percell)
            self._split_kw = dict(capacity=self._split_capacity,
                                  weight_threshold=splitting_threshold,
                                  max_steps=splitting_max_steps,
                                  device=self.device)
            if splitting_percell:
                # the tables and region grid go to the device in setup,
                # not in the first batch
                t1 = time.perf_counter()
                self._split_cells = splitting.make_splitting_cells_fn(
                    self.tables, self.tgeom, cfg,
                    per_cell_seeds=not cfg.shared_pupil_samples,
                    **self._split_kw)
                st["split_tables_s"] = time.perf_counter() - t1
                if self.device.type == "cuda":
                    t1 = time.perf_counter()
                    torch.cuda.synchronize(self.device)
                    st["sync_s"] = time.perf_counter() - t1
            else:
                self._split_trace = splitting.make_splitting_trace_fn(
                    self.tables, self.tgeom, cfg, **self._split_kw)
            self.split_truncated = 0.0
            self.split_pruned = 0.0
            self.split_out_coupled = 0.0
            self.split_peak_live = 0
        else:
            timer = self._build_kernel_tracer(
                engine, cfg, pers_accum_mode, pers_transit_jump,
                pers_jump_phase, device_rows)
            if self.device.type == "cuda":
                # the rows' upload and kernel end inside setup, never in run()
                torch.cuda.synchronize(self.device)
                st.update((f"{k}_ms", v) for k, v in timer.ms().items())
        self.setup_seconds = time.perf_counter() - t0

    @property
    def luts(self) -> RcwaLuts:
        """The design's LUTs (host, complex128): as given, loaded from
        ``luts_dir``, or synthesized at first read."""
        return self._host.luts()

    @property
    def tables(self):
        """The design's host cell tables (:class:`..luts.packing.CellTables`),
        built at first read; the kernel engines on synthetic LUTs never read
        them."""
        return self._host.tables()

    def _build_kernel_tracer(self, engine, cfg, pers_accum_mode,
                             pers_transit_jump, pers_jump_phase,
                             device_rows: bool) -> EventTimer:
        """Bind the kernel engine's tracer to this design's rows; returns
        the timer of the rows' kernel (span ``"rows"``)."""
        st = self.setup_timings
        timer = EventTimer(self.device)
        on_gpu = self.device.type == "cuda"
        t1 = time.perf_counter()
        if device_rows:
            inputs = cell_rows.synthetic_row_inputs(
                [self.geom], seed=self._host.seed, pinned=on_gpu)
            st["host_rows_s"] = time.perf_counter() - t1
            t1 = time.perf_counter()
            cp = cell_rows.cell_rows(inputs, self.geom.eyebox_range,
                                     cfg.eyebox_bins, self.device, timer)
            st["rows_s"] = time.perf_counter() - t1
        else:
            cp = trace_rows.build_kernel_cell_params(
                self.tables, self.geom.eyebox_range,
                eyebox_bins=cfg.eyebox_bins)
            st["host_rows_s"] = time.perf_counter() - t1
        gr = trace_rows.build_kernel_geom(self.tgeom)
        kw = dict(num_fc=self.tgeom.num_fc, num_oc=self.tgeom.num_oc,
                  edge_counts=trace_rows.edge_counts(self.tgeom),
                  eyebox_bins=cfg.eyebox_bins)
        if engine == "persistent":
            self.tracer = PersistentTracer(
                cp, gr, max_iters=cfg.max_bounces, accum_mode=pers_accum_mode,
                transit_jump=pers_transit_jump, jump_phase=pers_jump_phase,
                **kw).to(self.device)
        else:
            self.tracer = CellTracer(cp, gr, max_bounces=cfg.max_bounces,
                                     **kw).to(self.device)
            if self._segmented:
                self._seg_tracer = SegmentedCellTracer(
                    max_bounces=cfg.max_bounces,
                    segment_bounces=self._segment_bounces,
                    hist_dims=(self.L, self.M, self.N), **kw)
        return timer

    # ------------------------------------------------------------------
    def _slots_gens(self, rays_per_cell: int):
        lanes = trace_rows.LANES
        slots = min(self._persistent_slots, rays_per_cell)
        slots = max(lanes, (slots // lanes) * lanes)
        return slots, -(-rays_per_cell // slots)

    def _shared_points(self, rays_per_cell: int,
                       iteration: int) -> torch.Tensor:
        """The pupil points every cell shares at ``rays_per_cell`` and
        ``iteration`` (:func:`.seeding.shared_points`), drawn on the host
        once and kept on the device."""
        key = (rays_per_cell, iteration)
        if self._points is None or self._points[0] != key:
            pts = seeding.shared_points(self.geom, self.cfg, rays_per_cell,
                                        iteration)
            self._points = (key, seeding.to_device(pts, self.device))
        return self._points[1]

    def _device_ray_blocks(self, cell_ids: np.ndarray, slots: int,
                           iteration: int = 0, cpb: int = 1):
        """Launch tiles and per-slot seeds of one batch, on the device.

        With shared pupil samples and fast seeding, one (1, 6, RT, 128) tile
        serves every cell and the seeds, hashed on the device
        (:func:`.seeding.cell_seeds_device`, bitwise the host hash), follow
        the contract global index ``(iteration * cells + cid) * slots +
        slot`` for any set of cells; with ``cpb`` cells per block the tile
        is repeated ``cpb`` times along its rows (every cell of a block
        respawns from the same samples) and the (C, RT, 128) seeds reshape
        to (C / cpb, cpb * RT, 128), so each cell keeps its own seed block.
        Otherwise the batch is seeded per cell on the host, as the JAX
        package's general path does.
        """
        rt = slots // trace_rows.LANES
        C = len(cell_ids)
        if seeding.device_seeded(self.cfg):
            key = (slots, iteration, cpb)
            if self._tile is None or self._tile[0] != key:
                tile = seeding.ray_tile(self._shared_points(slots, iteration))
                self._tile = (key, tile.repeat(1, cpb, 1)[None])
            seeds = seeding.cell_seeds_device(
                cell_ids, slots, iteration, self.L * self.M * self.N,
                self.cfg.seed, self.device)
            return self._tile[1], seeds.reshape(C // cpb, cpb * rt, -1)
        if cpb != 1:
            raise ValueError("several cells per block need shared pupil "
                             "samples and fast seeding")
        batch = seeding.build_ray_batch(self.geom, self.cfg, cell_ids=cell_ids,
                                        rays_per_cell=slots, iteration=iteration)
        rays_in, rng_in = trace_rows.pack_ray_blocks(batch, C, slots, rt)
        return trace_rows.blocks_to_device(rays_in, rng_in, self.device)

    def _my_cells(self, cell_ids: np.ndarray) -> np.ndarray:
        """The cells of a batch this rank traces: all of them, or with a
        mesh its contiguous chunk along the mesh's first axis."""
        if self._mesh is None:
            return cell_ids
        axis = self._mesh.mesh_dim_names[0]
        n, idx, _ = shard._axis(self._mesh, axis)
        shard._check_cells(len(cell_ids), n, axis)
        return shard._chunk(cell_ids, n, idx)

    def _gather(self, tiles: torch.Tensor, nb: torch.Tensor):
        """A batch's tiles and ``nb`` from every rank of the mesh's first
        axis (as they are without a mesh)."""
        if self._mesh is None:
            return tiles, nb
        return shard.gather_cells(
            tiles, nb, self._mesh.get_group(self._mesh.mesh_dim_names[0]))

    def _pers_ctrl(self, rays_per_cell: int, gens: int = 1) -> torch.Tensor:
        """``[per-cell spawn target, spawn_iters]`` in count spawn,
        ``[generations per slot, spawn_iters]`` in gens spawn."""
        first = rays_per_cell if self._spawn_mode == "count" else gens
        return torch.tensor([first, self._spawn_iters], dtype=torch.int32,
                            device=self.device)

    def _pers_nominal(self, slots: int, gens: int, rays_per_cell: int) -> int:
        """The per-cell ray count the histogram is normalised to."""
        return rays_per_cell if self._spawn_mode == "count" else slots * gens

    def _renorm_tiles(self, tiles: torch.Tensor, nb: torch.Tensor,
                      nominal_per_cell: int) -> torch.Tensor:
        """Wald renormalisation in count or saturating spawn: scale each
        cell's tile by nominal / spawned (the spawns overshoot the target by
        at most one iteration's deaths)."""
        if self._spawn_iters <= 0 and self._spawn_mode != "count":
            return tiles
        spawned = torch.clamp(nb[:, 2], min=1).to(torch.float32)
        factor = torch.full_like(spawned, float(nominal_per_cell)) / spawned
        return tiles * factor[:, None, None]

    def trace_batch_tiles(self, cell_ids: np.ndarray, rays_per_cell: int,
                          iteration: int):
        """Persistent engine: one launch over the cells ``cell_ids`` (any
        sorted subset) at ``rays_per_cell`` rays per cell, seeded as
        ``seeding.build_ray_batch(geom, cfg, cell_ids=cell_ids,
        rays_per_cell=slots, iteration=iteration)`` seeds them.  Returns
        ``(tiles (C, ny, nx) on the device, renormalised to nominal units,
        nb (C, 4), nominal ray count)``.

        Raises before the launch when a counter could leave its exact
        range: the int32 spawn and bounce counters (a slot makes at most one
        counted bounce per iteration, or a jump's hops), and the float32
        histogram counts, exact below 2^24 per bin; a launch whose spawns
        could pass 2^24 is checked after it instead (a ray deposits at most
        once, so a bin holds at most the cell's spawns)."""
        if self.engine != "persistent":
            raise ValueError("trace_batch_tiles belongs to the persistent "
                             "engine")
        slots, gens = self._slots_gens(rays_per_cell)
        tr = self.tracer
        hops = ((15 if tr.jump_phase == "pow2" else 4095)
                if tr.transit_jump else 1)
        most_spawned = (rays_per_cell + slots if self._spawn_mode == "count"
                        else slots * gens)
        if (most_spawned >= 1 << 31
                or slots * hops * self.cfg.max_bounces >= 1 << 31):
            raise ValueError(
                f"{rays_per_cell} rays per cell over {slots} slots and "
                f"{self.cfg.max_bounces} iterations could pass the kernel's "
                "int32 counters; lower the boost tier or max_bounces")
        mine = self._my_cells(cell_ids)
        rays_in, rng_in = self._device_ray_blocks(mine, slots, iteration)
        tiles, nb = self._gather(*self.tracer(
            mine, rays_in, rng_in, self._pers_ctrl(rays_per_cell, gens),
            spawn_mode=self._spawn_mode))
        if most_spawned >= 1 << 24 and float(tiles.max()) >= 1 << 24:
            raise RuntimeError(
                "a histogram bin reached 2^24 counts, where float32 counts "
                "stop being exact; lower the boost tier")
        nominal = self._pers_nominal(slots, gens, rays_per_cell)
        return (self._renorm_tiles(tiles, nb, nominal), nb,
                nominal * len(cell_ids))

    def _run_cells(self, wavelengths) -> np.ndarray:
        """The cell ids a run traces: every cell, or those of the
        ``wavelengths`` subset."""
        all_cells = np.arange(self.L * self.M * self.N)
        if wavelengths is None:
            return all_cells
        lsel = all_cells // (self.M * self.N)
        return all_cells[np.isin(lsel, np.asarray(wavelengths))]

    def _tiles_from_hist(self, hist: np.ndarray,
                         all_cells: np.ndarray) -> torch.Tensor:
        """Inverse of :func:`.trace_persistent.hist_tiles_to_histogram`: the
        (len(all_cells), ny, nx) tile accumulator of a (L, N, M, ny, nx)
        histogram on the device (a permutation: exact)."""
        ny, nx = self.cfg.eyebox_bins
        flat = torch.from_numpy(np.ascontiguousarray(hist, np.float32)).to(
            self.device).permute(0, 2, 1, 3, 4).reshape(-1, ny, nx)
        return flat.index_select(
            0, torch.from_numpy(all_cells.astype(np.int64)).to(self.device))

    def run(self, rays_per_fov: Optional[int] = None,
            num_iter: Optional[int] = None, cells_per_batch: int = 2048,
            evaluate_metrics: bool = True,
            eval_cfg: EvalConfig = EvalConfig(),
            verbose: bool = False, wavelengths: Optional[tuple] = None,
            checkpoint_path: Optional[str] = None, checkpoint_every: int = 1,
            histogram_device: bool = False, error_groups: bool = False,
            metrics_device: bool = False,
            dense_metrics: bool = False) -> SimulationResult:
        """Trace the workload and reduce the metrics.

        Persistent engine: with folding (and no ``error_groups``),
        ``num_iter`` folds into the spawn target: one pass traces ``num_iter
        * rays_per_fov`` rays per cell with continued per-slot RNG streams
        (the reference's re-launch loop), paying the drain tail once;
        without it, one launch per iteration and batch, iteration ``it``
        seeded from ``it``, the per-cell tiles summed in float32 in
        iteration order.  Cell engine: ``num_iter`` relaunches of
        ``rays_per_fov`` rays per cell, each seeded anew.

        - ``wavelengths``: trace only these wavelength indices; the other
          cells get no rays.
        - ``checkpoint_path``: save the histogram, the iterations done and
          the counters every ``checkpoint_every`` iterations
          (:mod:`..utils.checkpoint`), and resume from a checkpoint of the
          same design and configuration; a resumed run is bit for bit an
          uninterrupted one.  A folded run is one iteration, saved at its
          end.
        - ``histogram_device``: keep the histogram on the device.
          Efficiencies come from per-colour float64 device sums and the
          metrics from the pupil-integrated stack
          (:func:`eye_perceived_torch`), of which only (L, fy, fx, 7, 8) is
          pulled for the host colorimetry;
          ``metrics_device`` runs that colorimetry on the device too
          (:func:`evaluate_torch`: float32, the metrics within 1e-4
          relative of the host's) and pulls two scalars, the (7, 8)
          luminance grid and the (fy, fx, 3, 7, 8) eye-view image.  The JAX
          package's device metrics return no image; these do, for the
          5 MB pull.
        - ``error_groups`` (persistent engine, ``num_iter >= 2``; suspends
          folding): Monte-Carlo standard errors by a delete-one jackknife
          over the iterations, from one device perception per iteration.
        - ``dense_metrics``: the metrics at every valid eye position too
          (:func:`evaluate_dense`, on the device), in ``result.dense``.

        The cell, vector and splitting engines run the general loop: every
        ray seeded anew (on the device under the default config, else on the
        host), the histogram a sum of per-batch deposits on the device,
        pulled once unless ``histogram_device`` keeps it there
        (``error_groups`` raises there).  The splitting engine's batches hold
        at most ``SPLIT_SLOT_BUDGET`` wavefront slots.
        """
        rpf = rays_per_fov if rays_per_fov is not None else self.cfg.rays_per_fov
        iters = num_iter if num_iter is not None else self.cfg.num_iter
        if self.engine != "persistent" and error_groups:
            raise ValueError("error_groups belongs to the persistent engine "
                             f"(engine={self.engine!r} traces each "
                             "iteration's rays in batches, not as groups)")
        if metrics_device and not histogram_device:
            raise ValueError("metrics_device evaluates the device histogram: "
                             "pass histogram_device=True with it")
        if error_groups and iters < 2:
            raise ValueError("error_groups needs num_iter >= 2 (the "
                             "iterations are the jackknife groups)")
        all_cells = self._run_cells(wavelengths)
        if self.engine != "persistent":
            if self.engine == "splitting" and self._split_percell:
                cells_per_batch = max(1, min(
                    cells_per_batch, SPLIT_SLOT_BUDGET // self._split_capacity))
            return self._run_general(rpf, iters, all_cells, cells_per_batch,
                                     evaluate_metrics, eval_cfg, verbose,
                                     checkpoint_path, checkpoint_every,
                                     histogram_device, metrics_device,
                                     dense_metrics)
        if not error_groups and self._fold_iterations and iters > 1:
            rpf, iters = rpf * iters, 1
        ny, nx = self.cfg.eyebox_bins
        n_sel = len(all_cells)
        timings = {"seed_s": 0.0}
        timer = EventTimer(self.device)
        total_bounces = total_rays = total_spawned = 0
        start_iter = 0
        resumed = (load_checkpoint(checkpoint_path, self.design, self.cfg,
                                   with_extras=True)
                   if checkpoint_path else None)
        if resumed is not None:
            h0, start_iter, total_bounces, extras = resumed
            total_rays = extras.get("total_rays", 0)
            total_spawned = extras.get("total_spawned", 0)
            if error_groups and start_iter:
                raise ValueError("error_groups does not compose with a "
                                 "resumed checkpoint (its groups are lost)")

        t0 = time.perf_counter()
        acc = (self._tiles_from_hist(h0, all_cells) if resumed is not None
               else torch.zeros((n_sel, ny, nx), dtype=torch.float32,
                                device=self.device))
        slots, gens = self._slots_gens(rpf)
        nominal = self._pers_nominal(slots, gens, rpf)
        ctrl = self._pers_ctrl(rpf, gens)
        stats = np.zeros((n_sel, 4), np.int64)
        pending = []   # (batch start, nb, rays) of launches not yet pulled
        snaps = []     # error_groups: cumulative (perception, colour sums)

        def drain():
            nonlocal total_bounces, total_rays, total_spawned
            for start, nb, n in pending:
                nbh = nb.cpu().numpy().astype(np.int64)
                stats[start:start + len(nbh)] += nbh
                total_bounces += int(nbh[:, 0].sum())
                total_spawned += int(nbh[:, 2].sum())
                total_rays += n
            pending.clear()

        def assemble():
            return hist_tiles_to_histogram(acc, all_cells, self.L, self.M,
                                           self.N, ny, nx)

        for it in range(start_iter, iters):
            for start in range(0, n_sel, cells_per_batch):
                chunk = all_cells[start:start + cells_per_batch]
                # a batch that does not split evenly into blocks runs one
                # cell per block
                cpb = self._pers_cpb if len(chunk) % self._pers_cpb == 0 else 1
                mine = self._my_cells(chunk)
                ts = time.perf_counter()
                with timer.span("seed"):
                    rays_in, rng_in = self._device_ray_blocks(mine, slots, it,
                                                              cpb=cpb)
                timings["seed_s"] += time.perf_counter() - ts
                with timer.span("kernel"):
                    tile, nb = self.tracer(mine, rays_in, rng_in, ctrl,
                                           cells_per_block=cpb,
                                           spawn_mode=self._spawn_mode)
                if self._mesh is not None:
                    tg = time.perf_counter()
                    with timer.span("gather"):
                        tile, nb = self._gather(tile, nb)
                    timings["gather_s"] = (timings.get("gather_s", 0.0)
                                           + time.perf_counter() - tg)
                acc[start:start + len(chunk)] += self._renorm_tiles(
                    tile, nb, nominal)
                pending.append((start, nb, nominal * len(chunk)))
                if verbose:
                    print(f"iter {it} cells {start}-{start + len(chunk)} "
                          "dispatched")
            if error_groups:
                with timer.span("perceive"):
                    snap = assemble()
                    snaps.append((eye_perceived_torch(snap, eval_cfg),
                                  snap.sum(dim=(1, 2, 3, 4),
                                           dtype=torch.float64)))
                    del snap
            # with a mesh every rank holds the same histogram; rank 0
            # writes it
            if (checkpoint_path and (it + 1) % checkpoint_every == 0
                    and (self._mesh is None or self._mesh.get_rank() == 0)):
                drain()
                save_checkpoint(checkpoint_path, assemble().cpu().numpy(),
                                it + 1, self.design, self.cfg, total_bounces,
                                extras={"total_rays": total_rays,
                                        "total_spawned": total_spawned})
        ta = time.perf_counter()
        hist_dev = assemble()
        del acc
        drain()
        if histogram_device:
            histogram = hist_dev
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        else:
            histogram = hist_dev.cpu().numpy()
            if not dense_metrics:
                del hist_dev
                hist_dev = None
        trace_seconds = time.perf_counter() - t0
        timings["assemble_s"] = time.perf_counter() - ta

        cells_traced = n_sel * iters
        actual_rpf = total_rays / cells_traced if cells_traced else rpf
        eff, met, dense = self._tail(histogram, hist_dev, actual_rpf, iters,
                                     evaluate_metrics, eval_cfg,
                                     metrics_device, dense_metrics, timings,
                                     timer)
        stderr = (self._jackknife_stderr(snaps, actual_rpf, iters, eval_cfg)
                  if snaps else None)
        timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
        # count and saturating spawn trace the rays they spawn
        rays_traced = (total_spawned if (self._spawn_iters > 0
                                         or self._spawn_mode == "count")
                       else total_rays)
        return SimulationResult(
            histogram=histogram, efficiencies=eff, metrics=met,
            rays_traced=rays_traced, total_bounces=total_bounces,
            trace_seconds=trace_seconds, cell_stats=stats, timings=timings,
            metric_stderr=stderr, dense=dense)

    def _tail(self, histogram, hist_dev: Optional[torch.Tensor],
              actual_rpf: float, iters: int, evaluate_metrics: bool,
              eval_cfg: EvalConfig, metrics_device: bool,
              dense_metrics: bool, timings: dict, timer: EventTimer):
        """Efficiencies, metrics and dense metrics of a run's histogram:
        on the host for a numpy histogram, from device sums and the device
        perception stack for a device one, with the colorimetry and the
        eye-view image on the device too under ``metrics_device``.
        ``hist_dev`` is the histogram on the device (the dense scan's
        input).  Device spans ``perceive`` and ``colorimetry``; ``pull_s``
        is the host clock around the pull of the stack (host colorimetry)
        or of the metrics and image (device colorimetry)."""
        norm = actual_rpf * iters
        if isinstance(histogram, np.ndarray):
            eff = efficiencies(histogram, actual_rpf, iters)
        else:
            # per-colour sums on the device, accumulated in float64
            sums = histogram.sum(dim=(1, 2, 3, 4),
                                 dtype=torch.float64).cpu().numpy()
            num = actual_rpf * self.M * self.N * self.L * iters
            names = wavelength_channel_names(self.L)
            eff = {names[i]: float(sums[i] / num * self.L)
                   for i in range(self.L)}
        met = None
        if evaluate_metrics:
            tm = time.perf_counter()
            if isinstance(histogram, np.ndarray):
                met = evaluate(histogram / actual_rpf / iters, eval_cfg)
            else:
                with timer.span("perceive"):
                    perc = eye_perceived_torch(histogram, eval_cfg)
                if metrics_device:
                    met = evaluate_on_device(perc, norm, timer, timings)
                else:
                    tp = time.perf_counter()
                    perc = perc.cpu().numpy()
                    timings["pull_s"] = time.perf_counter() - tp
                    met = evaluate(None, eval_cfg,
                                   perceive=perc / actual_rpf / iters)
            timings["metrics_s"] = time.perf_counter() - tm
        dense = None
        if dense_metrics:
            td = time.perf_counter()
            n_epy = hist_dev.shape[3] - eval_cfg.pupil_mask_bins + 1
            dense = evaluate_dense(hist_dev, eval_cfg, norm=norm,
                                   chunk_rows=8 if n_epy > 16 else 0)
            timings["dense_s"] = time.perf_counter() - td
        return eff, met, dense

    def _jackknife_stderr(self, snaps, actual_rpf: float, iters: int,
                          eval_cfg: EvalConfig) -> dict:
        """Delete-one jackknife over the ``num_iter`` sample groups, on the
        host in float64.

        ``snaps`` holds per-iteration cumulative (perception stack, colour
        sums) pairs on the device; consecutive differences are the K
        independent groups (each iteration has its own seeds).  Each
        leave-one-out replicate renormalises the other groups' stack to
        per-ray units and evaluates every metric; SE = sqrt((K - 1) / K *
        sum (m_i - mean)^2), exact for the linear efficiencies and first
        order for delta_e and the uniformities."""
        K = len(snaps)
        perc = [p.cpu().numpy().astype(np.float64) for p, _ in snaps]
        sums = [s.cpu().numpy() for _, s in snaps]
        p_tot, s_tot = perc[-1], sums[-1]
        groups_p = [perc[0]] + [perc[i] - perc[i - 1] for i in range(1, K)]
        groups_s = [sums[0]] + [sums[i] - sums[i - 1] for i in range(1, K)]
        names = wavelength_channel_names(self.L)
        reps = {k: [] for k in
                [f"eff_{n}" for n in names] + ["delta_e", "u_fov", "u_eyebox"]}
        num = actual_rpf * self.M * self.N * self.L * (iters - 1)
        for i in range(K):
            m = evaluate(None, eval_cfg,
                         perceive=(p_tot - groups_p[i]) / actual_rpf
                         / (iters - 1), with_image=False)
            s = (s_tot - groups_s[i]) / num * self.L
            for li, n in enumerate(names):
                reps[f"eff_{n}"].append(float(s[li]))
            reps["delta_e"].append(m.delta_e)
            reps["u_fov"].append(m.u_fov)
            reps["u_eyebox"].append(m.u_eyebox)
        out = {}
        for k, vals in reps.items():
            v = np.asarray(vals, np.float64)
            out[k] = float(np.sqrt((K - 1) / K * ((v - v.mean()) ** 2).sum()))
        return out

    # ------------------------------------------------------------------
    # engines "cell", "vector", "splitting": the general loop over
    # iterations and batches

    def _cell_blocks(self, cell_ids: np.ndarray, rays_per_cell: int,
                     iteration: int):
        """One batch's kernel blocks on the device: rays_in (C, 6, RT, 128),
        rng_in (C, RT, 128), RT = ceil(rays_per_cell / 128); padding rays
        die at init.  Built on the device from the shared points under a
        :func:`.seeding.device_seeded` config, else every ray seeded on the
        host (the same blocks, bit for bit)."""
        if seeding.device_seeded(self.cfg):
            return seeding.ray_blocks_device(
                self._shared_points(rays_per_cell, iteration), cell_ids,
                iteration, self.L * self.M * self.N, self.cfg.seed)
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
        base = seeding.to_device(trace_cell.cell_hist_base(
            cell_ids, self.M, self.N, *self.cfg.eyebox_bins), self.device)
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

    def _ray_state(self, cell_ids: np.ndarray, rays_per_cell: int,
                   iteration: int) -> dict:
        """One batch as an (R,) vector ray state on the device, built as
        :meth:`_cell_blocks` builds its blocks."""
        if seeding.device_seeded(self.cfg):
            return seeding.ray_state_device(
                self._shared_points(rays_per_cell, iteration), cell_ids,
                iteration, self.L * self.M * self.N, self.cfg.seed)
        b = seeding.build_ray_batch(self.geom, self.cfg, cell_ids=cell_ids,
                                    rays_per_cell=rays_per_cell,
                                    iteration=iteration)
        return trace_vector.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                           b["cid"], b["idx"], b["rng"],
                                           device=self.device)

    def _vector_rays(self, cell_ids: np.ndarray, rays_per_cell: int,
                     iteration: int) -> dict:
        """One batch as a (1, R) vector ray state on the device."""
        return {k: v[None] for k, v in
                self._ray_state(cell_ids, rays_per_cell, iteration).items()}

    def _trace_vector(self, rays: dict, out: torch.Tensor, timer,
                      segment_bounces: Optional[int]):
        """Trace one batch of the vector engine and add its deposits to
        ``out``: to the end in one loop (``segment_bounces=None``), or in
        bounce segments with the survivors compacted between them.  Returns
        (bounces, deposits) as device scalars."""
        ny, nx = self.cfg.eyebox_bins
        deposits = []

        def add(r):
            deposits.append(trace_vector.add_deposits(
                out.view(-1), r["dep"], r["cid"], self.M, self.N, ny, nx))

        if segment_bounces is not None:
            bounces = trace_vector.trace_compacted(
                self.tracer, rays, self.cfg.max_bounces, segment_bounces,
                add, timer=timer, stats=self.stats)
        else:
            rays, bounces = self.tracer(rays, timer=timer, stats=self.stats)
            with timer.span("scatter"):
                add(rays)
        return bounces.sum(), sum(deposits)

    def _split_seeds(self, cell_ids: np.ndarray, rays_per_cell: int,
                     iteration: int) -> dict:
        """The splitting engine's launch rays of one batch on the device:
        the global wavefront's (R,) ray state, or the per-cell engine's
        float32 :data:`.seeding.FIELDS`, (rays_per_cell,) shared by every
        cell or (C, rays_per_cell) without shared pupil samples."""
        if not self._split_percell:
            return self._ray_state(cell_ids, rays_per_cell, iteration)
        if self.cfg.shared_pupil_samples:
            fields = seeding.launch_fields(
                self._shared_points(rays_per_cell, iteration))
            return dict(zip(seeding.FIELDS, fields))
        batch = seeding.build_ray_batch(self.geom, self.cfg,
                                        cell_ids=cell_ids,
                                        rays_per_cell=rays_per_cell,
                                        iteration=iteration)
        shape = (len(cell_ids), rays_per_cell)
        te = np.asarray(batch["te"], np.complex128).reshape(shape)
        tm = np.asarray(batch["tm"], np.complex128).reshape(shape)
        x = np.asarray(batch["x"], np.float64).reshape(shape)
        y = np.asarray(batch["y"], np.float64).reshape(shape)
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(
                    self.device, torch.float32)
                for k, v in zip(seeding.FIELDS, (x, y, te.real, te.imag,
                                                 tm.real, tm.imag))}

    def _trace_splitting(self, seeds: dict, cell_ids: np.ndarray,
                         rays_per_cell: int):
        """One batch of the splitting engine from its :meth:`_split_seeds`:
        (histogram (L, N, M, ny, nx) on the device, steps).  The weight
        ledgers accumulate on the Simulator; a truncated wavefront warns
        (its expectation is biased low)."""
        ny, nx = self.cfg.eyebox_bins
        C, P = len(cell_ids), rays_per_cell
        if not self._split_percell:
            if 2 * C * P > self._split_capacity:
                raise ValueError(
                    f"{C * P} launch rays cannot even seed the "
                    f"{self._split_capacity}-slot wavefront buffer; lower "
                    "cells_per_batch / rays_per_fov or raise "
                    "splitting_capacity")
            hist, out_w, trunc, pruned, steps = self._split_trace(seeds)
            self.split_pruned += float(pruned)
            self.split_out_coupled += float(out_w)
            tr = float(trunc)
            self.split_truncated += tr
            if tr > 1e-3 * C * P:
                warnings.warn(
                    f"splitting wavefront truncated {tr:.3g} weight "
                    f"({tr / (C * P):.2%} of this batch's launch weight): "
                    "the expectation is biased low; lower cells_per_batch "
                    "or raise splitting_capacity")
            return hist.reshape(self.L, self.N, self.M, ny, nx), steps
        tiles, out_w, trunc, pruned, steps, peak = self._split_cells(
            cell_ids, seeds)
        self.split_pruned += float(pruned.sum())
        self.split_out_coupled += float(out_w.sum())
        tr = float(trunc.sum())
        self.split_truncated += tr
        pk = int(peak.max())
        self.split_peak_live = max(self.split_peak_live, pk)
        if tr > 0:
            warnings.warn(
                f"splitting wavefront truncated {tr:.3g} weight (peak live "
                f"width {pk}/{self._split_capacity} slots): the expectation "
                "is biased low; raise splitting_capacity")
        return splitting.cells_tiles_to_histogram(
            tiles, cell_ids, self.L, self.M, self.N, ny, nx), steps

    def trace_batch(self, cell_ids: np.ndarray, rays_per_cell: int,
                    iteration: int):
        """Trace one batch of cells to the end (cell, vector and splitting
        engines); returns ``(histogram (L, N, M, ny, nx) on the device,
        bounce count, ray count)``.  The splitting engine's count is its
        steps."""
        n = len(cell_ids) * rays_per_cell
        if self.engine == "splitting":
            hist, steps = self._trace_splitting(
                self._split_seeds(cell_ids, rays_per_cell, iteration),
                cell_ids, rays_per_cell)
            return hist, steps, n
        hist = torch.zeros((self.L, self.N, self.M, *self.cfg.eyebox_bins),
                           dtype=torch.float32, device=self.device)
        if self.engine == "vector":
            bounces, _ = self._trace_vector(
                self._vector_rays(cell_ids, rays_per_cell, iteration), hist,
                EventTimer("cpu"), None)
            return hist, bounces, n
        if self.engine != "cell":
            raise ValueError("trace_batch belongs to the cell, vector and "
                             "splitting engines")
        rays_in, rng_in = self._cell_blocks(cell_ids, rays_per_cell, iteration)
        bounces, _ = self._trace_blocks(cell_ids, rays_in, rng_in, hist,
                                        EventTimer("cpu"))
        return hist, bounces, n

    def trace_batch_compacted(self, cell_ids: np.ndarray, rays_per_cell: int,
                              iteration: int,
                              segment_bounces: Optional[int] = None):
        """Vector engine: one batch traced in bounce segments of
        ``segment_bounces`` (default the Simulator's), the survivors gathered
        on the device between segments so late bounces run on a small
        batch.  Returns what :meth:`trace_batch` returns, bit for bit (per
        ray RNG streams carry over; the last segment gets exactly the budget
        left)."""
        if self.engine != "vector":
            raise ValueError("compacted tracing belongs to engine='vector'")
        hist = torch.zeros((self.L, self.N, self.M, *self.cfg.eyebox_bins),
                           dtype=torch.float32, device=self.device)
        bounces, _ = self._trace_vector(
            self._vector_rays(cell_ids, rays_per_cell, iteration), hist,
            EventTimer("cpu"), segment_bounces or self._segment_bounces)
        return hist, bounces, len(cell_ids) * rays_per_cell

    def _trace_chunk(self, chunk: np.ndarray, rpf: int, it: int,
                     hist_dev: torch.Tensor, timer: EventTimer,
                     timings: dict):
        """Seed and trace one batch of the general loop into ``hist_dev``;
        returns (bounces, deposits); the splitting engine's bounces are its
        steps and its deposits None.  The seeding's host time goes to
        ``timings["seed_s"]``, its device time to the span ``seed``."""
        seed = {"cell": self._cell_blocks, "vector": self._vector_rays,
                "splitting": self._split_seeds}[self.engine]
        ts = time.perf_counter()
        with timer.span("seed"):
            rays = seed(chunk, rpf, it)
        timings["seed_s"] += time.perf_counter() - ts
        if self.engine == "cell":
            return self._trace_blocks(chunk, *rays, hist_dev, timer)
        if self.engine == "vector":
            steps0 = self.stats.get("steps", 0)
            syncs0 = self.stats.get("syncs", 0)
            out = self._trace_vector(
                rays, hist_dev, timer,
                self._segment_bounces if self._segmented else None)
            timings.setdefault("batch_steps", []).append(
                self.stats["steps"] - steps0)
            timings.setdefault("batch_syncs", []).append(
                self.stats["syncs"] - syncs0)
            return out
        with timer.span("trace"):
            hist, steps = self._trace_splitting(rays, chunk, rpf)
            hist_dev += hist
        return steps, None

    def _run_general(self, rpf: int, iters: int, all_cells: np.ndarray,
                     cells_per_batch: int, evaluate_metrics: bool,
                     eval_cfg: EvalConfig, verbose: bool,
                     checkpoint_path: Optional[str], checkpoint_every: int,
                     histogram_device: bool, metrics_device: bool,
                     dense_metrics: bool) -> SimulationResult:
        timings = {"seed_s": 0.0}
        timer = EventTimer(self.device)
        self.stats = {}   # vector engine: steps, syncs, segments
        total_bounces = total_rays = deposits = 0
        start_iter = 0
        resumed = (load_checkpoint(checkpoint_path, self.design, self.cfg,
                                   with_extras=True)
                   if checkpoint_path else None)

        t0 = time.perf_counter()
        # the histogram accumulates on the device and is pulled once, unless
        # histogram_device keeps it there
        if resumed is not None:
            h0, start_iter, total_bounces, extras = resumed
            total_rays = extras.get("total_rays", 0)
            # whole counts: the histogram's sum is its deposits
            deposits = int(h0.sum(dtype=np.float64))
            hist_dev = torch.from_numpy(
                np.ascontiguousarray(h0, np.float32)).to(self.device)
        else:
            hist_dev = torch.zeros(
                (self.L, self.N, self.M, *self.cfg.eyebox_bins),
                dtype=torch.float32, device=self.device)
        for it in range(start_iter, iters):
            for start in range(0, len(all_cells), cells_per_batch):
                chunk = all_cells[start:start + cells_per_batch]
                bounces, n_dep = self._trace_chunk(chunk, rpf, it, hist_dev,
                                                   timer, timings)
                total_bounces = total_bounces + bounces
                deposits = None if n_dep is None else deposits + n_dep
                total_rays += len(chunk) * rpf
                if verbose:
                    print(f"iter {it} cells {start}-{start + len(chunk)} "
                          "dispatched")
            if checkpoint_path and (it + 1) % checkpoint_every == 0:
                total_bounces = int(total_bounces)
                save_checkpoint(checkpoint_path, hist_dev.cpu().numpy(),
                                it + 1, self.design, self.cfg, total_bounces,
                                extras={"total_rays": total_rays})
        ta = time.perf_counter()
        if histogram_device:
            histogram = hist_dev
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        else:
            histogram = hist_dev.cpu().numpy()
            if not dense_metrics:
                del hist_dev
                hist_dev = None
        total_bounces = int(total_bounces)
        deposits = None if deposits is None else int(deposits)
        trace_seconds = time.perf_counter() - t0
        timings["assemble_s"] = time.perf_counter() - ta

        cells_traced = len(all_cells) * iters
        actual_rpf = total_rays / cells_traced if cells_traced else rpf
        eff, met, dense = self._tail(histogram, hist_dev, actual_rpf, iters,
                                     evaluate_metrics, eval_cfg,
                                     metrics_device, dense_metrics, timings,
                                     timer)
        timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
        timings.update(self.stats)
        return SimulationResult(
            histogram=histogram, efficiencies=eff, metrics=met,
            rays_traced=total_rays, total_bounces=total_bounces,
            trace_seconds=trace_seconds, timings=timings, deposits=deposits,
            dense=dense)


def evaluate_on_device(perc: torch.Tensor, norm: float, timer: EventTimer,
                       timings: dict) -> EvalResult:
    """:func:`evaluate_torch` with the eye-view image, in two timed steps:
    the colorimetry of the (L, fy, fx, epy, epx) stack (device span
    ``colorimetry``), then, after a synchronize, the pull of the metrics and
    the image (host clock ``timings["pull_s"]``)."""
    with timer.span("colorimetry"):
        out = colorimetry_torch(perc, norm=norm, with_image=True)
    if perc.is_cuda:   # pull_s times the copy alone
        torch.cuda.synchronize(perc.device)
    tp = time.perf_counter()
    met = result_to_host(out, *perc.shape[3:])
    timings["pull_s"] = time.perf_counter() - tp
    return met


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
    if result.dense is not None:
        d = result.dense
        n_epy, n_epx = d.eye_luminance.shape
        lines += [
            f"Dense scan ({n_epy}x{n_epx} = {n_epy * n_epx:,} eye positions):",
            f"  delta_e {d.delta_e:.3f}  u_fov {d.u_fov * 100:.2f} %  "
            f"u_eyebox {d.u_eyebox * 100:.2f} %  "
            f"starved {d.starved_eye_positions}",
        ]
    return "\n".join(lines)
