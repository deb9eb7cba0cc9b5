"""Batched design sweeps: the vector trace and the persistent trace.

Port of ``sweep/design_sweep.py`` of the JAX package.
:func:`run_design_sweep` (its ``run_design_sweep``) traces every design's
rays in one vector trace whose leading axis is the design
(:mod:`..engine.trace_vector`).  :func:`run_design_sweep_persistent`:
each candidate design's geometry is built on the host,
the designs of a chunk are stacked along the cell axis (D contiguous runs of
L*M*N cells, one geometry row per design; their rows built on the device by
:mod:`..engine.cell_rows`), and ONE launch of
:func:`..engine.trace_persistent.persistent_trace` traces the whole chunk on
the device: the CUDA kernel on a GPU, its plain PyTorch version on the CPU.
Efficiencies, bounces and (optionally) the display metrics reduce on the
device; nothing is pulled to the host until the end.  With a
``torch.distributed`` device mesh (:mod:`..parallel.shard`) each rank preps
and traces whole designs of every chunk and the per-design results are
gathered to every rank.
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Sequence, Union

import numpy as np
import torch

from ..config import EvalConfig, TraceConfig, WaveguideDesign
from ..design.geometry import generate_geometry
from ..engine import (
    build, cell_rows, seeding, trace_persistent, trace_rows, trace_vector,
)
from ..engine.device import resolve_device
from ..engine.timing import EventTimer
from ..engine.trace_geometry import build_trace_geometry
from ..eval import eye_tail
from ..eval.metrics import evaluate_batch, pupil_mask, pupil_window_sum
from ..luts.packing import build_cell_tables
from ..luts.synthetic import make_synthetic_luts
from ..parallel import shard


@dataclasses.dataclass
class SweepResult:
    designs: List[WaveguideDesign]
    histograms: Optional[np.ndarray]  # (K, L, N, M, ny, nx): kept designs
    efficiencies: np.ndarray     # (D, L) per-design per-wavelength efficiency
    bounces: np.ndarray          # (D,)
    # per-design display metrics (delta_e / u_fov / u_eyebox EvalResults),
    # filled by run_design_sweep_persistent(evaluate_metrics=True)
    metrics: Optional[list] = None
    # host seconds of each layer, kernel milliseconds (CUDA events) and
    # launches: see run_design_sweep_persistent
    timings: dict = dataclasses.field(default_factory=dict)


def _ray_state(geom, cfg: TraceConfig, device) -> dict:
    """A design's (R,) ray state over all its cells at iteration 0: built on
    the device from its shared pupil points under a
    :func:`..engine.seeding.device_seeded` config, else seeded on the host
    (the same state, bit for bit)."""
    if seeding.device_seeded(cfg):
        n = geom.th_out_ic.size
        pts = seeding.shared_points(geom, cfg, cfg.rays_per_fov, 0)
        return seeding.ray_state_device(seeding.to_device(pts, device),
                                        np.arange(n), 0, n, cfg.seed)
    b = seeding.build_ray_batch(geom, cfg)
    return trace_vector.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                       b["cid"], b["idx"], b["rng"],
                                       device=device)


def run_design_sweep(
    designs: Sequence[WaveguideDesign],
    cfg: TraceConfig = TraceConfig(num_fov_x=16, num_fov_y=12, rays_per_fov=256,
                                   max_bounces=2048),
    lut_seed: int = 1234, device="cuda",
    segment_bounces: Optional[int] = 24,
    keep_histograms: Union[bool, Sequence[int]] = True,
) -> SweepResult:
    """Trace every design with identical workloads on ``device``, in one
    vector trace over a leading design axis; returns per-design results.

    Each design gets its geometry, synthetic LUTs, cell tables, trace
    geometry (simplified at 1e-3) and ray batch, as the JAX package's sweep
    builds them (the batch built on the device from its shared pupil
    points under a :func:`..engine.seeding.device_seeded` config, bitwise
    the host's); a batch depends on the design only through its in-coupler
    polygon, so designs that share it share one batch.  All designs must share strip counts
    (num_fc / num_oc).  ``segment_bounces`` traces in bounce segments with
    each design's survivors compacted between them (``None``: one loop to
    the end); the results are the same bit for bit, and each design's equal
    its solo sweep's.  ``keep_histograms``: every design's (L, N, M, ny, nx)
    histogram in ``SweepResult.histograms`` (the default, as the JAX sweep),
    those of a sequence of design indices (in design order), or none.

    ``SweepResult.timings``: host seconds ``prep_s`` (geometry, tables),
    ``seed_s`` (the ray batches), ``upload_s`` (the tracer's tables and
    grids, and on a GPU the kernel's build and bind) and ``pull_s``; device
    milliseconds from CUDA events on a GPU (``seed_ms``, ``bounce_ms``: the
    trace calls, ``compact_ms``, ``scatter_ms``);
    ``steps``, ``syncs`` (reads from the device: a trace call's steps on a
    GPU, each step's two reads on the CPU, a compaction's size) and
    ``segments``."""
    dev = resolve_device(device)
    timings = {}
    timer = EventTimer(dev)
    t0 = time.perf_counter()
    # ics: per design, the geometry of the first design of its run of
    # designs with one in-coupler polygon
    tables, tgeoms, ics = [], [], []
    for d in designs:
        geom = generate_geometry(d, cfg.num_fov_x, cfg.num_fov_y)
        tables.append(build_cell_tables(
            geom, make_synthetic_luts(geom, seed=lut_seed)))
        tgeoms.append(build_trace_geometry(geom, simplify_tol=1e-3))
        ics.append(geom if not ics or not np.array_equal(ics[-1].ic, geom.ic)
                   else ics[-1])
    timings["prep_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    with timer.span("seed"):
        states = {}
        for g in ics:
            if id(g) not in states:
                states[id(g)] = _ray_state(g, cfg, dev)
        rays = trace_vector.stack_ray_states([states[id(g)] for g in ics])
        del states
    timings["seed_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tracer = trace_vector.VectorTracer(tables, tgeoms, cfg, device=dev)
    timings["upload_s"] = time.perf_counter() - t0

    D = len(designs)
    L, M, N = 3, cfg.num_fov_x, cfg.num_fov_y
    ny, nx = cfg.eyebox_bins
    size = L * N * M * ny * nx
    hists = torch.zeros(D * size, dtype=torch.float32, device=dev)
    base = (torch.arange(D, device=dev) * size)[:, None]
    stats = {}

    def add(r):
        trace_vector.add_deposits(hists, r["dep"], r["cid"], M, N, ny, nx,
                                  base=base)

    if segment_bounces is None:
        rays, bounces = tracer(rays, timer=timer, stats=stats)
        with timer.span("scatter"):
            add(rays)
    else:
        bounces = trace_vector.trace_compacted(
            tracer, rays, cfg.max_bounces, segment_bounces, add, timer=timer,
            stats=stats)
    del rays
    t0 = time.perf_counter()
    hists = hists.reshape(D, L, N, M, ny, nx)
    # the JAX sweep's efficiencies: float32 sums over each design's bins
    eff = (hists.sum(dim=(2, 3, 4, 5)).cpu().numpy()
           / (L * M * N * cfg.rays_per_fov) * 3)
    keep = (list(range(D)) if keep_histograms is True
            else sorted(keep_histograms or ()))
    kept = hists[keep].cpu().numpy() if keep else None
    bounces = bounces.cpu().numpy()
    timings["pull_s"] = time.perf_counter() - t0
    timings.update((f"{k}_ms", v) for k, v in timer.ms().items())
    timings.update(stats)
    return SweepResult(designs=list(designs), histograms=kept,
                       efficiencies=eff, bounces=bounces, timings=timings)


@dataclasses.dataclass
class ChunkRows:
    """Inputs of one launch over a chunk of ``nd`` designs."""
    tgeoms: list                 # TraceGeometry per design
    cell_params: torch.Tensor    # (nd * n_cells, PC) float32, on the device
    geom_rows: np.ndarray        # (nd, PG) float32
    rays: np.ndarray             # (nd or nd * n_cells, 6, RT, 128) float32
    rng: Optional[np.ndarray]    # (nd * n_cells, RT, 128) uint32; None: shared
    edge_counts: tuple           # the chunk's largest (hull, r1, r2) counts
    # (nd * n_cells, records * 25) int32 packed selection words on the
    # device, or None
    cell_params_packed: Optional[torch.Tensor] = None
    # host seconds of the prep's parts: geometry_s (geometry and trace
    # geometry), host_rows_s (the rows' host inputs), rows_s (their upload
    # and launch, or the plain version on the CPU), tiles_s (launch tiles)
    timings: dict = dataclasses.field(default_factory=dict)
    # on a GPU, the device time of the rows' kernel (span "rows")
    timer: Optional[EventTimer] = None


def prepare_chunk(designs: Sequence[WaveguideDesign], cfg: TraceConfig,
                  slots: int, lut_seed: int = 1234,
                  shared: bool = True, packed: bool = False,
                  cells_per_block: int = 1, device="cuda") -> ChunkRows:
    """Rows and launch tiles of one design chunk.

    Geometry and trace geometry per design; the kernel rows of the chunk's
    synthetic LUTs on ``device`` (the card unless the caller asks for the
    CPU) from host inputs computed once over the chunk's design axis
    (:mod:`..engine.cell_rows`: the CUDA kernel on a GPU, its plain version
    on the CPU; bitwise the host synthetic-LUT -> cell table -> row
    pipeline).  ``shared``: one (6, RT, 128) launch tile per design (reused
    while the in-coupler polygon is unchanged) and no seeds (the launch
    takes :func:`shared_seed_block`); else every cell's tile and seeds,
    built on the host.  Edge counts are the chunk's largest: a design's
    padding half-planes are always true, so its cells see the same regions
    as in a solo run.  ``packed`` adds the packed selection words, on the
    device; ``cells_per_block = k`` (shared only) repeats each design's tile
    k times along its rows, one run of ``slots`` slots per cell of a
    block."""
    dev = resolve_device(device)
    timings = {}
    t0 = time.perf_counter()
    rt = slots // trace_rows.LANES
    n_cells = 3 * cfg.num_fov_x * cfg.num_fov_y
    geoms = [generate_geometry(d, cfg.num_fov_x, cfg.num_fov_y) for d in designs]
    tgs = [build_trace_geometry(g, simplify_tol=0.05) for g in geoms]
    grs = np.stack([trace_rows.build_kernel_geom(tg) for tg in tgs])
    timings["geometry_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    inputs = cell_rows.synthetic_row_inputs(geoms, seed=lut_seed,
                                            pinned=dev.type == "cuda")
    timings["host_rows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    timer = EventTimer(dev)
    cp = cell_rows.cell_rows(inputs, np.stack([g.eyebox_range for g in geoms]),
                             cfg.eyebox_bins, dev, timer)
    del inputs
    cpk = (trace_rows.pack_selection_params(cp, tgs[0].num_fc, tgs[0].num_oc)
           if packed else None)
    timings["rows_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    tiles, rngs = [], []
    prev_ic, prev = None, None
    cfg_s = dataclasses.replace(cfg, rays_per_fov=slots)
    for g in geoms:
        if shared:
            if prev_ic is None or not np.array_equal(prev_ic, g.ic):
                b = seeding.build_ray_batch(g, cfg_s, cell_ids=np.array([0]),
                                            rays_per_cell=slots)
                tile = trace_rows.pack_ray_blocks(b, 1, slots, rt)[0][0]
                prev_ic = g.ic
                prev = np.concatenate([tile] * cells_per_block, axis=1)
            tiles.append(prev)
        else:
            r_in, rng_in = trace_rows.pack_ray_blocks(
                seeding.build_ray_batch(g, cfg_s), n_cells, slots, rt)
            tiles.append(r_in)
            rngs.append(rng_in)
    ec = tuple(max(c) for c in zip(*(trace_rows.edge_counts(g) for g in tgs)))
    timings["tiles_s"] = time.perf_counter() - t0
    return ChunkRows(
        tgeoms=tgs, cell_params=cp, geom_rows=grs,
        rays=np.stack(tiles) if shared else np.concatenate(tiles),
        rng=None if shared else np.concatenate(rngs), edge_counts=ec,
        cell_params_packed=cpk, timings=timings,
        timer=timer if timer.on else None)


def shared_seed_block(cfg: TraceConfig, slots: int, cells_per_block: int = 1,
                      device="cuda") -> torch.Tensor:
    """(L*M*N, RT, 128) int32 per-slot seeds shared by every design, hashed
    on ``device`` (the card unless the caller asks for the CPU): the seed
    contract global index ``cid * slots + slot``
    (iteration 0), as the per-cell host path and the JAX package's sweep
    hash it (:func:`..engine.seeding.cell_seeds_device`, bitwise
    :func:`..engine.seeding.cell_seeds`).  With ``cells_per_block = k`` the
    same seeds as (L*M*N / k, k * RT, 128): each cell of a block keeps its
    own seed block."""
    n_cells = 3 * cfg.num_fov_x * cfg.num_fov_y
    return seeding.cell_seeds_device(np.arange(n_cells), slots, 0, n_cells,
                                     cfg.seed, resolve_device(device)).reshape(
        n_cells // cells_per_block, -1, trace_rows.LANES)


def _chunk_reduce(tiles, nb, nd: int, n_cells: int, L: int, MN: int, nx: int,
                  renorm: bool, nominal: int):
    """(tiles, nb) -> (eff (nd, L), bounces (nd,), factor (C,)) on the device.

    ``factor`` is the per-cell Wald renormalisation nominal / actual spawns,
    applied to the histogram sums (the JAX package's ``_chunk_reducer``).
    The sums run one design at a time: a float32 reduction's order can
    depend on how many designs share it, and a design's efficiencies must
    not depend on which designs share its launch (a chunk, a mesh rank's
    share of one, or a solo sweep)."""
    spawned = torch.clamp(nb[:, 2], min=1).to(torch.float32)
    factor = (nominal / spawned) if renorm else torch.ones_like(spawned)
    per_design_l = torch.stack([
        (tiles[sl, :, :nx].sum(dim=(1, 2)) * factor[sl]).reshape(L, MN)
        .sum(dim=1)
        for sl in (slice(d * n_cells, (d + 1) * n_cells) for d in range(nd))])
    eff = per_design_l / (nominal * MN * L) * L
    bounces = nb[:, 0].to(torch.int64).reshape(nd, n_cells).sum(dim=1)
    return eff, bounces, factor


def _chunk_perceive(tiles, factor, nd: int, L: int, M: int, N: int, nx: int,
                    mask: np.ndarray, stride) -> torch.Tensor:
    """(tiles, factor) -> (nd, L, N, M, epy, epx) pupil-integrated perception
    stacks: each cell's tile cut to ``nx`` and multiplied by its Wald factor,
    then summed over the pupil window, by one
    :func:`..eval.metrics.pupil_window_sum` per design (on the card the
    kernel scales each tile as it stages it, so no scaled copy is made; on
    the CPU the copy never exceeds one design's tiles).  The cell grid is
    (L, M, N)-major."""
    n_cells = L * M * N
    out = []
    for d in range(nd):
        sl = slice(d * n_cells, (d + 1) * n_cells)
        perc = pupil_window_sum(tiles[sl, :, :nx], mask, stride,
                                scale=factor[sl])
        out.append(perc.reshape((L, M, N) + tuple(perc.shape[-2:]))
                   .permute(0, 2, 1, 3, 4))
    return torch.stack(out)


def run_design_sweep_persistent(
    designs: Sequence[WaveguideDesign],
    cfg: TraceConfig = TraceConfig(num_fov_x=16, num_fov_y=12,
                                   rays_per_fov=2048, max_bounces=4096),
    lut_seed: int = 1234,
    spawn_iters: int = 256,
    keep_histograms: Union[bool, Sequence[int]] = False,
    designs_per_batch: int = 16,
    _force_host_blocks: bool = False,
    spawn_mode: str = "gens",
    slots: Optional[int] = None,
    evaluate_metrics: bool = False,
    eval_cfg: Optional[EvalConfig] = None,
    device="cuda",
    accum_mode: str = "fma",
    cells_per_block: int = 1,
    transit_jump: bool = False,
    mesh=None,
) -> SweepResult:
    """Trace every design with identical workloads on ``device``.

    The launch grid is ``nd x (L*M*N)`` cells laid out as nd contiguous
    per-design runs; each cell reads its design's geometry row.  Sweeps
    larger than ``designs_per_batch`` launch in chunks; chunk k+1's prep
    (geometry, trace geometry, the rows' host inputs and launch tiles; its
    rows' kernel queues behind chunk k's trace) runs while chunk k traces on
    the device.  A tail
    chunk launches its real design count: chunked and single-launch sweeps
    give the same results bit for bit.

    ``spawn_mode="gens"``: ``ctrl = [gens, spawn_iters]`` with
    ``gens = ceil(rays_per_fov / slots)`` generations per slot; with
    ``spawn_iters > 0`` dead slots keep respawning until that iteration
    (saturating spawn) and each cell's tile is renormalised to ``slots x
    gens`` rays (Wald factor nominal / spawned).  ``spawn_mode="count"``:
    each cell traces its exact ``cfg.rays_per_fov`` target, renormalised the
    same way.  ``slots`` (default ``min(rays_per_fov, 2048)``) is the lane
    count per cell.

    ``accum_mode="packed"`` reads bfloat16-rounded selection records;
    ``transit_jump`` (packed; the phase by squaring) advances a slot on a
    pure TIR hop to its next event in one iteration; ``cells_per_block = k``
    (packed, the shared-seed path, ``L*M*N % k == 0``) puts k cells of
    ``slots`` slots each into one block, each cell's result equal to its
    k = 1 result bit for bit.

    With shared pupil samples and fast seeding, each design uploads one
    ``(6, RT, 128)`` launch tile (reused while the in-coupler polygon is
    unchanged) and one ``(L*M*N, RT, 128)`` seed block, hashed once per
    sweep on the device with the seed contract global index ``cid * slots +
    slot`` (:func:`shared_seed_block`, iteration 0), serves every design.
    Otherwise, or when the ray indices pass 32 bits, every cell's tile and
    seeds are built on the host.

    ``evaluate_metrics`` adds the display metrics of each design
    (``SweepResult.metrics``: pupil integration per chunk on the device,
    one batched colorimetry pass at the end).  ``keep_histograms`` pulls
    each design's renormalised (L, N, M, ny, nx) histogram into
    ``SweepResult.histograms``; a sequence of design indices pulls only
    those designs' (in design order).

    ``SweepResult.timings``, host seconds: ``prep_s`` (geometry, rows and
    tiles) and its parts ``prep_geometry_s`` (geometry and trace geometry),
    ``prep_host_rows_s`` (the rows' host inputs), ``prep_rows_s`` (their
    upload and the rows' kernel launch, or the plain version on the CPU)
    and ``prep_tiles_s`` (launch tiles), ``seed_s`` (dispatching the shared
    seed block's hash on the device), ``upload_s`` (geometry rows and tiles
    to the device), ``keep_s`` (kept
    histograms to the host) and ``pull_s``
    (efficiencies and bounces to the host), both waiting for the device,
    ``metrics_s`` (batched colorimetry and its pull); on a GPU, device
    milliseconds from CUDA events: ``kernel_ms`` (the launches),
    ``reduce_ms`` (Wald factors, efficiency sums and pupil integration) and
    ``prep_rows_ms`` (the rows' kernel); and ``launches``.

    ``mesh``: the designs of every chunk split over the mesh's first axis,
    whole designs to a rank (a chunk whose design count does not divide
    repeats its last design, as the JAX package's mesh sweep pads it; a
    sweep of several chunks needs ``designs_per_batch`` to divide).  Each
    rank preps and traces only its designs; efficiencies, bounces, the
    metrics' perception stacks and kept histograms are gathered, so every
    rank returns the one-rank sweep's result, bit for bit; ``gather_s``
    times the collectives.
    """
    dev = resolve_device(device)
    on_gpu = dev.type == "cuda"
    if on_gpu:
        # the nvcc builds and the modules' loads are not sweep time
        build.build_all(["persistent_trace", "cell_rows", "eye_tail"])
        trace_persistent.load_kernel()
        cell_rows.load_kernel()
        eye_tail.load_kernel()
    D = len(designs)
    L, M, N = 3, cfg.num_fov_x, cfg.num_fov_y
    n_cells = L * M * N
    ny, nx = cfg.eyebox_bins
    if spawn_mode not in trace_persistent.SPAWN_MODES:
        raise ValueError(f"unknown spawn_mode {spawn_mode!r}")
    count_spawn = spawn_mode == "count"
    lanes = trace_rows.LANES
    if slots is None:
        slots = min(cfg.rays_per_fov, 2048)
    slots = max(lanes, (min(slots, cfg.rays_per_fov) // lanes) * lanes)
    gens = -(-cfg.rays_per_fov // slots)
    nominal = cfg.rays_per_fov if count_spawn else slots * gens
    renorm = bool(spawn_iters > 0 or count_spawn)
    if eval_cfg is None:
        eval_cfg = EvalConfig()
    broadcast = (cfg.shared_pupil_samples and cfg.rng_mode == "fast"
                 and n_cells * slots <= 0xFFFFFFFF
                 and not _force_host_blocks)
    cpb = int(cells_per_block)
    trace_persistent.check_modes(accum_mode, cpb, transit_jump, "pow2")
    packed = accum_mode == "packed"
    if cpb > 1 and (not broadcast or n_cells % cpb):
        raise ValueError(
            "cells_per_block > 1 requires the shared-seed path and a cell "
            f"count divisible by it (got shared={broadcast}, {n_cells} "
            f"cells, cells_per_block={cpb})")
    parts = ("geometry_s", "host_rows_s", "rows_s", "tiles_s")
    timings = {"prep_s": 0.0, **{f"prep_{k}": 0.0 for k in parts},
               "seed_s": 0.0, "upload_s": 0.0, "keep_s": 0.0}
    events, row_timers = [], []
    db = max(1, min(designs_per_batch, D))
    n_dev, rank, group = 1, 0, None
    if mesh is not None:
        if mesh.device_type != dev.type:
            raise ValueError(f"a {mesh.device_type} mesh cannot drive "
                             f"device {dev}")
        n_dev, rank, group = shard._axis(mesh, mesh.mesh_dim_names[0])
        if D > db and db % n_dev:
            raise ValueError(
                f"designs_per_batch ({db}) must divide over the {n_dev}-"
                f"device mesh axis for mesh-parallel sweeps")
        timings["gather_s"] = 0.0

    def mine(idx):
        """This rank's designs of a chunk (padded with its last design to
        a multiple of the mesh axis)."""
        padded = list(idx) + [idx[-1]] * (-len(idx) % n_dev)
        return shard._chunk(padded, n_dev, rank)

    def gathered(t):
        if group is None:
            return t
        t0 = time.perf_counter()
        out = shard.all_gather_rows(t, group)
        timings["gather_s"] += time.perf_counter() - t0
        return out

    def prep(idx):
        t0 = time.perf_counter()
        rows = prepare_chunk([designs[i] for i in idx], cfg, slots,
                             lut_seed=lut_seed, shared=broadcast,
                             packed=packed, cells_per_block=cpb, device=dev)
        timings["prep_s"] += time.perf_counter() - t0
        for k in parts:
            timings[f"prep_{k}"] += rows.timings[k]
        if rows.timer is not None:
            row_timers.append(rows.timer)
        return rows

    rng_cell = None
    if broadcast:
        t0 = time.perf_counter()
        rng_cell = shared_seed_block(cfg, slots, cpb, dev)
        timings["seed_s"] = time.perf_counter() - t0

    mask = pupil_mask(eval_cfg.pupil_mask_bins)
    ctrl = torch.tensor([cfg.rays_per_fov if count_spawn else gens,
                         spawn_iters], dtype=torch.int32, device=dev)
    chunks = [list(range(s, min(s + db, D))) for s in range(0, D, db)]
    eff_parts, bounce_parts, nb_parts, perc_parts = [], [], [], []
    hist_parts = []
    if keep_histograms is True:
        keep = set(range(D))
    else:
        keep = set(keep_histograms or ())
    num_fc = num_oc = None
    launches0 = trace_persistent.launch_counts["persistent_trace"]
    prepped = prep(mine(chunks[0]))
    for ci, idx in enumerate(chunks):
        rows, prepped = prepped, None
        nd = len(mine(idx))
        if num_fc is None:
            num_fc, num_oc = rows.tgeoms[0].num_fc, rows.tgeoms[0].num_oc
        if any(g.num_fc != num_fc or g.num_oc != num_oc for g in rows.tgeoms):
            raise ValueError("designs in one sweep batch must share strip counts")
        t0 = time.perf_counter()
        cp_t, cpk_t = rows.cell_params, rows.cell_params_packed
        gr_t = torch.from_numpy(rows.geom_rows).to(dev)
        if broadcast:
            rays_in = torch.from_numpy(rows.rays).to(dev)   # (nd, 6, RT, 128)
            rng_in = rng_cell
        else:
            rays_in, rng_in = trace_rows.blocks_to_device(rows.rays, rows.rng,
                                                          dev)
        timings["upload_s"] += time.perf_counter() - t0
        if on_gpu:
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
            ev[0].record()
        tiles, nb = trace_persistent.persistent_trace(
            cp_t, gr_t, rays_in, rng_in, ctrl, num_fc=num_fc, num_oc=num_oc,
            edge_counts=rows.edge_counts, eyebox_bins=cfg.eyebox_bins,
            max_iters=cfg.max_bounces, spawn_mode=spawn_mode,
            accum_mode=accum_mode, cells_per_block=cpb,
            transit_jump=transit_jump, cell_params_packed=cpk_t)
        if on_gpu:
            ev[1].record()
        del cp_t, cpk_t, rays_in, rows
        nb_parts.append(nb)
        eff_d, bounce_d, factor = _chunk_reduce(
            tiles, nb, nd, n_cells, L, M * N, nx, renorm, nominal)
        eff_parts.append(gathered(eff_d)[:len(idx)])
        bounce_parts.append(gathered(bounce_d)[:len(idx)])
        if evaluate_metrics:
            perc_parts.append(gathered(_chunk_perceive(
                tiles, factor, nd, L, M, N, nx, mask,
                (eval_cfg.eye_step_y, eval_cfg.eye_step_x)))[:len(idx)])
        if on_gpu:
            ev[2].record()
            events.append(ev)
        t0 = time.perf_counter()
        for j, d in enumerate(idx):
            if d not in keep:
                continue
            # design j of the chunk is design j % nd of rank j // nd
            i = j % nd
            if j // nd == rank:
                h = trace_persistent.hist_tiles_to_histogram(
                    tiles[i * n_cells:(i + 1) * n_cells]
                    * factor[i * n_cells:(i + 1) * n_cells, None, None],
                    np.arange(n_cells), L, M, N, ny, nx).cpu()
            else:
                h = torch.empty((L, N, M, ny, nx), dtype=torch.float32)
            if group is not None:
                h = shard.broadcast_from(h, j // nd, group)
            hist_parts.append(h.numpy())
        del tiles
        timings["keep_s"] += time.perf_counter() - t0
        if ci + 1 < len(chunks):
            prepped = prep(mine(chunks[ci + 1]))

    t0 = time.perf_counter()
    overflowed = torch.cat([nb[:, 3] for nb in nb_parts]).sum()
    if group is not None:
        overflowed = shard.all_reduce_sum(overflowed, group)
    overflowed = int(overflowed)
    if overflowed:
        raise RuntimeError(
            f"{overflowed} deposits overflowed (nb[:, 3] != 0): the "
            "histogram undercounts")
    efficiencies = torch.cat(eff_parts).cpu().numpy()
    bounces = torch.cat(bounce_parts).cpu().numpy()
    timings["pull_s"] = time.perf_counter() - t0
    metrics = None
    if evaluate_metrics:
        t0 = time.perf_counter()
        metrics = evaluate_batch(torch.cat(perc_parts, dim=0), norm=nominal)
        timings["metrics_s"] = time.perf_counter() - t0
    if on_gpu:
        torch.cuda.synchronize(dev)
        timings["kernel_ms"] = sum(a.elapsed_time(b) for a, b, _ in events)
        timings["reduce_ms"] = sum(b.elapsed_time(c) for _, b, c in events)
        timings["prep_rows_ms"] = sum(t.ms()["rows"] for t in row_timers)
    timings["launches"] = (trace_persistent.launch_counts["persistent_trace"]
                           - launches0)
    return SweepResult(
        designs=list(designs),
        histograms=np.stack(hist_parts) if keep_histograms else None,
        efficiencies=efficiencies,
        bounces=bounces,
        metrics=metrics,
        timings=timings,
    )
