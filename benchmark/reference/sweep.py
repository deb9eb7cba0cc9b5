"""The reference results of designs of a persistent design sweep.

From each design's fields, the workload and the trace seed alone: the
geometry, the synthetic LUTs, the cell tables and cell rows on the host
(float64, rounded to float32 as the rows are stored), the shared launch
tile and the per-slot seeds, then the gens-spawn trace of all the designs'
cells together in plain PyTorch (:mod:`.trace`), the Wald
renormalisation, the efficiencies and the pupil integration in float64
PyTorch on the trace's device, and the display metrics in float64 NumPy.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import metrics, rows, seeding, trace
from .config import TraceConfig, WaveguideDesign
from .geometry import generate_geometry
from .packing import build_cell_tables
from .synthetic import make_synthetic_luts
from .trace_geometry import build_trace_geometry

LANES = rows.LANES


def make_design(fields: dict) -> WaveguideDesign:
    """A design from JSON fields: lists become tuples."""
    return WaveguideDesign(**{k: tuple(v) if isinstance(v, list) else v
                              for k, v in fields.items()})


def trace_config(work: dict, seed: int) -> TraceConfig:
    return TraceConfig(num_fov_x=work["num_fov_x"],
                       num_fov_y=work["num_fov_y"],
                       rays_per_fov=work["rays_per_fov"],
                       max_bounces=work["max_bounces"],
                       eyebox_bins=tuple(work["eyebox_bins"]), seed=seed)


def launch_shape(rays_per_fov: int, slots=None) -> tuple:
    """(slots, generations) a cell runs: ``slots`` lanes (default
    ``min(rays, 2048)``, a multiple of 128) and ``ceil(rays / slots)``
    generations a slot."""
    if slots is None:
        slots = min(rays_per_fov, 2048)
    slots = max(LANES, (min(slots, rays_per_fov) // LANES) * LANES)
    return slots, -(-rays_per_fov // slots)


def r1_edges(fields: dict, work: dict) -> int:
    """Half-plane edges of the design's whole-system region, as traced."""
    geom = generate_geometry(make_design(fields), work["num_fov_x"],
                             work["num_fov_y"])
    tg = build_trace_geometry(geom, simplify_tol=work["simplify_tol"])
    return rows.edge_counts(tg)[1]


@dataclasses.dataclass
class DesignResult:
    efficiencies: np.ndarray     # (L,) per-colour efficiency, (B, G, R)
    bounces: int
    deposits: int
    metrics: metrics.Metrics


def _prepared(fields: dict, work: dict, cfg: TraceConfig, slots: int) -> dict:
    """One design's host inputs of the trace: cell rows, geometry row,
    launch tile, strips and edges, and its eyebox bins' shape."""
    M, N = cfg.num_fov_x, cfg.num_fov_y
    geom = generate_geometry(make_design(fields), M, N)
    tg = build_trace_geometry(geom, simplify_tol=work["simplify_tol"])
    tables = build_cell_tables(geom, make_synthetic_luts(
        geom, seed=work["lut_seed"]))
    cfg_s = dataclasses.replace(cfg, rays_per_fov=slots)
    batch = seeding.build_ray_batch(geom, cfg_s, cell_ids=np.array([0]),
                                    rays_per_cell=slots)
    return dict(
        cp=rows.build_kernel_cell_params(tables, geom.eyebox_range,
                                         cfg.eyebox_bins),
        grow=rows.build_kernel_geom(tg),
        tile=rows.pack_ray_blocks(batch, 1, slots, slots // LANES)[0][0]
        .reshape(6, slots),
        num_fc=tg.num_fc, num_oc=tg.num_oc, edges=rows.edge_counts(tg))


def designs_result(fields_list: list, work: dict, seed: int,
                   device="cuda", times=None) -> list:
    """Trace several designs at the sweep's workload with trace seed
    ``seed``, their cells in one batch (a cell's values do not depend on
    the cells traced beside it); one :class:`DesignResult` a design.
    ``times``, a dict, receives the seconds of the host inputs, the trace
    and the reductions."""
    times = {} if times is None else times
    t0 = time.perf_counter()
    cfg = trace_config(work, seed)
    L, M, N = 3, cfg.num_fov_x, cfg.num_fov_y
    C = L * M * N
    ny, nx = cfg.eyebox_bins
    slots, gens = launch_shape(cfg.rays_per_fov, work.get("slots"))
    preps = [_prepared(f, work, cfg, slots) for f in fields_list]
    seeds = seeding.cell_seeds(np.arange(C), slots, 0, C, cfg.seed)

    dev = torch.device(device)
    times["host_s"] = time.perf_counter() - t0

    def cells(key):
        """Each design's ``key`` repeated over its cells."""
        return torch.from_numpy(np.repeat(
            np.stack([p[key] for p in preps]), C, axis=0)).to(dev)

    hist, bounces, spawned = trace.trace_design(
        torch.from_numpy(np.concatenate([p["cp"] for p in preps])).to(dev),
        cells("grow"), cells("tile"),
        torch.from_numpy(np.tile(seeds.astype(np.int64),
                                 (len(preps), 1))).to(dev),
        quota=gens, spawn_iters=work["spawn_iters"],
        num_fc=np.repeat([p["num_fc"] for p in preps], C),
        num_oc=np.repeat([p["num_oc"] for p in preps], C),
        edge_counts=tuple(np.max([p["edges"] for p in preps], axis=0)),
        eyebox_bins=cfg.eyebox_bins, max_iters=cfg.max_bounces)
    bounces = bounces.cpu().numpy()
    spawned = spawned.to(torch.float64)
    times["trace_s"] = time.perf_counter() - t0 - times["host_s"]
    out = []
    nominal = slots * gens
    for d in range(len(preps)):
        sl = slice(d * C, (d + 1) * C)
        counts = hist[sl].to(torch.float64)      # (C, ny, nx), float64
        # Wald renormalisation to the nominal slots x generations rays a cell
        factor = nominal / torch.clamp(spawned[sl], min=1.0)
        per_cell = counts.sum(dim=(1, 2)) * factor
        eff = (per_cell.reshape(L, M * N).sum(dim=1)
               / (nominal * M * N * L) * L)
        # (L, M, N) cells -> the (L, N, M, ny, nx) histogram in per-ray units
        hist_eb = ((counts * factor[:, None, None]).reshape(L, M, N, ny, nx)
                   .permute(0, 2, 1, 3, 4))
        perc = metrics.eye_perceived(hist_eb, work["pupil_mask_bins"],
                                     tuple(work["eye_stride"]))
        out.append(DesignResult(efficiencies=eff.cpu().numpy(),
                                bounces=int(bounces[sl].sum()),
                                deposits=int(hist[sl].sum()),
                                metrics=metrics.evaluate(
                                    perc.cpu().numpy() / nominal)))
        del counts, hist_eb
    times["reduce_s"] = (time.perf_counter() - t0 - times["host_s"]
                         - times["trace_s"])
    return out
