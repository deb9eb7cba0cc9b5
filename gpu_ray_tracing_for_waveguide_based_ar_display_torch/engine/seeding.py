"""Ray seeding: pupil sampling and the SoA launch batch.

Port of ``engine/seeding.py`` of the JAX package (host numpy, bitwise equal).
Every (FoV, wavelength) cell launches ``rays_per_cell`` rays from points in the
in-coupler pupil, the first half pure TE and the second half pure TM on the
same points.  With ``shared_pupil_samples`` one point set, drawn from
``numpy.random.default_rng(cfg.seed + 7919 * iteration)``, serves every cell.
``TraceConfig(pupil_sampler="native")`` draws the points with the native
host sampler (:mod:`.native`) seeded by the same value, as the JAX package
does (per cell: the first word of the cell's ``SeedSequence``); where the
JAX package falls back to numpy when that library is missing, the port
raises.

:func:`build_ray_batch` seeds every ray of a batch on the host, as the JAX
package does.  Under :func:`device_seeded` configs (shared pupil samples
and fast seeding, the defaults) a batch holds nothing beyond the shared
points, the TE / TM pattern and the hash of the ray index, so
:func:`ray_blocks_device` and :func:`ray_state_device` build the same
batch on the device, bit for bit, from the points alone.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraceConfig
from ..design.convex import point_in_polygon
from ..design.geometry import DesignGeometry
from ..ops import rng as rng_ops
from .trace_rows import LANES

_PLASTIC = 1.32471795724474602596  # plastic number, root of x^3 = x + 1


def sample_points_in_polygon(poly: np.ndarray, num: int,
                             rng: np.random.Generator) -> np.ndarray:
    """Rejection-sample ``num`` points uniformly inside a polygon: uniform
    bounding-box proposals, 2x oversampling per round."""
    lo = poly.min(axis=0)
    hi = poly.max(axis=0)
    out = np.empty((0, 2))
    while len(out) < num:
        cand = rng.uniform(lo, hi, size=(2 * (num - len(out)) + 16, 2))
        keep = point_in_polygon(cand[:, 0], cand[:, 1], poly)
        out = np.concatenate([out, cand[keep]], axis=0)
    return out[:num]


def sample_points_r2_disk(poly: np.ndarray, num: int,
                          rng: np.random.Generator) -> np.ndarray:
    """Randomized R2 low-discrepancy points in the polygon's inscribed disk
    (one uniform Cranley-Patterson shift from ``rng``, concentric
    square-to-disk map)."""
    # the in-coupler ring closes with a (nearly) duplicated last vertex
    if len(poly) > 1 and np.hypot(*(poly[0] - poly[-1])) < 1e-9:
        poly = poly[:-1]
    center = poly.mean(axis=0)
    a = poly
    e = np.roll(poly, -1, axis=0) - a
    elen = np.hypot(e[:, 0], e[:, 1])
    real = elen > 1e-12
    dist = np.abs(e[real, 0] * (center[1] - a[real, 1])
                  - e[real, 1] * (center[0] - a[real, 0])) / elen[real]
    r_in = float(dist.min())

    i = np.arange(num, dtype=np.float64)
    alpha = np.array([1.0 / _PLASTIC, 1.0 / _PLASTIC ** 2])
    u = (i[:, None] * alpha[None, :] + rng.uniform(0.0, 1.0, size=2)) % 1.0
    ab = 2.0 * u - 1.0
    ax, by = ab[:, 0], ab[:, 1]
    use_a = np.abs(ax) > np.abs(by)
    r = np.where(use_a, ax, by)
    phi = np.where(
        use_a,
        (np.pi / 4.0) * np.divide(by, ax, out=np.zeros_like(by), where=ax != 0.0),
        np.pi / 2.0 - (np.pi / 4.0) * np.divide(ax, by, out=np.zeros_like(ax),
                                                where=by != 0.0),
    )
    return center[None, :] + (r_in * r)[:, None] * np.stack(
        [np.cos(phi), np.sin(phi)], axis=1)


def sample_pupil(geom: DesignGeometry, cfg: TraceConfig, num: int,
                 rng: np.random.Generator, native_seed: int) -> np.ndarray:
    """``num`` pupil points by the configured sampling: ``rng`` feeds the
    numpy samplers, ``native_seed`` the native one."""
    if cfg.pupil_sampling == "r2":
        return sample_points_r2_disk(geom.ic, num, rng)
    if cfg.pupil_sampler == "native":
        from . import native

        return native.sample_points_in_polygon(geom.ic, num, seed=native_seed)
    return sample_points_in_polygon(geom.ic, num, rng)


def _check_batch(cfg: TraceConfig, rays_per_cell: int) -> None:
    if cfg.pupil_sampler not in ("numpy", "native"):
        raise ValueError("pupil_sampler must be 'numpy' or 'native', got "
                         f"{cfg.pupil_sampler!r}")
    if rays_per_cell % 2:
        raise ValueError(f"rays_per_fov must be even, got {rays_per_cell}")


def shared_points(geom: DesignGeometry, cfg: TraceConfig,
                  rays_per_cell: int, iteration: int) -> np.ndarray:
    """(rays_per_cell / 2, 2) float64: the pupil points every cell of
    iteration ``iteration`` launches from with ``shared_pupil_samples``,
    each traced as TE and as TM."""
    _check_batch(cfg, rays_per_cell)
    seed = cfg.seed + 7919 * iteration
    return sample_pupil(geom, cfg, rays_per_cell // 2,
                        np.random.default_rng(seed), seed)


def build_ray_batch(geom: DesignGeometry, cfg: TraceConfig,
                    cell_ids: Optional[np.ndarray] = None,
                    rays_per_cell: Optional[int] = None,
                    iteration: int = 0) -> dict:
    """Host SoA arrays for one batch: x, y, te, tm (complex64), cid, idx, rng.

    ``cell_ids`` are flat cell indices ``(l * M + m) * N + n`` (default: all).
    """
    L, M, N = geom.th_out_ic.shape
    if cell_ids is None:
        cell_ids = np.arange(L * M * N)
    rpc = rays_per_cell if rays_per_cell is not None else cfg.rays_per_fov
    _check_batch(cfg, rpc)
    half = rpc // 2
    n_cells = len(cell_ids)
    total = n_cells * rpc

    if cfg.shared_pupil_samples:
        pts = shared_points(geom, cfg, rpc, iteration)
        x = np.tile(np.concatenate([pts[:, 0], pts[:, 0]]), n_cells)
        y = np.tile(np.concatenate([pts[:, 1], pts[:, 1]]), n_cells)
    else:
        # one stream per cell keyed by (seed, iteration, cell id)
        xs = np.empty((n_cells, half))
        ys = np.empty((n_cells, half))
        for i, c in enumerate(np.asarray(cell_ids)):
            ss = np.random.SeedSequence((cfg.seed, 7919 * iteration, int(c)))
            pts = sample_pupil(geom, cfg, half, np.random.default_rng(ss),
                               int(ss.generate_state(1)[0]))
            xs[i], ys[i] = pts[:, 0], pts[:, 1]
        x = np.concatenate([xs, xs], axis=1).reshape(-1)
        y = np.concatenate([ys, ys], axis=1).reshape(-1)

    te = np.zeros(total, dtype=np.complex64)
    tm = np.zeros(total, dtype=np.complex64)
    pol = np.tile(np.arange(rpc) < half, n_cells)  # True = TE
    te[pol] = 1.0
    tm[~pol] = 1.0

    cid = np.repeat(cell_ids.astype(np.int32), rpc)
    within = np.tile(np.arange(rpc, dtype=np.uint64), n_cells)
    if cfg.rng_mode == "parity":
        if iteration != 0:
            raise ValueError("rng_mode='parity' supports a single iteration only")
        l = cell_ids // (M * N)
        mn = cell_ids % (M * N)
        ref_cell = (mn * L + l).astype(np.uint64)
        idx = (np.repeat(ref_cell, rpc) * np.uint64(rpc) + within).astype(np.uint32)
        rng_state = rng_ops.seed_parity(idx)
    else:
        idx64 = (np.repeat(cell_ids.astype(np.uint64), rpc) * np.uint64(rpc)
                 + within
                 + np.uint64(iteration) * np.uint64(L * M * N) * np.uint64(rpc))
        idx = (idx64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
        rng_state = rng_ops.seed_fast(idx64, cfg.seed)
    return {"x": x, "y": y, "te": te, "tm": tm, "cid": cid, "idx": idx,
            "rng": rng_state}


def cell_seeds(cell_ids: np.ndarray, slots: int, iteration: int,
               total_cells: int, seed: int) -> np.ndarray:
    """(C, slots) uint32 per-slot seeds of the persistent path, on the host:
    the reference :func:`cell_seeds_device` is held to.

    Seed contract: global ray index ``(iteration * cells + cid) * slots +
    slot``, hashed by :func:`..ops.rng.seed_fast`.
    """
    idx = ((np.uint64(iteration) * np.uint64(total_cells)
            + np.asarray(cell_ids).astype(np.uint64)[:, None])
           * np.uint64(slots)
           + np.arange(slots, dtype=np.uint64)[None, :])
    return rng_ops.seed_fast(idx, seed)


def device_seeded(cfg: TraceConfig) -> bool:
    """Whether a batch is built on the device: one point set serves every
    cell and the seeds hash the ray index (the default config).  Otherwise
    :func:`build_ray_batch` seeds it on the host, cell by cell."""
    return cfg.shared_pupil_samples and cfg.rng_mode == "fast"


def to_device(a: np.ndarray, device) -> torch.Tensor:
    """A host array on ``device``, values unchanged.  To a GPU the copy
    leaves from pinned memory without waiting: a copy from pageable memory
    would first wait for the work already queued (the previous batch's
    trace)."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if torch.device(device).type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t.to(device)


def _cells_on(cell_ids: np.ndarray, device) -> torch.Tensor:
    """Cell ids as an int64 tensor on ``device``; a contiguous run is made
    there."""
    ids = np.asarray(cell_ids, np.int64)
    if len(ids) and np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids))):
        return torch.arange(int(ids[0]), int(ids[0]) + len(ids), device=device)
    return to_device(ids, device)


def _ray_index(cid: torch.Tensor, rays: int, iteration: int,
               total_cells: int) -> torch.Tensor:
    """(len(cid), rays) int64 global ray indices ``(iteration * cells +
    cid) * rays + ray``: the seed contract of every engine."""
    return ((iteration * total_cells + cid[:, None]) * rays
            + torch.arange(rays, dtype=torch.int64, device=cid.device))


def cell_seeds_device(cell_ids: np.ndarray, slots: int, iteration: int,
                      total_cells: int, seed: int, device,
                      cells_per_hash: Optional[int] = None) -> torch.Tensor:
    """:func:`cell_seeds` hashed on ``device`` (the same seed contract, the
    same bits): (C, slots) int32 holding the uint32 seeds, as the kernels
    take them.  The hash runs ``cells_per_hash`` cells at a time (default:
    about 2^22 seeds), which bounds its int64 temporaries."""
    cid = _cells_on(cell_ids, device)
    step = cells_per_hash or max(1, (1 << 22) // slots)
    out = torch.empty((len(cid), slots), dtype=torch.int32, device=device)
    for s in range(0, len(cid), step):
        out[s:s + step] = rng_ops.as_int32_bits(rng_ops.seed_fast_device(
            _ray_index(cid[s:s + step], slots, iteration, total_cells), seed))
    return out


# the launch fields of a ray, in the kernels' tile order
FIELDS = ("x", "y", "ter", "tei", "tmr", "tmi")


def launch_fields(points: torch.Tensor) -> torch.Tensor:
    """(6, rays_per_cell) float32 launch fields of one cell (:data:`FIELDS`)
    from its (rays_per_cell / 2, 2) float64 points on the device: every
    point traced as TE (unit ``te``), then as TM (unit ``tm``); each
    coordinate rounded to float32 once, as the host batch rounds it."""
    half = points.shape[0]
    f = torch.zeros((6, 2 * half), dtype=torch.float32, device=points.device)
    xy = points.to(torch.float32).T
    f[0:2, :half] = xy
    f[0:2, half:] = xy
    f[2, :half] = 1.0
    f[4, half:] = 1.0
    return f


def ray_tile(points: torch.Tensor) -> torch.Tensor:
    """(6, RT, 128) float32 launch tile of one cell, RT = ceil(rays_per_cell
    / 128): :func:`launch_fields` padded with rays whose six fields are
    zero (they die at init), as :func:`.trace_rows.pack_ray_blocks` packs
    a cell."""
    f = launch_fields(points)
    rt = -(-f.shape[1] // LANES)
    tile = f.new_zeros((6, rt * LANES))
    tile[:, :f.shape[1]] = f
    return tile.reshape(6, rt, LANES)


def ray_blocks_device(points: torch.Tensor, cell_ids: np.ndarray,
                      iteration: int, total_cells: int, seed: int):
    """The cell kernel's launch blocks of one batch, built on the points'
    device from the shared ``points`` (:func:`shared_points` of the batch's
    rays per cell and iteration, on the device): rays_in (C, 6, RT, 128)
    float32 and rng_in (C, RT, 128) int32 holding the uint32 seeds (padding
    rays seed 1), equal to ``trace_rows.blocks_to_device(*pack_ray_blocks(
    build_ray_batch(...), C, rays_per_cell, RT))`` for any cells and
    iteration of a :func:`device_seeded` config."""
    tile = ray_tile(points)
    rpc, (_, rt, _) = 2 * points.shape[0], tile.shape
    C = len(cell_ids)
    rng_in = torch.ones((C, rt * LANES), dtype=torch.int32,
                        device=points.device)
    rng_in[:, :rpc] = cell_seeds_device(cell_ids, rpc, iteration, total_cells,
                                        seed, points.device)
    return (tile.expand(C, -1, -1, -1).contiguous(),
            rng_in.reshape(C, rt, LANES))


def ray_state_device(points: torch.Tensor, cell_ids: np.ndarray,
                     iteration: int, total_cells: int, seed: int) -> dict:
    """The vector engine's (R,) ray state of one batch, built on the points'
    device as :func:`ray_blocks_device` builds the blocks: field for field
    ``trace_vector.make_ray_state`` of :func:`build_ray_batch` (``rng`` the
    uint32 seeds and ``idx`` the low 32 bits of the global index, both as
    int64 values; ``cid`` int64)."""
    f = launch_fields(points)
    rpc = f.shape[1]
    dev = points.device
    cid = _cells_on(cell_ids, dev)
    R = len(cid) * rpc
    seeds = cell_seeds_device(cell_ids, rpc, iteration, total_cells, seed,
                              dev)
    state = {k: f[i].repeat(len(cid)) for i, k in enumerate(FIELDS)}
    state.update(
        cos_th=torch.ones(R, dtype=torch.float32, device=dev),
        gap_x=torch.zeros(R, dtype=torch.float32, device=dev),
        gap_y=torch.zeros(R, dtype=torch.float32, device=dev),
        state=torch.zeros(R, dtype=torch.int32, device=dev),
        rng=seeds.reshape(-1).to(torch.int64) & 0xFFFFFFFF,
        dep=torch.full((R,), -1, dtype=torch.int32, device=dev),
        cid=cid.repeat_interleave(rpc),
        idx=_ray_index(cid, rpc, iteration, total_cells).reshape(-1)
        & 0xFFFFFFFF)
    return state
