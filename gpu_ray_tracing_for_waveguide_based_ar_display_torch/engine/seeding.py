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
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..config import TraceConfig
from ..design.convex import point_in_polygon
from ..design.geometry import DesignGeometry
from ..ops import rng as rng_ops

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


def build_ray_batch(geom: DesignGeometry, cfg: TraceConfig,
                    cell_ids: Optional[np.ndarray] = None,
                    rays_per_cell: Optional[int] = None,
                    iteration: int = 0) -> dict:
    """Host SoA arrays for one batch: x, y, te, tm (complex64), cid, idx, rng.

    ``cell_ids`` are flat cell indices ``(l * M + m) * N + n`` (default: all).
    """
    if cfg.pupil_sampler not in ("numpy", "native"):
        raise ValueError("pupil_sampler must be 'numpy' or 'native', got "
                         f"{cfg.pupil_sampler!r}")
    L, M, N = geom.th_out_ic.shape
    if cell_ids is None:
        cell_ids = np.arange(L * M * N)
    rpc = rays_per_cell if rays_per_cell is not None else cfg.rays_per_fov
    if rpc % 2:
        raise ValueError(f"rays_per_fov must be even, got {rpc}")
    half = rpc // 2
    n_cells = len(cell_ids)
    total = n_cells * rpc

    if cfg.shared_pupil_samples:
        seed = cfg.seed + 7919 * iteration
        pts = sample_pupil(geom, cfg, half, np.random.default_rng(seed), seed)
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


def cell_seeds_device(cell_ids: np.ndarray, slots: int, iteration: int,
                      total_cells: int, seed: int, device,
                      cells_per_hash: int = 2048) -> torch.Tensor:
    """:func:`cell_seeds` hashed on ``device`` (the same seed contract, the
    same bits): (C, slots) int32 holding the uint32 seeds, as the kernels
    take them.  The hash runs ``cells_per_hash`` cells at a time, which bounds
    its int64 temporaries."""
    ids = np.asarray(cell_ids, np.int64)
    if len(ids) and np.array_equal(ids, np.arange(ids[0], ids[0] + len(ids))):
        # made on the device: a copy from pageable host memory would first
        # wait for the work already queued (the previous batch's launch)
        cid = torch.arange(int(ids[0]), int(ids[0]) + len(ids), device=device)
    else:
        cid = torch.from_numpy(ids).to(device)
    slot = torch.arange(slots, dtype=torch.int64, device=device)
    out = torch.empty((len(cid), slots), dtype=torch.int32, device=device)
    for s in range(0, len(cid), cells_per_hash):
        idx = ((iteration * total_cells + cid[s:s + cells_per_hash, None])
               * slots + slot)
        out[s:s + cells_per_hash] = rng_ops.as_int32_bits(
            rng_ops.seed_fast_device(idx, seed))
    return out
