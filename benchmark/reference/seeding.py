"""Ray seeding: pupil sampling and the SoA launch batch.

A frozen copy of the port's ``engine/seeding.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

Every (FoV, wavelength) cell launches ``rays_per_cell`` rays from points in
the in-coupler pupil, the first half pure TE and the second half pure TM on
the same points.  With ``shared_pupil_samples`` one point set, drawn from
``numpy.random.default_rng(cfg.seed + 7919 * iteration)``, serves every
cell.  :func:`cell_seeds` hashes each slot's seed from its global ray
index.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .config import TraceConfig
from .convex import point_in_polygon
from .geometry import DesignGeometry
from . import rng as rng_ops
from .rows import LANES

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
    if cfg.pupil_sampler != "numpy":
        raise ValueError("the reference draws pupil points with numpy only")
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
