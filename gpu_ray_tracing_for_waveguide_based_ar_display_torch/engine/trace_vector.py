"""Vector Monte-Carlo tracer: the whole ray batch advances one bounce per step.

Port of ``engine/trace_jnp.py`` of the JAX package (its ``engine="jnp"``).
Every ray is one element of a masked struct-of-arrays batch; a step applies
one bounce to every live ray, and the loop ends when no ray is alive or the
bounce budget is spent.  The step follows the JAX step operation for
operation (containment tests, the interaction record of the ray's site, the
2x2 complex Jones products, one roulette draw, the masked update).

The batch has a leading design axis: every tensor of the ray state is
(D, R), and row ``d`` holds the rays of design ``d``, traced with that
design's tables and geometry.  A design sweep traces D designs in one loop,
where the JAX package maps its trace over a design axis; the ``Simulator``
uses D = 1.  Rays that are dead take no part in a step (every update is
masked and the RNG advances only where a ray interacts), so a design traced
beside others gives what it gives alone, bit for bit.

Tables.  :func:`as_tables` carries the :class:`CellTables` across as the JAX
package's ``_as_jnp`` does (complex arrays as trailing (re, im) float
pairs); :func:`pack_tables` lays them out for the step: one 26-float
*interaction record* per (cell, site, state bit), site = IC, FC strip s or
OC strip s, holding the A / B / C branch Jones matrices and the A / B
scales, so the step reads one record per ray where the JAX step gathers
seven tables and selects among them (the same values: a selection is
exact).  Per-cell constants and per-direction hop vectors and phasors sit in
two more small tables.

Deposits.  A ray out-couples on its last bounce and keeps its position
after it, so the step only marks the out-coupling and the deposit bin is
computed once, at the end of the trace call, from that position: the same
bin the JAX step computes in the step.

The trace.  :func:`vector_trace` routes one trace call by device: on a GPU
one launch of the hand-written kernel ``csrc/vector_trace.cu``
(:func:`launch_vector_trace`: a lane runs a ray's whole bounce loop, its
warp a bounce a round with the region tests shared, the lanes whose rays
ended taking the next rays of their block's range; no read of the device
from the host), on the CPU its plain version
:func:`vector_trace_reference` (the eager loop above, which reads the
device twice a step).  Both take a :class:`VectorTraceArgs` and agree bit
for bit.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..config import TraceConfig
from ..luts.packing import CellTables, DIR_FC, DIR_IC, DIR_IC2, DIR_OC
from ..ops.rng import draw_uniform
from . import build
from .device import resolve_device
from .timing import EventTimer
from .trace_geometry import TraceGeometry
from .trace_persistent import launch_counts

DEAD = 6
_EDGE_TOL = 1e-6   # the float32-scale edge tolerance of the JAX step
_OUT = -2          # dep marker: out-coupled this call, bin not yet taken
REC_W = 26         # interaction record: j_a(8), j_b(8), j_c(8), s_a, s_b
# per-cell constants: init Jones A / B, init scales A / B, init cos0, IC
# scales A / B (the cos_th after the first interaction), OC branch C scale,
# deposit rectangle (xmin, xmax, ymin, ymax)
_I_JA, _I_JB, _I_SA, _I_SB, _I_COS0, _I_ICA, _I_ICB = 0, 8, 16, 17, 18, 19, 20
_C_SOUT, _C_EBR = 21, 22
# per (cell, direction): hop vector (dx, dy), TIR phasor, doubled phasor
DIR_W = 6
_HP_PAIRS = 1 << 22   # (position, edge) pairs per exact containment pass


def as_tables(tables: CellTables, dtype=torch.float32) -> dict:
    """The cell tables as CPU tensors, complex arrays as trailing (re, im)
    pairs: the arrays the JAX package's ``_as_jnp`` gives, bit for bit."""
    t = {}
    for f in dataclasses.fields(tables):
        v = getattr(tables, f.name)
        if isinstance(v, np.ndarray):
            if np.iscomplexobj(v):
                v = np.stack([v.real, v.imag], axis=-1)
                t[f.name] = torch.from_numpy(v).to(dtype)
            elif v.dtype.kind == "f":
                t[f.name] = torch.from_numpy(np.array(v)).to(dtype)
            else:
                t[f.name] = torch.from_numpy(np.array(v))
        else:
            t[f.name] = v
    return t


def geom_tensors(g: TraceGeometry, dtype=torch.float32) -> dict:
    """The trace geometry as CPU tensors (the JAX package's ``_geom_jnp``):
    scalars as 0-d tensors, the deposit rectangles as (M * N, 4)."""
    def t(v):
        return torch.tensor(np.asarray(v, np.float64), dtype=dtype)

    return {
        "ic_center": t(g.ic_center), "ic_radius": t(g.ic_radius),
        "ic_hp": t(g.ic_hp), "r1_hp": t(g.r1_hp), "r2_hp": t(g.r2_hp),
        "hull_hp": t(g.hull_hp), "fc_rot": t(g.fc_rot),
        "fc_top": t(g.fc_top), "fc_width": t(g.fc_width),
        "oc_rot_y": t(g.oc_rot_y), "oc_bounds": t(g.oc_bounds),
        "oc_top": t(g.oc_top), "oc_width": t(g.oc_width),
        "eyebox_range": t(g.eyebox_range.reshape(-1, 4)),
    }


def _pad_hp(hp: torch.Tensor, target: int) -> torch.Tensor:
    """Pad a half-plane pack with always-true rows (0, 0, 1)."""
    pad = target - hp.shape[0]
    if pad <= 0:
        return hp
    filler = hp.new_tensor([[0.0, 0.0, 1.0]]).expand(pad, 3)
    return torch.cat([hp, filler])


_HP = ("ic_hp", "r1_hp", "r2_hp", "hull_hp")


def stack_geoms(geoms: Sequence[dict]) -> dict:
    """Stack :func:`geom_tensors` dicts along a leading design axis; the
    half-plane packs are padded to the largest with always-true rows, which
    leaves every design's regions as they were."""
    out = {}
    for k in geoms[0]:
        vals = [g[k] for g in geoms]
        if k in _HP:
            e = max(v.shape[0] for v in vals)
            vals = [_pad_hp(v, e) for v in vals]
        out[k] = torch.stack(vals)
    return out


def _j8(j: torch.Tensor) -> torch.Tensor:
    """(..., 2, 2, 2) split-real Jones matrices -> (..., 8): row-major
    entries, (re, im) interleaved."""
    return j.reshape(*j.shape[:-3], 8)


def pack_tables(T: dict, G: dict, cell_ids=None) -> dict:
    """One design's :func:`as_tables` dict and :func:`geom_tensors` dict in
    the step's layout (plain tensor operations, so gradients can flow):

    - ``rec`` (26, C * 2 * S): the interaction record of cell c, site s
      (0: IC; 1 + i: FC strip i; 1 + S_fc + i: OC strip i) and state bit b
      at entry ``(c * S + s) * 2 + b``; branch C is zero off the OC sites;
    - ``cell`` (26, C): the per-cell constants (see ``_I_*``, ``_C_*``);
    - ``dirs`` (6, C * 4): per (cell, direction) hop vector, TIR phasor and
      doubled phasor.

    Each table is component-major, so a gather (:func:`_take`) gives each
    component as a contiguous tensor.

    ``cell_ids`` names the global cells of a table cut to some cells (each
    cell's deposit rectangle follows its FoV); default: all, in order."""
    C = T["init_cos0"].shape[0]

    def site(jones, scale):
        # jones (B, S, 2, C, 2, 2, 2), scale (2, S, C) -> (C, S, 2, 8 * B + 2)
        j = _j8(jones).permute(3, 1, 2, 0, 4)          # (C, S, 2, B, 8)
        j = j.reshape(*j.shape[:3], -1)
        if j.shape[-1] < 24:
            j = torch.cat([j, j.new_zeros(*j.shape[:3], 24 - j.shape[-1])], -1)
        s = scale.permute(2, 1, 0)[:, :, None, :].expand(C, -1, 2, 2)
        return torch.cat([j, s], -1)

    ic = site(T["ic_jones"][:, None], T["ic_scale"][:, None])
    fc = site(T["fc_jones"], T["fc_scale"])
    oc = site(T["oc_jones"], T["oc_scale"])
    rec = torch.cat([ic, fc, oc], dim=1).reshape(-1, REC_W)
    cid = torch.arange(C) if cell_ids is None else torch.as_tensor(cell_ids)
    mn = (cid.to(G["eyebox_range"].device, torch.int64)
          % G["eyebox_range"].shape[0])
    cell = torch.cat([
        _j8(T["init_jones"][0]), _j8(T["init_jones"][1]),
        T["init_scale"].T, T["init_cos0"][:, None], T["ic_scale"].T,
        T["oc_scale_out"][:, None], G["eyebox_range"][mn]], dim=1)
    dirs = torch.cat([T["gaps"], T["tir_phasor"], T["hop2_phasor"]], dim=-1)
    return {"rec": rec.T.contiguous(), "cell": cell.T.contiguous(),
            "dirs": dirs.reshape(-1, DIR_W).T.contiguous()}


def stack_tables(packed: Sequence[dict]) -> dict:
    """Several designs' :func:`pack_tables` dicts as one: the cell axis
    holds the designs one after another (global cell ``d * C + cid``)."""
    return {k: torch.cat([p[k] for p in packed], dim=1) for k in packed[0]}


# ---------------------------------------------------------------------------
# step arithmetic (shared with engine/splitting.py)


def _take(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Entries ``idx`` of a (width, n) table held component-major:
    (width, *idx.shape), each component contiguous."""
    return table.index_select(1, idx.reshape(-1)).reshape(table.shape[0],
                                                          *idx.shape)


def _hp_inside(hp: torch.Tensor, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """All-of half-plane containment: ``hp`` (D, E, 3) against (D, ...)
    positions, every (position, edge) pair tested as the JAX step tests it,
    ``x * a + y * b - c <= tol``."""
    D = hp.shape[0]
    d = torch.arange(D, device=x.device).repeat_interleave(x.numel() // D)
    return _hp_inside_rows(hp, d, x.reshape(-1), y.reshape(-1)).reshape(
        x.shape)


def _hp_inside_rows(hp, d, xs, ys):
    """Containment of positions ``xs``, ``ys`` (m,) of designs ``d`` (m,)
    in their design's half-planes ``hp[d]``, at most ``_HP_PAIRS``
    (position, edge) pairs per pass."""
    E = hp.shape[1]
    step = max(1, _HP_PAIRS // E)
    out = torch.empty(xs.shape, dtype=torch.bool, device=xs.device)
    for s in range(0, xs.shape[0], step):
        h = hp[d[s:s + step]]
        v = (xs[s:s + step, None] * h[..., 0] + ys[s:s + step, None] * h[..., 1]
             - h[..., 2])
        out[s:s + step] = (v <= _EDGE_TOL).all(dim=-1)
    return out


# ---------------------------------------------------------------------------
# region grids: the containment tests of a bounce, decided by a table lookup
# wherever the answer cannot depend on rounding

_REGIONS = ("r1_hp", "hull_hp", "r2_hp")
GRID_N = 256            # grid cells per side
_GRID_MARGIN = 1e-3     # mm: far above the float32 error of a cell lookup
_GRID_PAD = 2           # cells of the window beyond the whole-system region


def _vertices(hp: torch.Tensor) -> torch.Tensor:
    """(V, 2) vertices of the convex region of half-planes ``hp`` (E, 3),
    in float64: the pairwise line intersections that satisfy every
    half-plane."""
    a, b, c = hp[:, 0], hp[:, 1], hp[:, 2]
    det = a[:, None] * b[None, :] - a[None, :] * b[:, None]
    ok = det.abs() > 1e-12
    det = torch.where(ok, det, 1.0)
    x = (c[:, None] * b[None, :] - c[None, :] * b[:, None]) / det
    y = (a[:, None] * c[None, :] - a[None, :] * c[:, None]) / det
    x, y = x[ok], y[ok]
    feas = ((x[:, None] * a + y[:, None] * b - c) <= 1e-6).all(dim=1)
    return torch.stack([x[feas], y[feas]], dim=1)


def _corner_extremes(val: torch.Tensor) -> tuple:
    """The largest and smallest of each box's four corner values, ``val``
    (..., ny + 1, nx + 1) at the corners of (ny, nx) boxes."""
    return (torch.maximum(torch.maximum(val[..., :-1, :-1], val[..., 1:, :-1]),
                          torch.maximum(val[..., :-1, 1:], val[..., 1:, 1:])),
            torch.minimum(torch.minimum(val[..., :-1, :-1], val[..., 1:, :-1]),
                          torch.minimum(val[..., :-1, 1:], val[..., 1:, 1:])))


def add_region_grids(G: dict, n: int = GRID_N) -> dict:
    """Stacked geometry with a classification grid per design: an n x n
    window over the whole-system region (padded by ``_GRID_PAD`` cells) in
    which every cell holds, for r1, the hull and r2, 1 when every position
    of the cell is inside by the exact float32 test, 0 when every one is
    outside, 2 otherwise (2 bits per region in ``grid_code``, (D, n, n)).

    A cell is decided in float64 from the float32 half-planes: the cell,
    widened by ``_GRID_MARGIN``, lies inside when for every edge its largest
    ``a x + b y - c`` at the corners, plus the float32 rounding bound of the
    test at the window's largest coordinate, is at most the test's
    tolerance; outside when for some edge the smallest, less that bound,
    exceeds it.  A position's cell is ``floor((x - x0) * inv_h)`` in
    float32, which misses its true cell by far less than the margin, so a
    lookup of 0 or 1 is what the exact test gives; positions in cells of 2
    or outside the window take the exact test."""
    D = G["r1_hp"].shape[0]
    dev = G["r1_hp"].device
    codes, x0s, y0s, ixs, iys = [], [], [], [], []
    for d in range(D):
        v = _vertices(G["r1_hp"][d].double())
        lo, hi = v.min(dim=0).values, v.max(dim=0).values
        h = (hi - lo) / (n - 2 * _GRID_PAD)
        x0 = (lo[0] - _GRID_PAD * h[0]).float()
        y0 = (lo[1] - _GRID_PAD * h[1]).float()
        inv = (1.0 / h).float()
        k = torch.arange(n + 1, dtype=torch.float64, device=dev)
        cx = x0.double() + k / inv[0].double()
        cy = y0.double() + k / inv[1].double()
        r = float(torch.cat([cx.abs(), cy.abs()]).max())
        code = torch.zeros((n, n), dtype=torch.int32, device=dev)
        for shift, key in enumerate(_REGIONS):
            hp = G[key][d].double()
            a, b, c = hp[:, 0, None, None], hp[:, 1, None, None], hp[:, 2, None, None]
            val = a * cx[None, None, :] + b * cy[None, :, None] - c  # (E, iy, ix)
            cmax, cmin = _corner_extremes(val)
            slack = (_GRID_MARGIN * (a.abs() + b.abs())
                     + 2.0 ** -20 * (r * a.abs() + r * b.abs() + c.abs()))
            inside = (cmax + slack <= _EDGE_TOL).all(dim=0)
            outside = (cmin - slack > _EDGE_TOL).any(dim=0)
            cls = torch.where(inside, 1, torch.where(outside, 0, 2))
            code |= cls.to(torch.int32) << (2 * shift)
        codes.append(code)
        x0s.append(x0)
        y0s.append(y0)
        ixs.append(inv[0])
        iys.append(inv[1])
    out = dict(G)
    out.update(grid_code=torch.stack(codes).to(torch.uint8),
               grid_x0=torch.stack(x0s), grid_y0=torch.stack(y0s),
               grid_inv_hx=torch.stack(ixs), grid_inv_hy=torch.stack(iys))
    out["geom_rows"] = pack_geometry(out)[0]
    return out


SUBGRID = 8             # subcells per side of a refined grid cell


def region_subgrids(G: dict, design: int = 0, base: int = 0) -> tuple:
    """Design ``design``'s region grid (:func:`add_region_grids`) refined
    where it leaves a region open: ``(fine, codes)``.  ``fine`` (n, n)
    int16 holds a cell's ``grid_code`` where it decides all three regions,
    else ``-(t + 1)``: the cell's :data:`SUBGRID` x :data:`SUBGRID`
    subcells are row ``t - base`` of ``codes`` (M, SUBGRID, SUBGRID)
    uint8, so the rows of several designs can follow one another
    (:func:`region_subgrids_stacked`).  A subcell is
    classified as :func:`add_region_grids` classifies a cell (widened by
    ``_GRID_MARGIN``, with the float32 bound of the test at the window's
    largest coordinate) against the edges its cell leaves undecided; an edge
    the whole cell passes, the subcell passes, and a region the cell
    decides keeps the cell's code.  A position's subcell is
    ``floor((fx - ix) * SUBGRID)`` of its float32 ``fx = (x - x0) * inv_h``
    and ``ix = floor(fx)``, which misses its true subcell by far less than
    the margin, so a subcode of 0 or 1 is what the exact test gives.  Cells
    past row 32,767 (counting the ``base`` rows before) keep their open
    code."""
    d = design
    code = G["grid_code"][d].to(torch.int32).cpu()
    n = code.shape[0]
    cls = [(code >> (2 * k)) & 3 for k in range(len(_REGIONS))]
    iy, ix = torch.nonzero((cls[0] == 2) | (cls[1] == 2) | (cls[2] == 2),
                           as_tuple=True)
    keep = max(0, (1 << 15) - 1 - base)
    iy, ix = iy[:keep], ix[:keep]
    M = iy.numel()
    fine = code.to(torch.int16)
    fine[iy, ix] = -1 - torch.arange(base, base + M, dtype=torch.int16)
    x0, y0 = G["grid_x0"][d].double().cpu(), G["grid_y0"][d].double().cpu()
    invx = G["grid_inv_hx"][d].double().cpu()
    invy = G["grid_inv_hy"][d].double().cpu()
    k = torch.arange(n + 1, dtype=torch.float64)
    r = float(torch.cat([(x0 + k / invx).abs(), (y0 + k / invy).abs()]).max())
    sub = SUBGRID
    u = torch.arange(sub + 1, dtype=torch.float64) / sub
    codes = torch.zeros((M, sub, sub), dtype=torch.int32)
    for shift, key in enumerate(_REGIONS):
        cell = cls[shift][iy, ix]
        codes |= (cell << (2 * shift))[:, None, None]
        t = torch.nonzero(cell == 2).squeeze(1)       # cells open here
        hp = G[key][d].double().cpu()
        a, b, c = hp[:, 0], hp[:, 1], hp[:, 2]
        slack = (_GRID_MARGIN * (a.abs() + b.abs())
                 + 2.0 ** -20 * (r * a.abs() + r * b.abs() + c.abs()))
        # the edges each open cell leaves undecided, (edge, cell) pairs
        cx = x0 + (ix[t].double()[:, None] + u[[0, -1]]) / invx    # (m, 2)
        cy = y0 + (iy[t].double()[:, None] + u[[0, -1]]) / invy
        val = (a[:, None, None, None] * cx[None, :, None, :]
               + b[:, None, None, None] * cy[None, :, :, None]
               - c[:, None, None, None])                        # (E, m, 2, 2)
        cmax = _corner_extremes(val)[0][..., 0, 0]
        e, j = torch.nonzero(cmax + slack[:, None] > _EDGE_TOL, as_tuple=True)
        cx = x0 + (ix[t[j]].double()[:, None] + u) / invx          # (p, sub+1)
        cy = y0 + (iy[t[j]].double()[:, None] + u) / invy
        val = (a[e, None, None] * cx[:, None, :] + b[e, None, None]
               * cy[:, :, None] - c[e, None, None])         # (p, sub+1, sub+1)
        smax, smin = _corner_extremes(val)
        fail = torch.zeros((t.numel(), sub, sub), dtype=torch.int32)
        fail.index_add_(0, j, (smax + slack[e, None, None] > _EDGE_TOL).int())
        out = torch.zeros((t.numel(), sub, sub), dtype=torch.int32)
        out.index_add_(0, j, (smin - slack[e, None, None] > _EDGE_TOL).int())
        sc = torch.where(fail == 0, 1, torch.where(out > 0, 0, 2)).int()
        codes[t] = (codes[t] & ~(3 << (2 * shift))) | (sc << (2 * shift))
    return fine, codes.to(torch.uint8)


def region_subgrids_stacked(G: dict) -> tuple:
    """Every design's refined region grid (:func:`region_subgrids`), as
    the vector kernel reads them: ``fine`` (D, n, n) int16 and the subcell
    rows of all designs in one (M, SUBGRID, SUBGRID) uint8 ``codes``,
    design d's rows after those of the designs before it (design 0's
    ``fine`` and rows are :func:`region_subgrids`' own), on ``G``'s
    device."""
    fines, codes, base = [], [], 0
    for d in range(G["grid_code"].shape[0]):
        f, c = region_subgrids(G, d, base)
        fines.append(f)
        codes.append(c)
        base += c.shape[0]
    dev = G["grid_code"].device
    return torch.stack(fines).to(dev), torch.cat(codes).to(dev)


# the geometry scalars the kernels read, in their order (csrc/step_common.cuh
# G_*), then the half-plane packs of GEOM_HP, (E, 3) each
GEOM_SCALARS = ("icx", "icy", "icr", "fcr0", "fcr1", "fc_top", "fc_width",
                "ocr0", "ocr1", "oc_top", "oc_width", "b0", "b1", "b2", "b3",
                "grid_x0", "grid_y0", "grid_inv_hx", "grid_inv_hy")
GEOM_HP = ("ic_hp", "r1_hp", "r2_hp", "hull_hp")
_G_GRID = GEOM_SCALARS[-4:]    # the region grid's window, from G itself


def pack_geometry(G: dict) -> tuple:
    """Stacked geometry with its region grids (:func:`add_region_grids`)
    as the kernels read it: ``(rows (D, len(GEOM_SCALARS) + 3 * sum(edges))
    in G's float type, grid codes (D, n, n) uint8, edges)``, each row
    :data:`GEOM_SCALARS`, then the packs of :data:`GEOM_HP` (padded to the
    designs' largest edge counts by :func:`stack_geoms`)."""
    D = G["fc_top"].shape[0]
    fdt = G["fc_top"].dtype
    S = _col(G, D, 1)
    scal = [S[k] for k in GEOM_SCALARS[:11]] + list(S["b"])
    scal += [G[k] for k in _G_GRID]
    rows = torch.cat([v.reshape(D, 1).to(fdt) for v in scal]
                     + [G[k].reshape(D, -1).to(fdt) for k in GEOM_HP], dim=1)
    edges = tuple(int(G[k].shape[1]) for k in GEOM_HP)
    return rows.contiguous(), G["grid_code"].contiguous(), edges


def unpack_geometry(rows: torch.Tensor, grid: torch.Tensor,
                    edges: tuple) -> dict:
    """The stacked geometry dict of :func:`pack_geometry`'s output, as
    :func:`regions_inside`, :func:`in_ic` and :func:`_col` read it."""
    D = rows.shape[0]
    v = dict(zip(GEOM_SCALARS, rows[:, :len(GEOM_SCALARS)].T))
    G = {"ic_center": torch.stack([v["icx"], v["icy"]], 1),
         "ic_radius": v["icr"], "fc_rot": torch.stack([v["fcr0"],
                                                       v["fcr1"]], 1),
         "fc_top": v["fc_top"], "fc_width": v["fc_width"],
         "oc_rot_y": torch.stack([v["ocr0"], v["ocr1"]], 1),
         "oc_bounds": torch.stack([v[f"b{i}"] for i in range(4)], 1),
         "oc_top": v["oc_top"], "oc_width": v["oc_width"],
         "grid_code": grid}
    G.update((k, v[k]) for k in _G_GRID)
    at = len(GEOM_SCALARS)
    for k, e in zip(GEOM_HP, edges):
        G[k] = rows[:, at:at + 3 * e].reshape(D, e, 3)
        at += 3 * e
    return G


def regions_inside(G: dict, x: torch.Tensor, y: torch.Tensor,
                   need: torch.Tensor, stats: Optional[dict] = None):
    """(in r1, in the hull, in r2) of (D, ...) positions, each what
    :func:`_hp_inside` gives wherever ``need`` is set (elsewhere
    unspecified): a grid lookup (:func:`add_region_grids`), then the exact
    test for the positions the lookup leaves open, gathered in one read
    from the device."""
    D, n = G["grid_code"].shape[:2]
    shape = (D,) + (1,) * (x.dim() - 1)
    ix = torch.floor((x - G["grid_x0"].reshape(shape))
                     * G["grid_inv_hx"].reshape(shape))
    iy = torch.floor((y - G["grid_y0"].reshape(shape))
                     * G["grid_inv_hy"].reshape(shape))
    inwin = (ix >= 0) & (ix < n) & (iy >= 0) & (iy < n)
    base = (torch.arange(D, device=x.device) * (n * n)).reshape(shape)
    flat = (base + torch.clamp(iy, 0, n - 1).to(torch.int64) * n
            + torch.clamp(ix, 0, n - 1).to(torch.int64))
    code = torch.where(inwin, G["grid_code"].view(-1)[flat].to(torch.int32),
                       0b101010)
    cls = [(code >> (2 * k)) & 3 for k in range(len(_REGIONS))]
    open_ = need & ((cls[0] == 2) | (cls[1] == 2) | (cls[2] == 2))
    idx = torch.nonzero(open_.reshape(-1)).squeeze(1)
    if stats is not None:
        stats["syncs"] = stats.get("syncs", 0) + 1
    inside = [c == 1 for c in cls]
    if idx.numel():
        d = idx // (x.numel() // D)
        xs, ys = x.reshape(-1)[idx], y.reshape(-1)[idx]
        for k, key in enumerate(_REGIONS):
            inside[k].reshape(-1)[idx] = _hp_inside_rows(G[key], d, xs, ys)
    return tuple(inside)


def _jones_apply(j: torch.Tensor, ter, tei, tmr, tmi):
    """Split-real complex 2x2 matvec; ``j`` (8, ...) in :func:`_j8`'s
    order."""
    ar, ai, br, bi, cr, ci, dr, di = j.unbind(0)
    return (ar * ter - ai * tei + br * tmr - bi * tmi,
            ar * tei + ai * ter + br * tmi + bi * tmr,
            cr * ter - ci * tei + dr * tmr - di * tmi,
            cr * tei + ci * ter + dr * tmi + di * tmr)


def _phase_mul(pr, pi, re, im):
    """Multiply (re, im) by the unit phasor (pr, pi)."""
    return pr * re - pi * im, pr * im + pi * re


def _power(ter, tei, tmr, tmi):
    return ter * ter + tei * tei + tmr * tmr + tmi * tmi


def _rsqrt(v: torch.Tensor) -> torch.Tensor:
    """``1 / sqrt(v)``: in float32 the root is taken in float64 and rounded
    (the correctly rounded float32 root, which torch's float32 CPU ``sqrt``
    is not: F4 in ROADMAP.md), then its reciprocal."""
    if v.dtype == torch.float64:
        return 1.0 / torch.sqrt(v)
    return 1.0 / torch.sqrt(v.double()).to(v.dtype)


def _bin(v: torch.Tensor, hi: int) -> torch.Tensor:
    """floor, clamped to [0, hi], as an int64 index."""
    return torch.clamp(torch.floor(v), 0, hi).to(torch.int64)


def _col(G: dict, D: int, ndim: int) -> dict:
    """The per-design scalars of stacked geometry, shaped to broadcast
    against (D, ...) tensors of ``ndim`` dimensions."""
    shape = (D,) + (1,) * (ndim - 1)
    return {
        "icx": G["ic_center"][:, 0].reshape(shape),
        "icy": G["ic_center"][:, 1].reshape(shape),
        "icr": G["ic_radius"].reshape(shape),
        "fcr0": G["fc_rot"][:, 0].reshape(shape),
        "fcr1": G["fc_rot"][:, 1].reshape(shape),
        "fc_top": G["fc_top"].reshape(shape),
        "fc_width": G["fc_width"].reshape(shape),
        "ocr0": G["oc_rot_y"][:, 0].reshape(shape),
        "ocr1": G["oc_rot_y"][:, 1].reshape(shape),
        "oc_top": G["oc_top"].reshape(shape),
        "oc_width": G["oc_width"].reshape(shape),
        "b": [G["oc_bounds"][:, i].reshape(shape) for i in range(4)],
    }


def in_ic(G: dict, S: dict, x, y, circle: bool):
    """In-coupler containment: circle test, or the polygon's half-planes."""
    if circle:
        dx = x - S["icx"]
        dy = y - S["icy"]
        return dx * dx + dy * dy <= S["icr"] * S["icr"]
    return _hp_inside(G["ic_hp"], x, y)


def site_key(S: dict, x, y, state, alive, in_hull, num_fc: int,
             num_oc: int):
    """The site and membership tests of a bounce: (grp_ic, grp_fc, grp_oc,
    in_rect, record key ``site * 2 + bit``)."""
    grp_ic = alive & (state <= 1)
    grp_fc = alive & ((state == 2) | (state == 3))
    grp_oc = alive & (state >= 4)
    bit = (state & 1).to(torch.int64)
    yrot = S["fcr0"] * x + S["fcr1"] * y
    fc_strip = _bin((S["fc_top"] - yrot) / S["fc_width"], num_fc - 1)
    yr = S["ocr0"] * x + S["ocr1"] * y
    b = S["b"]
    in_rect = ((x >= b[0] - _EDGE_TOL) & (x <= b[1] + _EDGE_TOL)
               & (y >= b[2] - _EDGE_TOL) & (y <= b[3] + _EDGE_TOL))
    oc_strip = _bin((S["oc_top"] - yr) / S["oc_width"], num_oc - 1)
    site = torch.where(grp_oc, 1 + num_fc + oc_strip,
                       torch.where(grp_fc, 1 + fc_strip, 0))
    return grp_ic, grp_fc, grp_oc, in_rect, site * 2 + bit


def deposit_bin(ebr: torch.Tensor, x, y, ny: int, nx: int):
    """(in the deposit rectangle, bin ``iy * nx + ix``) of positions in
    per-ray rectangles ``ebr`` (4, ...)."""
    e0, e1, e2, e3 = ebr.unbind(0)
    in_quad = ((x >= e0 - _EDGE_TOL) & (x <= e1 + _EDGE_TOL)
               & (y >= e2 - _EDGE_TOL) & (y <= e3 + _EDGE_TOL))
    # divided by tensors: torch on the card multiplies by the reciprocal of
    # a Python scalar divisor, which can move a position on a bin edge
    dxb = (e1 - e0) / torch.full_like(e1, nx)
    dyb = (e3 - e2) / torch.full_like(e3, ny)
    ix = _bin((x - e0) / dxb, nx - 1)
    iy = _bin((y - e2) / dyb, ny - 1)
    return in_quad, iy * nx + ix


# ---------------------------------------------------------------------------
# the ray state


def make_ray_state(x, y, te, tm, cid, ray_idx, rng_state,
                   precision: str = "f32", device="cuda") -> dict:
    """Initial state of a batch from host arrays: (R,) tensors on
    ``device``; te / tm are the complex polarisation amplitudes, held as
    split (re, im) fields.  ``precision="f64"`` holds the fields in float64
    (oracle parity); the trace is float32."""
    device = resolve_device(device)
    fdt = torch.float64 if precision == "f64" else torch.float32
    te = np.asarray(te, np.complex128)
    tm = np.asarray(tm, np.complex128)
    r = len(x)

    def f(v):
        return torch.from_numpy(np.asarray(v, np.float64)).to(device, fdt)

    def i64(v):
        return torch.from_numpy(np.asarray(v).astype(np.int64)).to(device)

    return {
        "x": f(x), "y": f(y), "ter": f(te.real), "tei": f(te.imag),
        "tmr": f(tm.real), "tmi": f(tm.imag),
        "cos_th": torch.ones(r, dtype=fdt, device=device),
        "gap_x": torch.zeros(r, dtype=fdt, device=device),
        "gap_y": torch.zeros(r, dtype=fdt, device=device),
        "state": torch.zeros(r, dtype=torch.int32, device=device),
        "rng": i64(rng_state), "dep": torch.full((r,), -1, dtype=torch.int32,
                                                 device=device),
        "cid": i64(cid), "idx": i64(ray_idx),
    }


def stack_ray_states(states: Sequence[dict]) -> dict:
    """(R,) ray states of D designs -> one (D, R) state."""
    return {k: torch.stack([s[k] for s in states]) for k in states[0]}


# ---------------------------------------------------------------------------
# the trace: the plain version's steps


def _init_step(r: dict, T: dict, S: dict, g: torch.Tensor, G: dict,
               circle: bool) -> dict:
    """First IC interaction from air (reference kernel :860-904)."""
    pol = (r["ter"], r["tei"], r["tmr"], r["tmi"])
    cell = _take(T["cell"], g)
    pol_a = _jones_apply(cell[_I_JA:_I_JA + 8], *pol)
    pol_b = _jones_apply(cell[_I_JB:_I_JB + 8], *pol)
    cos0 = cell[_I_COS0]
    eff_a = _power(*pol_a) * cell[_I_SA] / cos0
    eff_b = _power(*pol_b) * cell[_I_SB] / cos0
    u, rng = draw_uniform(r["rng"], r["idx"],
                          torch.ones_like(r["state"], dtype=torch.bool))
    a = u <= eff_a
    b = (~a) & (u <= eff_a + eff_b)
    ter_n, tei_n, tmr_n, tmi_n = (torch.where(a, pa, pb)
                                  for pa, pb in zip(pol_a, pol_b))
    inv = _rsqrt(torch.clamp(_power(ter_n, tei_n, tmr_n, tmi_n),
                             min=1e-30))
    dirs = torch.where(a, DIR_IC, DIR_IC2)
    d = _take(T["dirs"], g * 4 + dirs)
    ter_n, tei_n = ter_n * inv, tei_n * inv
    tmr_n, tmi_n = _phase_mul(d[2], d[3], tmr_n * inv, tmi_n * inv)
    gx, gy = d[0], d[1]
    x = r["x"] + gx
    y = r["y"] + gy
    ic_in = in_ic(G, S, x, y, circle)
    state = torch.where(
        a, torch.where(ic_in, 0, 2),
        torch.where(b, torch.where(ic_in, 1, DEAD), DEAD)).to(torch.int32)
    cos_th = torch.where(a, cell[_I_ICA], cell[_I_ICB])
    live = state < DEAD
    out = dict(r)
    out.update(
        x=torch.where(live, x, r["x"]), y=torch.where(live, y, r["y"]),
        ter=torch.where(live, ter_n, r["ter"]),
        tei=torch.where(live, tei_n, r["tei"]),
        tmr=torch.where(live, tmr_n, r["tmr"]),
        tmi=torch.where(live, tmi_n, r["tmi"]),
        cos_th=torch.where(live, cos_th, r["cos_th"]),
        gap_x=torch.where(live, gx, 0.0), gap_y=torch.where(live, gy, 0.0),
        state=state, rng=rng)
    return out


def _bounce_step(r: dict, T: dict, S: dict, g: torch.Tensor, G: dict,
                 stats: dict, num_fc: int, num_oc: int, circle: bool) -> dict:
    """One bounce of the whole batch (reference kernel :906-1247)."""
    x, y, state = r["x"], r["y"], r["state"]
    alive = state < DEAD
    in_r1, in_hull, in_r2 = regions_inside(G, x, y, alive, stats)
    # global containment
    state = torch.where(alive & ~in_r1, DEAD, state)
    alive = state < DEAD
    grp_ic, grp_fc, grp_oc, in_rect, key = site_key(
        S, x, y, state, alive, in_hull, num_fc, num_oc)
    hit_fc = grp_fc & in_hull
    hit_oc = grp_oc & in_rect
    interact = grp_ic | hit_fc | hit_oc

    rec = _take(T["rec"], g * (2 * (1 + num_fc + num_oc)) + key)
    pol = (r["ter"], r["tei"], r["tmr"], r["tmi"])
    s_a, s_b = rec[24], rec[25]
    pol_a = _jones_apply(rec[0:8], *pol)
    pol_b = _jones_apply(rec[8:16], *pol)
    pol_c = _jones_apply(rec[16:24], *pol)
    s_c = _take(T["cell"][_C_SOUT:_C_SOUT + 1], g)[0]
    inv_cos = 1.0 / r["cos_th"]
    eff_a = _power(*pol_a) * s_a * inv_cos
    eff_b = _power(*pol_b) * s_b * inv_cos
    eff_c = _power(*pol_c) * s_c * inv_cos

    u, rng = draw_uniform(r["rng"], r["idx"], interact)
    br_a = interact & (u <= eff_a) & (eff_a > 0)
    br_b = interact & ~br_a & (u <= eff_a + eff_b) & (eff_b > 0)
    br_c = (hit_oc & ~br_a & ~br_b & (u <= eff_a + eff_b + eff_c)
            & (eff_c > 0))
    die_roulette = interact & ~(br_a | br_b | br_c)

    # accepted A / B: renormalise, TIR phasor, hop
    accept = br_a | br_b
    dir_a = torch.where(grp_oc, DIR_FC, DIR_IC)
    dir_b = torch.where(grp_ic, DIR_IC2,
                        torch.where(grp_fc, DIR_FC, DIR_OC))
    dirs = torch.where(br_a, dir_a, dir_b)
    ter_n, tei_n, tmr_n, tmi_n = (torch.where(br_a, pa, pb)
                                  for pa, pb in zip(pol_a, pol_b))
    inv = _rsqrt(torch.clamp(_power(ter_n, tei_n, tmr_n, tmi_n),
                             min=1e-30))
    d = _take(T["dirs"], g * 4 + dirs)
    ter_n, tei_n = ter_n * inv, tei_n * inv
    tmr_n, tmi_n = _phase_mul(d[2], d[3], tmr_n * inv, tmi_n * inv)
    cos_n = torch.where(br_a, s_a, s_b)
    gx_n, gy_n = d[0], d[1]

    st_a = torch.where(grp_oc, 4, torch.where(grp_fc, 2, -1))
    st_b = torch.where(grp_oc, 5, torch.where(grp_fc, 3, -1))
    x_acc = x + gx_n
    y_acc = y + gy_n
    ic_in = in_ic(G, S, x_acc, y_acc, circle)
    st_a = torch.where(grp_ic, torch.where(ic_in, 0, 2), st_a)
    st_b = torch.where(grp_ic, torch.where(ic_in, 1, DEAD), st_b)
    st_acc = torch.where(br_a, st_a, st_b)

    # out-couple (C): the bin is taken from this position at the end
    dep = torch.where(br_c, _OUT, r["dep"])

    # misses: TIR hop with the doubled phasor, or a phase transition
    miss_fc2 = grp_fc & ~in_hull & (state == 2)
    miss_fc3 = grp_fc & ~in_hull & (state == 3)
    fc3_to_oc = miss_fc3 & ~in_r2
    miss_hop_fc3 = miss_fc3 & in_r2
    miss_oc4 = grp_oc & ~in_rect & (state == 4)
    miss_oc5 = grp_oc & ~in_rect & (state == 5)
    hop = miss_fc2 | miss_hop_fc3 | miss_oc4
    hop_dir = torch.where(miss_fc2, DIR_IC, DIR_FC)
    hd = _take(T["dirs"], g * 4 + hop_dir)

    new_state = torch.where(
        accept, st_acc,
        torch.where(br_c | die_roulette | miss_oc5, DEAD,
                    torch.where(fc3_to_oc, 4, state))).to(torch.int32)
    hop_tmr, hop_tmi = _phase_mul(hd[4], hd[5], r["tmr"], r["tmi"])
    out = dict(r)
    out.update(
        x=torch.where(accept, x_acc, torch.where(hop, x + r["gap_x"], x)),
        y=torch.where(accept, y_acc, torch.where(hop, y + r["gap_y"], y)),
        ter=torch.where(accept, ter_n, r["ter"]),
        tei=torch.where(accept, tei_n, r["tei"]),
        tmr=torch.where(accept, tmr_n,
                        torch.where(hop, hop_tmr, r["tmr"])),
        tmi=torch.where(accept, tmi_n,
                        torch.where(hop, hop_tmi, r["tmi"])),
        cos_th=torch.where(accept, cos_n, r["cos_th"]),
        gap_x=torch.where(accept, gx_n, r["gap_x"]),
        gap_y=torch.where(accept, gy_n, r["gap_y"]),
        state=new_state, rng=rng, dep=dep)
    return out


# ---------------------------------------------------------------------------
# the trace call: its arguments, the plain version and the kernel

# the ray state's fields in the kernel's order (csrc/vector_trace.cu): the
# float fields, then state, rng and dep (read and written), then cid and
# idx (read only)
RAY_FLOATS = ("x", "y", "ter", "tei", "tmr", "tmi", "cos_th", "gap_x",
              "gap_y")
RAY_KEYS = RAY_FLOATS + ("state", "rng", "dep", "cid", "idx")
_RAY_INTS = {"state": torch.int32, "rng": torch.int64, "dep": torch.int32,
             "cid": torch.int64, "idx": torch.int64}
_RAY_OUT = RAY_KEYS[:-2]
# the C parameters of vector_trace_launch, in order: 6 table pointers, the
# input and output pointer arrays, bounces and steps, 17 ints, the stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 17
                   + [ctypes.c_void_p])


@dataclasses.dataclass
class VectorTraceArgs:
    """One trace call as the kernel takes it: the designs' packed tables
    (:func:`stack_tables` of :func:`pack_tables`), their geometry rows and
    region grids (:func:`pack_geometry`), the grids refined where they are
    open (:func:`region_subgrids_stacked`: the kernel reads these, the
    plain version the grids; None where only the plain version runs), the
    (D, R) ray state and the call's knobs.  ``mode="resume"`` skips the
    first in-coupler interaction; ``max_bounces`` bounds the call's
    steps."""
    rec: torch.Tensor          # (26, D * C * R2)
    cell: torch.Tensor         # (26, D * C)
    dirs: torch.Tensor         # (6, D * C * 4)
    geom: torch.Tensor         # (D, len(GEOM_SCALARS) + 3 * sum(edges))
    grid: torch.Tensor         # (D, n, n) uint8 region codes
    fine: Optional[torch.Tensor]       # (D, n, n) int16 refined codes
    sub_codes: Optional[torch.Tensor]  # (M, SUBGRID, SUBGRID) uint8
    rays: dict                 # RAY_KEYS -> (D, R)
    edges: tuple               # half-planes of each pack of GEOM_HP
    mode: str
    max_bounces: int
    num_fc: int
    num_oc: int
    eyebox_bins: tuple
    circle: bool

    def to(self, device) -> "VectorTraceArgs":
        """The same call with its tensors on ``device``."""
        out = dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})
        out.rays = {k: v.to(device) for k, v in self.rays.items()}
        return out


@dataclasses.dataclass
class VectorTraceOut:
    """The final (D, R) ray state (``dep`` holds each out-coupled ray's bin,
    or -1 outside its deposit rectangle), the (D,) int64 count of live rays
    summed over the steps, and the call's steps (an int32 scalar tensor:
    the most steps any ray began alive)."""
    rays: dict
    bounces: torch.Tensor
    steps: torch.Tensor


def vector_trace_args(rays: dict, T: dict, G: dict, *, mode: str,
                      max_bounces: int, num_fc: int, num_oc: int,
                      eyebox_bins, circle: bool) -> VectorTraceArgs:
    """A trace call's :class:`VectorTraceArgs` from (D, R) rays, packed
    tables ``T`` and geometry ``G`` with its region grids
    (:func:`add_region_grids`, which packs the geometry rows) and, for the
    kernel, their refinement (``G["fine"]``, ``G["sub_codes"]``:
    :func:`region_subgrids_stacked`)."""
    if mode not in ("full", "resume"):
        raise ValueError(f"mode must be 'full' or 'resume', got {mode!r}")
    return VectorTraceArgs(
        rec=T["rec"], cell=T["cell"], dirs=T["dirs"], geom=G["geom_rows"],
        grid=G["grid_code"], fine=G.get("fine"),
        sub_codes=G.get("sub_codes"), rays=dict(rays),
        edges=tuple(int(G[k].shape[1]) for k in GEOM_HP), mode=mode,
        max_bounces=int(max_bounces), num_fc=int(num_fc),
        num_oc=int(num_oc), eyebox_bins=tuple(eyebox_bins),
        circle=bool(circle))


def vector_trace_reference(a: VectorTraceArgs,
                           stats: Optional[dict] = None) -> VectorTraceOut:
    """The plain PyTorch version of the kernel: the eager step loop on
    ``a``'s device.  Each step reads from the device whether any ray is
    alive and the positions the region grids leave open
    (``stats["syncs"]`` counts both reads)."""
    stats = stats if stats is not None else {}
    r = dict(a.rays)
    D = r["x"].shape[0]
    ny, nx = a.eyebox_bins
    G = unpack_geometry(a.geom, a.grid, a.edges)
    T = {"rec": a.rec, "cell": a.cell, "dirs": a.dirs}
    C = T["cell"].shape[1] // D
    g = r["cid"] + C * torch.arange(D, device=r["cid"].device)[:, None]
    S = _col(G, D, 2)
    if a.mode == "full":
        r = _init_step(r, T, S, g, G, a.circle)
    bounces = torch.zeros(D, dtype=torch.int64, device=g.device)
    it = 0
    while it < a.max_bounces:
        n_alive = (r["state"] < DEAD).sum(dim=1)
        stats["syncs"] = stats.get("syncs", 0) + 1
        if not bool(n_alive.any()):
            break
        bounces += n_alive
        r = _bounce_step(r, T, S, g, G, stats, a.num_fc, a.num_oc, a.circle)
        it += 1
    out = r["dep"] == _OUT
    ebr = _take(T["cell"][_C_EBR:_C_EBR + 4], g)
    in_quad, b = deposit_bin(ebr, r["x"], r["y"], ny, nx)
    r["dep"] = torch.where(out, torch.where(in_quad, b, -1),
                           r["dep"]).to(torch.int32)
    return VectorTraceOut(rays=r, bounces=bounces,
                          steps=torch.tensor(it, dtype=torch.int32,
                                             device=g.device))


def launch_vector_trace(a: VectorTraceArgs) -> VectorTraceOut:
    """The kernel on ``a``'s CUDA tensors: one launch, queued on the
    current stream (no host read).  Every output field is a new tensor
    (the inputs are not written; ``cid`` and ``idx`` are passed through).
    Raises if a tensor is not what the kernel takes or the launch is
    refused."""
    dev = a.rec.device
    if dev.type != "cuda":
        raise ValueError(f"the vector_trace kernel runs on cuda, not {dev}")
    for name in ("rec", "cell", "dirs", "geom"):
        t = getattr(a, name)
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if a.fine is None or a.sub_codes is None:
        raise ValueError("the kernel reads the refined region grids: give "
                         "G region_subgrids_stacked's fine and sub_codes")
    if (a.fine.device != dev or a.fine.dtype != torch.int16
            or a.fine.dim() != 3 or a.fine.shape[1] != a.fine.shape[2]):
        raise ValueError("the refined grids must be (D, n, n) int16 on the "
                         "card")
    if (a.sub_codes.device != dev or a.sub_codes.dtype != torch.uint8
            or a.sub_codes.dim() != 3
            or a.sub_codes.shape[1] != a.sub_codes.shape[2]):
        raise ValueError("the subcell codes must be (M, s, s) uint8 on the "
                         "card")
    rays = {k: a.rays[k].contiguous() for k in RAY_KEYS}
    D, R = rays["x"].shape
    for k, v in rays.items():
        want = _RAY_INTS.get(k, torch.float32)
        if v.device != dev or v.dtype != want or v.shape != (D, R):
            raise ValueError(f"ray field {k} must be {want} ({D}, {R}) on "
                             f"{dev}, got {v.dtype} {tuple(v.shape)} on "
                             f"{v.device}")
    if a.geom.shape[0] != D or a.fine.shape[0] != D:
        raise ValueError(f"{D} design rows against {a.geom.shape[0]} "
                         f"geometry rows and {a.fine.shape[0]} grids")
    C = a.cell.shape[1] // D
    R2 = 2 * (1 + a.num_fc + a.num_oc)
    if (a.cell.shape[1] != D * C or a.rec.shape[1] != D * C * R2
            or a.dirs.shape[1] != D * C * 4):
        raise ValueError("the tables do not hold D x C cells")
    out = {k: torch.empty_like(rays[k]) for k in _RAY_OUT}
    bounces = torch.zeros(D, dtype=torch.int64, device=dev)
    steps = torch.zeros((), dtype=torch.int32, device=dev)
    if D * R:
        lib = load_kernel()
        fine, sub_codes = a.fine.contiguous(), a.sub_codes.contiguous()
        ins = (ctypes.c_void_p * len(RAY_KEYS))(
            *[rays[k].data_ptr() for k in RAY_KEYS])
        outs = (ctypes.c_void_p * len(_RAY_OUT))(
            *[out[k].data_ptr() for k in _RAY_OUT])
        ny, nx = a.eyebox_bins
        with torch.cuda.device(dev):
            stream = torch.cuda.current_stream(dev).cuda_stream
            err = lib.vector_trace_launch(
                a.rec.data_ptr(), a.cell.data_ptr(), a.dirs.data_ptr(),
                a.geom.data_ptr(), fine.data_ptr(), sub_codes.data_ptr(),
                ins, outs, bounces.data_ptr(), steps.data_ptr(), D, R, C,
                R2, a.num_fc, a.num_oc, ny, nx, a.max_bounces,
                int(a.mode == "full"), int(a.circle), fine.shape[1],
                sub_codes.shape[1], *a.edges, stream)
        if err != 0:
            msg = lib.vector_trace_error_string(err).decode()
            raise RuntimeError(f"vector_trace launch failed: {msg} ({err})")
        launch_counts["vector_trace"] += 1
    out.update(cid=rays["cid"], idx=rays["idx"])
    final = dict(a.rays)
    final.update(out)
    return VectorTraceOut(rays=final, bounces=bounces, steps=steps)


def vector_trace(a: VectorTraceArgs,
                 stats: Optional[dict] = None) -> VectorTraceOut:
    """One trace call: the kernel for CUDA tensors, the plain version for
    CPU ones (no fallback between them)."""
    dev = a.rec.device
    if dev.type == "cuda":
        return launch_vector_trace(a)
    if dev.type != "cpu":
        raise ValueError(f"vector_trace runs on cpu or cuda, not {dev}")
    return vector_trace_reference(a, stats)


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/vector_trace.cu``; raises with
    the compiler's output if the build fails."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("vector_trace")
        lib.vector_trace_launch.argtypes = LAUNCH_ARGTYPES
        lib.vector_trace_launch.restype = ctypes.c_int
        lib.vector_trace_error_string.argtypes = [ctypes.c_int]
        lib.vector_trace_error_string.restype = ctypes.c_char_p
        lib.vector_trace_occupancy.argtypes = [ctypes.c_void_p]
        lib.vector_trace_occupancy.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def kernel_occupancy() -> dict:
    """What the card makes of the kernel: resident blocks per SM
    (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``), registers and
    local bytes a thread, threads a block and the most rays a block's
    range holds (the launch sizes the range).  Needs the card."""
    lib = load_kernel()
    out = (ctypes.c_int * 5)()
    err = lib.vector_trace_occupancy(ctypes.addressof(out))
    if err != 0:
        msg = lib.vector_trace_error_string(err).decode()
        raise RuntimeError(f"vector_trace_occupancy failed: {msg} ({err})")
    keys = ("blocks_per_sm", "registers", "local_bytes", "threads",
            "max_rays_per_block")
    return dict(zip(keys, list(out)))


def make_trace_fn_dynamic(cfg: TraceConfig, num_fc: int, num_oc: int,
                          mode: str = "full"):
    """Build ``trace(rays, T, G, max_bounces=None, timer=None, stats=None)
    -> (rays_final, bounces)`` with the tables and geometry as arguments:
    ``T`` from :func:`stack_tables` of :func:`pack_tables` dicts, ``G``
    from :func:`add_region_grids` of :func:`stack_geoms`, ``rays`` (D, R) from
    :func:`stack_ray_states` (or (R,) for D = 1, returned as (R,)).
    ``bounces`` is the (D,) int64 count of live rays summed over the steps,
    per design.

    ``mode="resume"`` skips the first in-coupler interaction and continues
    the state: the building block of segment-and-compact scheduling.
    ``max_bounces`` (default ``cfg.max_bounces``) bounds the steps of this
    call; the loop also ends when no ray is alive.  A call is one
    :func:`vector_trace`: on a GPU one kernel launch, on the CPU the plain
    version, which reads the device twice a step (``stats["syncs"]``
    counts those reads).  ``stats["steps"]`` adds the call's steps, which
    on a GPU is one read from the device (counted in ``stats["syncs"]``),
    made only when ``stats`` is given.  ``timer`` collects the device time
    of the call in the span ``bounce``."""
    if mode not in ("full", "resume"):
        raise ValueError(f"mode must be 'full' or 'resume', got {mode!r}")
    circle = cfg.ic_test == "circle"

    def trace(rays: dict, T: dict, G: dict, max_bounces: Optional[int] = None,
              timer: Optional[EventTimer] = None,
              stats: Optional[dict] = None):
        flat = rays["x"].dim() == 1
        r = {k: v[None] for k, v in rays.items()} if flat else dict(rays)
        D = r["x"].shape[0]
        if G["fc_top"].shape[0] != D:
            raise ValueError(f"{D} design rows against "
                             f"{G['fc_top'].shape[0]} geometries")
        timer = timer if timer is not None else EventTimer("cpu")
        budget = cfg.max_bounces if max_bounces is None else int(max_bounces)
        a = vector_trace_args(r, T, G, mode=mode, max_bounces=budget,
                              num_fc=num_fc, num_oc=num_oc,
                              eyebox_bins=cfg.eyebox_bins, circle=circle)
        with timer.span("bounce"):
            res = vector_trace(a, stats)
        if stats is not None:
            if res.steps.is_cuda:
                stats["syncs"] = stats.get("syncs", 0) + 1
            stats["steps"] = stats.get("steps", 0) + int(res.steps)
        if flat:
            return {k: v[0] for k, v in res.rays.items()}, res.bounces
        return res.rays, res.bounces

    return trace


def make_trace_fn(tables: CellTables, tgeom: TraceGeometry, cfg: TraceConfig,
                  precision: str = "f32", device="cuda"):
    """Build ``trace(rays) -> (rays_final, bounces)`` with the tables of one
    design bound on ``device``; ``precision="f64"`` traces in float64
    (oracle parity) with the plain version, on the CPU only: on a GPU every
    trace is the float32 kernel, so a float64 request there raises."""
    if torch.device(device).type == "cuda" and precision != "f32":
        raise ValueError(f"precision={precision!r} traces on the CPU only: "
                         "the vector_trace kernel is float32")
    device = resolve_device(device)
    fdt = torch.float64 if precision == "f64" else torch.float32
    if device.type == "cuda":
        load_kernel()
    G = geom_tensors(tgeom, fdt)
    T = {k: v.to(device) for k, v in pack_tables(as_tables(tables, fdt),
                                                   G).items()}
    G = add_region_grids(stack_geoms([G]))
    G["fine"], G["sub_codes"] = region_subgrids_stacked(G)
    G = {k: v.to(device) for k, v in G.items()}
    core = make_trace_fn_dynamic(cfg, tgeom.num_fc, tgeom.num_oc)

    def trace(rays, **kw):
        rays_f, bounces = core(rays, T, G, **kw)
        return rays_f, bounces.sum()

    return trace


class VectorTracer(nn.Module):
    """The vector trace bound to D designs: their tables and geometry held
    as buffers on the module's device.  ``forward(rays, mode=, ...)`` runs
    :func:`make_trace_fn_dynamic`'s trace in full or resume mode: one
    kernel launch on a GPU, the plain version on the CPU."""

    def __init__(self, tables: Sequence[CellTables],
                 tgeoms: Sequence[TraceGeometry], cfg: TraceConfig,
                 dtype=torch.float32, device="cuda"):
        """The tables are packed and the region grids built on ``device``
        (the card unless the caller asks for the CPU), each design's grid
        refined where it is open (:func:`region_subgrids_stacked`, buffers
        ``G_fine`` and ``G_sub_codes``, which the kernel reads); on a GPU
        the kernel is built and bound here, and only float32 is taken."""
        super().__init__()
        if torch.device(device).type == "cuda" and dtype != torch.float32:
            raise ValueError(f"{dtype} traces on the CPU only: the "
                             "vector_trace kernel is float32")
        device = resolve_device(device)
        if device.type == "cuda":
            load_kernel()
        num_fc, num_oc = tgeoms[0].num_fc, tgeoms[0].num_oc
        if any(g.num_fc != num_fc or g.num_oc != num_oc for g in tgeoms):
            raise ValueError("designs in one trace must share strip counts")

        def to(d):
            return {k: (v.to(device) if torch.is_tensor(v) else v)
                    for k, v in d.items()}

        Gs = [to(geom_tensors(g, dtype)) for g in tgeoms]
        T = stack_tables([pack_tables(to(as_tables(t, dtype)), G)
                          for t, G in zip(tables, Gs)])
        for k, v in T.items():
            self.register_buffer(f"T_{k}", v)
        G = add_region_grids(stack_geoms(Gs))
        G["fine"], G["sub_codes"] = region_subgrids_stacked(G)
        for k, v in G.items():
            self.register_buffer(f"G_{k}", v)
        self.cfg = cfg
        self.num_fc, self.num_oc = num_fc, num_oc
        self._fns = {m: make_trace_fn_dynamic(cfg, num_fc, num_oc, mode=m)
                     for m in ("full", "resume")}

    def tables(self) -> dict:
        return {k[2:]: v for k, v in self.named_buffers() if k[:2] == "T_"}

    def geometry(self) -> dict:
        return {k[2:]: v for k, v in self.named_buffers() if k[:2] == "G_"}

    def forward(self, rays: dict, mode: str = "full",
                max_bounces: Optional[int] = None,
                timer: Optional[EventTimer] = None,
                stats: Optional[dict] = None):
        return self._fns[mode](rays, self.tables(), self.geometry(),
                               max_bounces=max_bounces, timer=timer,
                               stats=stats)


# ---------------------------------------------------------------------------
# segment-and-compact scheduling and deposits


def compact_rays(rays: dict):
    """The live rays of each design row moved to the front, stably, and
    the rows cut to the largest live count ``k`` (one read from the
    device); rows with fewer live rays keep dead ones, which a step leaves
    as they are.  Returns ``(rays, k)``."""
    alive = rays["state"] < DEAD
    k = int(alive.sum(dim=1).max())
    order = torch.sort((~alive).to(torch.uint8), dim=1,
                       stable=True).indices[:, :k]
    return {key: torch.gather(v, 1, order) for key, v in rays.items()}, k


def trace_compacted(tracer: VectorTracer, rays: dict, max_bounces: int,
                    segment_bounces: int, on_deposits,
                    timer: Optional[EventTimer] = None,
                    stats: Optional[dict] = None) -> torch.Tensor:
    """Trace (D, R) rays in segments of ``segment_bounces`` steps, moving
    the survivors of every design row together between segments
    (:func:`compact_rays`) so late steps run on a small batch.  After each
    segment ``on_deposits(rays)`` receives the segment's final state (its
    ``dep`` holds the segment's deposits; it is reset before the next).  Per
    ray RNG streams carry over and the last segment gets exactly the budget
    left, so the deposits and the (D,) bounce total returned equal one trace
    of ``max_bounces``, bit for bit."""
    if segment_bounces < 1:
        raise ValueError("segment_bounces must be positive")
    timer = timer if timer is not None else EventTimer("cpu")
    stats = stats if stats is not None else {}
    total = None
    budget = int(max_bounces)
    mode = "full"
    while budget > 0:
        seg = min(segment_bounces, budget)
        rays, b = tracer(rays, mode=mode, max_bounces=seg, timer=timer,
                         stats=stats)
        mode = "resume"
        total = b if total is None else total + b
        budget -= seg
        with timer.span("scatter"):
            on_deposits(rays)
        if budget <= 0:
            break
        with timer.span("compact"):
            rays, k = compact_rays(rays)
            stats["syncs"] = stats.get("syncs", 0) + 1
            stats["segments"] = stats.get("segments", 0) + 1
        if k == 0:
            break
        rays["dep"] = torch.full_like(rays["dep"], -1)
    return total


def deposits_to_histogram(dep: torch.Tensor, cid: torch.Tensor, L: int,
                          M: int, N: int, ny: int, nx: int) -> torch.Tensor:
    """Per-ray terminal deposits -> the (L, N, M, ny, nx) eyebox histogram
    (the reference's ``matrix_EB`` axis order: lambda, FoV y, FoV x, eyebox
    y, eyebox x), on ``dep``'s device."""
    hist = torch.zeros(L * N * M * ny * nx, dtype=torch.float32,
                       device=dep.device)
    add_deposits(hist, dep.reshape(-1), cid.reshape(-1), M, N, ny, nx)
    return hist.reshape(L, N, M, ny, nx)


def add_deposits(hist_flat: torch.Tensor, dep: torch.Tensor,
                 cid: torch.Tensor, M: int, N: int, ny: int, nx: int,
                 base: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Add one per deposit (``dep >= 0``) of rays of cells ``cid`` into a
    flat (L, N, M, ny, nx) histogram, in place; ``base`` (broadcast against
    ``dep``) offsets each row, e.g. by design.  Whole counts in float32 sum
    exactly in any order (below 2^24 per bin).  Returns the number of
    deposits as a device scalar."""
    has = dep >= 0
    l = cid // (M * N)
    mn = cid % (M * N)
    flat = ((l * N + mn % N) * M + mn // N) * (ny * nx) + torch.clamp(dep, min=0)
    if base is not None:
        flat = flat + base
    hist_flat.index_add_(0, flat.reshape(-1).to(torch.int64),
                         has.reshape(-1).to(hist_flat.dtype))
    return has.sum()
