"""Deterministic-splitting (wavefront) tracer: all branches, weighted, no RNG.

Port of ``engine/splitting.py`` of the JAX package, in its ``fast=False``
form.  Where the Monte-Carlo tracer draws one outcome per interaction, this
engine follows every branch with its weight multiplied by the branch
efficiency, and the out-coupling branch deposits its weighted energy: the
result is the exact expectation of the Monte-Carlo tracer for the traced
launch positions, a zero-variance eyebox map.  The physics is the vector
tracer's step (:mod:`.trace_vector`: the same interaction records, the same
arithmetic) with the roulette replaced by weighted children.

Two schedules share it:

1. :func:`make_splitting_trace_fn`: one global ``capacity``-slot wavefront;
   after every step the children are compacted by a stable sort on their
   aliveness (heaviest first), and children that overflow are dropped
   lightest first into the ``truncated`` ledger.  With the options of the
   differentiable path (``table_arg``, ``fixed_steps``, ``soft_binning``)
   the histogram is a function of the tables that autograd differentiates
   (:mod:`..opt.grating_opt`).
2. :func:`make_splitting_cells_fn`: one ``capacity``-slot wavefront per
   (lambda, FoV) cell: each cell's tables are cut out once per chunk, each
   cell deposits into its own (ny, nx) tile, and a step's next wavefront is
   its live A children, then its live B children, in slot order (overflow
   counted in ``truncated``).  On a GPU a chunk is one launch of the
   hand-written kernel ``csrc/split_cells.cu`` (:func:`launch_split_cells`:
   one block per cell, the whole step loop inside it, no host read); its
   plain version :func:`split_cells_reference` runs the chunk as the rows
   of a (C, K) batch, compacted by a per-row cumsum and scatter, and serves
   the CPU (:func:`split_cells` routes by device).

The global engine and the plain version keep a wavefront's live slots
first and step only as many slots as the widest wavefront holds, which they
read from the device once per step (the loop's stop test needs it anyway):
a dead slot has no children and deposits nothing, so the slots left out
change no result and no ledger.

The plain versions add deposits with ``index_add_``, under deterministic
algorithms (on the card a sorted accumulation in place of float atomics),
so a cell's tile does not depend on the other cells of its chunk; the
kernel adds each bin's deposits in the same slot order, bit for bit the
plain version on the CPU.  The backward of a
table gather (``index_select``) is an ``index_add`` too: a gradient is
deterministic when the backward runs under :func:`deterministic`.  Only the
global engine with ``table_arg=True`` records a graph; every other trace
runs under ``torch.no_grad()``.

Not ported: the JAX package's ``fast=True`` lowerings of the per-cell
engine (site selection by a one-hot matmul, compaction by a variadic sort,
deposits by a one-hot matmul), which are TPU lowerings of the same values.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..config import TraceConfig
from ..luts.packing import CellTables, DIR_FC, DIR_IC, DIR_IC2, DIR_OC
from . import build
from .device import resolve_device
from .trace_geometry import TraceGeometry
from .trace_persistent import launch_counts
from . import trace_vector
from .trace_vector import (
    DEAD, GEOM_SCALARS, _C_EBR, _C_SOUT, _EDGE_TOL, _I_COS0, _I_ICA,
    _I_ICB, _I_JA, _I_JB, _I_SA, _I_SB, _col, _jones_apply, _phase_mul,
    _power, _rsqrt, _take, add_region_grids, as_tables, deposit_bin,
    geom_tensors, in_ic, pack_tables, regions_inside, site_key, stack_geoms,
)

# wavefront fields (cid is left out of the per-cell engine, where a slot's
# cell is its row)
_KEYS = ("x", "y", "ter", "tei", "tmr", "tmi", "cos_th", "gap_x", "gap_y",
         "state", "w", "cid")

# the cell axis of each table of :func:`.trace_vector.as_tables`
_TABLE_CELL_AXIS = {
    "init_jones": 1, "init_scale": 1, "init_cos0": 0,
    "ic_jones": 2, "ic_scale": 1,
    "fc_jones": 3, "fc_scale": 2,
    "oc_jones": 3, "oc_scale": 2, "oc_scale_out": 0,
    "gaps": 0, "tir_phasor": 0, "hop2_phasor": 0,
}


@dataclasses.dataclass
class SplitResult:
    histogram: np.ndarray       # (L, N, M, ny, nx) weighted eyebox deposits
    out_coupled: float          # total deposited weight (inside eyebox quads)
    truncated: float            # weight lost to buffer overflow (should be ~0)
    pruned: float               # weight killed by the threshold (downward bias bound)
    steps: int
    peak_live: int = 0          # max concurrent live wavefront width observed


def _accumulate(hist: torch.Tensor, n: int, idx: torch.Tensor,
                val: torch.Tensor) -> None:
    """``hist[idx] += val`` for the slots with ``idx >= 0`` and a nonzero
    ``val``, in place, deterministically.  ``hist`` holds ``n`` bins and
    then one scratch bin per slot: the other slots add into their own
    scratch bins, so no bin collects a run of empty adds (a deterministic
    accumulation sums each bin's adds in turn).  Adding 0 changes no bin,
    so the result is that of adding every slot's ``val``."""
    idx, val = idx.reshape(-1), val.reshape(-1)
    use = (idx >= 0) & (val != 0)
    scratch = n + torch.arange(idx.numel(), device=idx.device)
    with deterministic():
        hist.index_add_(0, torch.where(use, idx, scratch),
                        torch.where(use, val, 0.0))


def _accumulate_in_order(hist: torch.Tensor, n: int, idx: torch.Tensor,
                         val: torch.Tensor) -> None:
    """:func:`_accumulate`, with every bin adding its values one by one in
    slot order on any device.  ``index_add_`` on the CPU adds in index
    order; the deterministic one on the card sums a bin's values first and
    then adds the sum, so there the values go in rounds of distinct bins,
    round r holding each bin's r-th value."""
    if hist.device.type == "cpu":
        _accumulate(hist, n, idx, val)
        return
    idx, val = idx.reshape(-1), val.reshape(-1)
    sel = torch.nonzero((idx >= 0) & (val != 0)).squeeze(1)
    if not sel.numel():
        return
    bins, order = torch.sort(idx[sel], stable=True)
    vals = val[sel][order]
    pos = torch.arange(bins.numel(), device=bins.device)
    first = torch.ones_like(bins, dtype=torch.bool)
    first[1:] = bins[1:] != bins[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        m = rank == r
        hist.index_add_(0, bins[m], vals[m])


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the operations inside: a weighted
    ``index_add_`` accumulates in an order that does not depend on the
    other cells of a chunk, and a backward run inside accumulates the
    gradients of gathers in a fixed order."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn_only = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn_only)


def _build_step_fns(cfg: TraceConfig, *, n_cells_mn: int, M: int, N: int,
                    num_fc: int, num_oc: int,
                    weight_threshold: float, soft_binning: bool = False):
    """The branch-transport physics: ``split_init``, ``split_step`` and
    ``deposit``, over packed tables ``T`` (:func:`.trace_vector.pack_tables`)
    indexed by each slot's table cell ``g``, geometry ``G`` (one design, with
    its region grids: :func:`.trace_vector.add_region_grids`) and its
    broadcast scalars ``S``.

    ``n_cells_mn`` / ``M`` / ``N`` set the histogram's index space: the
    global engine passes the real grid; the per-cell engine passes 1 / 1 / 1
    with each slot's row as its ``cid``, so deposits index the row's
    (ny * nx) tile."""
    ny, nx = cfg.eyebox_bins
    circle = cfg.ic_test == "circle"
    R2 = 2 * (1 + num_fc + num_oc)

    def grid_base(cid):
        mn = cid % n_cells_mn
        return ((cid // n_cells_mn * N + mn % N) * M + mn // N) * (ny * nx)

    def deposit(T, hist, n, g, cid, x, y, w):
        """Add deposit weights into the flat histogram of ``n`` bins (then
        one scratch bin per slot, see :func:`_accumulate`), in place.  Hard
        mode: the nearest bin.  Soft mode: bilinear (cloud-in-cell) over the
        four surrounding bin centres, a continuous function of (x, y)."""
        ebr = _take(T["cell"][_C_EBR:_C_EBR + 4], g)
        if not soft_binning:
            in_quad, b = deposit_bin(ebr, x, y, ny, nx)
            _accumulate(hist, n, torch.where(in_quad, grid_base(cid) + b, -1),
                        w)
            return hist
        e0, e1, e2, e3 = ebr.unbind(0)
        in_quad = ((x >= e0 - _EDGE_TOL) & (x <= e1 + _EDGE_TOL)
                   & (y >= e2 - _EDGE_TOL) & (y <= e3 + _EDGE_TOL))
        w = torch.where(in_quad, w, 0.0)
        dxb = (e1 - e0) / nx
        dyb = (e3 - e2) / ny
        # bin-centre coordinates; the clamp keeps all mass inside the map
        u = torch.clamp((x - e0) / dxb - 0.5, 0.0, nx - 1.0)
        v = torch.clamp((y - e2) / dyb - 0.5, 0.0, ny - 1.0)
        ix0 = torch.clamp(torch.floor(u), 0, nx - 2).to(torch.int64)
        iy0 = torch.clamp(torch.floor(v), 0, ny - 2).to(torch.int64)
        fx = u - ix0
        fy = v - iy0
        base = grid_base(cid)
        for di, dj, wf in ((0, 0, (1 - fx) * (1 - fy)),
                           (1, 0, fx * (1 - fy)),
                           (0, 1, (1 - fx) * fy),
                           (1, 1, fx * fy)):
            _accumulate(hist, n, base + (iy0 + dj) * nx + (ix0 + di), w * wf)
        return hist

    def split_init(T, S, G, g, rays):
        """First IC interaction: both orders become children with weights.
        Returns the two children and the weight the threshold killed (summed
        over the last axis)."""
        cell = _take(T["cell"], g)
        pol = (rays["ter"], rays["tei"], rays["tmr"], rays["tmi"])
        w = rays["w"]
        outs = []
        pruned = 0.0
        for branch, dir_ in ((0, DIR_IC), (1, DIR_IC2)):
            jo, so, ico = ((_I_JA, _I_SA, _I_ICA) if branch == 0
                           else (_I_JB, _I_SB, _I_ICB))
            p = _jones_apply(cell[jo:jo + 8], *pol)
            eff = _power(*p) * cell[so] / cell[_I_COS0]
            pw_p = _power(*p)
            inv = _rsqrt(torch.where(pw_p > 1e-30, pw_p, 1.0))
            d = _take(T["dirs"], g * 4 + dir_)
            ter, tei = p[0] * inv, p[1] * inv
            tmr, tmi = _phase_mul(d[2], d[3], p[2] * inv, p[3] * inv)
            gx, gy = d[0], d[1]
            x = rays["x"] + gx
            y = rays["y"] + gy
            icin = in_ic(G, S, x, y, circle)
            state = (torch.where(icin, 0, 2) if branch == 0
                     else torch.where(icin, 1, DEAD))
            wgt = w * eff
            # threshold kills (not geometric deaths) are the pruned ledger
            killed = (state < DEAD) & ~(wgt > weight_threshold)
            pruned = pruned + torch.where(killed, wgt, 0.0).sum(dim=-1)
            state = torch.where(wgt > weight_threshold, state, DEAD)
            out = dict(x=x, y=y, ter=ter, tei=tei, tmr=tmr, tmi=tmi,
                       cos_th=cell[ico].expand_as(x), gap_x=gx.expand_as(x),
                       gap_y=gy.expand_as(x), state=state.to(torch.int32),
                       w=wgt)
            if "cid" in rays:
                out["cid"] = rays["cid"]
            outs.append(out)
        return outs, pruned

    def split_step(T, S, G, g, buf):
        """One wavefront bounce: each slot -> (child A, child B, deposit
        weight); the weight the threshold killed, summed over the last
        axis."""
        x, y = buf["x"], buf["y"]
        state = buf["state"]
        w = buf["w"]
        in_r1, in_hull, in_r2 = regions_inside(G, x, y, state < DEAD)
        alive = (state < DEAD) & in_r1
        grp_ic, grp_fc, grp_oc, in_rect, key = site_key(
            S, x, y, state, alive, in_hull, num_fc, num_oc)
        hit_fc = grp_fc & in_hull
        hit_oc = grp_oc & in_rect
        interact = grp_ic | hit_fc | hit_oc

        rec = _take(T["rec"], g * R2 + key)
        pol = (buf["ter"], buf["tei"], buf["tmr"], buf["tmi"])
        s_a, s_b = rec[24], rec[25]
        pol_a = _jones_apply(rec[0:8], *pol)
        pol_b = _jones_apply(rec[8:16], *pol)
        pol_c = _jones_apply(rec[16:24], *pol)
        # padded and dead slots carry cos_th = 0
        inv_cos = 1.0 / torch.where(buf["cos_th"] > 0, buf["cos_th"], 1.0)
        eff_a = _power(*pol_a) * s_a * inv_cos
        eff_b = _power(*pol_b) * s_b * inv_cos
        s_c = _take(T["cell"][_C_SOUT:_C_SOUT + 1], g)[0]
        eff_c = _power(*pol_c) * s_c * inv_cos
        dep_w = torch.where(hit_oc, w * eff_c, 0.0)

        miss_fc2 = grp_fc & ~in_hull & (state == 2)
        miss_fc3 = grp_fc & ~in_hull & (state == 3)
        fc3_to_oc = miss_fc3 & ~in_r2
        hop = (miss_fc2 | (miss_fc3 & in_r2)
               | (grp_oc & ~in_rect & (state == 4)))
        miss_oc5 = grp_oc & ~in_rect & (state == 5)
        hop_dir = torch.where(miss_fc2, DIR_IC, DIR_FC)
        hd = _take(T["dirs"], g * 4 + hop_dir)
        hop_tmr, hop_tmi = _phase_mul(hd[4], hd[5], buf["tmr"],
                                      buf["tmi"])

        def child(bp, eff, scale_cos, dir_idx, to_fc, to_oc, ic_in, ic_out):
            pw_c = _power(*bp)
            inv = _rsqrt(torch.where(pw_c > 1e-30, pw_c, 1.0))
            d = _take(T["dirs"], g * 4 + dir_idx)
            ter = bp[0] * inv
            tei = bp[1] * inv
            tmr, tmi = _phase_mul(d[2], d[3], bp[2] * inv, bp[3] * inv)
            gx, gy = d[0], d[1]
            xa = x + gx
            ya = y + gy
            icin = in_ic(G, S, xa, ya, circle)
            st = torch.where(grp_oc, to_oc, torch.where(
                grp_fc, to_fc, torch.where(icin, ic_in, ic_out)))
            wgt = w * eff
            keep = wgt > weight_threshold
            pruned = torch.where(interact & alive & ~keep, wgt,
                                 0.0).sum(dim=-1)
            st = torch.where(interact & keep, st, DEAD)
            out = dict(x=xa, y=ya, ter=ter, tei=tei, tmr=tmr, tmi=tmi,
                       cos_th=scale_cos, gap_x=gx, gap_y=gy,
                       state=st.to(torch.int32), w=wgt)
            if "cid" in buf:
                out["cid"] = buf["cid"]
            return out, pruned

        dir_a = torch.where(grp_oc, DIR_FC, DIR_IC)
        dir_b = torch.where(grp_ic, DIR_IC2,
                            torch.where(grp_fc, DIR_FC, DIR_OC))
        ch_a, pr_a = child(pol_a, eff_a, s_a, dir_a, 2, 4, 0, 2)
        ch_b, pr_b = child(pol_b, eff_b, s_b, dir_b, 3, 5, 1, DEAD)

        # slots that do not interact: child A carries the hop survivor or
        # the phase change
        surv_state = torch.where(fc3_to_oc, 4, torch.where(hop, state, DEAD))
        surv_state = torch.where(miss_oc5, DEAD, surv_state)
        not_int = alive & ~interact
        for k, surv in (
                ("x", torch.where(hop, x + buf["gap_x"], x)),
                ("y", torch.where(hop, y + buf["gap_y"], y)),
                ("ter", buf["ter"]), ("tei", buf["tei"]),
                ("tmr", torch.where(hop, hop_tmr, buf["tmr"])),
                ("tmi", torch.where(hop, hop_tmi, buf["tmi"])),
                ("cos_th", buf["cos_th"]), ("gap_x", buf["gap_x"]),
                ("gap_y", buf["gap_y"]), ("w", w)):
            ch_a[k] = torch.where(not_int, surv, ch_a[k])
        ch_a["state"] = torch.where(
            alive, torch.where(not_int, surv_state, ch_a["state"]),
            DEAD).to(torch.int32)
        ch_b["state"] = torch.where(alive & interact, ch_b["state"],
                                    DEAD).to(torch.int32)
        return ch_a, ch_b, dep_w, pr_a + pr_b

    return split_init, split_step, deposit


def _geometry(tgeom: TraceGeometry, device, dtype=torch.float32):
    """(one-design geometry dict, its ``geom_tensors`` on the CPU)."""
    G0 = geom_tensors(tgeom, dtype)
    G = {k: v.to(device)
         for k, v in add_region_grids(stack_geoms([G0])).items()}
    return G, G0


def make_splitting_trace_fn(tables: CellTables, tgeom: TraceGeometry,
                            cfg: TraceConfig, capacity: int = 1 << 16,
                            weight_threshold: float = 1e-5,
                            max_steps: int = 512, table_arg: bool = False,
                            fixed_steps: int = 0, soft_binning: bool = False,
                            device="cuda"):
    """Build ``trace(rays0) -> (hist_flat, out_w, trunc_w, pruned, steps)``,
    the global-buffer engine on ``device``: every launch ray shares one
    ``capacity``-slot wavefront.

    ``rays0`` is a :func:`.trace_vector.make_ray_state` dict whose length is
    the initial wavefront; each launch ray with a nonzero amplitude weighs 1.

    ``table_arg``: the trace takes the :func:`.trace_vector.as_tables` dict
    as a second argument (``trace(rays0, T)``) and packs it inside, so the
    histogram is a differentiable function of the tables: with grad mode
    on, autograd records the trace (the forward values are those of the
    closed-over tables bit for bit).  ``fixed_steps > 0`` runs exactly that
    many steps, with no stop test.  ``soft_binning`` splats each deposit
    bilinearly over the four nearest bins, a continuous function of the
    deposit position (it blurs the map by at most half a bin).  Without
    ``table_arg`` the trace runs under ``torch.no_grad()``."""
    device = resolve_device(device)
    G, G0 = _geometry(tgeom, device)
    ny, nx = cfg.eyebox_bins
    L, M, N = tables.L, tables.M, tables.N
    hist_size = L * N * M * ny * nx
    split_init, split_step, deposit = _build_step_fns(
        cfg, n_cells_mn=M * N, M=M, N=N, num_fc=tgeom.num_fc,
        num_oc=tgeom.num_oc, weight_threshold=weight_threshold,
        soft_binning=soft_binning)
    S = _col(G, 1, 1)
    T_closed = None
    if not table_arg:
        T_closed = {k: v.to(device) for k, v in
                    pack_tables(as_tables(tables), G0).items()}

    def compact(children: dict, cap: int):
        """Keep the ``cap`` heaviest live slots (a stable sort), as a buffer
        of just the live ones kept: ``(buffer, dropped weight, its
        width)``; the width is read from the device."""
        alive = children["state"] < DEAD
        aliveness = torch.where(alive, children["w"], -1.0)
        order = torch.argsort(-aliveness, stable=True)
        width = min(cap, int(alive.sum()))
        kept = {k: v[order[:width]] for k, v in children.items()}
        rest = order[cap:]
        dropped = torch.where(alive[rest], children["w"][rest], 0.0).sum()
        return kept, dropped, width

    def trace(rays0: dict, T: Optional[dict] = None):
        with torch.set_grad_enabled(table_arg and torch.is_grad_enabled()):
            return _trace(rays0, T)

    def _trace(rays0: dict, T: Optional[dict]):
        if table_arg:
            T = pack_tables({k: (v.to(device) if torch.is_tensor(v) else v)
                             for k, v in T.items()},
                            {k: v.to(device) for k, v in G0.items()})
        else:
            T = T_closed
        w0 = (rays0["ter"].abs() + rays0["tei"].abs() + rays0["tmr"].abs()
              + rays0["tmi"].abs())
        r0 = {k: rays0[k] for k in ("x", "y", "ter", "tei", "tmr", "tmi",
                                    "cid")}
        r0["w"] = torch.where(w0 > 0, 1.0, 0.0).to(w0.dtype)
        kids, pruned = split_init(T, S, G, r0["cid"], r0)
        children = {k: torch.cat([kids[0][k], kids[1][k]]) for k in _KEYS}
        buf, trunc, width = compact(children, capacity)
        hist = torch.zeros(hist_size + capacity, dtype=w0.dtype,
                           device=w0.device)

        def body(buf, trunc, pruned):
            ch_a, ch_b, dep_w, pr = split_step(T, S, G, buf["cid"], buf)
            deposit(T, hist, hist_size, buf["cid"], buf["cid"], buf["x"],
                    buf["y"], dep_w)
            children = {k: torch.cat([ch_a[k], ch_b[k]]) for k in _KEYS}
            buf, dropped, width = compact(children, capacity)
            return buf, trunc + dropped, pruned + pr, width

        # the buffer holds only its live slots: a dead slot has no children
        # and deposits nothing, so stepping it would change no result
        it = 0
        if fixed_steps > 0:
            for it in range(1, fixed_steps + 1):
                buf, trunc, pruned, width = body(buf, trunc, pruned)
        else:
            while it < max_steps and width > 0:
                buf, trunc, pruned, width = body(buf, trunc, pruned)
                it += 1
        hist = hist[:hist_size]
        return hist, hist.sum(), trunc, pruned, it

    return trace


def run_splitting(tables: CellTables, tgeom: TraceGeometry, cfg: TraceConfig,
                  rays0: dict, **kw) -> SplitResult:
    """:func:`make_splitting_trace_fn` on ``rays0``, as a
    :class:`SplitResult`."""
    trace = make_splitting_trace_fn(tables, tgeom, cfg, **kw)
    hist, out_w, trunc, pruned, steps = trace(rays0)
    ny, nx = cfg.eyebox_bins
    return SplitResult(
        histogram=hist.cpu().numpy().reshape(tables.L, tables.N, tables.M,
                                             ny, nx),
        out_coupled=float(out_w), truncated=float(trunc),
        pruned=float(pruned), steps=int(steps))


# ---------------------------------------------------------------------------
# the per-cell engine


def _gather_cell_tables(T: dict, cell_ids: torch.Tensor) -> dict:
    """The chunk's tables: every table of an :func:`.trace_vector.as_tables`
    dict cut to the cells ``cell_ids`` along its cell axis, in chunk order,
    so row c of a chunk reads cell ``cell_ids[c]``."""
    out = dict(T)
    for k, ax in _TABLE_CELL_AXIS.items():
        out[k] = T[k].index_select(ax, cell_ids)
    return out


_NF = 11                  # wavefront fields of a kernel buffer
# the C parameters of split_cells_launch, in order: 13 pointers, 16 ints,
# the threshold and the stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_int] * 16
                   + [ctypes.c_float, ctypes.c_void_p])


@dataclasses.dataclass
class SplitCellsArgs:
    """One chunk of the per-cell engine as the kernel takes it: the chunk's
    packed tables (:func:`.trace_vector.pack_tables` of the chunk's cells),
    the design's geometry flattened (:func:`pack_geometry`) and its region
    grid, and the launch seeds as one float32 tensor, (6, P) shared by every
    cell or (6, C, P), in :data:`.seeding.FIELDS` order."""
    rec: torch.Tensor          # (26, C * R2)
    cell: torch.Tensor         # (26, C)
    dirs: torch.Tensor         # (6, C * 4)
    geom: torch.Tensor         # (len(GEOM_SCALARS) + 3 * sum(edges),)
    grid: torch.Tensor         # (n, n) uint8 region codes
    seeds: torch.Tensor        # (6, P) or (6, C, P)
    edges: tuple               # half-planes of each pack of GEOM_HP
    C: int
    P: int
    capacity: int
    weight_threshold: float
    max_steps: int
    num_fc: int
    num_oc: int
    eyebox_bins: tuple
    circle: bool

    def to(self, device) -> "SplitCellsArgs":
        """The same chunk with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


@dataclasses.dataclass
class SplitCellsOut:
    """Per cell: ``tiles`` (C, ny, nx), the ``trunc`` and ``pruned``
    ledgers, the ``peak`` live children of a step before the cut, the
    ``steps`` it took and the slots it stepped (``work``, summed over its
    steps)."""
    tiles: torch.Tensor
    trunc: torch.Tensor
    pruned: torch.Tensor
    peak: torch.Tensor
    steps: torch.Tensor
    work: torch.Tensor


def pack_geometry(G: dict) -> tuple:
    """One design's geometry with its region grid (:func:`_geometry`) as
    the kernel reads it: ``(flat float32, grid codes (n, n) uint8, edges)``
    (:data:`.trace_vector.GEOM_SCALARS`, then the packs of
    :data:`.trace_vector.GEOM_HP`): row 0 of
    :func:`.trace_vector.pack_geometry`."""
    rows, grid, edges = trace_vector.pack_geometry(G)
    return rows[0].float().contiguous(), grid[0].contiguous(), edges


def unpack_geometry(flat: torch.Tensor, grid: torch.Tensor,
                    edges: tuple) -> dict:
    """The one-design geometry dict of :func:`pack_geometry`'s output, as
    :func:`.trace_vector.regions_inside`, :func:`.trace_vector.in_ic` and
    :func:`.trace_vector._col` read it."""
    return trace_vector.unpack_geometry(flat[None], grid[None], edges)


def split_cells_args(Tc: dict, packed: tuple, seeds: torch.Tensor,
                     cfg: TraceConfig, num_fc: int, num_oc: int,
                     capacity: int, weight_threshold: float,
                     max_steps: int) -> SplitCellsArgs:
    """The kernel's arguments of one chunk: ``Tc`` the chunk's packed
    tables, ``packed`` the design's geometry with its grid as
    :func:`pack_geometry` gives it, ``seeds`` (6, P) or (6, C, P), all on
    one device."""
    geom, grid, edges = packed
    C = Tc["cell"].shape[1]
    return SplitCellsArgs(
        rec=Tc["rec"].contiguous(), cell=Tc["cell"].contiguous(),
        dirs=Tc["dirs"].contiguous(), geom=geom, grid=grid,
        seeds=seeds.float().contiguous(), edges=edges, C=C,
        P=seeds.shape[-1], capacity=int(capacity),
        weight_threshold=float(weight_threshold), max_steps=int(max_steps),
        num_fc=num_fc, num_oc=num_oc, eyebox_bins=tuple(cfg.eyebox_bins),
        circle=cfg.ic_test == "circle")


def split_cells_reference(a: SplitCellsArgs) -> SplitCellsOut:
    """The plain PyTorch version of the kernel: the eager step loop over
    the chunk's (C, width) wavefront, on ``a``'s device.  Each step reads
    the widest row's live count (and the positions the region grids leave
    open) from the device.  Every bin adds its deposits one by one in slot
    order (:func:`_accumulate_in_order`), as the kernel does, on either
    device."""
    dev = a.rec.device
    ny, nx = a.eyebox_bins
    K, C = a.capacity, a.C
    G = unpack_geometry(a.geom, a.grid, a.edges)
    S = _col(G, 1, 2)
    Tc = {"rec": a.rec, "cell": a.cell, "dirs": a.dirs}
    cfg = TraceConfig(eyebox_bins=(ny, nx),
                      ic_test="circle" if a.circle else "polygon")
    nkeys = tuple(k for k in _KEYS if k != "cid")
    split_init, split_step, _ = _build_step_fns(
        cfg, n_cells_mn=1, M=1, N=1, num_fc=a.num_fc, num_oc=a.num_oc,
        weight_threshold=a.weight_threshold)

    def compact(children: dict):
        """Per-row cumsum compaction into at most K slots: the rows are cut
        to the widest row's live count (read from the device), since the
        slots past it would be dead.  Returns (buffer, dropped weight, live
        children per row, width)."""
        alive = children["state"] < DEAD
        pos = torch.cumsum(alive.to(torch.int32), dim=1) - 1
        nlive = alive.sum(dim=1)
        width = min(K, int(nlive.max()))
        keep = alive & (pos < K)
        idx = torch.where(keep, pos, width).to(torch.int64)
        out = {}
        for k in nkeys:
            v = children[k]
            init = torch.full((C, width + 1), DEAD if k == "state" else 0,
                              dtype=v.dtype, device=dev)
            out[k] = init.scatter_(1, idx, v)[:, :width]
        dropped = torch.where(alive & ~keep, children["w"], 0.0).sum(dim=1)
        return out, dropped, nlive, width

    g = torch.arange(C, device=dev)[:, None]
    ebr = _take(Tc["cell"][_C_EBR:_C_EBR + 4], g)
    rays0 = {k: a.seeds[i].expand(C, a.P) for i, k in
             enumerate(("x", "y", "ter", "tei", "tmr", "tmi"))}
    w0 = (rays0["ter"].abs() + rays0["tei"].abs() + rays0["tmr"].abs()
          + rays0["tmi"].abs())
    rays0["w"] = torch.where(w0 > 0, 1.0, 0.0).to(w0.dtype)
    kids, pruned = split_init(Tc, S, G, g, rays0)
    children = {k: torch.cat([kids[0][k], kids[1][k]], dim=-1)
                for k in nkeys}
    buf, trunc, peak, width = compact(children)
    n_bins = C * ny * nx
    hist = torch.zeros(n_bins + C * K, dtype=w0.dtype, device=dev)
    steps = torch.zeros(C, dtype=torch.int64, device=dev)
    work = torch.zeros(C, dtype=torch.int64, device=dev)
    rows = torch.clamp(peak, max=K)
    it = 0
    # each row holds its live slots first; the buffer is as wide as the
    # widest row's (a dead slot has no children and deposits nothing)
    while it < a.max_steps and width > 0:
        steps += rows > 0
        work += rows
        ch_a, ch_b, dep_w, pr = split_step(Tc, S, G, g, buf)
        in_quad, b = deposit_bin(ebr, buf["x"], buf["y"], ny, nx)
        _accumulate_in_order(hist, n_bins,
                             torch.where(in_quad, g * (ny * nx) + b, -1),
                             dep_w)
        children = {k: torch.cat([ch_a[k], ch_b[k]], dim=-1) for k in nkeys}
        buf, dropped, nlive, width = compact(children)
        trunc = trunc + dropped
        pruned = pruned + pr
        peak = torch.maximum(peak, nlive)
        rows = torch.clamp(nlive, max=K)
        it += 1
    return SplitCellsOut(tiles=hist[:n_bins].reshape(C, ny, nx), trunc=trunc,
                         pruned=pruned, peak=peak, steps=steps, work=work)


def launch_split_cells(a: SplitCellsArgs) -> SplitCellsOut:
    """The kernel on ``a``'s CUDA tensors: one launch for the chunk, queued
    on the current stream (no host read).  Raises if the launch is
    refused, e.g. for a tile too large for the card's shared memory."""
    dev = a.rec.device
    if dev.type != "cuda":
        raise ValueError(f"the split_cells kernel runs on cuda, not {dev}")
    for name in ("rec", "cell", "dirs", "geom", "seeds"):
        t = getattr(a, name)
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if a.grid.device != dev or a.grid.dtype != torch.uint8:
        raise ValueError("the region grid must be uint8 on the card")
    lib = load_kernel()
    ny, nx = a.eyebox_bins
    C, K = a.C, a.capacity
    out = SplitCellsOut(
        tiles=torch.empty((C, ny, nx), dtype=torch.float32, device=dev),
        trunc=torch.empty(C, dtype=torch.float32, device=dev),
        pruned=torch.empty(C, dtype=torch.float32, device=dev),
        peak=torch.empty(C, dtype=torch.int32, device=dev),
        steps=torch.empty(C, dtype=torch.int32, device=dev),
        work=torch.empty(C, dtype=torch.int64, device=dev))
    if C == 0:
        return out
    buf = torch.empty((C, 3, _NF, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.split_cells_launch(
            a.rec.data_ptr(), a.cell.data_ptr(), a.dirs.data_ptr(),
            a.geom.data_ptr(), a.grid.data_ptr(), a.seeds.data_ptr(),
            buf.data_ptr(), out.tiles.data_ptr(), out.trunc.data_ptr(),
            out.pruned.data_ptr(), out.peak.data_ptr(), out.steps.data_ptr(),
            out.work.data_ptr(), C, a.P, K, 2 * (1 + a.num_fc + a.num_oc),
            a.num_fc, a.num_oc, ny, nx, a.max_steps,
            int(a.seeds.dim() == 3), int(a.circle), a.grid.shape[0],
            *a.edges, float(np.float32(a.weight_threshold)), stream)
    if err != 0:
        msg = lib.split_cells_error_string(err).decode()
        raise RuntimeError(f"split_cells launch failed: {msg} ({err})")
    launch_counts["split_cells"] += 1
    return out


def split_cells(a: SplitCellsArgs) -> SplitCellsOut:
    """One chunk of the per-cell engine: the kernel for CUDA tensors, the
    plain version for CPU ones (no fallback between them)."""
    dev = a.rec.device
    if dev.type == "cuda":
        return launch_split_cells(a)
    if dev.type != "cpu":
        raise ValueError(f"split_cells runs on cpu or cuda, not {dev}")
    return split_cells_reference(a)


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/split_cells.cu``; raises with
    the compiler's output if the build fails."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("split_cells")
        lib.split_cells_launch.argtypes = LAUNCH_ARGTYPES
        lib.split_cells_launch.restype = ctypes.c_int
        lib.split_cells_error_string.argtypes = [ctypes.c_int]
        lib.split_cells_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def make_splitting_cells_fn(tables: CellTables, tgeom: TraceGeometry,
                            cfg: TraceConfig, capacity: int = 4096,
                            weight_threshold: float = 1e-5,
                            max_steps: int = 1024,
                            per_cell_seeds: bool = False, device="cuda"):
    """Build the per-cell-wavefront exact tracer on ``device``:
    ``trace(cell_ids, seeds) -> (tiles, out_w, trunc, pruned, steps, peak)``.

    - ``cell_ids``: (C,) flat cell indices ``(l * M + m) * N + n``.
    - ``seeds``: dict of x, y, ter, tei, tmr, tmi, each (P,) (launch
      positions shared by every cell, the reference's shared pupil samples)
      or (C, P) with ``per_cell_seeds=True``.  Each seed with a nonzero
      amplitude weighs 1.
    - ``tiles``: (C, ny, nx), each cell's weighted eyebox map;
      ``out_w`` / ``trunc`` / ``pruned``: (C,) per-cell weight ledgers;
      ``steps``: steps until the whole chunk drained (an int); ``peak``:
      (C,) the widest live wavefront of each cell (the zero-variance
      guarantee needs ``trunc == 0``, i.e. ``peak <= capacity``).

    Each cell's wavefront holds at most ``capacity`` slots; a step's
    children are its live A children in slot order, then its live B
    children, and those past the capacity are counted in ``trunc``.  On a
    CUDA device a chunk is one launch of ``csrc/split_cells.cu``
    (:func:`launch_split_cells`, built and bound here); on the CPU the
    plain version :func:`split_cells_reference`.  ``trace.args(cell_ids,
    seeds)`` gives a chunk's :class:`SplitCellsArgs` (what the kernel
    takes)."""
    device = resolve_device(device)
    T = {k: (v.to(device) if torch.is_tensor(v) else v)
         for k, v in as_tables(tables).items()}
    G, G0 = _geometry(tgeom, device)
    G0 = {k: v.to(device) for k, v in G0.items()}
    packed = pack_geometry(G)
    if device.type == "cuda":
        load_kernel()

    @torch.no_grad()
    def chunk_args(cell_ids, seeds: dict) -> SplitCellsArgs:
        """The kernel's arguments for the chunk ``cell_ids``."""
        ids = torch.as_tensor(np.asarray(cell_ids) if not torch.is_tensor(
            cell_ids) else cell_ids).to(device, torch.int64)
        C = ids.shape[0]
        P = seeds["x"].shape[-1]
        if 2 * P > capacity:
            raise ValueError(f"2 x {P} seed children exceed the "
                             f"{capacity}-slot per-cell buffer")
        Tc = pack_tables(_gather_cell_tables(T, ids), G0, ids)
        s = torch.stack([torch.as_tensor(seeds[k]).to(device, torch.float32)
                         for k in ("x", "y", "ter", "tei", "tmr", "tmi")])
        if per_cell_seeds:
            s = s.expand(6, C, P)
        return split_cells_args(Tc, packed, s, cfg, tgeom.num_fc,
                                tgeom.num_oc, capacity, weight_threshold,
                                max_steps)

    @torch.no_grad()
    def trace(cell_ids, seeds: dict):
        out = split_cells(chunk_args(cell_ids, seeds))
        steps = int(out.steps.max()) if out.steps.numel() else 0
        return (out.tiles, out.tiles.sum(dim=(1, 2)), out.trunc, out.pruned,
                steps, out.peak.to(torch.int64))

    trace.args = chunk_args
    return trace


def cells_tiles_to_histogram(tiles: torch.Tensor, cell_ids, L: int, M: int,
                             N: int, ny: int, nx: int) -> torch.Tensor:
    """Scatter per-cell (C, ny, nx) tiles into the (L, N, M, ny, nx) map."""
    ids = torch.as_tensor(np.asarray(cell_ids) if not torch.is_tensor(
        cell_ids) else cell_ids).to(tiles.device, torch.int64)
    flat = tiles.new_zeros((L * M * N, ny, nx))
    flat.index_add_(0, ids, tiles)
    return flat.reshape(L, M, N, ny, nx).permute(0, 2, 1, 3, 4).contiguous()


def run_splitting_cells(tables: CellTables, tgeom: TraceGeometry,
                        cfg: TraceConfig, cell_ids, seeds: dict,
                        **kw) -> SplitResult:
    """:func:`make_splitting_cells_fn` on one chunk, assembled into a
    :class:`SplitResult`."""
    trace = make_splitting_cells_fn(tables, tgeom, cfg, **kw)
    tiles, out_w, trunc, pruned, steps, peak = trace(cell_ids, seeds)
    ny, nx = cfg.eyebox_bins
    hist = cells_tiles_to_histogram(tiles, cell_ids, tables.L, tables.M,
                                    tables.N, ny, nx)
    return SplitResult(
        histogram=hist.cpu().numpy(), out_coupled=float(out_w.sum()),
        truncated=float(trunc.sum()), pruned=float(pruned.sum()),
        steps=int(steps), peak_live=int(peak.max()))
