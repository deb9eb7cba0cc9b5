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
   the histogram is a function of the tables, differentiated by a
   hand-written adjoint (:class:`SplitTraceFunction`,
   :mod:`..opt.grating_opt`).  On a GPU a trace runs the kernels of
   ``csrc/split_trace.cu`` (:func:`launch_split_trace`: a few launches a
   step, no host read in a fixed-step trace) and its gradient their
   adjoint (:func:`launch_split_trace_backward`, a reverse sweep over the
   forward's tape); their plain versions :func:`split_trace_reference`
   (the eager step loop) and :func:`split_trace_backward_reference` (the
   adjoint written out in PyTorch) serve the CPU (:func:`split_trace`,
   :func:`split_trace_backward` route by device).
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

The plain versions add each bin's deposits one by one in slot order
(:func:`_accumulate_in_order`: ``index_add_`` on the CPU, rounds of
distinct bins on the card), so a cell's tile does not depend on the other
cells of its chunk; the kernels add each bin's deposits in the same order,
bit for bit the plain versions on either device.  The plain backward adds
each table entry's gradient terms in a fixed order too
(:func:`_add_rows`), and so does its kernel.  Only the global engine with
``table_arg=True`` and grad mode on builds a graph node; every other trace
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
    DEAD, DIR_W, GEOM_SCALARS, REC_W, _C_EBR, _C_SOUT, _EDGE_TOL, _I_COS0,
    _I_ICA, _I_ICB, _I_JA, _I_JB, _I_SA, _I_SB, _col, _jones_apply, _phase_mul,
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
            _accumulate_in_order(
                hist, n, torch.where(in_quad, grid_base(cid) + b, -1), w)
            return hist
        e0, e1, e2, e3 = ebr.unbind(0)
        in_quad = ((x >= e0 - _EDGE_TOL) & (x <= e1 + _EDGE_TOL)
                   & (y >= e2 - _EDGE_TOL) & (y <= e3 + _EDGE_TOL))
        w = torch.where(in_quad, w, 0.0)
        dxb = _div(e1 - e0, nx)
        dyb = _div(e3 - e2, ny)
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
            _accumulate_in_order(hist, n,
                                 base + (iy0 + dj) * nx + (ix0 + di), w * wf)
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
    on, the trace runs through :class:`SplitTraceFunction`, whose backward
    is the hand-written adjoint (the forward values are those of the
    closed-over tables bit for bit).  ``fixed_steps > 0`` runs exactly that
    many steps, with no stop test.  ``soft_binning`` splats each deposit
    bilinearly over the four nearest bins, a continuous function of the
    deposit position (it blurs the map by at most half a bin).

    On a CUDA device the trace runs ``csrc/split_trace.cu`` (built and
    bound here), on the CPU its plain version: :func:`split_trace`.
    ``trace.args(rays0, T=None)`` gives the :class:`SplitTraceArgs` of a
    trace (what the kernels take)."""
    device = resolve_device(device)
    G, G0 = _geometry(tgeom, device)
    G0 = {k: v.to(device) for k, v in G0.items()}
    packed = pack_geometry(G)
    if device.type == "cuda":
        load_trace_kernel()
    kw = dict(capacity=int(capacity), weight_threshold=float(weight_threshold),
              fixed_steps=int(fixed_steps), max_steps=int(max_steps),
              soft_binning=bool(soft_binning),
              eyebox_bins=tuple(cfg.eyebox_bins), num_fc=tgeom.num_fc,
              num_oc=tgeom.num_oc, circle=cfg.ic_test == "circle",
              L=tables.L, M=tables.M, N=tables.N)

    def pack(T: dict) -> dict:
        return pack_tables({k: (v.to(device) if torch.is_tensor(v) else v)
                            for k, v in T.items()}, G0)

    T_closed = None if table_arg else pack(as_tables(tables))

    def packed_tables(T: Optional[dict]) -> dict:
        return pack(T) if table_arg else T_closed

    def args(rays0: dict, T: Optional[dict] = None,
             Tp: Optional[dict] = None) -> SplitTraceArgs:
        """The kernels' arguments of one trace (``Tp``: the packed tables,
        else those of ``T``)."""
        Tp = packed_tables(T) if Tp is None else Tp
        geom, grid, edges = packed
        rays = torch.stack([rays0[k] for k in ("x", "y", "ter", "tei", "tmr",
                                               "tmi")]).to(torch.float32)
        return SplitTraceArgs(
            rec=Tp["rec"], cell=Tp["cell"], dirs=Tp["dirs"], geom=geom,
            grid=grid, rays=rays.contiguous(),
            cid=rays0["cid"].to(torch.int32).contiguous(), edges=edges, **kw)

    def trace(rays0: dict, T: Optional[dict] = None):
        Tp = packed_tables(T)
        a = args(rays0, Tp=Tp)
        if table_arg and torch.is_grad_enabled() and any(
                Tp[k].requires_grad for k in ("rec", "cell", "dirs")):
            hist, trunc, pruned, steps = SplitTraceFunction.apply(
                Tp["rec"], Tp["cell"], Tp["dirs"], a)
            steps = int(steps)
        else:
            with torch.no_grad():
                out = split_trace(dataclasses.replace(
                    a, rec=a.rec.detach(), cell=a.cell.detach(),
                    dirs=a.dirs.detach()))
            hist, trunc, pruned, steps = (out.hist, out.trunc, out.pruned,
                                          out.steps)
        return hist, hist.sum(), trunc, pruned, steps

    trace.args = args
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


# tape fields: the 11 of a kernel buffer (state as int32 bits), then the
# slot's table cell and its provenance (int32 bits)
_NT = 13
_TAPE_FLOATS = ("x", "y", "ter", "tei", "tmr", "tmi", "cos_th", "gap_x",
                "gap_y")
_T_ST, _T_W, _T_CID, _T_SRC = 9, 10, 11, 12
# the differentiable fields of a slot, in the order of its adjoint
_ADJ = ("x", "y", "ter", "tei", "tmr", "tmi", "cos_th", "gap_x", "gap_y",
        "w")
# the int parameters of split_trace_forward / split_trace_backward, in order
TRACE_PARAMS = ("R", "K", "E", "C", "R2", "num_fc", "num_oc", "ny", "nx",
                "M", "N", "hist", "soft", "circle", "grid_n", "e_ic", "e_r1",
                "e_r2", "e_hull", "steps", "ring")
_NCNT = 16                # the kernels' device counters
_CNT_STEPS = 4            # the steps taken (forward)
_CNT_BARRIERS = 6         # the grid barriers passed
# the last call of each kernel: {"kernels": launched, "grid": blocks,
# "blocks_per_sm": resident blocks a SM, "counters": the call's device
# counters (int32, _NCNT)}
last_launch = {}


@dataclasses.dataclass
class SplitTraceArgs:
    """One trace of the global engine as its kernels take it: the packed
    tables (:func:`.trace_vector.pack_tables`, component-major; the
    differentiable inputs), the design's geometry flattened
    (:func:`pack_geometry`) with its region grid, the launch rays' fields
    (x, y, ter, tei, tmr, tmi) with their table cells, and the knobs."""
    rec: torch.Tensor          # (26, C * R2)
    cell: torch.Tensor         # (26, C)
    dirs: torch.Tensor         # (6, C * 4)
    geom: torch.Tensor         # (len(GEOM_SCALARS) + 3 * sum(edges),)
    grid: torch.Tensor         # (n, n) uint8 region codes
    rays: torch.Tensor         # (6, R) float32
    cid: torch.Tensor          # (R,) int32
    edges: tuple
    capacity: int
    weight_threshold: float
    fixed_steps: int           # > 0: exactly this many steps, no stop test
    max_steps: int
    soft_binning: bool
    eyebox_bins: tuple
    num_fc: int
    num_oc: int
    circle: bool
    L: int
    M: int
    N: int

    @property
    def hist_size(self) -> int:
        ny, nx = self.eyebox_bins
        return self.L * self.N * self.M * ny * nx

    def to(self, device) -> "SplitTraceArgs":
        """The same trace with its tensors on ``device``."""
        return dataclasses.replace(self, **{
            f.name: getattr(self, f.name).to(device)
            for f in dataclasses.fields(self)
            if torch.is_tensor(getattr(self, f.name))})


@dataclasses.dataclass
class SplitTape:
    """The wavefront kept after each step, all the backward needs:
    ``fields`` (steps + 1, 13, K) float32, row t the buffer that step t
    sweeps (row 0: the launch rays' kept children), each slot's 11 fields
    as a kernel buffer holds them, its table cell and its provenance
    ``src``: its index among the children of the step before (child A of
    slot s at s, child B at width + s; of launch ray r, A at r and B at
    R + r); ``widths`` (steps + 1,) int32, the live slots of each row (the
    rest of a row is unspecified)."""
    fields: torch.Tensor
    widths: torch.Tensor


@dataclasses.dataclass
class SplitTraceOut:
    """``hist`` (hist_size,), the ``trunc`` and ``pruned`` ledgers (0-d),
    the ``steps`` taken and, when asked for, the :class:`SplitTape`."""
    hist: torch.Tensor
    trunc: torch.Tensor
    pruned: torch.Tensor
    steps: int
    tape: Optional[SplitTape] = None


def _tape_row(buf: dict, src: torch.Tensor, K: int) -> torch.Tensor:
    """One tape row (13, K) of a kept buffer and its provenance."""
    width = src.shape[0]
    row = torch.zeros((_NT, K), dtype=torch.float32, device=src.device)
    for f, k in enumerate(_TAPE_FLOATS):
        row[f, :width] = buf[k].detach()
    row[_T_ST, :width] = buf["state"].to(torch.int32).view(torch.float32)
    row[_T_W, :width] = buf["w"].detach()
    row[_T_CID, :width] = buf["cid"].to(torch.int32).view(torch.float32)
    row[_T_SRC, :width] = src.to(torch.int32).view(torch.float32)
    return row


def tape_buffer(row: torch.Tensor, width: int) -> dict:
    """The wavefront buffer of one tape row, as the step functions take it
    (with ``src``, the provenance)."""
    buf = {k: row[f, :width] for f, k in enumerate(_TAPE_FLOATS)}
    buf["state"] = row[_T_ST, :width].view(torch.int32)
    buf["w"] = row[_T_W, :width]
    buf["cid"] = row[_T_CID, :width].view(torch.int32).to(torch.int64)
    buf["src"] = row[_T_SRC, :width].view(torch.int32).to(torch.int64)
    return buf


def _trace_setup(a: SplitTraceArgs):
    """(geometry dict, its broadcast scalars, the step functions, tables)
    of ``a``'s trace."""
    ny, nx = a.eyebox_bins
    G = unpack_geometry(a.geom, a.grid, a.edges)
    S = _col(G, 1, 1)
    cfg = TraceConfig(eyebox_bins=(ny, nx),
                      ic_test="circle" if a.circle else "polygon")
    fns = _build_step_fns(
        cfg, n_cells_mn=a.M * a.N, M=a.M, N=a.N, num_fc=a.num_fc,
        num_oc=a.num_oc, weight_threshold=a.weight_threshold,
        soft_binning=a.soft_binning)
    return G, S, fns, {"rec": a.rec, "cell": a.cell, "dirs": a.dirs}


def split_trace_reference(a: SplitTraceArgs,
                          keep_tape: bool = False) -> SplitTraceOut:
    """The plain PyTorch version of the forward kernel: the eager step loop
    of the global wavefront, on ``a``'s device.  After every step the
    children are compacted by a stable sort on their aliveness (heaviest
    first) into at most ``capacity`` slots; the overflow goes to the
    truncated ledger.  The buffer holds only its live slots, whose count is
    read from the device once a step.  Every bin adds its deposits one by
    one in slot order (:func:`_accumulate_in_order`; soft binning: four
    rounds, one per corner), as the kernel does, on either device.  Its
    operations are differentiable by autograd; ``keep_tape`` also returns
    the :class:`SplitTape` the hand-written backward reads."""
    ny, nx = a.eyebox_bins
    K = a.capacity
    G, S, (split_init, split_step, deposit), T = _trace_setup(a)
    hist_size = a.hist_size
    rows, widths = [], []

    def compact(children: dict):
        """Keep the ``K`` heaviest live slots (a stable sort), as a buffer
        of just the live ones kept: ``(buffer, dropped weight, its
        width)``; the width is read from the device."""
        alive = children["state"] < DEAD
        aliveness = torch.where(alive, children["w"], -1.0)
        order = torch.argsort(-aliveness, stable=True)
        width = min(K, int(alive.sum()))
        kept = {k: v[order[:width]] for k, v in children.items()}
        rest = order[K:]
        dropped = torch.where(alive[rest], children["w"][rest], 0.0).sum()
        if keep_tape:
            rows.append(_tape_row(kept, order[:width], K))
            widths.append(width)
        return kept, dropped, width

    r0 = {k: a.rays[i] for i, k in enumerate(("x", "y", "ter", "tei", "tmr",
                                              "tmi"))}
    r0["cid"] = a.cid.to(torch.int64)
    w0 = r0["ter"].abs() + r0["tei"].abs() + r0["tmr"].abs() + r0["tmi"].abs()
    r0["w"] = torch.where(w0 > 0, 1.0, 0.0).to(w0.dtype)
    kids, pruned = split_init(T, S, G, r0["cid"], r0)
    children = {k: torch.cat([kids[0][k], kids[1][k]]) for k in _KEYS}
    buf, trunc, width = compact(children)
    hist = torch.zeros(hist_size + K, dtype=w0.dtype, device=w0.device)

    def body(buf, trunc, pruned):
        ch_a, ch_b, dep_w, pr = split_step(T, S, G, buf["cid"], buf)
        deposit(T, hist, hist_size, buf["cid"], buf["cid"], buf["x"],
                buf["y"], dep_w)
        children = {k: torch.cat([ch_a[k], ch_b[k]]) for k in _KEYS}
        buf, dropped, width = compact(children)
        return buf, trunc + dropped, pruned + pr, width

    # the buffer holds only its live slots: a dead slot has no children
    # and deposits nothing, so stepping it would change no result
    it = 0
    if a.fixed_steps > 0:
        for it in range(1, a.fixed_steps + 1):
            buf, trunc, pruned, width = body(buf, trunc, pruned)
    else:
        while it < a.max_steps and width > 0:
            buf, trunc, pruned, width = body(buf, trunc, pruned)
            it += 1
    tape = None
    if keep_tape:
        tape = SplitTape(torch.stack(rows), torch.tensor(
            widths, dtype=torch.int32, device=hist.device))
    return SplitTraceOut(hist[:hist_size], trunc, pruned, it, tape)


def _add_rows(table: torch.Tensor, idx: torch.Tensor,
              rows: torch.Tensor) -> None:
    """``table[idx[i]] += rows[i]`` for i in order, in place: every entry
    adds its rows one by one in that order on any device (on the card in
    rounds of distinct entries, round r holding each entry's r-th row)."""
    if table.device.type == "cpu":
        table.index_add_(0, idx, rows)
        return
    if not idx.numel():
        return
    entries, order = torch.sort(idx, stable=True)
    vals = rows[order]
    pos = torch.arange(entries.numel(), device=entries.device)
    first = torch.ones_like(entries, dtype=torch.bool)
    first[1:] = entries[1:] != entries[:-1]
    rank = pos - torch.cummax(torch.where(first, pos, 0), 0).values
    for r in range(int(rank.max()) + 1):
        m = rank == r
        table.index_add_(0, entries[m], vals[m])


def _div(v: torch.Tensor, n: int) -> torch.Tensor:
    """``v / n`` divided by a tensor (torch on the card multiplies by the
    reciprocal of a Python scalar divisor; the kernel divides)."""
    return v / torch.full_like(v, n)


def _jones_adjoint(j, pol, d):
    """The adjoint of :func:`.trace_vector._jones_apply`: given the output's
    adjoint ``d`` (4), the adjoints of the matrix ``j`` (8) and of the
    input polarisation ``pol`` (4)."""
    ter, tei, tmr, tmi = pol
    d0, d1, d2, d3 = d
    dj = (d0 * ter + d1 * tei, d1 * ter - d0 * tei,
          d0 * tmr + d1 * tmi, d1 * tmr - d0 * tmi,
          d2 * ter + d3 * tei, d3 * ter - d2 * tei,
          d2 * tmr + d3 * tmi, d3 * tmr - d2 * tmi)
    dpol = (d0 * j[0] + d1 * j[1] + d2 * j[4] + d3 * j[5],
            d1 * j[0] - d0 * j[1] + d3 * j[4] - d2 * j[5],
            d0 * j[2] + d1 * j[3] + d2 * j[6] + d3 * j[7],
            d1 * j[2] - d0 * j[3] + d3 * j[6] - d2 * j[7])
    return dj, dpol


def _branch_adjoint(bp, pw, D, lam, w, inv_cos, s):
    """The adjoint of one child of a transport (``child`` of
    :func:`_build_step_fns`, and ``split_init``'s children): ``bp`` its
    polarisation before renormalisation, ``pw`` its power, ``D`` its
    direction row (6), ``lam`` the child's adjoint (:data:`_ADJ`), ``w`` the
    parent's weight, ``s`` the efficiency's scale; the efficiency is
    ``pw * s * inv_cos``.  Returns (the direction row's adjoint (4), the
    polarisation's (4), the scale's share through the efficiency, the
    adjoint of ``inv_cos``, the weight's)."""
    lx, ly, lter, ltei, ltmr, ltmi, _, lgx, lgy, lw = lam
    pos = pw > 1e-30
    inv = _rsqrt(torch.where(pos, pw, 1.0))
    q2 = bp[2] * inv
    q3 = bp[3] * inv
    dD = (lx + lgx, ly + lgy, ltmr * q2 + ltmi * q3, ltmi * q2 - ltmr * q3)
    dq2 = ltmr * D[2] + ltmi * D[3]
    dq3 = ltmi * D[2] - ltmr * D[3]
    dinv = lter * bp[0] + ltei * bp[1] + dq2 * bp[2] + dq3 * bp[3]
    dpw = torch.where(pos, dinv * -0.5 * inv * inv * inv, 0.0)
    d_eff = lw * w
    dps = d_eff * inv_cos
    dpw = dpw + dps * s
    d_s = dps * pw
    d_ic = d_eff * (pw * s)
    dbp = (lter * inv + (bp[0] + bp[0]) * dpw,
           ltei * inv + (bp[1] + bp[1]) * dpw,
           dq2 * inv + (bp[2] + bp[2]) * dpw,
           dq3 * inv + (bp[3] + bp[3]) * dpw)
    return dD, dbp, d_s, d_ic


def _step_adjoint(a: SplitTraceArgs, T: dict, G: dict, S: dict, buf: dict,
                  lam_a, lam_b, gh: torch.Tensor):
    """The adjoint of one step of the plain forward over the buffer
    ``buf``: its decisions and values recomputed with the forward's
    operations, then the chain rule written out.  ``lam_a`` / ``lam_b``
    (10, n) are the adjoints of each slot's child A (or survivor) and child
    B, zero where that child was not kept; ``gh`` the histogram's adjoint.
    Returns (the slots' adjoints (10, n), the table contributions: (rec
    entries, (n, 26)), (cells, (n, 26)), (direction entries (3n,),
    (3n, 6)))."""
    ny, nx = a.eyebox_bins
    R2 = 2 * (1 + a.num_fc + a.num_oc)
    n_mn = a.M * a.N
    x, y, state, w, g = buf["x"], buf["y"], buf["state"], buf["w"], buf["cid"]
    in_r1, in_hull, in_r2 = regions_inside(G, x, y, state < DEAD)
    alive = (state < DEAD) & in_r1
    grp_ic, grp_fc, grp_oc, in_rect, key = site_key(
        S, x, y, state, alive, in_hull, a.num_fc, a.num_oc)
    hit_fc = grp_fc & in_hull
    hit_oc = grp_oc & in_rect
    interact = grp_ic | hit_fc | hit_oc
    rec_idx = g * R2 + key
    rec = _take(T["rec"], rec_idx)
    pol = (buf["ter"], buf["tei"], buf["tmr"], buf["tmi"])
    s_a, s_b = rec[24], rec[25]
    pol_a = _jones_apply(rec[0:8], *pol)
    pol_b = _jones_apply(rec[8:16], *pol)
    pol_c = _jones_apply(rec[16:24], *pol)
    cpos = buf["cos_th"] > 0
    inv_cos = 1.0 / torch.where(cpos, buf["cos_th"], 1.0)
    pw_a, pw_b, pw_c = _power(*pol_a), _power(*pol_b), _power(*pol_c)
    eff_a = pw_a * s_a * inv_cos
    eff_b = pw_b * s_b * inv_cos
    s_c = _take(T["cell"][_C_SOUT:_C_SOUT + 1], g)[0]
    eff_c = pw_c * s_c * inv_cos
    dep = torch.where(hit_oc, w * eff_c, 0.0)
    miss_fc2 = grp_fc & ~in_hull & (state == 2)
    miss_fc3 = grp_fc & ~in_hull & (state == 3)
    hop = (miss_fc2 | (miss_fc3 & in_r2)
           | (grp_oc & ~in_rect & (state == 4)))
    not_int = alive & ~interact
    dir_a = torch.where(grp_oc, DIR_FC, DIR_IC)
    dir_b = torch.where(grp_ic, DIR_IC2, torch.where(grp_fc, DIR_FC, DIR_OC))
    hop_dir = torch.where(miss_fc2, DIR_IC, DIR_FC)
    z = torch.zeros_like(x)
    # child A's adjoint is the survivor's where the slot does not interact
    lam_c = [torch.where(interact, v, z) for v in lam_a]
    lam_s = [torch.where(not_int, v, z) for v in lam_a]
    lam_b = [torch.where(interact, v, z) for v in lam_b]

    # the deposit's adjoint, hard: the bin's; soft: the four corners'
    ebr = _take(T["cell"][_C_EBR:_C_EBR + 4], g)
    mn = g % n_mn
    base = ((g // n_mn * a.N + mn % a.N) * a.M + mn // a.N) * (ny * nx)
    d_e = [z, z, z, z]
    d_xd = d_yd = z
    if not a.soft_binning:
        in_quad, b = deposit_bin(ebr, x, y, ny, nx)
        use = in_quad & (dep != 0)
        d_dep = torch.where(use, gh[torch.where(use, base + b, 0)], 0.0)
    else:
        e0, e1, e2, e3 = ebr.unbind(0)
        in_quad = ((x >= e0 - _EDGE_TOL) & (x <= e1 + _EDGE_TOL)
                   & (y >= e2 - _EDGE_TOL) & (y <= e3 + _EDGE_TOL))
        wq = torch.where(in_quad, dep, 0.0)
        dxb = _div(e1 - e0, nx)
        dyb = _div(e3 - e2, ny)
        qx = (x - e0) / dxb
        qy = (y - e2) / dyb
        pu = qx - 0.5
        pv = qy - 0.5
        u = torch.clamp(pu, 0.0, nx - 1.0)
        v = torch.clamp(pv, 0.0, ny - 1.0)
        ix0 = torch.clamp(torch.floor(u), 0, nx - 2).to(torch.int64)
        iy0 = torch.clamp(torch.floor(v), 0, ny - 2).to(torch.int64)
        fx = u - ix0
        fy = v - iy0
        ax = 1 - fx
        ay = 1 - fy
        wf = (ax * ay, fx * ay, ax * fy, fx * fy)
        gk = [torch.where(wq * f != 0, gh[base + (iy0 + dj) * nx + ix0 + di],
                          0.0)
              for (di, dj), f in zip(((0, 0), (1, 0), (0, 1), (1, 1)), wf)]
        d_wq = gk[0] * wf[0] + gk[1] * wf[1] + gk[2] * wf[2] + gk[3] * wf[3]
        dwf = [c * wq for c in gk]
        d_ax = dwf[0] * ay + dwf[2] * fy
        d_ay = dwf[0] * ax + dwf[1] * fx
        d_fx = dwf[1] * ay + dwf[3] * fy - d_ax
        d_fy = dwf[2] * ax + dwf[3] * fx - d_ay
        d_u = torch.where((pu >= 0) & (pu <= nx - 1), d_fx, 0.0)
        d_v = torch.where((pv >= 0) & (pv <= ny - 1), d_fy, 0.0)
        d_xd = d_u / dxb
        d_yd = d_v / dyb
        d_spx = _div(-(d_u * qx) / dxb, nx)
        d_spy = _div(-(d_v * qy) / dyb, ny)
        d_e = [-d_xd - d_spx, d_spx, -d_yd - d_spy, d_spy]
        d_dep = torch.where(in_quad, d_wq, 0.0)
    d_dep = torch.where(hit_oc, d_dep, 0.0)

    Da = _take(T["dirs"], g * 4 + dir_a)
    Db = _take(T["dirs"], g * 4 + dir_b)
    dDa, dbpa, dsa, dica = _branch_adjoint(pol_a, pw_a, Da, lam_c, w,
                                           inv_cos, s_a)
    dDb, dbpb, dsb, dicb = _branch_adjoint(pol_b, pw_b, Db, lam_b, w,
                                           inv_cos, s_b)
    # the deposit: dep = w * eff_c
    d_effc = d_dep * w
    dpcs = d_effc * inv_cos
    dpwc = dpcs * s_c
    d_sc = dpcs * pw_c
    dicc = d_effc * (pw_c * s_c)
    dbpc = tuple((p + p) * dpwc for p in pol_c)
    dja, dpa = _jones_adjoint(rec[0:8], pol, dbpa)
    djb, dpb = _jones_adjoint(rec[8:16], pol, dbpb)
    djc, dpc = _jones_adjoint(rec[16:24], pol, dbpc)
    d_ic = dica + dicb + dicc
    d_cos = torch.where(cpos, -(d_ic * inv_cos * inv_cos), 0.0)
    # the survivor: a hop adds the gap and turns the TM phase
    hd = _take(T["dirs"][4:6], g * 4 + hop_dir)
    sx, sy, ster, stei, stmr, stmi, scos, sgx, sgy, sw = lam_s
    tmr, tmi = buf["tmr"], buf["tmi"]
    s_tmr = torch.where(hop, stmr * hd[0] + stmi * hd[1], stmr)
    s_tmi = torch.where(hop, stmi * hd[0] - stmr * hd[1], stmi)
    dH = (torch.where(hop, stmr * tmr + stmi * tmi, 0.0),
          torch.where(hop, stmi * tmr - stmr * tmi, 0.0))
    lam = torch.stack([
        lam_c[0] + lam_b[0] + sx + d_xd,
        lam_c[1] + lam_b[1] + sy + d_yd,
        dpa[0] + dpb[0] + dpc[0] + ster,
        dpa[1] + dpb[1] + dpc[1] + stei,
        dpa[2] + dpb[2] + dpc[2] + s_tmr,
        dpa[3] + dpb[3] + dpc[3] + s_tmi,
        d_cos + scos,
        torch.where(hop, sx, 0.0) + sgx,
        torch.where(hop, sy, 0.0) + sgy,
        lam_c[9] * eff_a + lam_b[9] * eff_b + d_dep * eff_c + sw])
    c_rec = torch.stack([*dja, *djb, *djc, lam_c[6] + dsa, lam_b[6] + dsb])
    c_cell = torch.stack([z] * _C_SOUT + [d_sc, *d_e])
    c_dirs = torch.cat([torch.stack([*dDa, z, z]), torch.stack([*dDb, z, z]),
                        torch.stack([z, z, z, z, *dH])], dim=1)
    dir_idx = torch.cat([g * 4 + dir_a, g * 4 + dir_b, g * 4 + hop_dir])
    return lam, (rec_idx, c_rec.T), (g, c_cell.T), (dir_idx, c_dirs.T)


def _init_adjoint(a: SplitTraceArgs, T: dict, lam: torch.Tensor):
    """The adjoint of ``split_init`` given its children's adjoints ``lam``
    (10, 2R) (child A of ray r at r, B at R + r): the table contributions
    ((cells (2R,), (2R, 26)), (direction entries (2R,), (2R, 6)))."""
    R = a.rays.shape[1]
    g = a.cid.to(torch.int64)
    cell = _take(T["cell"], g)
    pol0 = tuple(a.rays[2:6])
    w0 = pol0[0].abs() + pol0[1].abs() + pol0[2].abs() + pol0[3].abs()
    w = torch.where(w0 > 0, 1.0, 0.0).to(w0.dtype)
    z = torch.zeros_like(w)
    c_cell, c_dirs, dir_idx = [], [], []
    for branch, dir_ in ((0, DIR_IC), (1, DIR_IC2)):
        jo, so, ico = ((_I_JA, _I_SA, _I_ICA) if branch == 0
                       else (_I_JB, _I_SB, _I_ICB))
        lb = lam[:, branch * R:(branch + 1) * R]
        p = _jones_apply(cell[jo:jo + 8], *pol0)
        pw = _power(*p)
        eff = pw * cell[so] / cell[_I_COS0]
        D = _take(T["dirs"], g * 4 + dir_)
        lx, ly, lter, ltei, ltmr, ltmi, lcos, lgx, lgy, lw = lb
        pos = pw > 1e-30
        inv = _rsqrt(torch.where(pos, pw, 1.0))
        q2 = p[2] * inv
        q3 = p[3] * inv
        dD = (lx + lgx, ly + lgy, ltmr * q2 + ltmi * q3, ltmi * q2 - ltmr * q3)
        dq2 = ltmr * D[2] + ltmi * D[3]
        dq3 = ltmi * D[2] - ltmr * D[3]
        dinv = lter * p[0] + ltei * p[1] + dq2 * p[2] + dq3 * p[3]
        dpw = torch.where(pos, dinv * -0.5 * inv * inv * inv, 0.0)
        d_eff = lw * w
        d_num = d_eff / cell[_I_COS0]
        d_c0 = -(d_eff * eff) / cell[_I_COS0]
        dpw = dpw + d_num * cell[so]
        d_so = d_num * pw
        dp = (lter * inv + (p[0] + p[0]) * dpw,
              ltei * inv + (p[1] + p[1]) * dpw,
              dq2 * inv + (p[2] + p[2]) * dpw,
              dq3 * inv + (p[3] + p[3]) * dpw)
        dj, _ = _jones_adjoint(cell[jo:jo + 8], pol0, dp)
        c = [z] * 26
        c[jo:jo + 8] = dj
        c[so] = d_so
        c[_I_COS0] = d_c0
        c[ico] = lcos
        c_cell.append(torch.stack(c))
        c_dirs.append(torch.stack([*dD, z, z]))
        dir_idx.append(g * 4 + dir_)
    return ((torch.cat([g, g]), torch.cat(c_cell, dim=1).T),
            (torch.cat(dir_idx), torch.cat(c_dirs, dim=1).T))


def split_trace_backward_reference(a: SplitTraceArgs, tape: SplitTape,
                                   grad_hist: torch.Tensor) -> tuple:
    """The plain PyTorch version of the backward kernel: the adjoint of
    :func:`split_trace_reference` written out by hand, an explicit reverse
    sweep over ``tape`` (not autograd).  Each step's adjoint recomputes the
    step's decisions and values from its tape row; its children's adjoints
    come from the next row through the provenance.  Discrete choices carry
    no gradient (region tests, the threshold, the sort's order, the bins).
    The table gradients are added per table entry in a fixed order: steps
    from last to first, then the launch rays, within a step the slots in
    order (directions: the A children, the B children, the hops).  Returns
    ``(d_rec, d_cell, d_dirs)``, shaped as ``a.rec``, ``a.cell``,
    ``a.dirs``."""
    dev, dt = a.rec.device, a.rec.dtype
    G, S, _, T = _trace_setup(a)
    gh = grad_hist.reshape(-1).to(dt)
    widths = [int(v) for v in tape.widths.tolist()]
    d_rec = torch.zeros((a.rec.shape[1], REC_W), dtype=dt, device=dev)
    d_cell = torch.zeros((a.cell.shape[1], a.cell.shape[0]), dtype=dt,
                         device=dev)
    d_dirs = torch.zeros((a.dirs.shape[1], DIR_W), dtype=dt, device=dev)
    lam, src = None, None
    for t in range(len(widths) - 2, -1, -1):
        n = widths[t]
        lc = torch.zeros((len(_ADJ), 2 * n), dtype=dt, device=dev)
        if lam is not None:
            lc[:, src] = lam
        buf = tape_buffer(tape.fields[t], n)
        lam, *contribs = _step_adjoint(a, T, G, S, buf, lc[:, :n],
                                       lc[:, n:], gh)
        src = buf["src"]
        for table, (idx, rows) in zip((d_rec, d_cell, d_dirs), contribs):
            _add_rows(table, idx, rows)
    lc = torch.zeros((len(_ADJ), 2 * a.rays.shape[1]), dtype=dt, device=dev)
    if lam is not None:
        lc[:, src] = lam
    for table, (idx, rows) in zip((d_cell, d_dirs), _init_adjoint(a, T, lc)):
        _add_rows(table, idx, rows)
    return d_rec.T.contiguous(), d_cell.T.contiguous(), d_dirs.T.contiguous()


def _trace_params(a: SplitTraceArgs, **kw):
    """The int parameters of the kernels' C functions (:data:`TRACE_PARAMS`)."""
    ny, nx = a.eyebox_bins
    v = dict(R=a.rays.shape[1], K=a.capacity, E=a.rec.shape[1],
             C=a.cell.shape[1], R2=2 * (1 + a.num_fc + a.num_oc),
             num_fc=a.num_fc, num_oc=a.num_oc, ny=ny, nx=nx, M=a.M, N=a.N,
             hist=a.hist_size, soft=int(a.soft_binning), circle=int(a.circle),
             grid_n=a.grid.shape[0], e_ic=a.edges[0], e_r1=a.edges[1],
             e_r2=a.edges[2], e_hull=a.edges[3], steps=0, ring=0)
    v.update(kw)
    return (ctypes.c_int * len(TRACE_PARAMS))(*(int(v[k])
                                                for k in TRACE_PARAMS))


def _launched(lib, what: str, err: int, info, counters) -> None:
    """Raise if the kernel was refused; else count it (its launches under
    ``<what>_kernels``) and keep :data:`last_launch`."""
    if err != 0:
        msg = lib.split_trace_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")
    launch_counts[what] += 1
    launch_counts[f"{what}_kernels"] += info[0]
    last_launch[what] = {"kernels": info[0], "grid": info[1],
                         "blocks_per_sm": info[2], "counters": counters}


def _check_trace_args(a: SplitTraceArgs, what: str):
    dev = a.rec.device
    if dev.type != "cuda":
        raise ValueError(f"the {what} kernel runs on cuda, not {dev}")
    for name in ("rec", "cell", "dirs", "geom", "rays"):
        t = getattr(a, name)
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if a.grid.device != dev or a.grid.dtype != torch.uint8:
        raise ValueError("the region grid must be uint8 on the card")
    if a.cid.device != dev:
        raise ValueError(f"cid must be on {dev}")
    if not a.weight_threshold >= 0:
        raise ValueError("the kernels take a weight threshold >= 0 (live "
                         "weights are then positive)")
    return dev


def _tables_entry_major(a: SplitTraceArgs) -> tuple:
    """The packed tables entry-major, as the kernels read them: (C * R2, 26),
    (C, 26), (C * 4, 6)."""
    return tuple(t.detach().t().contiguous() for t in (a.rec, a.cell, a.dirs))


def _ptrs(*ts) -> list:
    return [t.data_ptr() for t in ts]


def launch_split_trace(a: SplitTraceArgs,
                       keep_tape: bool = False) -> SplitTraceOut:
    """The forward kernel on ``a``'s CUDA tensors, queued on the current
    stream: one cooperative kernel runs the whole trace and decides the stop
    test on the card.  ``fixed_steps`` mode reads nothing from the device;
    stop-test mode reads the step count once, at the end.  With
    ``keep_tape`` every step's kept wavefront stays in the tape (one row a
    step), else two rows take turns.  Raises if the launch is refused."""
    dev = _check_trace_args(a, "split_trace")
    lib = load_trace_kernel()
    K = a.capacity
    steps_max = a.fixed_steps if a.fixed_steps > 0 else a.max_steps
    recT, cellT, dirsT = _tables_entry_major(a)
    cid = a.cid.to(torch.int32).contiguous()
    rays = a.rays.contiguous()
    tape = torch.empty((steps_max + 1 if keep_tape else 2, _NT, K),
                       dtype=torch.float32, device=dev)
    ints = torch.zeros(_NCNT + steps_max + 1, dtype=torch.int32, device=dev)
    widths = ints[_NCNT:]
    hist = torch.zeros(a.hist_size, dtype=torch.float32, device=dev)
    ledger = torch.zeros(2, dtype=torch.float32, device=dev)
    p = _trace_params(a, steps=steps_max, ring=int(not keep_tape))
    scratch = torch.empty(lib.split_trace_scratch_bytes(p, 0),
                          dtype=torch.uint8, device=dev)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.split_trace_forward(
            p, float(np.float32(a.weight_threshold)),
            *_ptrs(recT, cellT, dirsT, a.geom, a.grid, rays, cid, tape,
                   widths, hist, ledger, ints, scratch), info, stream)
    _launched(lib, "split_trace", err, info, ints[:_NCNT])
    steps = (a.fixed_steps if a.fixed_steps > 0
             else int(ints[_CNT_STEPS]))
    out = SplitTraceOut(hist, ledger[0], ledger[1], steps)
    if keep_tape:
        out.tape = SplitTape(tape[:steps + 1], widths[:steps + 1])
    return out


def launch_split_trace_backward(a: SplitTraceArgs, tape: SplitTape,
                                grad_hist: torch.Tensor) -> tuple:
    """The backward kernel on ``a``'s CUDA tensors and ``tape``, queued on
    the current stream (one cooperative kernel, no read of the device):
    ``(d_rec, d_cell, d_dirs)`` shaped as ``a``'s tables.  Raises if the
    launch is refused."""
    dev = _check_trace_args(a, "split_trace_backward")
    lib = load_trace_kernel()
    recT, cellT, dirsT = _tables_entry_major(a)
    fields = tape.fields.contiguous()
    widths = tape.widths.to(dev, torch.int32).contiguous()
    if fields.device != dev or fields.shape[1:] != (_NT, a.capacity):
        raise ValueError(f"the tape must be (steps + 1, {_NT}, "
                         f"{a.capacity}) on {dev}")
    gh = grad_hist.reshape(-1).to(torch.float32).contiguous()
    if gh.numel() != a.hist_size:
        raise ValueError(f"grad_hist holds {gh.numel()} bins, not "
                         f"{a.hist_size}")
    d = [torch.zeros_like(t) for t in (recT, cellT, dirsT)]
    ints = torch.zeros(_NCNT, dtype=torch.int32, device=dev)
    p = _trace_params(a, steps=fields.shape[0] - 1)
    scratch = torch.empty(lib.split_trace_scratch_bytes(p, 1),
                          dtype=torch.uint8, device=dev)
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.split_trace_backward(
            p, *_ptrs(recT, cellT, dirsT, a.geom, a.grid, a.rays.contiguous(),
                      a.cid.to(torch.int32).contiguous(), fields, widths, gh,
                      *d, ints, scratch), info, stream)
    _launched(lib, "split_trace_backward", err, info, ints)
    return tuple(t.t().contiguous() for t in d)


def split_trace(a: SplitTraceArgs, keep_tape: bool = False) -> SplitTraceOut:
    """One forward trace of the global engine: the kernels for CUDA
    tensors, the plain version for CPU ones (no fallback between them)."""
    dev = a.rec.device
    if dev.type == "cuda":
        return launch_split_trace(a, keep_tape)
    if dev.type != "cpu":
        raise ValueError(f"split_trace runs on cpu or cuda, not {dev}")
    return split_trace_reference(a, keep_tape)


def split_trace_backward(a: SplitTraceArgs, tape: SplitTape,
                         grad_hist: torch.Tensor) -> tuple:
    """The tables' adjoints of a forward trace: the backward kernels for
    CUDA tensors, the hand-written plain version for CPU ones."""
    dev = a.rec.device
    if dev.type == "cuda":
        return launch_split_trace_backward(a, tape, grad_hist)
    if dev.type != "cpu":
        raise ValueError(f"split_trace runs on cpu or cuda, not {dev}")
    return split_trace_backward_reference(a, tape, grad_hist)


class SplitTraceFunction(torch.autograd.Function):
    """The global trace as an autograd node: ``apply(rec, cell, dirs, args)
    -> (hist, trunc, pruned, steps)``, the histogram differentiable in the
    packed tables; the ledgers and the step count are not.  Both directions
    dispatch on the device (:func:`split_trace`,
    :func:`split_trace_backward`); the tape is kept only when a table
    needs a gradient."""

    @staticmethod
    def forward(ctx, rec, cell, dirs, args):
        a = dataclasses.replace(args, rec=rec, cell=cell, dirs=dirs)
        keep = any(ctx.needs_input_grad[:3])
        out = split_trace(a, keep_tape=keep)
        steps = torch.tensor(out.steps)
        ctx.mark_non_differentiable(out.trunc, out.pruned, steps)
        ctx.args, ctx.tape = (a, out.tape) if keep else (None, None)
        return out.hist, out.trunc, out.pruned, steps

    @staticmethod
    def backward(ctx, g_hist, g_trunc, g_pruned, g_steps):
        a = ctx.args
        if g_hist is None:
            g_hist = torch.zeros(a.hist_size, dtype=a.rec.dtype,
                                 device=a.rec.device)
        d_rec, d_cell, d_dirs = split_trace_backward(a, ctx.tape, g_hist)
        return d_rec, d_cell, d_dirs, None


# the C parameters of split_trace_forward: the int parameters, the
# threshold, 13 pointers, the launch info (int[3]) and the stream; of
# split_trace_backward: the int parameters, 15 pointers, the info and the
# stream
_INTS = ctypes.POINTER(ctypes.c_int)
_FORWARD_ARGTYPES = ([_INTS, ctypes.c_float] + [ctypes.c_void_p] * 13
                     + [_INTS, ctypes.c_void_p])
_BACKWARD_ARGTYPES = [_INTS] + [ctypes.c_void_p] * 15 + [_INTS,
                                                          ctypes.c_void_p]
_TRACE_LIB = None


def load_trace_kernel():
    """Build (at first use) and bind ``csrc/split_trace.cu``; raises with
    the compiler's output if the build fails."""
    global _TRACE_LIB
    if _TRACE_LIB is None:
        lib = build.load_library("split_trace")
        lib.split_trace_forward.argtypes = _FORWARD_ARGTYPES
        lib.split_trace_forward.restype = ctypes.c_int
        lib.split_trace_backward.argtypes = _BACKWARD_ARGTYPES
        lib.split_trace_backward.restype = ctypes.c_int
        lib.split_trace_scratch_bytes.argtypes = [
            ctypes.POINTER(ctypes.c_int), ctypes.c_int]
        lib.split_trace_scratch_bytes.restype = ctypes.c_size_t
        lib.split_trace_error_string.argtypes = [ctypes.c_int]
        lib.split_trace_error_string.restype = ctypes.c_char_p
        _TRACE_LIB = lib
    return _TRACE_LIB


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
# the C parameters of split_cells_launch, in order: 14 pointers, 17 ints,
# the threshold, the cluster size and the stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 14 + [ctypes.c_int] * 17
                   + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
CLUSTER_SIZES = (1, 2, 4)


@dataclasses.dataclass
class SplitCellsArgs:
    """One chunk of the per-cell engine as the kernel takes it: the chunk's
    packed tables (:func:`.trace_vector.pack_tables` of the chunk's cells),
    the design's geometry flattened (:func:`pack_geometry`) and its region
    grid, and the launch seeds as one float32 tensor, (6, P) shared by every
    cell or (6, C, P), in :data:`.seeding.FIELDS` order.  The kernel reads
    the region grid refined where it is open
    (:func:`.trace_vector.region_subgrids`: ``fine``, ``sub_codes``); the
    plain version reads ``grid``."""
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
    fine: torch.Tensor         # (n, n) int16 codes or -(subgrid row + 1)
    sub_codes: torch.Tensor    # (M, sub, sub) uint8 subcell codes

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
                     max_steps: int, subgrids: tuple) -> SplitCellsArgs:
    """The kernel's arguments of one chunk: ``Tc`` the chunk's packed
    tables, ``packed`` the design's geometry with its grid as
    :func:`pack_geometry` gives it, ``seeds`` (6, P) or (6, C, P),
    ``subgrids`` the grid refined (:func:`.trace_vector.region_subgrids`),
    all on one device."""
    geom, grid, edges = packed
    fine, sub_codes = subgrids
    C = Tc["cell"].shape[1]
    return SplitCellsArgs(
        rec=Tc["rec"].contiguous(), cell=Tc["cell"].contiguous(),
        dirs=Tc["dirs"].contiguous(), geom=geom, grid=grid,
        seeds=seeds.float().contiguous(), edges=edges, C=C,
        P=seeds.shape[-1], capacity=int(capacity),
        weight_threshold=float(weight_threshold), max_steps=int(max_steps),
        num_fc=num_fc, num_oc=num_oc, eyebox_bins=tuple(cfg.eyebox_bins),
        circle=cfg.ic_test == "circle", fine=fine, sub_codes=sub_codes)


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


def cluster_size(cells: int, capacity: int, threads: int, sms: int,
                 blocks_per_sm: int) -> int:
    """The blocks that share each cell of a chunk of ``cells`` cells of
    ``capacity`` slots: the largest of :data:`CLUSTER_SIZES` whose pass
    (``q * threads`` slots) fits in the capacity and whose ``cells * q``
    blocks fill at most two waves of a card of ``sms`` SMs holding
    ``blocks_per_sm`` blocks each.  A cell's time is its steps times its
    passes, so a chunk smaller than the card spreads each cell's passes over
    several SMs; a large one keeps a cell to a block.  Shape alone decides,
    and a cell's outputs do not depend on it."""
    for q in sorted(CLUSTER_SIZES, reverse=True):
        if q == 1 or (q * threads <= capacity
                      and cells * q <= 2 * blocks_per_sm * sms):
            return q
    return 1


_SHAPES = {}


def split_cells_shape(ny: int, nx: int, R2: int, edges: tuple) -> dict:
    """The kernel's launch shapes on the current card for a chunk's tile
    and tables: ``{"threads", "sms", q: {"blocks_per_sm", "clusters",
    "resident", "smem", "registers", "local_bytes"}}`` for each cluster size
    q (``resident``: the blocks of clusters of q resident at once;
    ``local_bytes``: a thread's local memory, spills included), from the
    runtime's function attributes and occupancy calculator (cached per
    shape)."""
    key = (torch.cuda.current_device(), ny, nx, R2, sum(edges))
    if key not in _SHAPES:
        lib = load_kernel()
        out = (ctypes.c_int * 17)()
        err = lib.split_cells_shape(ny, nx, R2, sum(edges), out)
        if err != 0:
            msg = lib.split_cells_error_string(err).decode()
            raise RuntimeError(f"split_cells_shape failed: {msg} ({err})")
        shape = {"threads": out[15], "sms": out[16]}
        for k, q in enumerate(CLUSTER_SIZES):
            row = out[5 * k:5 * k + 5]
            shape[q] = {"blocks_per_sm": row[0], "clusters": row[1],
                        "resident": row[1] * q, "smem": row[2],
                        "registers": row[3], "local_bytes": row[4]}
        _SHAPES[key] = shape
    return _SHAPES[key]


def launch_split_cells(a: SplitCellsArgs, cluster: Optional[int] = None
                       ) -> SplitCellsOut:
    """The kernel on ``a``'s CUDA tensors: one launch for the chunk, queued
    on the current stream (no host read), each cell on a cluster of
    ``cluster`` blocks (default :func:`cluster_size` of the chunk; the
    outputs are the same at every size).  Raises if the launch is refused,
    e.g. for a tile too large for the card's shared memory."""
    dev = a.rec.device
    if dev.type != "cuda":
        raise ValueError(f"the split_cells kernel runs on cuda, not {dev}")
    for name in ("rec", "cell", "dirs", "geom", "seeds"):
        t = getattr(a, name)
        if t.device != dev or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 on {dev}, got "
                             f"{t.dtype} on {t.device}")
    if (a.fine.device != dev or a.fine.dtype != torch.int16
            or a.sub_codes.device != dev or a.sub_codes.dtype != torch.uint8
            or a.sub_codes.dim() != 3 or len(a.sub_codes) < 1
            or a.fine.shape != a.grid.shape):
        raise ValueError("the refined region grid must be int16 (n, n) and "
                         "uint8 (M >= 1, sub, sub) on the card")
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
    R2 = 2 * (1 + a.num_fc + a.num_oc)
    buf = torch.empty((C, 4, _NF, K), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        shape = split_cells_shape(ny, nx, R2, a.edges)
        q = cluster or cluster_size(C, K, shape["threads"], shape["sms"],
                                    shape[1]["blocks_per_sm"])
        if q not in CLUSTER_SIZES:
            raise ValueError(f"cluster size {q} is not one of "
                             f"{CLUSTER_SIZES}")
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.split_cells_launch(
            a.rec.data_ptr(), a.cell.data_ptr(), a.dirs.data_ptr(),
            a.geom.data_ptr(), a.fine.data_ptr(), a.sub_codes.data_ptr(),
            a.seeds.data_ptr(), buf.data_ptr(), out.tiles.data_ptr(),
            out.trunc.data_ptr(), out.pruned.data_ptr(), out.peak.data_ptr(),
            out.steps.data_ptr(), out.work.data_ptr(), C, a.P, K, R2,
            a.num_fc, a.num_oc, ny, nx, a.max_steps, int(a.seeds.dim() == 3),
            int(a.circle), a.fine.shape[0], a.sub_codes.shape[1], *a.edges,
            float(np.float32(a.weight_threshold)), q, stream)
    if err != 0:
        msg = lib.split_cells_error_string(err).decode()
        raise RuntimeError(f"split_cells launch failed: {msg} ({err})")
    launch_counts["split_cells"] += 1
    last_launch["split_cells"] = {
        "threads": shape["threads"], "cluster": q, "grid": C * q,
        "blocks_per_sm": shape[q]["blocks_per_sm"],
        "resident_blocks": shape[q]["resident"], "smem": shape[q]["smem"],
        "registers": shape[q]["registers"],
        "local_bytes": shape[q]["local_bytes"]}
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
        _LIB = bind_library(build.load_library("split_cells"))
    return _LIB


def bind_library(lib):
    """Set the argument and result types of ``csrc/split_cells.cu``'s C
    functions on the loaded library ``lib``; returns it."""
    lib.split_cells_launch.argtypes = LAUNCH_ARGTYPES
    lib.split_cells_launch.restype = ctypes.c_int
    lib.split_cells_error_string.argtypes = [ctypes.c_int]
    lib.split_cells_error_string.restype = ctypes.c_char_p
    lib.split_cells_shape.argtypes = [ctypes.c_int] * 4 + [ctypes.c_void_p]
    lib.split_cells_shape.restype = ctypes.c_int
    return lib


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
    fine, sub_codes = trace_vector.region_subgrids(G)
    if len(sub_codes) == 0:        # no open cell: one row, a valid pointer
        sub_codes = torch.zeros((1,) + sub_codes.shape[1:], dtype=torch.uint8)
    subgrids = (fine.to(device), sub_codes.to(device))
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
                                max_steps, subgrids)

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
