"""The persistent trace's semantics in plain PyTorch, for one design.

A frozen copy of the plain version that the port holds its trace kernel to
(exact selection, one cell per block, single TIR hops), cut to what the
benchmark's reference needs, with one addition: every ``COMPACT`` iterations
the cells that have finished are dropped from the working tensors.  A
finished cell's body is a no-op, so dropping it changes no value; it saves
the iterations that the slowest cells run alone.

Each cell owns ``S`` slots.  A slot walks the state machine IC 0/1, FC 2/3,
OC 4/5, dead 6, awaiting respawn 7; out-coupled rays inside the cell's
eyebox rectangle add one to its (ny, nx) tile.  Gens spawn: each slot counts
its generations and a dead slot respawns while ``gen < quota`` or ``it <
spawn_iters``; a cell stops when every slot is dead with its quota met and
``it >= spawn_iters``, or at ``max_iters``.  Float32 operations in a fixed
order, no fused multiply-add (each tensor operation rounds), and ``1 /
sqrt(x)`` with the square root correctly rounded.
"""

from __future__ import annotations

import torch

from .rng import draw24, xorshift32_step
from .rows import (
    MAX_EDGES, PC, _EBR, _EBS, _EBT, _FC_BLK, _FC_STRIDE, _G_FC_INVW,
    _G_FC_ROT, _G_FC_TOP, _G_HULL, _G_IC, _G_OC_BT, _G_OC_INVW, _G_OC_ROT,
    _G_OC_TOP, _G_R1, _G_R2, _GAPS, _HOP2_PH, _IC_BLK, _IC_SA, _IC_SB,
    _INIT_COS0, _INIT_JA, _INIT_JB, _INIT_SA, _INIT_SB, _OC_BLK, _OC_SOUT,
    _OC_STRIDE, _TIR_PH,
)

_MASK32 = 0xFFFFFFFF
COMPACT = 32   # iterations between drops of finished cells


def _jones(j, ter, tei, tmr, tmi):
    """2x2 complex matvec; ``j`` = 8 coefficients (re/im interleaved)."""
    ar, ai, br, bi, cr, ci, dr, di = j
    return (ar * ter - ai * tei + br * tmr - bi * tmi,
            ar * tei + ai * ter + br * tmi + bi * tmr,
            cr * ter - ci * tei + dr * tmr - di * tmi,
            cr * tei + ci * ter + dr * tmi + di * tmr)


def _power(v):
    return v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]


def _rsqrt(v):
    """``1 / sqrt(v)``: the float32 square root correctly rounded (taken in
    float64, then rounded), then its reciprocal."""
    return 1.0 / torch.sqrt(torch.clamp(v, min=1e-30).double()).float()


def _bin(v, hi):
    """floor, clamped to [0, hi], as an index; ``hi`` an int, or a (C, 1)
    float tensor of each cell's own."""
    if isinstance(hi, torch.Tensor):
        return torch.minimum(torch.clamp(torch.floor(v), min=0),
                             hi).to(torch.int64)
    return torch.clamp(torch.floor(v), 0, hi).to(torch.int64)


class _Rows:
    """Per cell, as columns: its row (C, PC), its design's geometry row
    (C, PG), launch tile (C, 6, S) and last FC and OC strips (C, 1)."""

    def __init__(self, cp: torch.Tensor, grow: torch.Tensor,
                 tile: torch.Tensor, fc_hi: torch.Tensor,
                 oc_hi: torch.Tensor):
        self.cp = cp
        self.cpz = torch.cat([cp, cp.new_zeros((cp.shape[0], 8))], dim=1)
        self.grow, self.tile = grow, tile
        self.fc_hi, self.oc_hi = fc_hi, oc_hi

    def keep(self, mask):
        for n in ("cp", "cpz", "grow", "tile", "fc_hi", "oc_hi"):
            setattr(self, n, getattr(self, n)[mask])

    def g(self, j):
        return self.grow[:, j:j + 1]

    def c(self, j):
        return self.cp[:, j:j + 1]

    def take(self, off):
        return torch.gather(self.cpz, 1, off)

    def region(self, base, n, x, y):
        g = self.g
        inside = torch.ones_like(x, dtype=torch.bool)
        for e in range(n):
            inside = inside & (x * g(base + e) + y * g(base + MAX_EDGES + e)
                               <= g(base + 2 * MAX_EDGES + e))
        return inside

    def in_ic(self, px, py):
        dx = px - self.g(_G_IC)
        dy = py - self.g(_G_IC + 1)
        return dx * dx + dy * dy <= self.g(_G_IC + 2)


def _bounce_step(rows: _Rows, fields, state, rng, *, edge_counts,
                 eyebox_bins):
    """One bounce of every live slot; returns ``(fields, state, rng, began,
    dep, code)``: ``began`` the slots that began the bounce alive, ``dep``
    those that out-coupled inside their cell's eyebox rectangle, into bin
    ``code = iy * nx + ix``."""
    x, y, ter, tei, tmr, tmi, cos_th, gx, gy = fields
    g, c, take = rows.g, rows.c, rows.take
    n_hull, n_r1, n_r2 = (int(e) for e in edge_counts)
    ny, nx = eyebox_bins

    began = state < 6
    in_r1 = rows.region(_G_R1, n_r1, x, y)
    state = torch.where(began & ~in_r1, 6, state)
    alive = state < 6
    grp_ic = alive & (state <= 1)
    grp_fc = alive & ((state == 2) | (state == 3))
    grp_oc = alive & (state >= 4)
    bit = state & 1

    in_hull = rows.region(_G_HULL, n_hull, x, y)
    yrot = g(_G_FC_ROT) * x + g(_G_FC_ROT + 1) * y
    fc_strip = _bin((g(_G_FC_TOP) - yrot) * g(_G_FC_INVW), rows.fc_hi)
    yr = g(_G_OC_ROT) * x + g(_G_OC_ROT + 1) * y
    in_rect = ((x >= g(_G_OC_BT)) & (x <= g(_G_OC_BT + 1))
               & (y >= g(_G_OC_BT + 2)) & (y <= g(_G_OC_BT + 3)))
    oc_strip = _bin((g(_G_OC_TOP) - yr) * g(_G_OC_INVW), rows.oc_hi)
    hit_fc = grp_fc & in_hull
    hit_oc = grp_oc & in_rect
    interact = grp_ic | hit_fc | hit_oc

    fc_base = _FC_BLK + _FC_STRIDE * fc_strip
    oc_base = _OC_BLK + _OC_STRIDE * oc_strip
    ja_off = torch.where(grp_ic, _IC_BLK + 16 * bit, torch.where(
        grp_fc, fc_base + 16 * bit, torch.where(
            grp_oc, oc_base + 24 * bit, PC)))
    jb_off = torch.where(alive, ja_off + 8, PC)
    jc_off = torch.where(grp_oc, oc_base + 24 * bit + 16, PC)
    s_a = take(torch.where(grp_ic, _IC_SA, torch.where(
        grp_fc, fc_base + 32, torch.where(grp_oc, oc_base + 48, PC))))
    s_b = take(torch.where(grp_ic, _IC_SB, torch.where(
        grp_fc, fc_base + 33, torch.where(grp_oc, oc_base + 49, PC))))
    ja = [take(ja_off + k) for k in range(8)]
    jb = [take(jb_off + k) for k in range(8)]
    jc = [take(jc_off + k) for k in range(8)]
    pol_a = _jones(ja, ter, tei, tmr, tmi)
    pol_b = _jones(jb, ter, tei, tmr, tmi)
    pol_c = _jones(jc, ter, tei, tmr, tmi)
    inv_cos = 1.0 / cos_th
    eff_a = _power(pol_a) * s_a * inv_cos
    eff_b = _power(pol_b) * s_b * inv_cos
    eff_c = _power(pol_c) * c(_OC_SOUT) * inv_cos

    # the stream advances only on an interaction
    rng_new = xorshift32_step(rng)
    u = draw24(rng_new)
    rng = torch.where(interact, rng_new, rng)
    br_a = interact & (u <= eff_a) & (eff_a > 0)
    br_b = interact & ~br_a & (u <= eff_a + eff_b) & (eff_b > 0)
    br_c = (hit_oc & ~br_a & ~br_b & (u <= eff_a + eff_b + eff_c)
            & (eff_c > 0))
    die = interact & ~(br_a | br_b | br_c)
    accept = br_a | br_b

    dirs = torch.where(br_a, torch.where(grp_oc, 1, 0),
                       torch.where(grp_oc, 3, torch.where(grp_fc, 1, 2)))
    ter_n = torch.where(br_a, pol_a[0], pol_b[0])
    tei_n = torch.where(br_a, pol_a[1], pol_b[1])
    tmr_n = torch.where(br_a, pol_a[2], pol_b[2])
    tmi_n = torch.where(br_a, pol_a[3], pol_b[3])
    inv = _rsqrt(_power((ter_n, tei_n, tmr_n, tmi_n)))
    phr = take(_TIR_PH + 2 * dirs)
    phi = take(_TIR_PH + 1 + 2 * dirs)
    ter_n, tei_n = ter_n * inv, tei_n * inv
    tr, ti = tmr_n * inv, tmi_n * inv
    tmr_n, tmi_n = phr * tr - phi * ti, phr * ti + phi * tr
    cos_n = torch.where(br_a, s_a, s_b)
    gx_n = take(_GAPS + 2 * dirs)
    gy_n = take(_GAPS + 1 + 2 * dirs)
    x_acc = x + gx_n
    y_acc = y + gy_n
    icin = rows.in_ic(x_acc, y_acc)
    st_a = torch.where(grp_oc, 4, torch.where(grp_fc, 2, torch.where(icin, 0, 2)))
    st_b = torch.where(grp_oc, 5, torch.where(grp_fc, 3, torch.where(icin, 1, 6)))
    st_acc = torch.where(br_a, st_a, st_b)

    # deposit: branch C inside the cell's eyebox rectangle
    in_quad = ((x >= c(_EBT)) & (x <= c(_EBT + 1))
               & (y >= c(_EBT + 2)) & (y <= c(_EBT + 3)))
    dep = br_c & in_quad
    ix = _bin((x - c(_EBR)) * c(_EBS), nx - 1)
    iy = _bin((y - c(_EBR + 2)) * c(_EBS + 1), ny - 1)
    code = iy * nx + ix

    # misses: TIR hops by the carried gap, FC fold-out to the OC, OC exits
    miss_fc2 = grp_fc & ~in_hull & (state == 2)
    miss_fc3 = grp_fc & ~in_hull & (state == 3)
    in_r2 = rows.region(_G_R2, n_r2, x, y)
    fc3_to_oc = miss_fc3 & ~in_r2
    hop = (miss_fc2 | (miss_fc3 & in_r2)
           | (grp_oc & ~in_rect & (state == 4)))
    miss_oc5 = grp_oc & ~in_rect & (state == 5)
    h_phr = torch.where(miss_fc2, c(_HOP2_PH + 0), c(_HOP2_PH + 2))
    h_phi = torch.where(miss_fc2, c(_HOP2_PH + 1), c(_HOP2_PH + 3))
    x_hop, y_hop = x + gx, y + gy
    hop_tmr = h_phr * tmr - h_phi * tmi
    hop_tmi = h_phr * tmi + h_phi * tmr

    state = torch.where(accept, st_acc, torch.where(
        br_c | die | miss_oc5, 6, torch.where(fc3_to_oc, 4, state)))
    fields = (torch.where(accept, x_acc, torch.where(hop, x_hop, x)),
              torch.where(accept, y_acc, torch.where(hop, y_hop, y)),
              torch.where(accept, ter_n, ter),
              torch.where(accept, tei_n, tei),
              torch.where(accept, tmr_n, torch.where(hop, hop_tmr, tmr)),
              torch.where(accept, tmi_n, torch.where(hop, hop_tmi, tmi)),
              torch.where(accept, cos_n, cos_th),
              torch.where(accept, gx_n, gx),
              torch.where(accept, gy_n, gy))
    return fields, state, rng, began, dep, code


def trace_design(cell_params: torch.Tensor, geom_row: torch.Tensor,
                 tile: torch.Tensor, seeds: torch.Tensor, *, quota: int,
                 spawn_iters: int, num_fc, num_oc, edge_counts,
                 eyebox_bins, max_iters: int):
    """Gens-spawn trace of the cells of one design or of several.

    ``cell_params`` (C, PC) float32; ``geom_row`` (PG,) float32 for one
    design, or (C, PG) a cell's design's; ``tile`` (6, S) float32 launch
    fields shared by every cell, or (C, 6, S); ``num_fc``, ``num_oc`` ints,
    or (C,) sequences; ``edge_counts`` the (hull, r1, r2) edges to test,
    the largest of the designs' (the padded edges are always true);
    ``seeds`` (C, S) int64 holding uint32 seeds.  A cell's values do not
    depend on the other cells traced with it.  Returns ``(hist (C, ny, nx)
    int64, bounces (C,) int64, spawned (C,) int64)``: deposits per bin,
    bounces begun alive, and generations spawned."""
    dev = cell_params.device
    ny, nx = eyebox_bins
    f32, i64 = torch.float32, torch.int64
    C, S = seeds.shape

    def per_cell(v):
        return torch.as_tensor(v, dtype=f32, device=dev).expand(C).reshape(C, 1)

    rows = _Rows(cell_params, geom_row.reshape(-1, geom_row.shape[-1]).expand(C, -1),
                 tile.reshape(-1, 6, S).expand(C, 6, S),
                 per_cell(num_fc) - 1, per_cell(num_oc) - 1)
    c = rows.c

    ids = torch.arange(C, device=dev)
    hist = torch.zeros((C * ny * nx,), dtype=i64, device=dev)
    bounces_out = torch.zeros((C,), dtype=i64, device=dev)
    spawned_out = torch.zeros((C,), dtype=i64, device=dev)

    def init_constants():
        """Per-slot constants of a (re)spawn, from the rows in use."""
        x0, y0, ter0, tei0, tmr0, tmi0 = rows.tile.unbind(1)
        pa0 = _jones([c(_INIT_JA + k) for k in range(8)], ter0, tei0, tmr0, tmi0)
        pb0 = _jones([c(_INIT_JB + k) for k in range(8)], ter0, tei0, tmr0, tmi0)
        inv_cos0 = 1.0 / c(_INIT_COS0)
        eff_a0 = _power(pa0) * c(_INIT_SA) * inv_cos0
        eff_ab0 = eff_a0 + _power(pb0) * c(_INIT_SB) * inv_cos0
        inv_a0 = _rsqrt(_power(pa0))
        inv_b0 = _rsqrt(_power(pb0))
        ta_r, ta_i = pa0[2] * inv_a0, pa0[3] * inv_a0
        tb_r, tb_i = pb0[2] * inv_b0, pb0[3] * inv_b0
        fld_a0 = (pa0[0] * inv_a0, pa0[1] * inv_a0,
                  c(_TIR_PH + 0) * ta_r - c(_TIR_PH + 1) * ta_i,
                  c(_TIR_PH + 0) * ta_i + c(_TIR_PH + 1) * ta_r)
        fld_b0 = (pb0[0] * inv_b0, pb0[1] * inv_b0,
                  c(_TIR_PH + 4) * tb_r - c(_TIR_PH + 5) * tb_i,
                  c(_TIR_PH + 4) * tb_i + c(_TIR_PH + 5) * tb_r)
        x1a0, y1a0 = x0 + c(_GAPS + 0), y0 + c(_GAPS + 1)
        x1b0, y1b0 = x0 + c(_GAPS + 4), y0 + c(_GAPS + 5)
        return dict(eff_a0=eff_a0, eff_ab0=eff_ab0, fld_a0=fld_a0,
                    fld_b0=fld_b0, x1a0=x1a0, y1a0=y1a0, x1b0=x1b0,
                    y1b0=y1b0, st1_a0=torch.where(rows.in_ic(x1a0, y1a0), 0, 2),
                    icin_b0=rows.in_ic(x1b0, y1b0))

    k0 = init_constants()
    x, y, ter, tei, tmr, tmi = (t.clone() for t in rows.tile.unbind(1))
    cos_th = torch.ones((C, S), dtype=f32, device=dev)
    gx = torch.zeros((C, S), dtype=f32, device=dev)
    gy = torch.zeros_like(gx)
    state = torch.full((C, S), 7, dtype=i64, device=dev)
    rng = seeds.to(i64) & _MASK32
    gen = torch.ones((C, S), dtype=i64, device=dev)   # first spawn: gen 1
    bounces = torch.zeros((C,), dtype=i64, device=dev)
    done = torch.zeros((C,), dtype=torch.bool, device=dev)

    for it in range(max_iters):
        met = gen >= quota
        exhausted = (state == 6) & met & (it >= spawn_iters)
        done = done | exhausted.all(dim=1)
        if it % COMPACT == 0:
            if bool(done.all()):
                break
            if bool(done.any()):
                # write out the finished cells and drop them
                fin = ids[done]
                bounces_out[fin] = bounces[done]
                spawned_out[fin] = gen[done].sum(dim=1)
                live = ~done
                ids, bounces, done = ids[live], bounces[live], done[live]
                x, y, ter, tei, tmr, tmi = (t[live] for t in
                                            (x, y, ter, tei, tmr, tmi))
                cos_th, gx, gy = cos_th[live], gx[live], gy[live]
                state, rng, gen, met = state[live], rng[live], gen[live], met[live]
                rows.keep(live)
                k0 = init_constants()
        # a finished cell's body is a no-op: nothing respawns, nothing lives
        rs = (state == 6) & (~met | (it < spawn_iters))
        gen = gen + rs
        state = torch.where(rs, 7, state)

        # init (first IC interaction) of awaiting slots
        m7 = state == 7
        rng_new = xorshift32_step(rng)
        u = draw24(rng_new)
        rng = torch.where(m7, rng_new, rng)
        a = m7 & (u <= k0["eff_a0"])
        b = m7 & ~a & (u <= k0["eff_ab0"])
        st1 = torch.where(a, k0["st1_a0"], torch.where(b & k0["icin_b0"], 1, 6))
        live = (st1 < 6) & m7
        fa, fb = k0["fld_a0"], k0["fld_b0"]
        x = torch.where(live, torch.where(a, k0["x1a0"], k0["x1b0"]), x)
        y = torch.where(live, torch.where(a, k0["y1a0"], k0["y1b0"]), y)
        ter = torch.where(live, torch.where(a, fa[0], fb[0]), ter)
        tei = torch.where(live, torch.where(a, fa[1], fb[1]), tei)
        tmr = torch.where(live, torch.where(a, fa[2], fb[2]), tmr)
        tmi = torch.where(live, torch.where(a, fa[3], fb[3]), tmi)
        cos_th = torch.where(m7, torch.where(a, c(_IC_SA), c(_IC_SB)), cos_th)
        gx = torch.where(live, torch.where(a, c(_GAPS + 0), c(_GAPS + 4)), gx)
        gy = torch.where(live, torch.where(a, c(_GAPS + 1), c(_GAPS + 5)), gy)
        state = torch.where(m7, st1, state)

        # one bounce for live slots; deposits go into the cell's tile
        fields, state, rng, alive, dep, code = _bounce_step(
            rows, (x, y, ter, tei, tmr, tmi, cos_th, gx, gy), state, rng,
            edge_counts=edge_counts,
            eyebox_bins=eyebox_bins)
        x, y, ter, tei, tmr, tmi, cos_th, gx, gy = fields
        bounces = bounces + alive.sum(dim=1)
        flat = (ids[:, None] * (ny * nx) + code)[dep]
        hist.index_add_(0, flat, torch.ones_like(flat))

    bounces_out[ids] = bounces
    spawned_out[ids] = gen.sum(dim=1)
    return hist.reshape(C, ny, nx), bounces_out, spawned_out
