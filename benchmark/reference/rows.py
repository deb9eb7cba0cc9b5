"""Kernel parameter rows and ray tiles (host numpy).

A frozen copy of the port's ``engine/trace_rows.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The numpy half of the JAX package's ``engine/trace_pallas.py``, copied
because that module imports Pallas.  The layouts are kept float for float: a
cell row holds ``PC`` = 704 float32 values, the geometry row ``PG`` = 320, so
the port's rows diff against the JAX package's as plain arrays.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from .packing import CellTables
from .trace_geometry import TraceGeometry

MAX_EDGES = 24
LANES = 128

# ---- per-cell row layout (float32) ------------------------------------------
_INIT_JA = 0          # 8: init Jones A (re/im interleaved row-major)
_INIT_JB = 8          # 8
_INIT_SA = 16
_INIT_SB = 17
_INIT_COS0 = 18
_OC_SOUT = 19
_GAPS = 20            # 8: (dx, dy) per direction 0..3
_TIR_PH = 28          # 8: (re, im) per direction
_HOP2_PH = 36         # 8
_EBR = 44             # 4: deposit rect (xmin, xmax, ymin, ymax)
_IC_BLK = 48          # 32: [bit][branch] Jones, 8 floats each
_IC_SA = 80
_IC_SB = 81
_FC_BLK = 96          # 7 strips x 36: JA_b0, JB_b0, JA_b1, JB_b1, s_a, s_b, pad2
_FC_STRIDE = 36
_OC_BLK = 352         # 6 strips x 56: JA/JB/JC per bit (48), s_a, s_b, pad6
_OC_STRIDE = 56
_EBT = 688            # 4: deposit rect widened by _EDGE_TOL
_EBS = 692            # 2: deposit bin scales nx/(x1-x0), ny/(y1-y0)
_HOP2_ANG = 694       # 2: TIR hop phase angles (dirs 0/1)
PC = 704

# ---- geometry row layout ------------------------------------------------------
_G_FC_ROT = 0         # 2
_G_FC_TOP = 2
_G_FC_INVW = 3
_G_OC_ROT = 4         # 2
_G_OC_TOP = 6
_G_OC_INVW = 7
_G_OC_B = 8           # 4: OC rect bounds
_G_IC = 12            # 3: cx, cy, r^2
_G_HULL = 16          # 3*MAX_EDGES: nx[24], ny[24], c+tol[24]
_G_R1 = 88
_G_R2 = 160
_G_MC_HULL = 232      # MAX_EDGES each: -(c+tol)
_G_MC_R1 = 256
_G_MC_R2 = 280
_G_OC_BT = 304        # 4: OC rect bounds widened by _EDGE_TOL
PG = 320

_EDGE_TOL = 1e-6

SEL_W = 50            # selection record: 34 shared params + 16 OC-only (branch C)
SEL_NW = SEL_W // 2   # two bf16 values per int32 word


def _flat_jones(j: np.ndarray) -> np.ndarray:
    """(..., 2, 2) complex -> (..., 8) float32 (re, im interleaved row-major)."""
    stacked = np.stack(
        [j[..., 0, 0].real, j[..., 0, 0].imag, j[..., 0, 1].real, j[..., 0, 1].imag,
         j[..., 1, 0].real, j[..., 1, 0].imag, j[..., 1, 1].real, j[..., 1, 1].imag],
        axis=-1,
    )
    return stacked.astype(np.float32)


def build_kernel_cell_params(tables: CellTables, eyebox_range_mn: np.ndarray,
                             eyebox_bins: tuple = (80, 120)) -> np.ndarray:
    """(C, PC) float32 cell rows from the packed cell tables.

    ``eyebox_range_mn``: (M, N, 4) per-FoV deposit rects (or (D, M, N, 4)),
    tiled over wavelength in cid order.  ``eyebox_bins`` (ny, nx) must match the
    trace's bins: the deposit slots ``_EBT`` / ``_EBS`` derive from them.
    """
    C = tables.num_cells
    p = np.zeros((C, PC), dtype=np.float32)
    p[:, _INIT_JA:_INIT_JA + 8] = _flat_jones(tables.init_jones[0])
    p[:, _INIT_JB:_INIT_JB + 8] = _flat_jones(tables.init_jones[1])
    p[:, _INIT_SA] = tables.init_scale[0]
    p[:, _INIT_SB] = tables.init_scale[1]
    p[:, _INIT_COS0] = tables.init_cos0
    p[:, _OC_SOUT] = tables.oc_scale_out
    p[:, _GAPS:_GAPS + 8] = tables.gaps.reshape(C, 8)
    ph = tables.tir_phasor
    p[:, _TIR_PH:_TIR_PH + 8] = np.stack([ph.real, ph.imag], axis=-1).reshape(C, 8)
    h2 = tables.hop2_phasor
    p[:, _HOP2_PH:_HOP2_PH + 8] = np.stack([h2.real, h2.imag], axis=-1).reshape(C, 8)
    p[:, _HOP2_ANG + 0] = np.angle(h2[:, 0])
    p[:, _HOP2_ANG + 1] = np.angle(h2[:, 1])
    eb = np.asarray(eyebox_range_mn)
    ebd = eb.reshape(eb.shape[0], -1, 4) if eb.ndim == 4 else eb.reshape(1, -1, 4)
    ebr = np.tile(ebd[:, None], (1, tables.L, 1, 1)).reshape(C, 4).astype(np.float32)
    p[:, _EBR:_EBR + 4] = ebr
    ny, nx = eyebox_bins
    tol = np.float32(_EDGE_TOL)
    p[:, _EBT + 0] = ebr[:, 0] - tol
    p[:, _EBT + 1] = ebr[:, 1] + tol
    p[:, _EBT + 2] = ebr[:, 2] - tol
    p[:, _EBT + 3] = ebr[:, 3] + tol
    p[:, _EBS + 0] = np.float32(nx) / (ebr[:, 1] - ebr[:, 0])
    p[:, _EBS + 1] = np.float32(ny) / (ebr[:, 3] - ebr[:, 2])
    for bit in range(2):
        for br in range(2):
            off = _IC_BLK + (bit * 2 + br) * 8
            p[:, off:off + 8] = _flat_jones(tables.ic_jones[br][bit])
    p[:, _IC_SA] = tables.ic_scale[0]
    p[:, _IC_SB] = tables.ic_scale[1]
    for s in range(tables.fc_jones.shape[1]):
        off = _FC_BLK + s * _FC_STRIDE
        p[:, off:off + 8] = _flat_jones(tables.fc_jones[0][s, 0])
        p[:, off + 8:off + 16] = _flat_jones(tables.fc_jones[1][s, 0])
        p[:, off + 16:off + 24] = _flat_jones(tables.fc_jones[0][s, 1])
        p[:, off + 24:off + 32] = _flat_jones(tables.fc_jones[1][s, 1])
        p[:, off + 32] = tables.fc_scale[0][s]
        p[:, off + 33] = tables.fc_scale[1][s]
    for s in range(tables.oc_jones.shape[1]):
        off = _OC_BLK + s * _OC_STRIDE
        for bit in range(2):
            for br in range(3):
                o2 = off + bit * 24 + br * 8
                p[:, o2:o2 + 8] = _flat_jones(tables.oc_jones[br][s, bit])
        p[:, off + 48] = tables.oc_scale[0][s]
        p[:, off + 49] = tables.oc_scale[1][s]
    return p


def _hp_from_existing(hp: np.ndarray) -> np.ndarray:
    """(E, 3) half-planes -> the 3 x MAX_EDGES packed layout; padding rows are
    always true (0*x + 0*y <= 1); more than MAX_EDGES edges are subsampled."""
    if len(hp) > MAX_EDGES:
        idx = np.linspace(0, len(hp) - 1, MAX_EDGES).astype(int)
        hp = hp[idx]
    out = np.zeros(3 * MAX_EDGES)
    out[2 * MAX_EDGES:] = 1.0
    e = len(hp)
    out[:e] = hp[:, 0]
    out[MAX_EDGES:MAX_EDGES + e] = hp[:, 1]
    out[2 * MAX_EDGES:2 * MAX_EDGES + e] = hp[:, 2]
    return out


def build_kernel_geom(tgeom: TraceGeometry) -> np.ndarray:
    """(PG,) float32 geometry row; edge tolerances folded in float32."""
    g = np.zeros(PG, dtype=np.float64)
    g[_G_FC_ROT:_G_FC_ROT + 2] = tgeom.fc_rot
    g[_G_FC_TOP] = tgeom.fc_top
    g[_G_FC_INVW] = 1.0 / tgeom.fc_width
    g[_G_OC_ROT:_G_OC_ROT + 2] = tgeom.oc_rot_y
    g[_G_OC_TOP] = tgeom.oc_top
    g[_G_OC_INVW] = 1.0 / tgeom.oc_width
    g[_G_OC_B:_G_OC_B + 4] = tgeom.oc_bounds
    g[_G_IC] = tgeom.ic_center[0]
    g[_G_IC + 1] = tgeom.ic_center[1]
    g[_G_IC + 2] = tgeom.ic_radius ** 2
    g[_G_HULL:_G_HULL + 3 * MAX_EDGES] = _hp_from_existing(tgeom.hull_hp)
    g[_G_R1:_G_R1 + 3 * MAX_EDGES] = _hp_from_existing(tgeom.r1_hp)
    g[_G_R2:_G_R2 + 3 * MAX_EDGES] = _hp_from_existing(tgeom.r2_hp)
    g32 = g.astype(np.float32)
    tol = np.float32(_EDGE_TOL)
    for base in (_G_HULL, _G_R1, _G_R2):
        g32[base + 2 * MAX_EDGES:base + 3 * MAX_EDGES] += tol
    for base, mc in ((_G_HULL, _G_MC_HULL), (_G_R1, _G_MC_R1), (_G_R2, _G_MC_R2)):
        g32[mc:mc + MAX_EDGES] = -g32[base + 2 * MAX_EDGES:base + 3 * MAX_EDGES]
    g32[_G_OC_BT + 0] = g32[_G_OC_B + 0] - tol
    g32[_G_OC_BT + 1] = g32[_G_OC_B + 1] + tol
    g32[_G_OC_BT + 2] = g32[_G_OC_B + 2] - tol
    g32[_G_OC_BT + 3] = g32[_G_OC_B + 3] + tol
    return g32


def edge_counts(tgeom: TraceGeometry) -> Tuple[int, int, int]:
    """Actual (hull, r1, r2) half-plane counts; the padded rows beyond them
    are always true, so a trace may stop its edge loops there."""
    return (min(len(tgeom.hull_hp), MAX_EDGES), min(len(tgeom.r1_hp), MAX_EDGES),
            min(len(tgeom.r2_hp), MAX_EDGES))


def pack_ray_blocks(batch: dict, n_cells: int, rays_per_cell: int,
                    rt: int) -> Tuple[np.ndarray, np.ndarray]:
    """Host SoA batch (cell-major) -> rays_in (C, 6, RT, 128) float32 and
    rng_in (C, RT, 128) uint32.  Padding slots carry zero amplitude (they die
    at init) and state 1."""
    rp = rt * LANES
    C = n_cells
    te = np.asarray(batch["te"], np.complex128)
    tm = np.asarray(batch["tm"], np.complex128)
    fields = [batch["x"], batch["y"], te.real, te.imag, tm.real, tm.imag]
    rays_in = np.zeros((C, 6, rp), dtype=np.float32)
    for fi, f in enumerate(fields):
        rays_in[:, fi, :rays_per_cell] = np.asarray(f, np.float64).reshape(
            C, rays_per_cell)
    rng_in = np.zeros((C, rp), dtype=np.uint32)
    rng_in[:, :rays_per_cell] = batch["rng"].reshape(C, rays_per_cell)
    rng_in[:, rays_per_cell:] = 1
    return rays_in.reshape(C, 6, rt, LANES), rng_in.reshape(C, rt, LANES)
