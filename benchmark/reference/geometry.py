"""Waveguide design generation: k-space rules -> coupler geometry + analytic LUTs.

A frozen copy of the port's ``design/geometry.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

Re-derivation of the reference design pipeline (``couplers_coor_full_color``,
couplers_coor.py:122-750) with three structural changes:

1. every per-FoV loop is vectorized numpy (the reference runs Python triple loops over
   50x50x3 and 3x100x75 grids),
2. shapely is replaced by the convex-only kernel in :mod:`.convex` (every polygon in the
   pipeline is convex), and
3. results are returned as a named dataclass instead of a 36-tuple.

Physics recap: an in-coupler grating (period ``lambda_ic`` @ ``phi_ic``) adds its grating
vector to the incident k-vector, trapping light in the n=1.9 slab beyond the TIR angle; a
folding grating (k-vector = reversed-OC - IC closure rule, couplers_coor.py:203-207)
redirects and replicates the pupil; an out-coupler ejects it toward the eyebox.  The
coupler *footprints* are built from tangent-line constructions in real space: for each
field angle, the pupil's two tangent lines along the in-glass propagation direction and
the eyebox edges' two tangent lines along the folded direction intersect in four points;
the union over the FoV sweep is the folding region.
"""

from __future__ import annotations

import dataclasses
from typing import List, Tuple

import numpy as np

from .config import WaveguideDesign
from . import convex


@dataclasses.dataclass
class DesignGeometry:
    """All host-side design artifacts (numpy, float64).

    Field names follow the reference's return contract (couplers_coor.py:740-750) with
    the driver's naming trap fixed: ``k_air`` is the air-side k-vector that the reference
    driver re-binds as ``kx_ic`` (gpu_ray_tracing_pro_fullColor.py:25).
    """

    design: WaveguideDesign

    # Coupler outlines (mm)
    ic: np.ndarray                       # (ic_num_vertices, 2) pupil circle polygon
    fc_strips: List[np.ndarray]          # num_fc polygons, each (Vi, 2)
    oc_strips: List[np.ndarray]          # num_oc polygons, each (Vi, 2)
    eff_reg1: np.ndarray                 # (H1, 2) hull of the whole system
    eff_reg2: np.ndarray                 # (H2, 2) hull of IC+FC region

    # Per-FoV eyebox footprint rectangles on the OC plane
    eyebox_quad: np.ndarray              # (M, N, 4, 2)
    eyebox_range: np.ndarray             # (M, N, 4) = (xmin, xmax, ymin, ymax)

    # Analytic LUTs
    lut_tir: np.ndarray                  # (L, M, N, 4) TIR retardation (delta_s-delta_p)
    lut_gap: np.ndarray                  # (L, M, N, 8) TIR round-trip hops (dx, dy) x4
    lut_fresnel: np.ndarray              # (M, N, 4) (r_TE, r_TM, hop, hop); unused by
                                         # the tracer, kept for parity (couplers_coor.py:627)

    # Propagation angle tables, (L, M, N) each
    th_in_ic: np.ndarray
    phi_in_ic: np.ndarray
    th_out_ic: np.ndarray
    phi_out_ic: np.ndarray
    th_out_ic2: np.ndarray
    phi_out_ic2: np.ndarray
    th_out_fc: np.ndarray
    phi_out_fc: np.ndarray
    th_out_oc: np.ndarray
    phi_out_oc: np.ndarray
    th_out_oc_glow: np.ndarray

    # Derived grating parameters
    lambda_fc: float
    phi_fc: float

    # Band-slicing metadata (rotation angle + band extents in the rotated frame);
    # lets engines replace per-strip polygon tests with one region test + 1-D binning
    fc_slice: dict
    oc_slice: dict
    cloud_hull: np.ndarray               # (H, 2) folding-region hull (union of FC strips)
    oc_rect: np.ndarray                  # (4, 2) out-coupler rectangle (union of OC strips)

    # k-space sweep samples, (L, design_sweep_n**2) each
    k_air: Tuple[np.ndarray, np.ndarray]
    k_after_ic: Tuple[np.ndarray, np.ndarray]
    k_after_fc: Tuple[np.ndarray, np.ndarray]

    @property
    def fc_packed(self) -> Tuple[np.ndarray, np.ndarray]:
        """CSR-style packed FC vertices + offsets (reference couplers_coor.py:717-721)."""
        return _pack_polys(self.fc_strips)

    @property
    def oc_packed(self) -> Tuple[np.ndarray, np.ndarray]:
        return _pack_polys(self.oc_strips)


def _pack_polys(polys: List[np.ndarray]) -> Tuple[np.ndarray, np.ndarray]:
    verts = np.concatenate(polys, axis=0)
    offsets = np.cumsum([0] + [len(p) for p in polys])
    return verts, offsets


def _grating_vectors(d: WaveguideDesign):
    """In-plane grating k-vectors (1/nm): IC, reversed-OC, and FC = revOC - IC."""
    kg_ic = 2 * np.pi / d.lambda_ic
    g_ic = np.array([kg_ic * np.cos(d.phi_ic), kg_ic * np.sin(d.phi_ic)])
    kg_oc = 2 * np.pi / d.lambda_oc
    g_oc_rev = np.array(
        [kg_oc * np.cos(d.phi_oc + np.pi), kg_oc * np.sin(d.phi_oc + np.pi)]
    )
    g_fc = g_oc_rev - g_ic
    lambda_fc = 2 * np.pi / np.hypot(*g_fc)
    phi_fc = np.arctan2(g_fc[1], g_fc[0])
    return g_ic, g_oc_rev, g_fc, lambda_fc, phi_fc


def _incidence(fov_x: np.ndarray, fov_y: np.ndarray):
    """Polar/azimuth of the air-side ray for field angles (broadcastable)."""
    tx, ty = np.tan(fov_x), np.tan(fov_y)
    th = np.arctan(np.sqrt(tx * tx + ty * ty))
    phi = np.arctan2(ty, tx)
    return th, phi


def _tangent_lines(d: WaveguideDesign, fov_x, fov_y, k0, g_ic, g_fc):
    """Per-field tangent-line parameters of the folding-region construction.

    For each field angle: the two pupil tangents along the in-glass
    propagation direction (slope ``k1``, intercepts ``b11``/``b12``) and the
    two eyebox-corner tangents along the folded direction (slope ``k2``,
    intercepts ``b21``/``b22``), plus the sampled k-vectors (air, after-IC,
    after-FC) for the k-space diagnostics.  Single source for both the
    design-sweep point cloud (:func:`_fold_intersections`) and the 9-corner
    FoV quads (:func:`_fov_quads`) — the corner-selection rule and the rest
    of the construction must never diverge between them.
    """
    x_ic0, y_ic0 = d.ic_center
    r = d.pupil_radius
    x_eb0, y_eb0 = d.eyebox_center
    w_eb, h_eb = d.eyebox_size
    er = d.eye_relief

    th, phi = _incidence(fov_x, fov_y)
    kx0 = d.n_air * k0 * np.sin(th) * np.cos(phi)
    ky0 = d.n_air * k0 * np.sin(th) * np.sin(phi)

    kx_ic = kx0 + g_ic[0]
    ky_ic = ky0 + g_ic[1]
    k1 = ky_ic / kx_ic
    root = r * np.sqrt(1.0 + k1 * k1)
    b11 = y_ic0 - k1 * x_ic0 + root
    b12 = y_ic0 - k1 * x_ic0 - root

    kx_fc = kx_ic + g_fc[0]
    ky_fc = ky_ic + g_fc[1]
    k2 = ky_fc / kx_fc

    dx = er * np.tan(th) * np.cos(phi)
    dy = er * np.tan(th) * np.sin(phi)
    xl, xr = x_eb0 - w_eb / 2 + dx, x_eb0 + w_eb / 2 + dx
    yb, yt = y_eb0 - h_eb / 2 + dy, y_eb0 + h_eb / 2 + dy
    # For a downhill folded direction the binding eyebox tangents run through the
    # left-bottom and right-top corners; uphill, through left-top and right-bottom.
    b21 = np.where(k2 <= 0, yb - k2 * xl, yt - k2 * xl)
    b22 = np.where(k2 <= 0, yt - k2 * xr, yb - k2 * xr)
    return (k1, b11, b12, k2, b21, b22,
            (kx0, ky0), (kx_ic, ky_ic), (kx_fc, ky_fc))


def _fold_intersections(d: WaveguideDesign, fov_x, fov_y, k0, g_ic, g_fc):
    """Tangent-line intersection points defining the folding region.

    ``fov_x/fov_y/k0`` broadcast together; returns stacked (P, 2) points plus the
    sampled k-vectors (air, after-IC, after-FC) for the k-space diagnostics.
    """
    (k1, b11, b12, k2, b21, b22,
     k_air, k_aic, k_afc) = _tangent_lines(d, fov_x, fov_y, k0, g_ic, g_fc)
    pts = []
    for b1 in (b11, b12):
        for b2 in (b22, b21):
            xi = (b2 - b1) / (k1 - k2)
            yi = k1 * xi + b1
            pts.append(np.stack([xi, yi], axis=-1))
    points = np.concatenate([p.reshape(-1, 2) for p in pts], axis=0)
    return points, k_air, k_aic, k_afc


def _fov_quads(d: WaveguideDesign, fov_x, fov_y, k0, g_ic, g_fc) -> np.ndarray:
    """Per-field folding-region quadrilaterals, shape (..., 4, 2).

    The four tangent-line intersections ordered as in couplers_coor.py:369-377.
    """
    k1, b11, b12, k2, b21, b22, *_ = _tangent_lines(
        d, fov_x, fov_y, k0, g_ic, g_fc)

    xs = np.stack(
        [
            (b22 - b11) / (k1 - k2),
            (b21 - b11) / (k1 - k2),
            (b21 - b12) / (k1 - k2),
            (b22 - b12) / (k1 - k2),
        ],
        axis=-1,
    )
    b1s = np.stack([b11, b11, b12, b12], axis=-1)
    ys = k1[..., None] * xs + b1s
    return np.stack([xs, ys], axis=-1)


def _slice_polygon(
    verts: np.ndarray, angle: float, num_slices: int, half_width: float
) -> Tuple[List[np.ndarray], dict]:
    """Rotate a convex polygon, cut it into horizontal bands, rotate back.

    Mirrors the band-slicing of couplers_coor.py:408-452 (FC) and :557-600 (OC): the
    band width is range/(num+0.001) so the sweep always yields exactly ``num_slices``
    strips with the last band extended to the bottom edge.
    """
    rot = np.array([[np.cos(angle), np.sin(angle)], [-np.sin(angle), np.cos(angle)]])
    rotated = verts @ rot.T
    top = rotated[:, 1].max()
    bottom = rotated[:, 1].min()
    width = (top - bottom) / (num_slices + 0.001)
    strips = []
    inv = rot.T  # rotation matrices: inverse == transpose
    for i in range(1, num_slices + 1):
        y_hi = top - (i - 1) * width
        y_lo = bottom if i == num_slices else top - i * width
        band = np.array(
            [
                [-half_width, y_hi],
                [half_width, y_hi],
                [half_width, y_lo],
                [-half_width, y_lo],
            ]
        )
        clipped = convex.clip_convex(rotated, band)
        if len(clipped) == 0:
            continue
        strips.append(clipped @ inv.T)
    info = {"angle": angle, "top": float(top), "bottom": float(bottom),
            "width": float(width)}
    return strips, info


def _tir_retardation(n_g: float, theta: np.ndarray) -> np.ndarray:
    """TIR phase retardation delta_s - delta_p for internal angle ``theta``.

    Standard Fresnel TIR phase shifts (couplers_coor.py:689-693 form).
    """
    # below-critical directions (possible in aggressive design sweeps) would NaN;
    # clamp to 0 so they carry zero retardation instead of poisoning the trace
    s = np.sqrt(np.maximum(n_g**2 * np.sin(theta) ** 2 - 1.0, 0.0))
    delta_s = 2.0 * np.arctan(s / (n_g * np.cos(theta)))
    delta_p = 2.0 * np.arctan(n_g * s / np.cos(theta))
    return delta_s - delta_p


def generate_geometry(
    design: WaveguideDesign = WaveguideDesign(),
    num_fov_x: int = 100,
    num_fov_y: int = 75,
) -> DesignGeometry:
    """Build the full design geometry for an ``num_fov_x x num_fov_y`` field grid."""
    d = design
    lmd = np.asarray(d.wavelengths, dtype=np.float64)
    k0 = 2 * np.pi / lmd
    g_ic, g_oc_rev, g_fc, lambda_fc, phi_fc = _grating_vectors(d)

    # --- in-coupler pupil circle (mm); sin-first parameterization like the reference
    t_ic = np.linspace(0, 2 * np.pi, d.ic_num_vertices)
    ic = np.stack(
        [
            d.ic_center[0] + d.pupil_radius * np.sin(t_ic),
            d.ic_center[1] + d.pupil_radius * np.cos(t_ic),
        ],
        axis=1,
    )

    # --- folding-region point cloud over the design sweep (vectorized 50x50x3)
    ns = d.design_sweep_n
    fov_xs = np.linspace(-d.fov_x / 2, d.fov_x / 2, ns)
    fov_ys = np.linspace(-d.fov_y / 2, d.fov_y / 2, ns)
    fx = fov_xs[:, None, None]  # (ns, 1, 1)
    fy = fov_ys[None, :, None]  # (1, ns, 1)
    kl = k0[None, None, :]      # (1, 1, L)
    cloud, k_air3, k_aic3, k_afc3 = _fold_intersections(d, fx, fy, kl, g_ic, g_fc)

    # k-space sweep samples reshaped (L, ns*ns) with the reference's (ii-major) order
    def _kflat(pair):
        return tuple(np.moveaxis(a, -1, 0).reshape(len(lmd), ns * ns) for a in pair)

    k_air = _kflat(k_air3)
    k_after_ic = _kflat(k_aic3)
    k_after_fc = _kflat(k_afc3)

    # --- 9-corner field quads x 3 wavelengths
    eps = np.finfo(float).eps
    f9x = np.array([-d.fov_x / 2, eps, d.fov_x / 2, -d.fov_x / 2, eps, d.fov_x / 2,
                    d.fov_x / 2, eps, -d.fov_x / 2])
    f9y = np.array([d.fov_y / 2] * 3 + [eps] * 3 + [-d.fov_y / 2] * 3)
    quads9 = _fov_quads(
        d, f9x[:, None], f9y[:, None], k0[None, :], g_ic, g_fc
    )  # (9, L, 4, 2)
    quad_pts = quads9.reshape(-1, 2)

    # --- region hulls
    cloud_hull = convex.convex_hull(cloud)
    eff_reg2 = convex.simplify_ring(
        convex.convex_hull(np.concatenate([cloud_hull, quad_pts, ic], axis=0)), 1e-3
    )

    # 9-corner eyebox footprint rectangles (wavelength-independent)
    rect9 = _eyebox_rects(d, f9x, f9y)[0].reshape(-1, 2)  # (9*4, 2)
    eff_reg1 = convex.simplify_ring(
        convex.convex_hull(
            np.concatenate([cloud_hull, quad_pts, ic, rect9], axis=0)
        ),
        1e-3,
    )

    # --- FC strips: slice the cloud hull perpendicular to the IC grating direction
    fc_strips, fc_slice = _slice_polygon(
        cloud_hull, np.pi / 2 + d.phi_ic, d.num_fc, d.glass_x
    )

    # --- OC strips: slice the out-coupler rectangle along the OC grating direction
    x_oc = np.tan(d.fov_x / 2) * abs(d.eye_relief) * 2 + d.eyebox_size[0]
    y_oc = np.tan(d.fov_y / 2) * abs(d.eye_relief) * 2 + d.eyebox_size[1]
    oc_rect = np.array(
        [
            [d.eyebox_center[0] - x_oc / 2, d.eyebox_center[1] - y_oc / 2],
            [d.eyebox_center[0] - x_oc / 2, d.eyebox_center[1] + y_oc / 2],
            [d.eyebox_center[0] + x_oc / 2, d.eyebox_center[1] + y_oc / 2],
            [d.eyebox_center[0] + x_oc / 2, d.eyebox_center[1] - y_oc / 2],
        ]
    )
    oc_strips, oc_slice = _slice_polygon(
        oc_rect, 3 * np.pi / 2 + d.phi_oc, d.num_oc, d.glass_x
    )

    # --- per-FoV eyebox footprint rectangles for the full trace grid
    gx = np.linspace(-d.fov_x / 2, d.fov_x / 2, num_fov_x)
    gy = np.linspace(-d.fov_y / 2, d.fov_y / 2, num_fov_y)
    gxx, gyy = np.meshgrid(gx, gy, indexing="ij")
    eyebox_quad, eyebox_range = _eyebox_rects(d, gxx, gyy)

    # --- angle tables + analytic LUTs over (L, M, N)
    th_in, phi_in = _incidence(gxx, gyy)  # (M, N), wavelength-independent
    L = len(lmd)
    th_in_ic = np.broadcast_to(th_in, (L,) + th_in.shape).copy()
    phi_in_ic = np.broadcast_to(phi_in, (L,) + phi_in.shape).copy()

    kx = d.n_air * k0[:, None, None] * np.sin(th_in) * np.cos(phi_in)
    ky = d.n_air * k0[:, None, None] * np.sin(th_in) * np.sin(phi_in)
    k0l = k0[:, None, None]

    def glass_dir(kxg, kyg):
        kzg = np.sqrt(k0l**2 * d.n_glass**2 - kxg**2 - kyg**2)
        th = np.arctan(np.sqrt((kxg**2 + kyg**2) / kzg**2))
        phi = np.arctan2(kyg, kxg)
        return th, phi

    th_out_ic2, phi_out_ic2 = glass_dir(kx - g_ic[0], ky - g_ic[1])
    th_out_ic, phi_out_ic = glass_dir(kx + g_ic[0], ky + g_ic[1])
    th_out_fc, phi_out_fc = glass_dir(kx + g_ic[0] + g_fc[0], ky + g_ic[1] + g_fc[1])
    th_out_oc, phi_out_oc = glass_dir(
        kx + g_ic[0] + g_fc[0] - 2 * g_oc_rev[0],
        ky + g_ic[1] + g_fc[1] - 2 * g_oc_rev[1],
    )
    th_out_oc_glow = np.broadcast_to(
        np.arcsin(np.sin(th_in) / d.n_glass), (L,) + th_in.shape
    ).copy()

    def hop(th, phi):
        return 2 * d.thickness * np.tan(th) * np.cos(phi), 2 * d.thickness * np.tan(
            th
        ) * np.sin(phi)

    lut_gap = np.zeros((L, num_fov_x, num_fov_y, 8))
    lut_gap[..., 0], lut_gap[..., 1] = hop(th_out_ic, phi_out_ic)
    lut_gap[..., 2], lut_gap[..., 3] = hop(th_out_fc, phi_out_fc)
    lut_gap[..., 4], lut_gap[..., 5] = hop(th_out_ic2, phi_out_ic2)
    lut_gap[..., 6], lut_gap[..., 7] = hop(th_out_oc, phi_out_oc)

    lut_tir = np.stack(
        [
            _tir_retardation(d.n_glass, th_out_ic),
            _tir_retardation(d.n_glass, th_out_fc),
            _tir_retardation(d.n_glass, th_out_ic2),
            _tir_retardation(d.n_glass, th_out_oc),
        ],
        axis=-1,
    )

    th_glass = np.arcsin(np.sin(th_in) / d.n_glass)
    r_te = (d.n_glass * np.cos(th_glass) - np.cos(th_in)) / (
        d.n_glass * np.cos(th_glass) + np.cos(th_in)
    )
    r_tm = (np.cos(th_glass) - d.n_glass * np.cos(th_in)) / (
        np.cos(th_glass) + d.n_glass * np.cos(th_in)
    )
    hop_g = 2 * d.thickness * np.tan(th_glass) * np.cos(phi_in)
    lut_fresnel = np.stack([r_te, r_tm, hop_g, hop_g], axis=-1)

    return DesignGeometry(
        design=d,
        ic=ic,
        fc_strips=fc_strips,
        oc_strips=oc_strips,
        eff_reg1=eff_reg1,
        eff_reg2=eff_reg2,
        eyebox_quad=eyebox_quad,
        eyebox_range=eyebox_range,
        lut_tir=lut_tir,
        lut_gap=lut_gap,
        lut_fresnel=lut_fresnel,
        th_in_ic=th_in_ic,
        phi_in_ic=phi_in_ic,
        th_out_ic=th_out_ic,
        phi_out_ic=phi_out_ic,
        th_out_ic2=th_out_ic2,
        phi_out_ic2=phi_out_ic2,
        th_out_fc=th_out_fc,
        phi_out_fc=phi_out_fc,
        th_out_oc=th_out_oc,
        phi_out_oc=phi_out_oc,
        th_out_oc_glow=th_out_oc_glow,
        fc_slice=fc_slice,
        oc_slice=oc_slice,
        cloud_hull=cloud_hull,
        oc_rect=oc_rect,
        lambda_fc=float(lambda_fc),
        phi_fc=float(phi_fc),
        k_air=k_air,
        k_after_ic=k_after_ic,
        k_after_fc=k_after_fc,
    )


def _eyebox_rects(d: WaveguideDesign, fov_x, fov_y):
    """Eyebox footprint rectangle per field angle: quad (..., 4, 2) + range (..., 4).

    The eyebox projected back to the waveguide plane along the air-side ray direction
    (couplers_coor.py:501-532); the quad vertex order is (lt, lb, rb, rt) and the range
    packs (xmin, xmax, ymin, ymax).
    """
    th, phi = _incidence(fov_x, fov_y)
    dx = d.eye_relief * np.tan(th) * np.cos(phi)
    dy = d.eye_relief * np.tan(th) * np.sin(phi)
    x0, y0 = d.eyebox_center
    w, h = d.eyebox_size
    xl, xr = x0 - w / 2 + dx, x0 + w / 2 + dx
    yb, yt = y0 - h / 2 + dy, y0 + h / 2 + dy
    quad = np.stack(
        [
            np.stack([xl, yt], axis=-1),
            np.stack([xl, yb], axis=-1),
            np.stack([xr, yb], axis=-1),
            np.stack([xr, yt], axis=-1),
        ],
        axis=-2,
    )
    rng = np.stack([xl, xr, yb, yt], axis=-1)
    return quad, rng
