"""Static-shape trace geometry: half-plane packs + band-slice coordinates.

A frozen copy of the port's ``engine/trace_geometry.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

Converts host :class:`~..design.geometry.DesignGeometry` into the fixed-shape float32
arrays the engines consume.  Two structural optimizations over the reference's
per-polygon even-odd scans (GPU_ray_tracing_functions.py:36-108):

1. every region is convex, so containment is an all-of half-plane test
   (``nx*x + ny*y <= c``), vectorizable as two FMAs per edge;
2. FC/OC strips are parallel band-slices of one region, so "which strip am I in"
   collapses to one region test plus 1-D binning of the band-frame coordinate —
   O(E_hull + 1) instead of O(sum of strip edges).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np

from . import convex
from .geometry import DesignGeometry


@dataclasses.dataclass
class TraceGeometry:
    """Engine-side geometry (numpy float32/float64 host arrays; engines cast)."""

    # in-coupler: circle test parameters and (optional parity) polygon half-planes
    ic_center: np.ndarray        # (2,)
    ic_radius: float
    ic_hp: np.ndarray            # (E_ic, 3) half-planes of the 100-gon

    # convex region half-planes
    r1_hp: np.ndarray            # (E1, 3) whole-system region
    r2_hp: np.ndarray            # (E2, 3) IC+FC region
    hull_hp: np.ndarray          # (Eh, 3) folding hull = union of FC strips

    # FC band frame: strip = clip(floor((top - yrot)/width), 0, S-1)
    fc_rot: np.ndarray           # (2,) = (-sin a, cos a); yrot = dot(fc_rot, (x, y))
    fc_top: float
    fc_width: float
    num_fc: int

    # OC band frame; the out-coupler rectangle is axis-aligned in the *original*
    # frame (its bounds below), while strip binning runs on the band-frame yrot
    oc_rot_y: np.ndarray         # (2,) = (-sin a, cos a)
    oc_bounds: np.ndarray        # (4,) = (xmin, xmax, ymin, ymax), original frame
    oc_top: float
    oc_width: float
    num_oc: int

    # per-FoV eyebox deposit rectangles
    eyebox_range: np.ndarray     # (M, N, 4) = (xmin, xmax, ymin, ymax)


def build_trace_geometry(
    geom: DesignGeometry, simplify_tol: float = 0.0
) -> TraceGeometry:
    """``simplify_tol`` > 0 Douglas-Peucker-simplifies the region hulls (sub-1e-3 mm
    boundary shifts, large edge-count savings); 0 keeps exact reference outlines."""

    def hp(poly):
        if simplify_tol > 0 and len(poly) > 8:
            poly = convex.simplify_ring(poly, simplify_tol)
        return convex.halfplanes(poly)

    d = geom.design

    fs = geom.fc_slice
    a = fs["angle"]
    fc_rot = np.array([-np.sin(a), np.cos(a)])

    os_ = geom.oc_slice
    ao = os_["angle"]
    oc_rot_y = np.array([-np.sin(ao), np.cos(ao)])
    oc_bounds = np.array(
        [geom.oc_rect[:, 0].min(), geom.oc_rect[:, 0].max(),
         geom.oc_rect[:, 1].min(), geom.oc_rect[:, 1].max()]
    )

    return TraceGeometry(
        ic_center=np.asarray(d.ic_center, dtype=np.float64),
        ic_radius=d.pupil_radius,
        ic_hp=convex.halfplanes(geom.ic),
        r1_hp=hp(geom.eff_reg1),
        r2_hp=hp(geom.eff_reg2),
        hull_hp=hp(geom.cloud_hull),
        fc_rot=fc_rot,
        fc_top=fs["top"],
        fc_width=fs["width"],
        num_fc=len(geom.fc_strips),
        oc_rot_y=oc_rot_y,
        oc_bounds=oc_bounds,
        oc_top=os_["top"],
        oc_width=os_["width"],
        num_oc=len(geom.oc_strips),
        eyebox_range=geom.eyebox_range,
    )
