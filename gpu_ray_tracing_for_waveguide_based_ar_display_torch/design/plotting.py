"""Design visualization: k-space diagram, 2-D layout, angular response.

Counterpart of the reference visualizer (plot_design_fullColor.py):
the k-space diagram shows air/glass/max-TIR circles with per-wavelength coupler
footprints (:24-87), the layout plot shows OC/FC/IC outlines in the glass (:89-139),
and the angular-response panels show the guided (theta, phi) clouds per propagation
stage (:141-228; concave alpha-shapes there, plain scatter+hull here).  Matplotlib
with the Agg backend; every figure is written to disk, nothing is shown.
"""

from __future__ import annotations

from typing import List

import numpy as np

import matplotlib

matplotlib.use("Agg")
import matplotlib.pyplot as plt  # noqa: E402

from .geometry import DesignGeometry  # noqa: E402
from . import convex  # noqa: E402


def plot_k_space(geom: DesignGeometry, path: str) -> str:
    """Normalized in-plane k-space diagram with the three coupler footprints."""
    d = geom.design
    fig, ax = plt.subplots(figsize=(7, 7))
    th = np.linspace(0, 2 * np.pi, 256)
    ax.plot(np.cos(th), np.sin(th), "k-", lw=1, label="air (|k|=k0)")
    ax.plot(d.n_glass * np.cos(th), d.n_glass * np.sin(th), "k--", lw=1,
            label=f"glass (|k|={d.n_glass}k0)")
    k_max = np.sin(np.arctan(d.pupil_radius / d.thickness)) * d.n_glass
    ax.plot(k_max * np.cos(th), k_max * np.sin(th), "k:", lw=1, label="max TIR")

    colors = ["tab:blue", "tab:green", "tab:red"]
    k0 = 2 * np.pi / np.asarray(d.wavelengths)
    stages = [("IC", geom.k_air), ("guided", geom.k_after_ic),
              ("folded", geom.k_after_fc)]
    for li, (c, lam) in enumerate(zip(colors, d.wavelengths)):
        for name, (kx, ky) in stages:
            pts = np.stack([kx[li] / k0[li], ky[li] / k0[li]], axis=1)
            hull = convex.convex_hull(pts)
            hull = np.concatenate([hull, hull[:1]])
            ax.plot(hull[:, 0], hull[:, 1], color=c, lw=1.2,
                    label=f"{name} {lam:.0f} nm" if name == "guided" else None)
            ax.fill(hull[:, 0], hull[:, 1], color=c, alpha=0.15)
    ax.set_aspect("equal")
    ax.set_xlabel("kx / k0")
    ax.set_ylabel("ky / k0")
    ax.legend(loc="upper right", fontsize=8)
    ax.set_title("k-space footprint per propagation stage")
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_layout(geom: DesignGeometry, path: str) -> str:
    """2-D waveguide layout: IC circle, FC strips, OC strips, effective regions."""
    fig, ax = plt.subplots(figsize=(9, 7))
    for reg, style in ((geom.eff_reg1, dict(color="0.6", ls="--", lw=1)),
                       (geom.eff_reg2, dict(color="0.8", ls=":", lw=1))):
        ring = np.concatenate([reg, reg[:1]])
        ax.plot(ring[:, 0], ring[:, 1], **style)
    for s in geom.oc_strips:
        ring = np.concatenate([s, s[:1]])
        ax.fill(ring[:, 0], ring[:, 1], color="tab:blue", alpha=0.35,
                edgecolor="navy", lw=0.8)
    for s in geom.fc_strips:
        ring = np.concatenate([s, s[:1]])
        ax.fill(ring[:, 0], ring[:, 1], color="tab:green", alpha=0.35,
                edgecolor="darkgreen", lw=0.8)
    ic_ring = np.concatenate([geom.ic, geom.ic[:1]])
    ax.fill(ic_ring[:, 0], ic_ring[:, 1], color="tab:red", alpha=0.6,
            edgecolor="darkred")
    q = geom.eyebox_quad[geom.eyebox_quad.shape[0] // 2,
                         geom.eyebox_quad.shape[1] // 2]
    ax.plot(np.append(q[:, 0], q[0, 0]), np.append(q[:, 1], q[0, 1]),
            "m-", lw=1.5, label="center-FoV eyebox footprint")
    # eyeglass-lens superellipse outline with a nasal notch, sized to enclose
    # the couplers (the reference decorates its layout the same way,
    # plot_design_fullColor.py:89-139)
    pts = np.concatenate([geom.eff_reg1, geom.ic])
    cx, cy = pts.mean(axis=0)
    a = 1.25 * np.abs(pts[:, 0] - cx).max()
    b = 1.35 * np.abs(pts[:, 1] - cy).max()
    t = np.linspace(0.0, 2.0 * np.pi, 400)
    n = 3.0
    lx = cx + a * np.sign(np.cos(t)) * np.abs(np.cos(t)) ** (2.0 / n)
    ly = cy + b * np.sign(np.sin(t)) * np.abs(np.sin(t)) ** (2.0 / n)
    nose = (lx > cx + 0.75 * a) & (ly < cy - 0.35 * b)
    lx = lx.copy()
    lx[nose] -= 0.18 * a * np.cos(4.0 * (ly[nose] - cy) / b)
    ax.plot(lx, ly, color="0.3", lw=1.2, label="lens outline")
    ax.set_aspect("equal")
    ax.set_xlabel("x (mm)")
    ax.set_ylabel("y (mm)")
    ax.set_title("waveguide layout: IC (red), FC strips (green), OC strips (blue)")
    ax.legend(fontsize=8)
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_angular_response(geom: DesignGeometry, path: str) -> str:
    """Guided-direction (theta, phi) clouds for the five propagation stages
    (the reference's five panels, plot_design_fullColor.py:141-228; the fifth
    is the out-coupled air-side direction, which the grating closure returns
    to the input FoV grid)."""
    d = geom.design
    L = geom.th_out_ic.shape[0]
    # air-side output = input FoV direction for every wavelength
    hx = np.tan(np.linspace(-d.fov_x / 2, d.fov_x / 2, geom.th_out_ic.shape[1]))
    hy = np.tan(np.linspace(-d.fov_y / 2, d.fov_y / 2, geom.th_out_ic.shape[2]))
    gx, gy = np.meshgrid(hx, hy, indexing="ij")
    th_air = np.broadcast_to(np.arctan(np.hypot(gx, gy)), (L,) + gx.shape)
    phi_air = np.broadcast_to(np.arctan2(gy, gx), (L,) + gx.shape)
    fig, axes = plt.subplots(2, 3, figsize=(14, 8))
    stages = [
        ("after IC (dir-1)", geom.th_out_ic, geom.phi_out_ic),
        ("after IC (dir-2)", geom.th_out_ic2, geom.phi_out_ic2),
        ("after fold", geom.th_out_fc, geom.phi_out_fc),
        ("after OC reversal", geom.th_out_oc, geom.phi_out_oc),
        ("out-coupled (air) = input FoV", th_air, phi_air),
    ]
    colors = ["tab:blue", "tab:green", "tab:red"]
    th_min = np.degrees(np.arcsin(d.n_air / d.n_glass))
    for ax, (name, th, phi) in zip(axes.flat, stages):
        for li, c in enumerate(colors):
            px = np.degrees(phi[li]).ravel()
            py = np.degrees(th[li]).ravel()
            # filled concave footprint like the reference's alpha-shapes
            # (plot_design_fullColor.py:141-228, alpha=0.1 on degree coords);
            # crescent-shaped guided clouds keep their notches instead of
            # being overstated by a convex hull
            ring = convex.concave_boundary(np.column_stack([px, py]),
                                           alpha=0.1)
            if len(ring) >= 3:
                ax.fill(ring[:, 0], ring[:, 1], color=c, alpha=0.3,
                        edgecolor=c, lw=1.0)
            ax.scatter(px, py, s=2, color=c, alpha=0.4,
                       label=f"{d.wavelengths[li]:.0f} nm" if name == stages[0][0]
                       else None)
        if name != stages[-1][0]:
            ax.axhline(th_min, color="k", ls=":", lw=1)
        ax.set_title(name, fontsize=9)
        ax.set_xlabel("azimuth (deg)")
        ax.set_ylabel("polar (deg)")
    axes.flat[-1].axis("off")
    axes.flat[0].legend(fontsize=7)
    fig.suptitle("angular response per stage (dotted line = TIR critical angle)")
    fig.tight_layout()
    fig.savefig(path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return path


def plot_design(geom: DesignGeometry, prefix: str = "design") -> List[str]:
    return [
        plot_k_space(geom, f"{prefix}_kspace.png"),
        plot_layout(geom, f"{prefix}_layout.png"),
        plot_angular_response(geom, f"{prefix}_angular.png"),
    ]
