"""Eye-view image export.

Mirrors the reference driver's PNG output (gpu_ray_tracing_pro_fullColor.py:199-203):
the simulated view at eye position (0, last-x), vertically flipped, 8-bit.
"""

from __future__ import annotations

import numpy as np


def eye_view_uint8(output_image: np.ndarray, eye_y: int = 0,
                   eye_x: int = -1) -> np.ndarray:
    """(FoVy, FoVx, 3) uint8 view for one eye position from the evaluation stack."""
    view = output_image[:, :, :, eye_y, eye_x]
    view = np.flipud(np.clip(view, 0.0, 1.0))
    return (view * 255.0).astype(np.uint8)


def save_png(path: str, rgb_uint8: np.ndarray) -> None:
    """Write an RGB uint8 image; prefers cv2 (parity), falls back to PIL."""
    try:
        import cv2

        cv2.imwrite(path, cv2.cvtColor(rgb_uint8, cv2.COLOR_RGB2BGR))
    except ImportError:
        from PIL import Image

        Image.fromarray(rgb_uint8).save(path)


def save_eyebox_center_view(path: str, output_image: np.ndarray) -> None:
    save_png(path, eye_view_uint8(output_image))


def save_eyebox_luminance_map(path: str, eye_luminance: np.ndarray) -> None:
    """Heatmap of mean luminance per eye position over the eyebox.

    Intended for the dense eye-position scan (evaluate_dense /
    ``simulate --dense-eyebox``): the (n_epy, n_epx) luminance map at every
    valid pupil position — the full-resolution view of what the reference's
    7x8 sampled grid (AR_system_evaluation_functions.py:91-109) probes at 56
    points.  Positions with zero luminance (starved or dark) render black.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    lum = np.asarray(eye_luminance, dtype=np.float64)
    fig, ax = plt.subplots(figsize=(8, 5))
    mx = lum.max()
    im = ax.imshow(lum / mx if mx > 0 else lum, origin="lower",
                   aspect="auto", cmap="magma", vmin=0.0, vmax=1.0)
    ax.set_title("Eyebox luminance (per eye position, normalized)")
    ax.set_xlabel("eye position x (0.1 mm bins)")
    ax.set_ylabel("eye position y (0.1 mm bins)")
    fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def save_fov_efficiency_heatmaps(path: str, histogram: np.ndarray) -> None:
    """3-panel normalized per-FoV efficiency heatmaps, one per color.

    Mirrors the reference driver's final figure
    (gpu_ray_tracing_pro_fullColor.py:213-237): per-FoV deposit totals summed
    over the eyebox, normalized to each panel's maximum, rendered R/G/B.
    ``histogram`` is the (L, FoVy, FoVx, eb_y, eb_x) eyebox histogram in
    wavelength order (B, G, R).
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    per_fov = np.asarray(histogram.sum(axis=(-2, -1)))  # (L, FoVy, FoVx)
    names = [("Red", 2), ("Green", 1), ("Blue", 0)]
    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for ax, (name, l) in zip(axes, names):
        img = per_fov[l]
        mx = img.max()
        im = ax.imshow(img / mx if mx > 0 else img, origin="lower",
                       aspect="auto", cmap="viridis", vmin=0.0, vmax=1.0)
        ax.set_title(f"{name} normalized FoV efficiency")
        ax.set_xlabel("FoV x")
        ax.set_ylabel("FoV y")
        fig.colorbar(im, ax=ax)
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)
