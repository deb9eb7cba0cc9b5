"""The display metrics in float64 on the host: pupil integration and the
colorimetry (CIEDE2000 colour dispersion, FoV and eyebox uniformity).

A frozen copy of the host path that the port's device tail is held to
(``evaluate`` with ``eye_perceived``), without the eye-view image; the
pupil integration runs in float64 PyTorch, on the card where the
histogram is.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import color

# Display primary response matrix (sensor RGB <- per-wavelength intensity) and
# its XYZ counterpart.
DISPLAY_M = np.array(
    [
        [1.67430115, -0.76582385, -0.06172232],
        [-0.12551154, 1.47840695, -0.04124377],
        [-0.01826868, -0.13098157, 1.61444037],
    ]
)
DISPLAY_M_XYZ = np.array(
    [
        [6.424000e-01, 1.891400e-01, 2.511000e-01],
        [2.650000e-01, 8.849624e-01, 7.390000e-02],
        [4.999999e-05, 3.693564e-02, 1.528100e+00],
    ]
)


@dataclasses.dataclass
class Metrics:
    delta_e: float           # mean CIE-2000 colour dispersion against white
    u_fov: float             # field-of-view luminance uniformity, 0-1
    u_eyebox: float          # eyebox luminance uniformity, 0-1
    starved_eye_positions: int   # positions with an empty (FoV, eye) bin


def pupil_mask(size: int) -> np.ndarray:
    """Circular pupil aperture mask over ``size x size`` bins."""
    radius = size / 2.0
    yy, xx = np.ogrid[:size, :size]
    center = radius - 0.5
    dist = np.sqrt((xx - center) ** 2 + (yy - center) ** 2)
    return (dist <= radius).astype(np.float64)


def eye_perceived(matrix_eb: torch.Tensor, mask_bins: int,
                  stride: tuple) -> torch.Tensor:
    """(..., eb_y, eb_x) float64 -> (..., n_epy, n_epx): the pupil disc's
    window sums at the eye positions that start every ``stride`` bins, on
    the tensor's device."""
    mask = torch.from_numpy(pupil_mask(mask_bins)).to(matrix_eb)
    msize = mask.shape[0]
    n_eby, n_ebx = matrix_eb.shape[-2:]
    y0s = range(0, n_eby - msize + 1, stride[0])
    x0s = range(0, n_ebx - msize + 1, stride[1])
    out = matrix_eb.new_zeros(matrix_eb.shape[:-2] + (len(y0s), len(x0s)))
    for iy, y0 in enumerate(y0s):
        for ix, x0 in enumerate(x0s):
            patch = matrix_eb[..., y0:y0 + msize, x0:x0 + msize]
            out[..., iy, ix] = (patch * mask).sum(dim=(-2, -1))
    return out


def evaluate(perceive: np.ndarray) -> Metrics:
    """The metrics of a (L, FoVy, FoVx, n_epy, n_epx) perception stack in
    per-ray units, wavelengths in (B, G, R) order."""
    n_l, n_fy, n_fx, n_epy, n_epx = perceive.shape
    white_linear = color.linearize_srgb(np.ones(3))
    drive = np.linalg.solve(DISPLAY_M, white_linear)
    # (B, G, R) -> (R, G, B)
    response = np.flip(np.transpose(perceive, (1, 2, 0, 3, 4)), axis=2)
    adjusted = drive[None, None, :, None, None] * response
    lab_white = color.xyz_to_lab(color.D65_XYZ_100)
    ep = np.transpose(adjusted, (3, 4, 0, 1, 2))  # (epy, epx, fy, fx, 3)
    xyz = ep @ DISPLAY_M_XYZ.T
    y_chan = xyz[..., 1]
    y_safe = np.maximum(y_chan, 1e-10)
    xyz_norm = xyz / y_safe[..., None] * 100.0
    lab = color.xyz_to_lab(xyz_norm)
    lab[y_chan == 0] = 0.0
    de = color.delta_e_2000(lab, lab_white)
    delta_e = float(np.mean(de))
    # a position with any empty (FoV, eye) bin is starved: it adds 0 to u_eb
    # and to the u_fov sum, but still divides by the full position count
    any0 = np.any(y_chan == 0, axis=(2, 3))
    ymax = y_chan.max(axis=(2, 3))
    ratio = np.where(any0, 0.0,
                     y_chan.min(axis=(2, 3)) / np.where(ymax > 0, ymax, 1.0))
    u_eb = np.where(any0, 0.0, y_chan.mean(axis=(2, 3)))
    return Metrics(
        delta_e=delta_e,
        u_fov=float(ratio.sum()) / (n_epy * n_epx),
        u_eyebox=0.0 if u_eb.max() == 0 else float(u_eb.min() / u_eb.max()),
        starved_eye_positions=int((u_eb == 0.0).sum()))
