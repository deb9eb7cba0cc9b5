"""Colorimetry primitives: sRGB transfer, XYZ/Lab, CIEDE2000, brightness norm.

A frozen copy of the port's ``eval/color.py``, kept as the
benchmark's reference: the program may change, this may not.

Self-contained replacements for the reference's ``colour``/``cv2`` usage
(AR_system_evaluation_functions.py).  Two faithfulness notes:

1. The reference feeds ``colour.XYZ_to_Lab`` XYZ values scaled x100 while colour's
   D65 whitepoint is Y=1 (AR_system_evaluation_functions.py:138-144), so its Lab
   values (and hence its delta-E numbers) live on an inflated scale.  ``xyz_to_lab``
   reproduces exactly that convention (whitepoint Y=1, inputs as given).
2. ``normalize_brightness_without_changing_color`` (:18-43) round-trips through HSV
   only to divide V by its global max; for float RGB that is algebraically identical
   to dividing the whole image by its max value, which is what
   ``normalize_brightness`` does.

Copied from the JAX package's ``eval/color.py``; ``xp`` takes ``numpy``
(float64, the host metrics) or ``torch`` (the tensors' dtype and device, the
device metrics) where the JAX package takes ``numpy`` or ``jax.numpy``.
"""

from __future__ import annotations

import numpy as np
import torch


class _TorchNamespace:
    """The numpy names this module uses, on torch tensors."""

    where = staticmethod(torch.where)
    sqrt = staticmethod(torch.sqrt)
    hypot = staticmethod(torch.hypot)
    arctan2 = staticmethod(torch.atan2)
    degrees = staticmethod(torch.rad2deg)
    radians = staticmethod(torch.deg2rad)
    sin = staticmethod(torch.sin)
    cos = staticmethod(torch.cos)
    exp = staticmethod(torch.exp)
    abs = staticmethod(torch.abs)

    asarray = staticmethod(torch.as_tensor)

    @staticmethod
    def cbrt(t):
        return torch.sign(t) * torch.abs(t) ** (1.0 / 3.0)

    @staticmethod
    def stack(arrays, axis=0):
        return torch.stack(arrays, dim=axis)


_TORCH = _TorchNamespace()


def _ns(xp):
    """``numpy`` as it is; ``torch`` as a namespace with numpy's names."""
    if xp is np:
        return np
    if xp is torch:
        return _TORCH
    raise ValueError(f"xp must be numpy or torch, got {xp!r}")

# CIE 1931 2-degree D65 whitepoint at colour-science's Y=1 normalization
D65_WHITE_Y1 = np.array([0.95047, 1.00000, 1.08883])
# The reference's D65 reference stimulus: spectral D65 integrated and scaled to
# Y=100 (AR_system_evaluation_functions.py:60-62)
D65_XYZ_100 = D65_WHITE_Y1 * 100.0


def linearize_srgb(srgb: np.ndarray, xp=np) -> np.ndarray:
    """sRGB electro-optical transfer (gamma removal), 0-1 float."""
    xp = _ns(xp)
    srgb = xp.asarray(srgb)
    return xp.where(srgb <= 0.04045, srgb / 12.92, ((srgb + 0.055) / 1.055) ** 2.4)


def apply_srgb_gamma(linear: np.ndarray, xp=np) -> np.ndarray:
    """Inverse sRGB transfer (gamma application), 0-1 float."""
    xp = _ns(xp)
    linear = xp.asarray(linear)
    return xp.where(
        linear <= 0.0031308, linear * 12.92, 1.055 * linear ** (1 / 2.4) - 0.055
    )


def normalize_brightness(rgb: np.ndarray) -> np.ndarray:
    """Scale the image so its brightest HSV-V (= max channel) is 1."""
    peak = float(np.max(rgb))
    return rgb / peak if peak > 0 else rgb


def xyz_to_lab(xyz: np.ndarray, whitepoint: np.ndarray = D65_WHITE_Y1,
               xp=np) -> np.ndarray:
    """CIE L*a*b* from XYZ (..., 3) against ``whitepoint`` (no rescaling of inputs).

    ``xp`` selects the array namespace: ``numpy`` (default; computes in
    float64 exactly as before) or ``torch`` (device path; keeps the input
    dtype and device, float32 on the GPU).
    """
    if xp is np:
        xyz = np.asarray(xyz, dtype=np.float64)
        wp = np.asarray(whitepoint, dtype=xyz.dtype)
    else:
        wp = torch.as_tensor(whitepoint, dtype=xyz.dtype, device=xyz.device)
    xp = _ns(xp)
    t = xyz / wp
    delta = 6.0 / 29.0
    f = xp.where(t > delta**3, xp.cbrt(t), t / (3 * delta**2) + 4.0 / 29.0)
    l = 116.0 * f[..., 1] - 16.0
    a = 500.0 * (f[..., 0] - f[..., 1])
    b = 200.0 * (f[..., 1] - f[..., 2])
    return xp.stack([l, a, b], axis=-1)


def delta_e_2000(lab1: np.ndarray, lab2: np.ndarray,
                 k_l: float = 1.0, k_c: float = 1.0, k_h: float = 1.0,
                 xp=np) -> np.ndarray:
    """CIEDE2000 color difference, broadcasting over leading axes of (..., 3)."""
    if xp is np:
        lab1 = np.asarray(lab1, dtype=np.float64)
        lab2 = np.asarray(lab2, dtype=np.float64)
    xp = _ns(xp)
    l1, a1, b1 = lab1[..., 0], lab1[..., 1], lab1[..., 2]
    l2, a2, b2 = lab2[..., 0], lab2[..., 1], lab2[..., 2]

    c1 = xp.hypot(a1, b1)
    c2 = xp.hypot(a2, b2)
    c_bar = 0.5 * (c1 + c2)
    g = 0.5 * (1.0 - xp.sqrt(c_bar**7 / (c_bar**7 + 25.0**7)))
    a1p = (1.0 + g) * a1
    a2p = (1.0 + g) * a2
    c1p = xp.hypot(a1p, b1)
    c2p = xp.hypot(a2p, b2)
    h1p = xp.degrees(xp.arctan2(b1, a1p)) % 360.0
    h2p = xp.degrees(xp.arctan2(b2, a2p)) % 360.0

    dl = l2 - l1
    dc = c2p - c1p
    dh_cond = h2p - h1p
    dhp = xp.where(
        c1p * c2p == 0.0,
        0.0,
        xp.where(
            xp.abs(dh_cond) <= 180.0,
            dh_cond,
            xp.where(dh_cond > 180.0, dh_cond - 360.0, dh_cond + 360.0),
        ),
    )
    dH = 2.0 * xp.sqrt(c1p * c2p) * xp.sin(xp.radians(dhp) / 2.0)

    l_bar = 0.5 * (l1 + l2)
    cp_bar = 0.5 * (c1p + c2p)
    h_sum = h1p + h2p
    h_diff = xp.abs(h1p - h2p)
    hp_bar = xp.where(
        c1p * c2p == 0.0,
        h_sum,
        xp.where(
            h_diff <= 180.0,
            0.5 * h_sum,
            xp.where(h_sum < 360.0, 0.5 * (h_sum + 360.0), 0.5 * (h_sum - 360.0)),
        ),
    )

    t = (
        1.0
        - 0.17 * xp.cos(xp.radians(hp_bar - 30.0))
        + 0.24 * xp.cos(xp.radians(2.0 * hp_bar))
        + 0.32 * xp.cos(xp.radians(3.0 * hp_bar + 6.0))
        - 0.20 * xp.cos(xp.radians(4.0 * hp_bar - 63.0))
    )
    d_theta = 30.0 * xp.exp(-(((hp_bar - 275.0) / 25.0) ** 2))
    r_c = 2.0 * xp.sqrt(cp_bar**7 / (cp_bar**7 + 25.0**7))
    s_l = 1.0 + 0.015 * (l_bar - 50.0) ** 2 / xp.sqrt(20.0 + (l_bar - 50.0) ** 2)
    s_c = 1.0 + 0.045 * cp_bar
    s_h = 1.0 + 0.015 * cp_bar * t
    r_t = -xp.sin(xp.radians(2.0 * d_theta)) * r_c

    term_l = dl / (k_l * s_l)
    term_c = dc / (k_c * s_c)
    term_h = dH / (k_h * s_h)
    return xp.sqrt(
        term_l**2 + term_c**2 + term_h**2 + r_t * term_c * term_h
    )
