"""Waveguide design presets (the framework's "model zoo").

``paper_default`` reproduces the reference constants
(couplers_coor.py:124-188); the others are representative design
variants for sweeps and regression baselines.
"""

from __future__ import annotations

import math

from ..config import WaveguideDesign

DEG = math.pi / 180.0


def paper_default() -> WaveguideDesign:
    """The published design: 18 deg x 13.5 deg FoV, n=1.9, 388 nm gratings."""
    return WaveguideDesign()


def wide_fov() -> WaveguideDesign:
    """24-degree horizontal FoV variant (larger out-coupler, denser k-space)."""
    return WaveguideDesign(fov_x=24.0 * DEG)


def thin_substrate() -> WaveguideDesign:
    """0.5 mm substrate: shorter TIR hops, denser pupil replication."""
    return WaveguideDesign(thickness=0.5)


def high_index() -> WaveguideDesign:
    """n=2.0 glass: smaller critical angle, wider guided FoV headroom."""
    return WaveguideDesign(n_glass=2.0)


def compact_eyebox() -> WaveguideDesign:
    """10 x 7 mm eyebox at 18 mm eye relief."""
    return WaveguideDesign(eyebox_size=(10.0, 7.0), eye_relief=-18.0)


PRESETS = {
    "paper_default": paper_default,
    "wide_fov": wide_fov,
    "thin_substrate": thin_substrate,
    "high_index": high_index,
    "compact_eyebox": compact_eyebox,
}


def get(name: str) -> WaveguideDesign:
    try:
        return PRESETS[name]()
    except KeyError:
        raise KeyError(
            f"unknown design preset {name!r}; available: {sorted(PRESETS)}"
        ) from None
