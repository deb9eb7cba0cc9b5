"""Frozen configuration dataclasses.

A frozen copy of the port's ``config.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The reference hard-codes every parameter in-source (design constants inside
``couplers_coor_full_color`` at couplers_coor.py:124-188, workload
constants in the driver at gpu_ray_tracing_pro_fullColor.py:16-17,60-61,
eval constants inside ``evaluation`` at
AR_system_evaluation_functions.py:47-96).  Here the same defaults live in
three frozen dataclasses so designs can be swept programmatically.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

DEG = math.pi / 180.0


@dataclasses.dataclass(frozen=True)
class WaveguideDesign:
    """Optical design of the diffractive waveguide (paper defaults).

    Mirrors the constants of couplers_coor.py:124-188.
    Lengths in mm, wavelengths and grating periods in nm, angles in radians.
    """

    # Field of view
    fov_x: float = 18.0 * DEG
    aspect_ratio: float = 4.0 / 3.0

    # Wavelengths (nm), index order 0=B, 1=G, 2=R (reference order 465/532/630)
    wavelengths: Tuple[float, ...] = (465.0, 532.0, 630.0)

    # Substrate
    n_glass: float = 1.9
    n_air: float = 1.0
    glass_x: float = 60.0
    glass_y: float = 50.0
    thickness: float = 0.7

    # Coupler counts
    num_fc: int = 7
    num_oc: int = 6

    # Input pupil (in-coupler)
    pupil_radius: float = 2.0
    ic_center: Tuple[float, float] = (-28.0, 15.0)
    ic_num_vertices: int = 100

    # Eyebox
    eyebox_size: Tuple[float, float] = (12.0, 8.0)
    eyebox_center: Tuple[float, float] = (0.0, 15.0)
    eye_relief: float = -20.0

    # Gratings: period (nm) and in-plane k-vector orientation (rad)
    lambda_ic: float = 388.0
    phi_ic: float = -38.0 * DEG
    lambda_oc: float = 388.0
    phi_oc: float = -142.0 * DEG

    # Resolution of the k-space design sweep used to build the folding region
    design_sweep_n: int = 50

    @property
    def fov_y(self) -> float:
        return self.fov_x / self.aspect_ratio

    @property
    def num_wavelengths(self) -> int:
        return len(self.wavelengths)


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Monte-Carlo trace workload configuration.

    Defaults mirror gpu_ray_tracing_pro_fullColor.py:16-17,37,60-61 and
    the bounce bound at GPU_ray_tracing_functions.py:905.
    """

    num_fov_x: int = 100
    num_fov_y: int = 75
    rays_per_fov: int = 5000       # per (FoV, wavelength) cell; half TE, half TM
    num_iter: int = 4              # additive re-trace passes
    max_bounces: int = 100_000     # hard bounce budget per ray
    eyebox_bins: Tuple[int, int] = (80, 120)   # (Ny, Nx) histogram bins
    seed: int = 0

    # RNG: 'fast' = hashed xorshift32 seeding; 'parity' = the reference's
    # 0x9E3779B9*(idx+1) seeding (gpu_ray_tracing_pro_fullColor.py:158)
    rng_mode: str = "fast"

    # IC containment: 'polygon' = 100-gon even-odd parity with the reference;
    # 'circle' = exact radius test (faster, statistically equivalent)
    ic_test: str = "circle"

    # Share one set of in-coupler sample points across every (FoV, lambda, pol)
    # cell exactly like the reference driver (:79-115), vs. independent samples.
    shared_pupil_samples: bool = True

    # 'numpy' or 'native' (C++ host sampler via ctypes, numpy fallback)
    pupil_sampler: str = "numpy"

    # Pupil point distribution: 'uniform' = rejection-sampled uniform points
    # (the reference's sampler, GPU_ray_tracing_functions.py:12-23); 'r2' =
    # randomized low-discrepancy points (R2 lattice + per-iteration
    # Cranley-Patterson rotation, concentric-mapped into the in-coupler's
    # inscribed disk).  'r2' is an unbiased RQMC estimator with the same mean
    # and lower pupil-axis variance — a beyond-reference capability.
    pupil_sampling: str = "uniform"


@dataclasses.dataclass(frozen=True)
class EvalConfig:
    """Display-metric evaluation configuration.

    Mirrors AR_system_evaluation_functions.py:47-96.
    """

    pupil_mask_bins: int = 30     # 3 mm pupil at 0.1 mm/bin
    eye_step_y: int = 8
    eye_step_x: int = 12
