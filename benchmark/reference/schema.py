"""RCWA look-up-table schema: array shapes and channel layout.

A frozen copy of the port's ``luts/schema.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The channel indices below are the contract between the LUT files and the tracer,
reverse-engineered from every LUT access in the reference full-color kernel
(GPU_ray_tracing_functions.py:833-1247).  Each interaction site reads a
Jones matrix as four channels passed to ``E_field_cal(ψ, E_te_te, E_te_tm, E_tm_te,
E_tm_tm)``; with the reference's internal assignment (a=E_te_te, b=E_tm_te, c=E_te_tm,
d=E_tm_tm, GPU_ray_tracing_functions.py:139-144) the matrix acting on (te, tm) is
``[[ch_a, ch_b], [ch_c, ch_d]]`` where the JONES_* tuples list (a, b, c, d).

Direction channels: channel 0 is the polar angle theta of the outgoing direction
(complex; ``.real`` is used), channel 1 the azimuth — except ``lut_oc2`` whose azimuth
lives at channel 2 (GPU_ray_tracing_functions.py:1151,1220).
"""

from __future__ import annotations

import dataclasses

import numpy as np

# Minimum channel counts accepted by validate() (max channel the tracer
# accesses + 1).  fc1's tracer maximum is channel 18 (full-color kernel,
# GPU_ray_tracing_functions.py:1007-1016), so a 19-channel fc1 file is fully
# consumable and must not be rejected.
CHANNELS = {
    "ic1": 41,
    "ic2": 32,
    "ic3": 30,
    "fc1": 19,
    "fc2": 20,
    "oc1": 39,
    "oc2": 41,
}

# Channel counts the SYNTHETIC files allocate — the reference's published
# file layout.  Differs from the tracer minimum only for fc1: the reference's
# deterministic-splitting kernel additionally reads fc1 channel 19
# (GPU_ray_tracing_functions.py:262,:320), so its shipped files carry 20.
FILE_CHANNELS = dict(CHANNELS, fc1=20)

# Jones channel quadruples (a, b, c, d) -> matrix [[a, b], [c, d]] on (te, tm)
# First IC interaction, air -> glass (kernel :860-869)
JONES_IC1_TO_IC2 = (13, 33, 18, 38)
JONES_IC1_TO_IC3 = (15, 35, 20, 40)
# Re-diffraction over the IC, propagation state 0 (dir-1) (:908-918)
JONES_IC2_TO_IC2 = (4, 24, 9, 29)
JONES_IC2_TO_IC3 = (6, 26, 11, 31)
# Re-diffraction over the IC, propagation state 1 (dir-2) (:955-964)
JONES_IC3_TO_IC2 = (2, 7, 22, 27)
JONES_IC3_TO_IC3 = (4, 24, 9, 29)
# Folding coupler, state 2 (pre-fold dir) (:1007-1016)
JONES_FC1_STAY = (3, 15, 6, 18)
JONES_FC1_FOLD = (2, 14, 5, 17)
# Folding coupler, state 3 (post-fold dir) (:1060-1069)
JONES_FC2_UNFOLD = (4, 16, 7, 19)
JONES_FC2_STAY = (3, 15, 6, 18)
# Out-coupler, state 4 (post-fold dir) (:1117-1131)
JONES_OC1_STAY = (4, 24, 9, 29)
JONES_OC1_REVERSE = (2, 22, 7, 27)
JONES_OC1_OUT = (13, 33, 18, 38)
# Out-coupler, state 5 (reversed dir) (:1186-1200)
JONES_OC2_UNREVERSE = (6, 26, 11, 31)
JONES_OC2_STAY = (4, 24, 9, 29)
JONES_OC2_OUT = (15, 35, 20, 40)

# Azimuth channel index per LUT (theta is always channel 0)
PHI_CHANNEL = {"ic2": 1, "ic3": 1, "fc1": 1, "fc2": 1, "oc1": 1, "oc2": 2}


@dataclasses.dataclass
class RcwaLuts:
    """The seven diffraction LUTs.

    Shapes (L = wavelengths, M = num_fov_x, N = num_fov_y, S = strips, C = channels):
    ``ic*``: (L, M, N, C); ``fc*``: (S_fc, L, M, N, C); ``oc*``: (S_oc, L, M, N, C).
    Complex valued.
    """

    ic1: np.ndarray
    ic2: np.ndarray
    ic3: np.ndarray
    fc1: np.ndarray
    fc2: np.ndarray
    oc1: np.ndarray
    oc2: np.ndarray

    def validate(self, num_fc: int, num_oc: int, L: int, M: int, N: int) -> None:
        for name in ("ic1", "ic2", "ic3"):
            arr = getattr(self, name)
            if arr.ndim != 4:
                raise ValueError(
                    f"lut_{name} must be 4-D (wavelength, FoV_x, FoV_y, "
                    f"channel); got {arr.ndim}-D shape {arr.shape} — a 3-D "
                    f"array is missing the full-color wavelength axis")
            if arr.shape[:3] != (L, M, N) or arr.shape[3] < CHANNELS[name]:
                raise ValueError(
                    f"lut_{name} shape {arr.shape} invalid for "
                    f"(L,M,N)=({L},{M},{N}): needs >= {CHANNELS[name]} channels")
        for name, s in (("fc1", num_fc), ("fc2", num_fc), ("oc1", num_oc), ("oc2", num_oc)):
            arr = getattr(self, name)
            if arr.ndim != 5:
                raise ValueError(
                    f"lut_{name} must be 5-D (strip, wavelength, FoV_x, FoV_y, "
                    f"channel); got {arr.ndim}-D shape {arr.shape}")
            if arr.shape[:4] != (s, L, M, N) or arr.shape[4] < CHANNELS[name]:
                raise ValueError(
                    f"lut_{name} shape {arr.shape} invalid for "
                    f"(S,L,M,N)=({s},{L},{M},{N}): needs >= {CHANNELS[name]} "
                    f"channels")
        for f in dataclasses.fields(self):
            if not np.iscomplexobj(getattr(self, f.name)):
                raise ValueError(
                    f"lut_{f.name} must be complex valued (Jones matrix "
                    f"entries); got dtype {getattr(self, f.name).dtype}")

    def astype(self, dtype) -> "RcwaLuts":
        return RcwaLuts(**{
            f.name: getattr(self, f.name).astype(dtype)
            for f in dataclasses.fields(self)
        })
