"""Synthetic RCWA look-up tables.

A frozen copy of the port's ``luts/synthetic.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The reference ships its LUTs as pre-computed ``.npy`` downloads (its RCWA solver is
"currently unavailable", README.md:80, download_lut.py:13-19).  Those
files cannot be fetched in an offline environment, so this module synthesizes LUTs that
are *physically consistent* with a given design:

- direction channels (theta/phi) are taken from the design's exact k-space angle tables
  (what an RCWA solver would tabulate for the grating equation),
- Jones matrices are ``c * U`` with ``U`` unitary, so each branch's Russian-roulette
  probability equals a prescribed smooth diffraction-efficiency profile *independent of
  the incident polarization state*, while still mixing TE/TM with nontrivial phases,
- branch efficiencies at every interaction site sum to < 1 (probability conservation),
  and out-coupler strips are gain-graded (later strips eject a larger fraction) the way
  production waveguides equalize eyebox brightness.

If the real LUT files are present, use :mod:`.io` instead; everything downstream is
agnostic to where the LUTs came from.

Batching: the random efficiency profiles and unitary mixes depend only on the FoV
coordinates and the seed — not on the design — so for a batch of designs the expensive
transcendentals are computed once and only the per-design scale factors broadcast over
a leading design axis, bitwise-identically to per-design calls.  The RNG-draw-ordered
branch sequence lives in ONE place (:func:`_synth_quads`) consumed by both
:func:`make_synthetic_luts_batch` (materializes the channel-layout LUT arrays) and the
fused sweep-prep path (:func:`..luts.packing.build_cell_tables_synthetic_batch`, which
skips the channel arrays entirely).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from .geometry import DesignGeometry
from .schema import FILE_CHANNELS, PHI_CHANNEL, RcwaLuts
from . import schema


def _unitary(beta, d1, d2):
    """2x2 unitary: rotation by beta times diagonal phases; broadcasts elementwise.

    Returns (u00, u01, u10, u11) complex arrays.
    """
    cb, sb = np.cos(beta), np.sin(beta)
    e1 = np.exp(1j * d1)
    e2 = np.exp(1j * d2)
    return cb * e1, -sb * e2, sb * e1, cb * e2


def _profile(base, amp, u, v, l, fx, fy, fl, phase):
    """Smooth bounded efficiency profile over (lambda, fov_x, fov_y)."""
    p = base * (1.0 + amp * np.cos(2 * np.pi * (fx * u + fy * v) + fl * l + phase))
    return np.clip(p, 0.01, 0.95)


def _stack_angles(geoms: Sequence[DesignGeometry]) -> dict:
    """Per-design (L, M, N) angle tables stacked to (D, L, M, N); shared checks."""
    D = len(geoms)
    g0 = geoms[0]
    L, M, N = g0.th_out_ic.shape
    num_fc = len(g0.fc_strips)
    num_oc = len(g0.oc_strips)
    for g in geoms[1:]:
        if (g.th_out_ic.shape != (L, M, N) or len(g.fc_strips) != num_fc
                or len(g.oc_strips) != num_oc):
            raise ValueError("designs in one LUT batch must share grid shapes")
    # per-design n_glass broadcasts as a (D, 1, 1, 1) column: every op it
    # joins is elementwise, so results stay bitwise-identical to per-design
    # scalar n_g (mixed-glass sweep batches are legal, like the per-design
    # prep path they replaced)
    n_g = np.array([g.design.n_glass for g in geoms]).reshape(D, 1, 1, 1)

    def dstack(attr):
        return np.stack([getattr(g, attr) for g in geoms])

    return dict(
        D=D, L=L, M=M, N=N, num_fc=num_fc, num_oc=num_oc, n_g=n_g,
        th_in_ic=dstack("th_in_ic"),
        th_out_ic=dstack("th_out_ic"), phi_out_ic=dstack("phi_out_ic"),
        th_out_ic2=dstack("th_out_ic2"), phi_out_ic2=dstack("phi_out_ic2"),
        th_out_fc=dstack("th_out_fc"), phi_out_fc=dstack("phi_out_fc"),
        th_out_oc=dstack("th_out_oc"), phi_out_oc=dstack("phi_out_oc"),
    )


def _synth_quads(A: dict, seed: int):
    """Yield ``(key, (j00, j01, j10, j11))`` in the exact RNG draw order.

    ``A`` is :func:`_stack_angles` output; each matrix element is a (D, L, M, N)
    complex128 array.  Keys are branch names, with a strip index for coupler
    strips (e.g. ``("fc1_fold", 3)``).  This generator is the single source of
    truth for the synthetic Jones sequence — every consumer must iterate it
    fully and in order so the ``default_rng(seed)`` stream stays aligned.
    """
    L, M, N = A["L"], A["M"], A["N"]
    n_g = A["n_g"]
    rng = np.random.default_rng(seed)

    # normalized FoV coordinates and wavelength index, broadcast to (1, L, M, N)
    u = (np.arange(M) / max(M - 1, 1) - 0.5)[None, None, :, None]
    v = (np.arange(N) / max(N - 1, 1) - 0.5)[None, None, None, :]
    l = np.arange(L)[None, :, None, None].astype(np.float64)

    cos_in_air = np.cos(A["th_in_ic"])
    cos_ic = np.cos(A["th_out_ic"])
    cos_ic2 = np.cos(A["th_out_ic2"])
    cos_fc = np.cos(A["th_out_fc"])
    cos_oc = np.cos(A["th_out_oc"])

    def prof(base, amp):
        # design-independent: shape (1, L, M, N)
        return _profile(
            base, amp, u, v, l,
            fx=rng.uniform(0.2, 0.8), fy=rng.uniform(0.2, 0.8),
            fl=rng.uniform(0.5, 2.0), phase=rng.uniform(0, 2 * np.pi),
        )

    def jones(p, cos_in, cos_out, extra=1.0):
        """Scaled unitary giving branch probability exactly p for any input state.

        ``p`` and the unitary are design-independent; only the scale ``c`` carries
        the design axis, so ``c * U`` broadcasts to (D, L, M, N) elementwise-
        identically to computing each design separately.
        """
        c = np.sqrt(p * cos_in / (cos_out * extra))
        beta = 0.15 * np.sin(2 * np.pi * (u + v) + l) + rng.uniform(-0.2, 0.2)
        d1 = rng.uniform(0, 2 * np.pi) + 0.3 * np.sin(4 * u + l)
        d2 = rng.uniform(0, 2 * np.pi) + 0.3 * np.cos(3 * v - l)
        j00, j01, j10, j11 = _unitary(beta, d1, d2)
        return c * j00, c * j01, c * j10, c * j11

    # ---- lut_ic1: first interaction from air
    p_a = prof(0.50, 0.18)
    p_b = prof(0.12, 0.30)
    yield "ic1_to_ic2", jones(p_a, cos_in_air, cos_ic, extra=n_g)
    yield "ic1_to_ic3", jones(p_b, cos_in_air, cos_ic2, extra=n_g)

    # ---- lut_ic2 / lut_ic3: re-diffraction while over the IC
    yield "ic2_to_ic2", jones(prof(0.70, 0.10), cos_ic, cos_ic)
    yield "ic2_to_ic3", jones(prof(0.12, 0.3), cos_ic, cos_ic2)
    yield "ic3_to_ic2", jones(prof(0.45, 0.2), cos_ic2, cos_ic)
    yield "ic3_to_ic3", jones(prof(0.35, 0.2), cos_ic2, cos_ic2)

    # ---- lut_fc1 / lut_fc2: folding couplers, per strip
    for s in range(A["num_fc"]):
        # fold fraction rises slightly along the strip stack
        grade = 0.14 + 0.12 * s / max(A["num_fc"] - 1, 1)
        yield ("fc1_stay", s), jones(prof(0.78, 0.06), cos_ic, cos_ic)
        yield ("fc1_fold", s), jones(prof(grade, 0.2), cos_ic, cos_fc)
        yield ("fc2_unfold", s), jones(prof(0.04, 0.3), cos_fc, cos_ic)
        yield ("fc2_stay", s), jones(prof(0.90, 0.04), cos_fc, cos_fc)

    # ---- lut_oc1 / lut_oc2: out-couplers, per strip
    for s in range(A["num_oc"]):
        frac = s / max(A["num_oc"] - 1, 1)
        p_out = 0.12 + 0.20 * frac          # graded ejection
        p_stay = 0.82 - 0.30 * frac
        yield ("oc1_stay", s), jones(prof(p_stay, 0.05), cos_fc, cos_fc)
        yield ("oc1_reverse", s), jones(prof(0.04, 0.3), cos_fc, cos_oc)
        yield ("oc1_out", s), jones(
            prof(p_out, 0.15), cos_fc, cos_in_air, extra=1.0 / n_g)
        yield ("oc2_unreverse", s), jones(prof(0.40, 0.2), cos_oc, cos_fc)
        yield ("oc2_stay", s), jones(prof(0.40, 0.15), cos_oc, cos_oc)
        yield ("oc2_out", s), jones(
            prof(p_out * 0.8, 0.2), cos_oc, cos_in_air, extra=1.0 / n_g)


def make_synthetic_luts(
    geom: DesignGeometry, seed: int = 1234, dtype=np.complex128
) -> RcwaLuts:
    """Build all seven LUTs for ``geom``'s FoV grid."""
    return make_synthetic_luts_batch([geom], seed=seed, dtype=dtype)[0]


# branch key -> (lut name, channel-quadruple schema name)
_QUAD_CHANNELS = {
    "ic1_to_ic2": ("ic1", schema.JONES_IC1_TO_IC2),
    "ic1_to_ic3": ("ic1", schema.JONES_IC1_TO_IC3),
    "ic2_to_ic2": ("ic2", schema.JONES_IC2_TO_IC2),
    "ic2_to_ic3": ("ic2", schema.JONES_IC2_TO_IC3),
    "ic3_to_ic2": ("ic3", schema.JONES_IC3_TO_IC2),
    "ic3_to_ic3": ("ic3", schema.JONES_IC3_TO_IC3),
    "fc1_stay": ("fc1", schema.JONES_FC1_STAY),
    "fc1_fold": ("fc1", schema.JONES_FC1_FOLD),
    "fc2_unfold": ("fc2", schema.JONES_FC2_UNFOLD),
    "fc2_stay": ("fc2", schema.JONES_FC2_STAY),
    "oc1_stay": ("oc1", schema.JONES_OC1_STAY),
    "oc1_reverse": ("oc1", schema.JONES_OC1_REVERSE),
    "oc1_out": ("oc1", schema.JONES_OC1_OUT),
    "oc2_unreverse": ("oc2", schema.JONES_OC2_UNREVERSE),
    "oc2_stay": ("oc2", schema.JONES_OC2_STAY),
    "oc2_out": ("oc2", schema.JONES_OC2_OUT),
}


def make_synthetic_luts_batch(
    geoms: Sequence[DesignGeometry], seed: int = 1234, dtype=np.complex128
) -> List[RcwaLuts]:
    """Build the seven channel-layout LUTs for every design in one pass.

    All designs must share (L, M, N, num_fc, num_oc).  Bitwise-identical to
    per-design ``make_synthetic_luts`` calls (tests/test_luts_io.py).  For the
    sweep hot path prefer ``build_cell_tables_synthetic_batch`` (packing.py),
    which consumes the same branch stream without materializing these
    channel arrays.
    """
    A = _stack_angles(geoms)
    D, L, M, N = A["D"], A["L"], A["M"], A["N"]
    num_fc, num_oc = A["num_fc"], A["num_oc"]

    arrs = {
        "ic1": np.zeros((D, L, M, N, FILE_CHANNELS["ic1"]), dtype=np.complex128),
        "ic2": np.zeros((D, L, M, N, FILE_CHANNELS["ic2"]), dtype=np.complex128),
        "ic3": np.zeros((D, L, M, N, FILE_CHANNELS["ic3"]), dtype=np.complex128),
        "fc1": np.zeros((D, num_fc, L, M, N, FILE_CHANNELS["fc1"]), dtype=np.complex128),
        "fc2": np.zeros((D, num_fc, L, M, N, FILE_CHANNELS["fc2"]), dtype=np.complex128),
        "oc1": np.zeros((D, num_oc, L, M, N, FILE_CHANNELS["oc1"]), dtype=np.complex128),
        "oc2": np.zeros((D, num_oc, L, M, N, FILE_CHANNELS["oc2"]), dtype=np.complex128),
    }
    # direction channels from the design's exact angle tables
    arrs["ic1"][..., 0] = A["th_in_ic"]
    arrs["ic2"][..., 0] = A["th_out_ic"]
    arrs["ic2"][..., PHI_CHANNEL["ic2"]] = A["phi_out_ic"]
    arrs["ic3"][..., 0] = A["th_out_ic2"]
    arrs["ic3"][..., PHI_CHANNEL["ic3"]] = A["phi_out_ic2"]
    for s in range(num_fc):
        arrs["fc1"][:, s, ..., 0] = A["th_out_ic"]
        arrs["fc1"][:, s, ..., PHI_CHANNEL["fc1"]] = A["phi_out_ic"]
        arrs["fc2"][:, s, ..., 0] = A["th_out_fc"]
        arrs["fc2"][:, s, ..., PHI_CHANNEL["fc2"]] = A["phi_out_fc"]
    for s in range(num_oc):
        arrs["oc1"][:, s, ..., 0] = A["th_out_fc"]
        arrs["oc1"][:, s, ..., PHI_CHANNEL["oc1"]] = A["phi_out_fc"]
        arrs["oc2"][:, s, ..., 0] = A["th_out_oc"]
        arrs["oc2"][:, s, ..., 1] = A["phi_out_oc"]  # unused by the tracer
        arrs["oc2"][:, s, ..., PHI_CHANNEL["oc2"]] = A["phi_out_oc"]

    for key, mats in _synth_quads(A, seed):
        name, strip = key if isinstance(key, tuple) else (key, None)
        lut, quad = _QUAD_CHANNELS[name]
        target = arrs[lut] if strip is None else arrs[lut][:, strip]
        a, b, cch, d = quad
        target[..., a], target[..., b], target[..., cch], target[..., d] = mats

    out = []
    for i in range(D):
        # copy each design's slice for D > 1: returning views would pin the
        # whole (D, ...) batch in memory for as long as any one design's
        # tables are retained
        def take(name):
            a = arrs[name][i]
            return a.copy() if D > 1 else a

        luts = RcwaLuts(ic1=take("ic1"), ic2=take("ic2"), ic3=take("ic3"),
                        fc1=take("fc1"), fc2=take("fc2"), oc1=take("oc1"),
                        oc2=take("oc2"))
        if i == 0:
            # the construction makes branch probabilities design-independent;
            # validating every member of a large batch would undo the batching
            luts.validate(num_fc, num_oc, L, M, N)
        out.append(luts.astype(dtype) if dtype != np.complex128 else luts)
    return out
