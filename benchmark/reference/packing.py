"""Packing raw LUTs + geometry into flat per-cell interaction tables.

A frozen copy of the port's ``luts/packing.py`` (host code only), kept as the
benchmark's reference: the program may change, this may not.

The tracer's unit of work is a *cell* = (wavelength, FoV_x index, FoV_y index); a ray's
cell never changes during its trace, so every LUT quantity it can ever touch is known
up front.  This module precomputes, per cell, a uniform "interaction record" for each
site kind so the hot loop is pure gathers + complex 2x2 matvecs with no trig:

- Jones matrices as complex64 2x2 (channel quadruples from :mod:`.schema`),
- branch efficiency scales (the cos(theta_out) numerators of the reference's
  ``efficiency = |J psi|^2 cos_out / cos_in`` roulette, including the n_g factors of
  the entry/exit sites, GPU_ray_tracing_functions.py:868-869,1131),
- TIR phase retardation as unit phasors e^{i delta} (the reference adds the angle to
  ``delta_phase``; in complex polarization state that is a multiply on the TM leg),
- per-direction TIR hop vectors.

Branch layout is uniform across states: branch A keeps/returns to the site's "first"
direction, branch B goes to the alternate direction, branch C (out-couplers only)
out-couples.  States sharing a site kind differ only in which Jones matrix applies, so
J tables carry a state-bit axis while scales/targets do not.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

from .geometry import DesignGeometry
from . import schema
from .schema import RcwaLuts

# direction indices into lut_gap pairs / lut_TIR channels
DIR_IC = 0    # post-IC, pre-fold ("dir-1")
DIR_FC = 1    # post-fold
DIR_IC2 = 2   # second IC order ("dir-2")
DIR_OC = 3    # post-OC reversal


@dataclasses.dataclass
class CellTables:
    """Flat per-cell tables; C = L*M*N cells, cid = (l*M + m)*N + n.

    Jones arrays are complex64 with a leading state-bit axis where the two states of a
    phase group read different channels; scales/cosines are float32.

    ``D > 1`` marks a *design-batched* table pack (``build_cell_tables_synthetic_batch``):
    the cell axis spans D contiguous per-design runs of L*M*N rows, exactly the layout
    the persistent kernel's multi-design grid consumes (trace_pallas_persistent.trace).
    """

    L: int
    M: int
    N: int

    # init site (first IC interaction from air)
    init_jones: np.ndarray      # (2, C, 2, 2) branch {A, B}
    init_scale: np.ndarray      # (2, C) cos_out * n_g
    init_cos0: np.ndarray       # (C,) cos of air-side incidence angle

    # over-IC re-diffraction site, states {0, 1}
    ic_jones: np.ndarray        # (2, 2, C, 2, 2)  [branch, state_bit, cid]
    ic_scale: np.ndarray        # (2, C) cos target per branch {A->ic dir, B->ic2 dir}

    # folding-coupler site, states {2, 3}; S_fc strips
    fc_jones: np.ndarray        # (2, S_fc, 2, C, 2, 2)
    fc_scale: np.ndarray        # (2, S_fc, C)

    # out-coupler site, states {4, 5}; S_oc strips
    oc_jones: np.ndarray        # (3, S_oc, 2, C, 2, 2)
    oc_scale: np.ndarray        # (2, S_oc, C); branch C scale is oc_scale_out
    oc_scale_out: np.ndarray    # (C,) cos(air)/n_g

    # per-cell constants
    gaps: np.ndarray            # (C, 4, 2) hop vector per direction
    tir_phasor: np.ndarray      # (C, 4) complex64 e^{i delta_TIR}
    hop2_phasor: np.ndarray     # (C, 4) complex64 e^{2 i delta_TIR}

    # design-batch size (see class docstring); 1 for single-design packs
    D: int = 1

    @property
    def num_cells(self) -> int:
        return self.D * self.L * self.M * self.N


def _cstack(arrs, axis: int = 0) -> np.ndarray:
    """``np.stack`` for complex arrays via a float-component view.

    Stacking the float32/float64 component views and viewing the result back
    is a pure reinterpretation — bitwise-identical output — that lets numpy
    take its contiguous-block copy path.  The real win on the target hosts is
    fewer *freshly allocated* intermediate bytes (first-touch of new pages is
    the dominant host cost there; see ``_disable_thp_first_touch`` in the
    package ``__init__``), so builders below prefer component buffers over
    nested complex stacking.  ``axis`` must be non-negative (the view widens
    the last axis, so stacking along it would interleave components).
    """
    a0 = arrs[0]
    if a0.dtype.kind != "c":
        return np.stack(arrs, axis=axis)
    assert axis >= 0, "use a non-negative axis with complex inputs"
    fdt = np.float32 if a0.dtype == np.complex64 else np.float64
    views = [np.ascontiguousarray(a).view(fdt) for a in arrs]
    return np.stack(views, axis=axis).view(a0.dtype)


def _jones_from(lut: np.ndarray, quad) -> np.ndarray:
    """Gather a (..., 2, 2) complex64 Jones stack from channel quadruple (a,b,c,d).

    Fills a float32 component buffer channel-by-channel instead of nesting
    ``np.stack`` on complex slices — the former stack-then-cast form touched
    ~3x the bytes in freshly allocated complex128 intermediates (see
    :func:`_cstack`); the float64->float32 component conversion is exactly the
    elementwise complex128->complex64 ``astype`` of the former form, so values
    are bitwise-identical.
    """
    lut = np.ascontiguousarray(lut)
    fdt = np.float64 if lut.dtype == np.complex128 else np.float32
    lv = lut.view(fdt).reshape(lut.shape + (2,))
    out = np.empty(lut.shape[:-1] + (2, 2, 2), np.float32)
    for i, ch in enumerate(quad):
        out[..., i // 2, i % 2, :] = lv[..., ch, :]
    return out.view(np.complex64).reshape(lut.shape[:-1] + (2, 2))


def build_cell_tables(geom: DesignGeometry, luts: RcwaLuts) -> CellTables:
    L, M, N = geom.th_out_ic.shape
    C = L * M * N
    f32 = np.float32

    def flat(x):
        """(L, M, N, ...) -> (C, ...)"""
        return np.ascontiguousarray(x.reshape((C,) + x.shape[3:]))

    def flat_s(x):
        """(S, L, M, N, ...) -> (S, C, ...)"""
        return np.ascontiguousarray(x.reshape((x.shape[0], C) + x.shape[4:]))

    cos = lambda ch0: np.cos(ch0.real).astype(f32)
    n_g = geom.design.n_glass

    cos_ic = cos(luts.ic2[..., 0])     # (L, M, N)
    cos_ic2 = cos(luts.ic3[..., 0])
    cos_air = cos(luts.ic1[..., 0])
    cos_fc1 = cos(luts.fc1[..., 0])    # (S, L, M, N)
    cos_fc2 = cos(luts.fc2[..., 0])
    cos_oc1 = cos(luts.oc1[..., 0])
    cos_oc2 = cos(luts.oc2[..., 0])

    init_jones = _cstack(
        [flat(_jones_from(luts.ic1, schema.JONES_IC1_TO_IC2)),
         flat(_jones_from(luts.ic1, schema.JONES_IC1_TO_IC3))]
    )
    init_scale = np.stack([flat(cos_ic * n_g), flat(cos_ic2 * n_g)]).astype(f32)
    init_cos0 = flat(cos_air)

    ic_jones = _cstack(
        [_cstack([flat(_jones_from(luts.ic2, schema.JONES_IC2_TO_IC2)),
                  flat(_jones_from(luts.ic3, schema.JONES_IC3_TO_IC2))]),
         _cstack([flat(_jones_from(luts.ic2, schema.JONES_IC2_TO_IC3)),
                  flat(_jones_from(luts.ic3, schema.JONES_IC3_TO_IC3))])]
    )  # (branch, bit, C, 2, 2)
    ic_scale = np.stack([flat(cos_ic), flat(cos_ic2)]).astype(f32)

    fc_jones = _cstack(
        [_cstack([flat_s(_jones_from(luts.fc1, schema.JONES_FC1_STAY)),
                  flat_s(_jones_from(luts.fc2, schema.JONES_FC2_UNFOLD))], axis=1),
         _cstack([flat_s(_jones_from(luts.fc1, schema.JONES_FC1_FOLD)),
                  flat_s(_jones_from(luts.fc2, schema.JONES_FC2_STAY))], axis=1)]
    )  # (branch, S, bit, C, 2, 2)
    fc_scale = np.stack([flat_s(cos_fc1), flat_s(cos_fc2)]).astype(f32)

    oc_jones = _cstack(
        [_cstack([flat_s(_jones_from(luts.oc1, schema.JONES_OC1_STAY)),
                  flat_s(_jones_from(luts.oc2, schema.JONES_OC2_UNREVERSE))], axis=1),
         _cstack([flat_s(_jones_from(luts.oc1, schema.JONES_OC1_REVERSE)),
                  flat_s(_jones_from(luts.oc2, schema.JONES_OC2_STAY))], axis=1),
         _cstack([flat_s(_jones_from(luts.oc1, schema.JONES_OC1_OUT)),
                  flat_s(_jones_from(luts.oc2, schema.JONES_OC2_OUT))], axis=1)]
    )  # (branch, S, bit, C, 2, 2)
    oc_scale = np.stack([flat_s(cos_oc1), flat_s(cos_oc2)]).astype(f32)
    oc_scale_out = flat((cos_air / n_g).astype(f32))

    gaps = flat(
        np.stack(
            [geom.lut_gap[..., 0:2], geom.lut_gap[..., 2:4],
             geom.lut_gap[..., 4:6], geom.lut_gap[..., 6:8]],
            axis=-2,
        ).astype(f32)
    )
    tir = geom.lut_tir  # (L, M, N, 4) already ordered (ic, fc, ic2, oc)
    tir_phasor = flat(np.exp(1j * tir).astype(np.complex64))
    hop2_phasor = flat(np.exp(2j * tir).astype(np.complex64))

    return CellTables(
        L=L, M=M, N=N,
        init_jones=init_jones, init_scale=init_scale, init_cos0=init_cos0,
        ic_jones=ic_jones, ic_scale=ic_scale,
        fc_jones=fc_jones, fc_scale=fc_scale,
        oc_jones=oc_jones, oc_scale=oc_scale, oc_scale_out=oc_scale_out,
        gaps=gaps, tir_phasor=tir_phasor, hop2_phasor=hop2_phasor,
    )


def build_cell_tables_synthetic_batch(
    geoms: Sequence[DesignGeometry], seed: int = 1234
) -> CellTables:
    """Synthetic-LUT cell tables for a whole design batch, fused.

    Equivalent to ``build_cell_tables(g, make_synthetic_luts(g, seed))`` per design
    with the results concatenated along the cell axis (D contiguous runs of C =
    L*M*N rows — the persistent kernel's multi-design layout), but **without
    materializing the channel-layout LUT arrays**: the synthetic Jones branches
    (synthetic._synth_quads, the single source of the RNG draw order) cast straight
    into the complex64 tables, and the channel put/gather round-trip — ~10x the
    final tables' footprint in complex128 traffic — disappears.  Field values are
    bitwise-identical to the unfused path (tests/test_luts_io.py pins this), since
    the channel arrays only ever stored these exact values.
    """
    from .synthetic import _stack_angles, _synth_quads

    A = _stack_angles(geoms)
    D, L, M, N = A["D"], A["L"], A["M"], A["N"]
    S_fc, S_oc = A["num_fc"], A["num_oc"]
    C = L * M * N
    DC = D * C
    f32 = np.float32
    # per-design n_glass, repeated per cell row.  float32: the unbatched path
    # multiplies/divides f32 cosines by a *python float* (NEP 50 weak scalar
    # -> the op stays f32), so the batched vector must join at f32 too for
    # bitwise-identical scales
    n_g = np.repeat(np.asarray(A["n_g"], dtype=f32).ravel(), C)

    def flat(x):
        """(D, L, M, N, ...) -> (D*C, ...)"""
        return np.ascontiguousarray(np.asarray(x).reshape((DC,) + x.shape[4:]))

    def jmat(quad):
        """Branch quadruple -> (D*C, 2, 2) complex64.

        Fills a float32 component buffer per channel (see _cstack: fewer
        freshly allocated intermediate bytes); the float64->float32 component
        assignment applies the same elementwise rounding as the former
        astype(complex64)-then-stack form -> bitwise-identical values.
        """
        q0 = quad[0]
        out = np.empty(q0.shape + (2, 2, 2), np.float32)
        for i, q in enumerate(quad):
            qv = np.ascontiguousarray(q).view(np.float64)
            out[..., i // 2, i % 2, :] = qv.reshape(q.shape + (2,))
        return flat(out.view(np.complex64).reshape(q0.shape + (2, 2)))

    # consume the branch stream fully and in order (keeps the RNG aligned)
    J = {}
    for key, quad in _synth_quads(A, seed):
        name, strip = key if isinstance(key, tuple) else (key, None)
        if strip is None:
            J[name] = jmat(quad)
        else:
            J.setdefault(name, [None] * (S_fc if name.startswith("fc") else S_oc))
            J[name][strip] = jmat(quad)

    def jstack(name):
        return _cstack(J[name])         # (S, D*C, 2, 2)

    # cosine channels: the channel arrays stored the angle tables verbatim, so
    # cos(lut[..., 0].real).astype(f32) == cos(angle).astype(f32)
    cos_air = flat(np.cos(A["th_in_ic"]).astype(f32))
    cos_ic = flat(np.cos(A["th_out_ic"]).astype(f32))
    cos_ic2 = flat(np.cos(A["th_out_ic2"]).astype(f32))
    cos_fc = flat(np.cos(A["th_out_fc"]).astype(f32))
    cos_oc = flat(np.cos(A["th_out_oc"]).astype(f32))

    init_jones = _cstack([J["ic1_to_ic2"], J["ic1_to_ic3"]])
    init_scale = np.stack([cos_ic * n_g, cos_ic2 * n_g]).astype(f32)
    init_cos0 = cos_air

    ic_jones = _cstack(
        [_cstack([J["ic2_to_ic2"], J["ic3_to_ic2"]]),
         _cstack([J["ic2_to_ic3"], J["ic3_to_ic3"]])]
    )  # (branch, bit, D*C, 2, 2)
    ic_scale = np.stack([cos_ic, cos_ic2]).astype(f32)

    fc_jones = _cstack(
        [_cstack([jstack("fc1_stay"), jstack("fc2_unfold")], axis=1),
         _cstack([jstack("fc1_fold"), jstack("fc2_stay")], axis=1)]
    )  # (branch, S, bit, D*C, 2, 2)
    # every FC strip's direction channel is the same angle table
    fc_scale = np.stack([np.broadcast_to(cos_ic, (S_fc, DC)),
                         np.broadcast_to(cos_fc, (S_fc, DC))]).astype(f32)

    oc_jones = _cstack(
        [_cstack([jstack("oc1_stay"), jstack("oc2_unreverse")], axis=1),
         _cstack([jstack("oc1_reverse"), jstack("oc2_stay")], axis=1),
         _cstack([jstack("oc1_out"), jstack("oc2_out")], axis=1)]
    )  # (branch, S, bit, D*C, 2, 2)
    oc_scale = np.stack([np.broadcast_to(cos_fc, (S_oc, DC)),
                         np.broadcast_to(cos_oc, (S_oc, DC))]).astype(f32)
    oc_scale_out = (cos_air / n_g).astype(f32)

    lut_gap = np.stack([g.lut_gap for g in geoms])       # (D, L, M, N, 8)
    gaps = flat(
        np.stack(
            [lut_gap[..., 0:2], lut_gap[..., 2:4],
             lut_gap[..., 4:6], lut_gap[..., 6:8]],
            axis=-2,
        ).astype(f32)
    )
    tir = np.stack([g.lut_tir for g in geoms])           # (D, L, M, N, 4)
    tir_phasor = flat(np.exp(1j * tir).astype(np.complex64))
    hop2_phasor = flat(np.exp(2j * tir).astype(np.complex64))

    return CellTables(
        L=L, M=M, N=N, D=D,
        init_jones=init_jones, init_scale=init_scale, init_cos0=init_cos0,
        ic_jones=ic_jones, ic_scale=ic_scale,
        fc_jones=fc_jones, fc_scale=fc_scale,
        oc_jones=oc_jones, oc_scale=oc_scale, oc_scale_out=oc_scale_out,
        gaps=gaps, tir_phasor=tir_phasor, hop2_phasor=hop2_phasor,
    )
