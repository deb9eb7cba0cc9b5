"""Differentiable analytic cell tables: grating parameters -> the tables'
analytic entries, in plain torch operations that autograd differentiates.

Port of ``design/diff.py`` of the JAX package.  The analytic half of the
design pipeline (angle tables, TIR hop vectors, TIR phase retardation:
:mod:`.geometry` and :mod:`..luts.packing`) is trigonometry on the grating
vectors, so it is a differentiable function of the grating period and
orientation (``lambda_ic``, ``phi_ic``, ``lambda_oc``, ``phi_oc``).  With the
splitting tracer's differentiable configuration
(:func:`..engine.splitting.make_splitting_trace_fn` with ``table_arg=True``)
the map from grating parameters to the eyebox energy distribution is one
autograd graph.

The surrogate: the geometry polygons (coupler strips, hulls, region tests)
stay at the base design, and the RCWA Jones matrices are held at the base
design's tables; only the angle / gap / TIR-phase physics and the
cos(theta) roulette scales are re-derived per parameter value (the
synthetic-LUT convention, where the direction channels equal the design's
angle tables).
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from ..config import WaveguideDesign
from ..engine.device import resolve_device

PARAMS = ("lambda_ic", "phi_ic", "lambda_oc", "phi_oc")


def design_params(design: WaveguideDesign, dtype=torch.float32,
                  device="cuda") -> Dict[str, torch.Tensor]:
    """The differentiable parameters at a design's values, 0-d tensors on
    ``device``."""
    device = resolve_device(device)
    return {k: torch.tensor(getattr(design, k), dtype=dtype, device=device)
            for k in PARAMS}


def _incidence(fov_x, fov_y):
    tx, ty = torch.tan(fov_x), torch.tan(fov_y)
    th = torch.atan(torch.sqrt(tx * tx + ty * ty))
    phi = torch.atan2(ty, tx)
    return th, phi


def _tir_retardation(n_g: float, theta: torch.Tensor) -> torch.Tensor:
    """delta_s - delta_p under TIR (:mod:`.geometry`), gradient-safe: below
    the critical angle the retardation is zero, and the root's argument is
    clamped so the clamp gives a zero gradient instead of NaN."""
    x = n_g ** 2 * torch.sin(theta) ** 2 - 1.0
    s = torch.sqrt(torch.clamp(x, min=1e-20))
    delta_s = 2.0 * torch.atan(s / (n_g * torch.cos(theta)))
    delta_p = 2.0 * torch.atan(n_g * s / torch.cos(theta))
    return torch.where(x > 0, delta_s - delta_p, 0.0)


def analytic_cell_tables(params: Dict[str, torch.Tensor],
                         design: WaveguideDesign, num_fov_x: int,
                         num_fov_y: int, num_fc: int, num_oc: int,
                         dtype=torch.float32) -> Dict[str, torch.Tensor]:
    """Every analytic cell-table entry at ``params``, on their device.

    The keys and shapes are those of
    :func:`..engine.trace_vector.as_tables` (split-real phasors with a
    trailing (re, im) axis), so ``{**T, **analytic_cell_tables(...)}``
    swaps a table dict's analytic physics and keeps its RCWA Jones blocks:

    - ``gaps`` (C, 4, 2): TIR round-trip hop vectors per direction,
    - ``tir_phasor`` / ``hop2_phasor`` (C, 4, 2): the e^{i delta} and
      e^{2 i delta} TIR retardation phasors,
    - ``init_scale`` (2, C), ``init_cos0`` (C,), ``ic_scale`` (2, C),
      ``fc_scale`` (2, S_fc, C), ``oc_scale`` (2, S_oc, C),
      ``oc_scale_out`` (C,): the cos(theta) roulette scale factors.
    """
    d = design
    M, N, L = num_fov_x, num_fov_y, len(d.wavelengths)
    C = L * M * N
    dev = params["lambda_ic"].device
    lmd = torch.as_tensor(np.asarray(d.wavelengths), dtype=dtype, device=dev)
    k0 = 2 * math.pi / lmd  # (L,)

    kg_ic = 2 * math.pi / params["lambda_ic"]
    g_ic = (kg_ic * torch.cos(params["phi_ic"]),
            kg_ic * torch.sin(params["phi_ic"]))
    kg_oc = 2 * math.pi / params["lambda_oc"]
    g_oc_rev = (kg_oc * torch.cos(params["phi_oc"] + math.pi),
                kg_oc * torch.sin(params["phi_oc"] + math.pi))
    g_fc = (g_oc_rev[0] - g_ic[0], g_oc_rev[1] - g_ic[1])

    gx = torch.linspace(-d.fov_x / 2, d.fov_x / 2, M, dtype=dtype, device=dev)
    gy = torch.linspace(-d.fov_y / 2, d.fov_y / 2, N, dtype=dtype, device=dev)
    gxx, gyy = torch.meshgrid(gx, gy, indexing="ij")    # (M, N)
    th_in, phi_in = _incidence(gxx, gyy)

    k0l = k0[:, None, None]                              # (L, 1, 1)
    kx = d.n_air * k0l * torch.sin(th_in) * torch.cos(phi_in)
    ky = d.n_air * k0l * torch.sin(th_in) * torch.sin(phi_in)

    def glass_dir(kxg, kyg):
        kzg = torch.sqrt(k0l ** 2 * d.n_glass ** 2 - kxg ** 2 - kyg ** 2)
        th = torch.atan(torch.sqrt((kxg ** 2 + kyg ** 2) / kzg ** 2))
        phi = torch.atan2(kyg, kxg)
        return th, phi

    th_ic, phi_ic = glass_dir(kx + g_ic[0], ky + g_ic[1])
    th_ic2, phi_ic2 = glass_dir(kx - g_ic[0], ky - g_ic[1])
    th_fc, phi_fc = glass_dir(kx + g_ic[0] + g_fc[0], ky + g_ic[1] + g_fc[1])
    th_oc, phi_oc = glass_dir(kx + g_ic[0] + g_fc[0] - 2 * g_oc_rev[0],
                              ky + g_ic[1] + g_fc[1] - 2 * g_oc_rev[1])

    def flat(x):
        return x.reshape(C, *x.shape[3:])

    def hop(th, phi):
        r = 2 * d.thickness * torch.tan(th)
        return torch.stack([r * torch.cos(phi), r * torch.sin(phi)], dim=-1)

    gaps = flat(torch.stack(
        [hop(th_ic, phi_ic), hop(th_fc, phi_fc),
         hop(th_ic2, phi_ic2), hop(th_oc, phi_oc)], dim=-2))  # (C, 4, 2)

    tir = flat(torch.stack(
        [_tir_retardation(d.n_glass, th_ic),
         _tir_retardation(d.n_glass, th_fc),
         _tir_retardation(d.n_glass, th_ic2),
         _tir_retardation(d.n_glass, th_oc)], dim=-1))        # (C, 4)
    tir_phasor = torch.stack([torch.cos(tir), torch.sin(tir)], dim=-1)
    hop2_phasor = torch.stack([torch.cos(2 * tir), torch.sin(2 * tir)],
                              dim=-1)

    cos_air = flat(torch.cos(th_in).expand(L, M, N))
    cos_ic = flat(torch.cos(th_ic))
    cos_ic2 = flat(torch.cos(th_ic2))
    cos_fc = flat(torch.cos(th_fc))
    cos_oc = flat(torch.cos(th_oc))

    def per_strip(a, b, S):
        return torch.stack([a, b])[:, None, :].expand(2, S, C)

    return {
        "gaps": gaps.to(dtype),
        "tir_phasor": tir_phasor.to(dtype),
        "hop2_phasor": hop2_phasor.to(dtype),
        "init_scale": torch.stack([cos_ic * d.n_glass,
                                   cos_ic2 * d.n_glass]).to(dtype),
        "init_cos0": cos_air.to(dtype),
        "ic_scale": torch.stack([cos_ic, cos_ic2]).to(dtype),
        "fc_scale": per_strip(cos_ic, cos_fc, num_fc).to(dtype),
        "oc_scale": per_strip(cos_fc, cos_oc, num_oc).to(dtype),
        "oc_scale_out": (cos_air / d.n_glass).to(dtype),
    }


def apply_design_params(T: dict, ana: Dict[str, torch.Tensor]) -> dict:
    """Swap a table dict's analytic entries for parameterised ones."""
    out = dict(T)
    out.update(ana)
    return out
