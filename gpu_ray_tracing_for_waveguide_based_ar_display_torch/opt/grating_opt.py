"""Gradient-based grating design: differentiate the eyebox through the
tracer.

Port of ``opt/grating_opt.py`` of the JAX package.  The deterministic
splitting tracer (:mod:`..engine.splitting`) runs in its differentiable
configuration (a fixed number of steps, the cell tables as an argument), so
the map from grating parameters to the eyebox energy distribution is one
autograd graph, whose trace node (``splitting.SplitTraceFunction``) runs
the kernels of ``csrc/split_trace.cu`` forward and backward on a GPU and
their plain versions on the CPU; Adam steps then do what waveguide
designers do by hand:

- :func:`optimize_apodization`: per-strip grating strengths (weaken the
  early out-coupler strips so energy survives to the far ones, flattening
  the eyebox);
- :func:`optimize_grating`: the coupler gratings' period and orientation
  through the differentiable analytic tables (:mod:`..design.diff`),
  optionally jointly with the apodization.

The apodization surrogate: scaling a grating's diffracted-order Jones matrix
by ``s`` in (0, 1) scales that order's diffraction efficiency by ``s**2``,
the first-order behaviour of a shallower grating (a full RCWA re-solve is
out of scope, so ``s`` is relative to the LUT's as-solved stack).  Knobs:
``s_fc`` (num_fc,), the folding coupler's redirect order (branch B,
``fc_jones[1]``) per strip, and ``s_oc`` (num_oc,), the out-coupler's
diffracted orders (``oc_jones[1:]``) per strip; both sigmoid-parameterised.

Adam is ``torch.optim.Adam(lr, betas=(0.9, 0.999), eps=1e-8)``: optax
``adam``'s update ``-lr * m_hat / (sqrt(v_hat) + eps)``, with the bias
corrections applied in another order (``lr / (1 - b1^t)`` times ``m /
(sqrt(v) / sqrt(1 - b2^t) + eps)``), so a trajectory agrees with optax's to
float32 rounding, not bit for bit.  Every gradient is computed under
deterministic algorithms (:func:`..engine.splitting.deterministic`).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from ..config import TraceConfig
from ..design.diff import (
    PARAMS, analytic_cell_tables, apply_design_params, design_params,
)
from ..engine import seeding, splitting, trace_vector
from ..engine.device import resolve_device
from ..engine.trace_geometry import TraceGeometry
from ..eval.metrics import pupil_conv, pupil_mask
from ..luts.packing import CellTables


def apply_apodization(T: dict, s_fc: torch.Tensor,
                      s_oc: torch.Tensor) -> dict:
    """Scale the diffracted-order Jones tables by per-strip amplitudes.

    ``T`` is a :func:`..engine.trace_vector.as_tables` dict (split-real:
    complex arrays carry a trailing (re, im) axis); fc_jones is (branch,
    S_fc, bit, C, 2, 2, reim), oc_jones (branch, S_oc, ...).
    """
    T = dict(T)
    fc, oc = T["fc_jones"], T["oc_jones"]
    T["fc_jones"] = torch.cat([fc[:1], (fc[1] * s_fc.reshape(-1, 1, 1, 1, 1,
                                                              1))[None],
                               fc[2:]])
    T["oc_jones"] = torch.cat([oc[:1],
                               oc[1:] * s_oc.reshape(1, -1, 1, 1, 1, 1, 1)])
    return T


@dataclasses.dataclass
class ApodizationResult:
    s_fc: np.ndarray             # (num_fc,) optimized amplitudes
    s_oc: np.ndarray             # (num_oc,)
    loss_history: np.ndarray     # (steps + 1,) loss[0] = initial design
    efficiency: Tuple[float, float]      # (initial, final) mean out-coupled
    nonuniformity: Tuple[float, float]   # (initial, final) FoV rel. std


def _eyebox_objective(hist, L, M, N, ny, nx, n0, eff_weight,
                      fov_uniformity_weight, eyebox_uniformity_weight,
                      pupil=None):
    """Differentiable loss reductions of the zero-variance eyebox histogram:
    maximise mean efficiency, minimise FoV and eyebox nonuniformity.

    ``pupil``: optional (ms, ms) pupil-disc mask.  When given, the eyebox
    term is the relative std of the pupil-integrated radiance over every
    valid eye position (one :func:`..eval.metrics.pupil_conv`, TF32 off)
    instead of raw bins: the quantity the evaluation metrics score.
    """
    eps = 1e-12
    h = hist.reshape(L, N, M, ny, nx)
    e_fov = h.sum(dim=(3, 4)) * (L * M * N / n0)   # (L, N, M) per-FoV eff
    eff = e_fov.mean()
    mu = e_fov.mean(dim=(1, 2))
    fov_nonuni = (torch.sqrt(((e_fov - mu[:, None, None]) ** 2)
                             .mean(dim=(1, 2))) / (mu + eps)).mean()
    e_bins = h.sum(dim=(1, 2))                      # (L, ny, nx)
    if pupil is not None:
        e_bins = pupil_conv(e_bins, pupil.to(e_bins.dtype), (1, 1))
    mu_b = e_bins.mean(dim=(1, 2))
    eb_nonuni = (torch.sqrt(((e_bins - mu_b[:, None, None]) ** 2)
                            .mean(dim=(1, 2))) / (mu_b + eps)).mean()
    val = (-eff_weight * eff / 0.03
           + fov_uniformity_weight * fov_nonuni
           + eyebox_uniformity_weight * eb_nonuni)
    return val, (eff, fov_nonuni, eb_nonuni)


def _pupil_for(pupil_bins: int, ny: int, nx: int, device="cuda"):
    """The loss's pupil-disc mask on ``device``, or None for raw-bin
    uniformity.

    ``pupil_bins`` is clamped to the eyebox so tiny grids stay valid, but a
    pupil that leaves only one valid eye position would make the integrated
    nonuniformity identically zero: that is an error, not a clamp."""
    if pupil_bins <= 0:
        return None
    ms = min(pupil_bins, ny, nx)
    if (ny - ms + 1) * (nx - ms + 1) < 2:
        raise ValueError(
            f"pupil_bins={pupil_bins} leaves <2 valid eye positions on the "
            f"({ny}, {nx}) eyebox; the pupil-integrated uniformity term "
            "would be identically 0: use a smaller pupil or pupil_bins=0")
    return torch.as_tensor(pupil_mask(ms), dtype=torch.float32,
                           device=resolve_device(device))


def _device_tables(tables: CellTables, device) -> dict:
    return {k: (v.to(device) if torch.is_tensor(v) else v)
            for k, v in trace_vector.as_tables(tables).items()}


def make_apodization_loss(
    tables: CellTables,
    tgeom: TraceGeometry,
    cfg: TraceConfig,
    rays0: dict,
    capacity: int = 4096,
    fixed_steps: int = 64,
    weight_threshold: float = 1e-4,
    eff_weight: float = 1.0,
    fov_uniformity_weight: float = 1.0,
    eyebox_uniformity_weight: float = 0.25,
    pupil_bins: int = 0,
):
    """Build ``loss(theta) -> (scalar, aux)`` and the base table dict, on
    the device of ``rays0`` (a :func:`..engine.trace_vector.make_ray_state`
    dict).

    ``theta`` is a dict ``{"fc": (num_fc,), "oc": (num_oc,)}`` of
    pre-sigmoid parameters; ``aux`` is ``(efficiency, fov_nonuni,
    eyebox_nonuni)``, differentiable reductions of the splitting tracer's
    zero-variance eyebox histogram.  ``pupil_bins > 0`` scores the eyebox
    term on pupil-integrated radiance (a disc of that many bins over every
    valid eye position) instead of raw bins.
    """
    device = rays0["x"].device
    T0 = _device_tables(tables, device)
    trace = splitting.make_splitting_trace_fn(
        tables, tgeom, cfg, capacity=capacity,
        weight_threshold=weight_threshold, table_arg=True,
        fixed_steps=fixed_steps, device=device)
    ny, nx = cfg.eyebox_bins
    L, M, N = tables.L, tables.M, tables.N
    n0 = max(len(rays0["x"]), 1)
    pupil = _pupil_for(pupil_bins, ny, nx, device)

    def loss(theta: Dict[str, torch.Tensor]):
        T = apply_apodization(T0, torch.sigmoid(theta["fc"]),
                              torch.sigmoid(theta["oc"]))
        hist, out_w, _, _, _ = trace(rays0, T)
        return _eyebox_objective(hist, L, M, N, ny, nx, n0, eff_weight,
                                 fov_uniformity_weight,
                                 eyebox_uniformity_weight, pupil=pupil)

    return loss, T0


def value_and_grad(loss, theta: Dict[str, torch.Tensor]):
    """``loss(theta)`` and the gradient of its scalar in every tensor of
    ``theta`` (each ``requires_grad``), left in their ``.grad``; forward
    and backward under deterministic algorithms.  Returns (value, aux) as
    Python floats."""
    for v in theta.values():
        v.grad = None
    with splitting.deterministic():
        val, aux = loss(theta)
        val.backward()
    return float(val.detach()), tuple(float(a.detach()) for a in aux)


def _launch_rays(geom, cfg: TraceConfig, rays_per_fov: int,
                 seed: Optional[int], device) -> dict:
    """The optimiser's launch wavefront through the production seeding path
    (the pupil sampling the Monte-Carlo engines trace)."""
    cfg_r = dataclasses.replace(cfg, rays_per_fov=rays_per_fov,
                                seed=cfg.seed if seed is None else seed)
    b = seeding.build_ray_batch(geom, cfg_r)
    return trace_vector.make_ray_state(b["x"], b["y"], b["te"], b["tm"],
                                       b["cid"], b["idx"], b["rng"],
                                       device=device)


def _adam(theta: Dict[str, torch.Tensor], learning_rate: float):
    return torch.optim.Adam(list(theta.values()), lr=learning_rate,
                            betas=(0.9, 0.999), eps=1e-8)


def _run_adam(loss, theta: Dict[str, torch.Tensor], steps: int,
              learning_rate: float):
    """``steps`` Adam steps, then the final design's loss: (history,
    initial aux, final aux)."""
    opt = _adam(theta, learning_rate)
    history = []
    aux0 = aux = None
    for _ in range(steps):
        val, aux = value_and_grad(loss, theta)
        if aux0 is None:
            aux0 = aux
        history.append(val)
        opt.step()
    with torch.no_grad():
        val, aux = loss(theta)
    history.append(float(val))
    aux = tuple(float(a) for a in aux)
    if aux0 is None:  # steps=0: report the initial design through the same path
        aux0 = aux
    return np.asarray(history), aux0, aux


def optimize_apodization(
    geom,
    tables: CellTables,
    tgeom: TraceGeometry,
    cfg: TraceConfig,
    rays_per_fov: int = 16,
    steps: int = 40,
    learning_rate: float = 0.15,
    theta0: float = 2.0,
    seed: Optional[int] = None,
    device="cuda",
    **loss_kw,
) -> ApodizationResult:
    """Adam on the per-strip grating amplitudes, on ``device``; returns the
    apodization.

    ``geom`` is the :class:`..design.geometry.DesignGeometry` the tables
    were packed from.  ``theta0 = 2.0`` starts near s = 0.88, close to the
    unapodized LUT stack but inside sigmoid's responsive range.
    """
    device = resolve_device(device)
    rays0 = _launch_rays(geom, cfg, rays_per_fov, seed, device)
    loss, _ = make_apodization_loss(tables, tgeom, cfg, rays0, **loss_kw)
    theta = {
        "fc": torch.full((tgeom.num_fc,), theta0, dtype=torch.float32,
                         device=device, requires_grad=True),
        "oc": torch.full((tgeom.num_oc,), theta0, dtype=torch.float32,
                         device=device, requires_grad=True),
    }
    history, aux0, aux = _run_adam(loss, theta, steps, learning_rate)
    with torch.no_grad():
        s_fc = torch.sigmoid(theta["fc"]).cpu().numpy()
        s_oc = torch.sigmoid(theta["oc"]).cpu().numpy()
    return ApodizationResult(
        s_fc=s_fc, s_oc=s_oc, loss_history=history,
        efficiency=(aux0[0], aux[0]), nonuniformity=(aux0[1], aux[1]))


# ---------------------------------------------------------------------------
# grating period / orientation (the differentiable analytic tables)

@dataclasses.dataclass
class GratingOptResult:
    params: Dict[str, float]     # optimized design parameter values
    loss_history: np.ndarray     # (steps + 1,)
    efficiency: Tuple[float, float]      # (initial, final)
    nonuniformity: Tuple[float, float]   # (initial, final)
    s_fc: Optional[np.ndarray] = None    # joint mode: optimized amplitudes
    s_oc: Optional[np.ndarray] = None


def _moved_params(base: dict, theta: Dict[str, torch.Tensor], opt_params,
                  param_box: float) -> dict:
    """The design parameters at ``theta``: each knob through the ``tanh``
    trust region, periods multiplicatively (``lambda0 * exp(t)``),
    orientations additively (``phi0 + t``); ``lambda_tied`` / ``phi_tied``
    move both couplers' as one."""
    p = dict(base)
    for k in opt_params:
        t = param_box * torch.tanh(theta[k])
        if k == "lambda_tied":
            # both pitches as a unit keep the k-closure's IC <-> OC symmetry,
            # so the design re-generates to a matched system
            p["lambda_ic"] = base["lambda_ic"] * torch.exp(t)
            p["lambda_oc"] = base["lambda_oc"] * torch.exp(t)
        elif k == "phi_tied":
            p["phi_ic"] = base["phi_ic"] + t
            p["phi_oc"] = base["phi_oc"] + t
        else:
            p[k] = (base[k] * torch.exp(t) if k.startswith("lambda")
                    else base[k] + t)
    return p


def make_grating_loss(
    tables: CellTables,
    tgeom: TraceGeometry,
    cfg: TraceConfig,
    rays0: dict,
    design,
    opt_params: Tuple[str, ...] = ("lambda_ic", "phi_ic"),
    capacity: int = 4096,
    fixed_steps: int = 64,
    weight_threshold: float = 1e-4,
    eff_weight: float = 1.0,
    fov_uniformity_weight: float = 1.0,
    eyebox_uniformity_weight: float = 0.25,
    pupil_bins: int = 0,
    apodize: bool = False,
    param_box: float = 0.05,
):
    """Build ``loss(theta) -> (scalar, aux)`` over grating design
    parameters and the base table dict, on the device of ``rays0``.

    ``param_box`` bounds the search to a trust region around the base
    design: periods within ``exp(+-box)``, orientations within ``+-box``
    rad, through a tanh squash.  The surrogate holds the RCWA Jones blocks
    and the footprint polygons at the base design, so it is only valid near
    it.

    ``apodize=True`` makes the optimisation joint: ``theta`` also carries
    the pre-sigmoid per-strip amplitude knobs ``"fc"`` (S_fc,) and ``"oc"``
    (S_oc,) of :func:`make_apodization_loss`, applied on top of the
    re-derived analytic tables.

    ``theta`` holds one unitless knob per name in ``opt_params``; each
    evaluation re-derives the analytic cell tables
    (:func:`..design.diff.analytic_cell_tables`) at the parameterised design
    and traces the zero-variance wavefront through them with soft
    (bilinear) deposits: the parameters act mostly by moving deposits, which
    hard binning would make a jump with zero gradient almost everywhere.
    """
    device = rays0["x"].device
    T0 = _device_tables(tables, device)
    trace = splitting.make_splitting_trace_fn(
        tables, tgeom, cfg, capacity=capacity,
        weight_threshold=weight_threshold, table_arg=True,
        fixed_steps=fixed_steps, soft_binning=True, device=device)
    ny, nx = cfg.eyebox_bins
    L, M, N = tables.L, tables.M, tables.N
    n0 = max(len(rays0["x"]), 1)
    base = design_params(design, device=device)
    pupil = _pupil_for(pupil_bins, ny, nx, device)

    def loss(theta: Dict[str, torch.Tensor]):
        p = _moved_params(base, theta, opt_params, param_box)
        ana = analytic_cell_tables(p, design, M, N, tgeom.num_fc,
                                   tgeom.num_oc)
        T = apply_design_params(T0, ana)
        if apodize:
            T = apply_apodization(T, torch.sigmoid(theta["fc"]),
                                  torch.sigmoid(theta["oc"]))
        hist, out_w, _, _, _ = trace(rays0, T)
        return _eyebox_objective(hist, L, M, N, ny, nx, n0, eff_weight,
                                 fov_uniformity_weight,
                                 eyebox_uniformity_weight, pupil=pupil)

    return loss, T0


def optimize_grating(
    geom,
    tables: CellTables,
    tgeom: TraceGeometry,
    cfg: TraceConfig,
    opt_params: Tuple[str, ...] = ("lambda_ic", "phi_ic"),
    rays_per_fov: int = 16,
    steps: int = 30,
    learning_rate: float = 0.01,
    seed: Optional[int] = None,
    apodize: bool = False,
    apod_theta0: float = 2.0,
    param_box: float = 0.05,
    device="cuda",
    **loss_kw,
) -> GratingOptResult:
    """Adam on grating period / orientation through the differentiable
    trace, on ``device``.

    ``apodize=True`` optimises the per-strip FC / OC amplitudes jointly
    with the grating parameters (one Adam state over both; the amplitude
    knobs start at ``apod_theta0`` as in :func:`optimize_apodization`)."""
    device = resolve_device(device)
    rays0 = _launch_rays(geom, cfg, rays_per_fov, seed, device)
    loss, _ = make_grating_loss(tables, tgeom, cfg, rays0, geom.design,
                                opt_params=opt_params, apodize=apodize,
                                param_box=param_box, **loss_kw)
    theta = {k: torch.zeros((), dtype=torch.float32, device=device,
                            requires_grad=True) for k in opt_params}
    if apodize:
        for k, n in (("fc", tgeom.num_fc), ("oc", tgeom.num_oc)):
            theta[k] = torch.full((n,), apod_theta0, dtype=torch.float32,
                                  device=device, requires_grad=True)
    history, aux0, aux = _run_adam(loss, theta, steps, learning_rate)
    # the optimised values in float64 through the same map
    base = {k: torch.tensor(getattr(geom.design, k), dtype=torch.float64)
            for k in PARAMS}
    moved = _moved_params(
        base, {k: theta[k].detach().cpu().double() for k in opt_params},
        opt_params, param_box)
    final = {k: float(v) for k, v in moved.items() if v is not base[k]}
    with torch.no_grad():
        s_fc = torch.sigmoid(theta["fc"]).cpu().numpy() if apodize else None
        s_oc = torch.sigmoid(theta["oc"]).cpu().numpy() if apodize else None
    return GratingOptResult(
        params=final, loss_history=history,
        efficiency=(aux0[0], aux[0]), nonuniformity=(aux0[1], aux[1]),
        s_fc=s_fc, s_oc=s_oc)
