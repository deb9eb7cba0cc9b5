"""Display-metric evaluation of the eyebox radiance histogram.

Port of ``evaluation`` (AR_system_evaluation_functions.py:45-163):
pupil-masked eye-position sampling of the eyebox, pure-white drive through the display
primary matrix, per-eye-position reconstruction, and the four headline metrics
(CIE-2000 color dispersion vs D65, FoV uniformity, eyebox uniformity, plus the
simulated eye-view image stack).  The host part is numpy float64, copied from
the JAX package's ``eval/metrics.py``; the device part is float32 on the
card, the counterpart of the JAX package's jnp functions: pupil integration
(:func:`eye_perceived_torch`, :func:`eye_perceived_conv`), colorimetry
(:func:`evaluate_torch`, :func:`evaluate_batch`) and the dense eye-position
scan (:func:`evaluate_dense`).  On a CUDA tensor they run the hand-written
kernels of ``csrc/eye_tail.cu`` (:mod:`.eye_tail`); on a CPU tensor their
plain PyTorch versions, :func:`eye_perceived_reference` and
:func:`_make_eval_core`.  :func:`pupil_conv` (one ``conv2d``, with autograd)
stays for the optimiser.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..config import EvalConfig
from . import color, eye_tail

# Display primary response matrix (sensor RGB <- per-wavelength intensity) and its
# XYZ counterpart; numeric constants from AR_system_evaluation_functions.py:47-57.
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
class EvalResult:
    delta_e: float           # mean CIE-2000 color dispersion vs pure white
    u_fov: float             # field-of-view luminance uniformity, 0-1
    u_eyebox: float          # eyebox luminance uniformity, 0-1
    # (FoVy, FoVx, 3, n_epy, n_epx) simulated eye views; None when the caller
    # asked evaluate(..., with_image=False)
    output_image: Optional[np.ndarray]
    eye_luminance: np.ndarray  # (n_epy, n_epx) mean luminance per eye position
    # eye positions with >= 1 zero-luminance FoV pixel.  Any nonzero count means
    # u_eyebox degenerates to 0 and u_fov is biased low — the MC sample budget
    # has not populated every (FoV, eye-position) bin yet (at the reference's
    # default 5,000 rays/FoV x 4 iters the corner positions are starved; see
    # tools/convergence_report.py), not that the display has a dead region.
    starved_eye_positions: int = 0


def pupil_mask(size: int) -> np.ndarray:
    """Circular pupil aperture mask over ``size x size`` bins (:68-74)."""
    radius = size / 2.0
    yy, xx = np.ogrid[:size, :size]
    center = radius - 0.5
    dist = np.sqrt((xx - center) ** 2 + (yy - center) ** 2)
    return (dist <= radius).astype(np.float64)


def eye_perceived(matrix_eb: np.ndarray, cfg: EvalConfig) -> np.ndarray:
    """Pupil-integrated radiance at sampled eye positions.

    Returns (L, FoVy, FoVx, n_epy, n_epx).  The reference samples eye positions on a
    stride instead of a full convolution (:91-109); with the pupil mask separable into
    row segments this is computed as strided masked window sums.
    """
    mask = pupil_mask(cfg.pupil_mask_bins)
    msize = mask.shape[0]
    n_l, n_fy, n_fx, n_eby, n_ebx = matrix_eb.shape
    y0s = np.arange(0, n_eby - msize + 1, cfg.eye_step_y)
    x0s = np.arange(0, n_ebx - msize + 1, cfg.eye_step_x)
    out = np.zeros((n_l, n_fy, n_fx, len(y0s), len(x0s)), dtype=matrix_eb.dtype)
    for iy, y0 in enumerate(y0s):
        for ix, x0 in enumerate(x0s):
            patch = matrix_eb[..., y0 : y0 + msize, x0 : x0 + msize]
            out[..., iy, ix] = np.einsum("...yx,yx->...", patch, mask)
    return out


# ---------------------------------------------------------------------------
# device metrics (plain PyTorch on the perception stack's device, float32)


@contextlib.contextmanager
def _no_tf32():
    """TF32 off for cuDNN convolutions and cuBLAS products inside the block,
    each restored after it: on the card a float32 pupil sum or (3, 3) colour
    product then rounds as in float32, as on the CPU (TF32 keeps 10 mantissa
    bits and would move the eye-view image past its rtol 2e-3 bar)."""
    keep = (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cudnn.allow_tf32,
         torch.backends.cuda.matmul.allow_tf32) = keep


def pupil_conv(m: torch.Tensor, mask: torch.Tensor,
               stride: Tuple[int, int]) -> torch.Tensor:
    """Pupil-window integration over the trailing two (eyebox) axes.

    One VALID ``conv2d`` with the pupil disc as kernel; leading axes are
    flattened into the conv batch.  The counterpart of the JAX package's
    ``pupil_conv`` (one ``lax.conv_general_dilated``).  TF32 is off for the
    call (:func:`_no_tf32`), so a float32 stack is summed in float32 on the
    card as well.
    """
    lead = tuple(m.shape[:-2])
    flat = m.reshape((-1, 1) + tuple(m.shape[-2:]))        # (B, 1, eby, ebx)
    kernel = mask.to(device=m.device, dtype=m.dtype)[None, None]
    with _no_tf32():
        out = F.conv2d(flat, kernel, stride=tuple(stride))
    return out.reshape(lead + tuple(out.shape[-2:]))


def pupil_segments(mask) -> np.ndarray:
    """(rows, 2) int32 ``[start, end)`` columns of each row of a 0/1 pupil
    mask, the form the perception kernel takes the disc in (a row without
    ones is ``[0, 0)``); refuses any other mask: values other than 0 and 1,
    or a row whose ones are not one run."""
    m = np.asarray(mask)
    if m.ndim != 2 or not np.isin(m, (0, 1)).all():
        raise ValueError("the pupil mask must be a 2-D array of 0s and 1s")
    segs = np.zeros((m.shape[0], 2), np.int32)
    for r, row in enumerate(m):
        cols = np.flatnonzero(row)
        if cols.size and cols[-1] - cols[0] + 1 != cols.size:
            raise ValueError(f"row {r} of the pupil mask is not one run of "
                             "ones: the window sum takes a disc")
        if cols.size:
            segs[r] = cols[0], cols[-1] + 1
    return segs


def eye_perceived_reference(matrix_eb: torch.Tensor, mask,
                            stride: Tuple[int, int],
                            scale: Optional[torch.Tensor] = None
                            ) -> torch.Tensor:
    """The perception kernel's plain version, on any device: (..., eby,
    ebx) -> (..., epy, epx) sums of the 0/1 ``mask``'s window at
    ``stride`` (VALID windows, as :func:`pupil_conv`), each image first
    multiplied by ``scale`` (the leading shape) when given.  The bins are
    added in the kernel's order, row-major over the mask's ones, into one
    accumulator: one strided slice view of the images per bin, never the
    windows themselves (94 G elements at stride 1 and reference size)."""
    segs = pupil_segments(mask)
    my, mx = np.shape(mask)
    sy, sx = stride
    eby, ebx = matrix_eb.shape[-2:]
    epy, epx = (eby - my) // sy + 1, (ebx - mx) // sx + 1
    if scale is not None:
        matrix_eb = matrix_eb * scale[..., None, None]
    out = matrix_eb.new_zeros(tuple(matrix_eb.shape[:-2]) + (epy, epx))
    for dy, (x0, x1) in enumerate(segs.tolist()):
        for dx in range(x0, x1):
            out += matrix_eb[..., dy:dy + sy * (epy - 1) + 1:sy,
                             dx:dx + sx * (epx - 1) + 1:sx]
    return out


def pupil_window_sum(matrix_eb: torch.Tensor, mask, stride: Tuple[int, int],
                     scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """:func:`eye_perceived_reference` on the tensor's device: the kernel
    ``pupil_window_sum`` for a CUDA tensor (bit for bit the plain version),
    the plain version for a CPU one."""
    dev = matrix_eb.device
    if dev.type == "cpu":
        return eye_perceived_reference(matrix_eb, mask, stride, scale)
    if dev.type != "cuda":
        raise ValueError(f"the perception runs on cpu or cuda, not {dev}")
    return eye_tail.launch_window_sum(matrix_eb, pupil_segments(mask),
                                      np.shape(mask)[1], stride, scale)


def eye_perceived_conv(matrix_eb: torch.Tensor, cfg: EvalConfig = EvalConfig(),
                       stride: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """Pupil integration of a (L, fy, fx, eb_y, eb_x) histogram on its
    device: :func:`pupil_window_sum` with the pupil disc, every VALID
    window at ``stride``.  ``stride=(1, 1)`` gives every valid eye position
    (51 x 91 at reference resolution); the default ``(eye_step_y,
    eye_step_x)`` gives the sampled grid of :func:`eye_perceived`: VALID
    windows at those steps start at the same ``y0``s and ``x0``s.  The
    counterpart of the JAX package's ``eye_perceived_conv_jnp``; the sums
    inside a window may associate differently from :func:`eye_perceived`'s
    and the JAX package's."""
    if stride is None:
        stride = (cfg.eye_step_y, cfg.eye_step_x)
    return pupil_window_sum(matrix_eb, pupil_mask(cfg.pupil_mask_bins),
                            stride)


def eye_perceived_torch(matrix_eb: torch.Tensor,
                        cfg: EvalConfig = EvalConfig()) -> torch.Tensor:
    """:func:`eye_perceived` on the histogram's device: (L, fy, fx, 80, 120)
    -> (L, fy, fx, 7, 8) at reference resolution, so only the stack (about
    5 MB at the reference workload) need leave the device.  The counterpart
    of the JAX package's ``eye_perceived_jnp``, computed as
    :func:`eye_perceived_conv` at the sampled grid's stride."""
    return eye_perceived_conv(matrix_eb, cfg)


def _make_eval_core(with_image: bool):
    """The device colorimetry body shared by :func:`evaluate_torch` and
    :func:`evaluate_batch`: (B, L, fy, fx, epy, epx) perception stacks ->
    dict of per-design tensors, in the stacks' dtype.  The same operations as
    the host :func:`evaluate` (and the JAX package's ``_make_eval_core``),
    with a leading design axis in place of ``vmap``; TF32 off
    (:func:`_no_tf32`)."""
    white_linear = color.linearize_srgb(np.ones(3))
    drive = np.linalg.solve(DISPLAY_M, white_linear)
    lab_white = color.xyz_to_lab(color.D65_XYZ_100)

    def _ev(perc: torch.Tensor, inv_norm: float) -> dict:
        dt, dev = perc.dtype, perc.device

        def const(a):
            return torch.as_tensor(np.asarray(a), dtype=dt, device=dev)

        perc = perc * inv_norm
        response = torch.flip(perc.permute(0, 2, 3, 1, 4, 5), dims=(3,))
        adjusted = const(drive)[None, None, None, :, None, None] * response
        ep = adjusted.permute(0, 4, 5, 1, 2, 3)      # (B, epy, epx, fy, fx, 3)
        with _no_tf32():   # cuBLAS
            xyz = ep @ const(DISPLAY_M_XYZ.T)
        y_chan = xyz[..., 1]                          # (B, epy, epx, fy, fx)
        y_safe = torch.clamp(y_chan, min=1e-10)
        xyz_norm = xyz / y_safe[..., None] * 100.0
        lab = color.xyz_to_lab(xyz_norm, xp=torch)
        lab = torch.where((y_chan == 0.0)[..., None], 0.0, lab)
        de = color.delta_e_2000(lab, const(lab_white), xp=torch)
        any0 = torch.any((y_chan == 0.0).flatten(3), dim=3)
        ymax = y_chan.amax(dim=(3, 4))
        ratio = torch.where(any0, 0.0,
                            y_chan.amin(dim=(3, 4))
                            / torch.where(ymax > 0, ymax, 1.0))
        u_eb = torch.where(any0, 0.0, y_chan.mean(dim=(3, 4)))
        outs = {"delta_e": de.mean(dim=(1, 2, 3, 4)),
                "ratio_sum": ratio.sum(dim=(1, 2)), "u_eb": u_eb}
        if with_image:
            with _no_tf32():
                rgb_linear = torch.clamp(ep @ const(DISPLAY_M.T), 0.0, 1.0)
            srgb = color.apply_srgb_gamma(rgb_linear, xp=torch)
            peak = srgb.amax(dim=(3, 4, 5), keepdim=True)
            normed = torch.where(peak > 0,
                                 srgb / torch.where(peak > 0, peak, 1.0),
                                 srgb)
            outs["image"] = normed.permute(0, 3, 4, 5, 1, 2)
        return outs

    return _ev


def colorimetry_constants() -> np.ndarray:
    """The colorimetry kernel's float32 constants, in ``csrc/eye_tail.cu``'s
    order, each rounded as :func:`_make_eval_core` rounds it: the drive,
    ``DISPLAY_M_XYZ``, ``DISPLAY_M`` and the D65 Lab white as its
    ``const()`` does, the whitepoint as :func:`.color.xyz_to_lab` does, and
    every Python scalar of the formulas as a float32 tensor operation takes
    it (``np.float32`` of the double; ``rad2deg`` and ``deg2rad`` multiply by
    180 / pi and pi / 180)."""
    delta = 6.0 / 29.0
    scalars = [1e-10, 100.0, delta**3, 3 * delta**2, 4.0 / 29.0, 1.0 / 3.0,
               116.0, 16.0, 500.0, 200.0, 25.0**7, 180.0 / np.pi,
               np.pi / 180.0, 0.17, 0.24, 0.32, 0.20, 0.015, 0.045,
               0.0031308, 12.92, 1.055, 1 / 2.4, 0.055]
    drive = np.linalg.solve(DISPLAY_M, color.linearize_srgb(np.ones(3)))
    parts = [drive, DISPLAY_M_XYZ.ravel(), DISPLAY_M.ravel(),
             color.xyz_to_lab(color.D65_XYZ_100), color.D65_WHITE_Y1,
             np.asarray(scalars)]
    return np.concatenate([np.asarray(x, np.float64).ravel()
                           for x in parts]).astype(np.float32)


def colorimetry_stack(stack: torch.Tensor, inv_norm: float,
                      with_image: bool) -> dict:
    """The colorimetry of (D, L, fy, fx, epy, epx) perception stacks on
    their device, queued with no host sync: the kernels of
    ``csrc/eye_tail.cu`` for a CUDA tensor (a contiguous float32 stack,
    L = 3; the image contiguous), :func:`_make_eval_core` for a CPU one.
    The same dict of per-design tensors either way."""
    dev = stack.device
    if dev.type == "cpu":
        return _make_eval_core(with_image)(stack, inv_norm)
    if dev.type != "cuda":
        raise ValueError(f"the colorimetry runs on cpu or cuda, not {dev}")
    return eye_tail.launch_colorimetry(stack, colorimetry_constants(),
                                       inv_norm, with_image)


def _inv_norm(norm: float) -> float:
    """``1 / norm`` rounded to float32, as the JAX package passes it."""
    return float(np.float32(1.0 / norm))


def _eval_result_from_out(out: dict, d: int, n_epy: int, n_epx: int,
                          with_image: bool) -> "EvalResult":
    u_eb = np.asarray(out["u_eb"][d], dtype=np.float64)
    return EvalResult(
        delta_e=float(out["delta_e"][d]),
        u_fov=float(out["ratio_sum"][d]) / (n_epy * n_epx),
        u_eyebox=0.0 if u_eb.max() == 0 else float(u_eb.min() / u_eb.max()),
        output_image=(np.asarray(out["image"][d]) if with_image else None),
        eye_luminance=u_eb,
        starved_eye_positions=int((u_eb == 0.0).sum()),
    )


def colorimetry_torch(perceive: torch.Tensor, norm: float = 1.0,
                      with_image: bool = False) -> dict:
    """The device half of :func:`evaluate_torch`: the colorimetry of a (L,
    fy, fx, epy, epx) perception stack queued on its device, with no host
    sync.  Returns the (1, ...) tensors ``delta_e``, ``ratio_sum``, ``u_eb``
    and, with ``with_image``, the (1, fy, fx, 3, epy, epx) eye views
    ``image``."""
    return colorimetry_stack(perceive[None], _inv_norm(norm), with_image)


def result_to_host(out: dict, n_epy: int, n_epx: int) -> "EvalResult":
    """The host half of :func:`evaluate_torch`: pull the tensors of
    :func:`colorimetry_torch` (two scalars, the (epy, epx) luminance grid and
    the eye views when it made them) into an :class:`EvalResult`."""
    out = {k: v.cpu().numpy() for k, v in out.items()}
    return _eval_result_from_out(out, 0, n_epy, n_epx, "image" in out)


def evaluate_torch(perceive: torch.Tensor, cfg: EvalConfig = EvalConfig(),
                   norm: float = 1.0, with_image: bool = False) -> "EvalResult":
    """Device-side :func:`evaluate` on a (L, fy, fx, epy, epx) perception
    stack, in the stack's dtype (float32 on the card): one host pull of two
    scalars and the (epy, epx) luminance grid (plus the eye views with
    ``with_image``: 5 MB at the reference workload).  ``norm`` divides the
    stack as the host path's ``perceive / rays``.  The counterpart of the
    JAX package's ``evaluate_jnp``; values agree with the float64 host
    :func:`evaluate` to float32 rounding (metrics within 1e-4 relative, the
    image within rtol 2e-3, atol 1e-5)."""
    return result_to_host(colorimetry_torch(perceive, norm, with_image),
                          perceive.shape[3], perceive.shape[4])


def evaluate_batch(perc_stack: torch.Tensor, norm: float = 1.0) -> list:
    """Batched :func:`evaluate_torch`: (D, L, fy, fx, epy, epx) perception
    stacks -> list of D :class:`EvalResult`, in one pass over the design axis
    and one host pull.  The counterpart of the JAX package's
    ``evaluate_jnp_batch`` (used by full-metric design sweeps)."""
    out = colorimetry_stack(perc_stack, _inv_norm(norm), with_image=False)
    out = {k: v.cpu().numpy() for k, v in out.items()}
    n_epy, n_epx = perc_stack.shape[4], perc_stack.shape[5]
    return [_eval_result_from_out(out, d, n_epy, n_epx, with_image=False)
            for d in range(perc_stack.shape[0])]


def evaluate_dense(matrix_eb: torch.Tensor, cfg: EvalConfig = EvalConfig(),
                   norm: float = 1.0, chunk_rows: int = 0) -> EvalResult:
    """The metrics over every valid eye position (the reference's dense scan,
    AR_system_evaluation_functions.py:77-89), on the histogram's device: the
    stride-1 stack of :func:`eye_perceived_conv` through the colorimetry of
    :func:`evaluate_torch`; ``eye_luminance`` is the full-resolution (epy,
    epx) map.  On the card the kernels evaluate every position in one pass;
    on the CPU ``chunk_rows > 0`` evaluates that many eye-position rows at a
    time, which bounds the plain colorimetry's temporaries (chunked and
    unchunked results agree to float association).  The counterpart of the
    JAX package's ``evaluate_dense``."""
    perc = eye_perceived_conv(matrix_eb, cfg, stride=(1, 1))
    n_epy, n_epx = perc.shape[3], perc.shape[4]
    if perc.is_cuda or chunk_rows <= 0 or chunk_rows >= n_epy:
        return evaluate_torch(perc, cfg, norm=norm)
    core = _make_eval_core(with_image=False)
    de_sum = ratio_sum = 0.0
    u_eb_rows = []
    for y0 in range(0, n_epy, chunk_rows):
        out = core(perc[None, :, :, :, y0:y0 + chunk_rows], _inv_norm(norm))
        rows = min(chunk_rows, n_epy - y0)
        de_sum += float(out["delta_e"][0]) * rows * n_epx
        ratio_sum += float(out["ratio_sum"][0])
        u_eb_rows.append(out["u_eb"][0].cpu().numpy().astype(np.float64))
    u_eb = np.concatenate(u_eb_rows, axis=0)
    return EvalResult(
        delta_e=de_sum / (n_epy * n_epx),
        u_fov=ratio_sum / (n_epy * n_epx),
        u_eyebox=0.0 if u_eb.max() == 0 else float(u_eb.min() / u_eb.max()),
        output_image=None,
        eye_luminance=u_eb,
        starved_eye_positions=int((u_eb == 0.0).sum()),
    )


def evaluate(matrix_eb: Optional[np.ndarray], cfg: EvalConfig = EvalConfig(),
             perceive: Optional[np.ndarray] = None,
             with_image: bool = True) -> EvalResult:
    """Compute the four display metrics from a (L, FoVy, FoVx, eb_y, eb_x) histogram.

    ``matrix_eb`` should be normalized to per-ray units exactly as the reference
    driver does (histogram / rays_per_fov / num_iter,
    gpu_ray_tracing_pro_fullColor.py:197).  Alternatively pass ``perceive`` (an
    already pupil-integrated (L, fy, fx, n_epy, n_epx) stack, e.g. from
    :func:`pupil_conv`) and omit the histogram.  ``with_image=False``
    skips the eye-view image reconstruction (gamma + normalization) — callers
    that only read the scalar metrics (e.g. the jackknife error-bars loop,
    which calls this once per sample group) save that host work.
    """
    if perceive is None:
        perceive = eye_perceived(matrix_eb, cfg)
    n_l, n_fy, n_fx, n_epy, n_epx = perceive.shape

    # pure-white sRGB drive mapped to per-wavelength intensities (:113-118)
    white_linear = color.linearize_srgb(np.ones(3))
    drive = np.linalg.solve(DISPLAY_M, white_linear)  # (3,) per-display-primary

    # waveguide response: histogram wavelength order is (B, G, R); flip to (R, G, B)
    # exactly like the reference's np.flip(..., axis=2) (:121)
    response = np.flip(np.transpose(perceive, (1, 2, 0, 3, 4)), axis=2)
    adjusted = drive[None, None, :, None, None] * response  # (fy, fx, 3, epy, epx)

    lab_white = color.xyz_to_lab(color.D65_XYZ_100)

    # vectorized over the (n_epy, n_epx) eye-position grid — the former
    # 56-iteration Python loop cost ~0.6 s/run on a 1-core host (~20% of the
    # reference-workload wall); identical math, batched leading axes
    ep = np.transpose(adjusted, (3, 4, 0, 1, 2))  # (epy, epx, fy, fx, 3)
    if with_image:
        rgb_linear = np.clip(ep @ DISPLAY_M.T, 0.0, 1.0)
        srgb = color.apply_srgb_gamma(rgb_linear)
        # per-position brightness normalization (color.normalize_brightness
        # batched: scale each eye image so its peak channel value is 1)
        peak = srgb.max(axis=(2, 3, 4), keepdims=True)
        normed = np.where(peak > 0, srgb / np.where(peak > 0, peak, 1.0), srgb)
        output_image = np.transpose(normed, (2, 3, 4, 0, 1))
    else:
        output_image = None

    xyz = ep @ DISPLAY_M_XYZ.T
    y_chan = xyz[..., 1]                           # (epy, epx, fy, fx)
    y_safe = np.maximum(y_chan, 1e-10)
    xyz_norm = xyz / y_safe[..., None] * 100.0
    lab = color.xyz_to_lab(xyz_norm)
    lab[y_chan == 0] = 0.0
    de = color.delta_e_2000(lab, lab_white)        # (epy, epx, fy, fx)
    # mean over FoV per position, then over positions (equal counts: = global
    # mean up to float association)
    delta_e = float(np.mean(de))
    # a position with any empty (FoV, eye) bin is starved: it contributes 0 to
    # u_eb and is excluded from the u_fov sum (but still divides by the full
    # position count) — exactly the former per-position branch
    any0 = np.any(y_chan == 0, axis=(2, 3))
    ymax = y_chan.max(axis=(2, 3))
    ratio = np.where(any0, 0.0,
                     y_chan.min(axis=(2, 3)) / np.where(ymax > 0, ymax, 1.0))
    u_eb = np.where(any0, 0.0, y_chan.mean(axis=(2, 3)))

    u_fov = float(ratio.sum()) / (n_epy * n_epx)
    u_eyebox = 0.0 if u_eb.max() == 0 else float(u_eb.min() / u_eb.max())
    starved = int((u_eb == 0.0).sum())
    return EvalResult(
        delta_e=delta_e,
        u_fov=u_fov,
        u_eyebox=u_eyebox,
        output_image=output_image,
        eye_luminance=u_eb,
        starved_eye_positions=starved,
    )


def wavelength_channel_names(n_wavelengths: int) -> list:
    """Display names per wavelength index: (B, G, R) for the standard 3-channel
    layout (couplers_coor.py:132), generic ``lmd{i}`` otherwise."""
    if n_wavelengths == 3:
        return ["B", "G", "R"]
    return [f"lmd{i}" for i in range(n_wavelengths)]


def efficiencies(matrix_eb: np.ndarray, rays_per_fov: float, num_iter: int) -> dict:
    """Per-color system efficiency (gpu_ray_tracing_pro_fullColor.py:186-192).

    The xL factor undoes the 1/L wavelength split of the launched rays (x3 in
    the reference); wavelength index order is (B, G, R) for L=3.
    """
    L = matrix_eb.shape[0]
    num_rays = rays_per_fov * matrix_eb.shape[1] * matrix_eb.shape[2] * L
    per_fov = matrix_eb.sum(axis=(-2, -1)) / num_rays / num_iter
    names = wavelength_channel_names(L)
    return {names[i]: float(per_fov[i].sum() * L) for i in range(L)}
