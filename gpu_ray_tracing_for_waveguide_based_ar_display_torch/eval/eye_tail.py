"""``simulate``'s tail on the card: the binding of ``csrc/eye_tail.cu``.

Two kernels (three ``__global__`` functions) in one library, built by
``engine/build.py`` and loaded by ctypes; :func:`load_kernel` also loads
the library's module, so a process pays for it at bind and not at its
first tail:

- :func:`launch_window_sum`: the pupil-window perception, (B, eby, ebx)
  images -> (B, epy, epx) window sums of the disc at a stride, bit for bit
  :func:`.metrics.eye_perceived_reference`; its launch shape follows from
  the shape alone (:func:`window_sum_plan`, the C rule
  ``window_sum_plan`` written out in Python; :func:`window_sum_shape` reads
  the card's, with the kernel's registers and resident blocks);
- :func:`launch_colorimetry`: the colorimetry of (D, 3, fy, fx, epy, epx)
  perception stacks, :func:`.metrics._make_eval_core`'s outputs in its
  operation order (within float32 association of it: its sums run in
  another fixed order, set by the stack's shape alone through
  :func:`colorimetry_splits`, and the card's ``powf``, ``atan2f``,
  ``sinf`` ... are not the host's); :func:`colorimetry_shape` reads its
  kernels' registers and resident blocks.

Both replace no TPU kernel: the JAX package's tail is jnp
(``eval/metrics.py::eye_perceived_jnp``, ``_make_eval_core``).  Each launch
adds one to its count in :data:`..engine.trace_persistent.launch_counts`
(``eye_perceive``, ``colorimetry``).  Callers route by device through
:func:`.metrics.pupil_window_sum` and :func:`.metrics.colorimetry_stack`:
the kernels for a CUDA tensor, the plain versions for a CPU one.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence

import numpy as np
import torch

from ..engine import build
from ..engine.trace_persistent import launch_counts

# colorimetry units: 32 positions (lanes) x 8 pixel groups
LANES = 32
GROUPS = 8
# the unit slots a design's units are to fill whatever its stack: five
# blocks of 256 threads on each of an H100's 132 SMs.  The split depends on
# the stack's shape alone, so a design's results do not depend on the
# designs that share its launch, nor on the card.
SLOTS = 660
SPLIT_WAVES = 4   # the most waves of SLOTS units a split rule weighs
PARTIALS = 6   # per (design, split, position): delta E, Y, min Y, max Y,
               # any Y = 0, peak
POSITION_RESULTS = 3   # per (design, position): delta E sum, ratio, peak
# colorimetry_shape's out[7], in its order
COLOR_SHAPE_KEYS = ("units_registers", "units_local_bytes",
                    "units_blocks_per_sm", "image_registers",
                    "image_local_bytes", "image_blocks_per_sm", "sms")
NCONST = 51    # the float32 constants of metrics.colorimetry_constants

# the window sum's launch rule (csrc/eye_tail.cu, mirrored by
# window_sum_plan): its forms, the stages a ring at most, the summing
# threads a block at most, the staging warp, the windows a thread at stride
# (sy, 1), the float4 chunks of a row read at once, a ring stage's
# mbarrier bytes, and an H100's shared bytes a block
FORMS = ("scalar", "vec4", "dense")
MAX_STAGES = 8
MAX_CONSUMERS = 512
PRODUCER = 32
DENSE_K = 13
VEC_CHUNKS = 8
BAR_BYTES = 16
SMEM_LIMIT = 232_448
# window_sum_shape's out[17], in its order
SHAPE_KEYS = ("form", "k", "stages", "lead", "consumers", "active",
              "threads", "band_rows", "bands", "items", "stage_floats",
              "smem", "blocks_per_sm", "registers", "local_bytes", "sms",
              "smem_limit")

WINDOW_ARGTYPES = ([ctypes.c_void_p] * 3 + [ctypes.c_longlong]
                   + [ctypes.c_int] * 6 + [ctypes.c_void_p]
                   + [ctypes.c_int] * 2 + [ctypes.c_void_p])
COLOR_ARGTYPES = ([ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_float]
                  + [ctypes.c_int] * 5 + [ctypes.c_void_p])


def _check(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise ValueError(f"the eye_tail kernels run on cuda, not {t.device} "
                         f"({what})")
    if t.dtype != torch.float32:
        raise ValueError(f"{what} must be float32, got {t.dtype}")


def _raise(lib, err: int, what: str) -> None:
    if err != 0:
        msg = lib.eye_tail_error_string(err).decode()
        raise RuntimeError(f"{what} launch failed: {msg} ({err})")


def window_sum_plan(eby: int, ebx: int, rows: int, cols: int, sy: int,
                    sx: int, smem_limit: int = SMEM_LIMIT) -> dict:
    """The window sum's launch shape for a ``rows x cols`` disc over ``eby
    x ebx`` images at stride ``(sy, sx)`` with ``smem_limit`` shared bytes a
    block: ``csrc/eye_tail.cu``'s ``window_sum_plan``, step for step (the
    card's own is :func:`window_sum_shape`).  Keys: ``form`` (an index of
    :data:`FORMS`), ``k`` (windows a thread), ``epy``, ``epx``,
    ``band_rows`` (window rows a unit: one stage's load), ``bands`` (units
    an image), ``xblocks``, ``items`` (items a unit), ``stage_rows``,
    ``stage_floats``, ``stages`` (1: no ring, no barriers), ``lead``
    (units whose items the consumers hold at once: ``stages - 2``, or
    ``stages - 1`` in a ring of 2 or 3), ``consumers`` (whole warps, at
    most the items of ``lead`` units), ``active`` (the consumers that sum:
    at most ``lead * items``), ``threads``, ``smem`` (dynamic shared
    bytes).  Raises ValueError if not one window row fits a stage."""
    if rows < 1 or cols < 1 or rows > eby or cols > ebx or sy < 1 or sx < 1:
        raise ValueError(f"a {rows} x {cols} disc at stride ({sy}, {sx}) "
                         f"does not fit {eby} x {ebx} images")
    epy, epx = (eby - rows) // sy + 1, (ebx - cols) // sx + 1
    if sx == 1 and epx >= DENSE_K:
        form = 2
    elif sx % 4 == 0 and ebx % 4 == 0:
        form = 1
    else:
        form = 0
    while True:
        pad = DENSE_K - 1 if form == 2 else 3 if form == 1 else 0
        band = 0
        for want in (2, 1):   # two stages and their barriers, or one
            fit = (smem_limit // 2 - BAR_BYTES if want == 2
                   else smem_limit) // 4 // 4 * 4
            stage_rows = (fit - pad) // ebx
            if stage_rows >= rows:
                band = min(epy, (stage_rows - rows) // sy + 1)
                break
        if band > 0:
            break
        if form == 0:
            raise ValueError(f"no window row of a {rows} x {cols} disc over "
                             f"{ebx}-bin rows fits {smem_limit} B")
        form = 0
    k = DENSE_K if form == 2 else 1
    xblocks = -(-epx // k)
    items = band * xblocks
    stage_rows = (band - 1) * sy + rows
    stage_floats = -(-(stage_rows * ebx + pad) // 4) * 4
    stage_bytes = stage_floats * 4 + BAR_BYTES
    fits = smem_limit // stage_bytes
    stages = 1 if fits < 2 else min(MAX_STAGES, fits)
    lead = stages - 2 if stages >= 4 else stages - 1 if stages >= 2 else 1
    consumers = min(MAX_CONSUMERS, max(32, lead * items // 32 * 32))
    return {"form": form, "k": k, "epy": epy, "epx": epx, "band_rows": band,
            "bands": -(-epy // band), "xblocks": xblocks, "items": items,
            "stage_rows": stage_rows, "stage_floats": stage_floats,
            "stages": stages, "lead": lead, "consumers": consumers,
            "active": min(consumers, lead * items),
            "threads": consumers + PRODUCER,
            "smem": stages * stage_bytes if stages > 1 else stage_floats * 4}


_SHAPES = {}


def window_sum_shape(eby: int, ebx: int, rows: int, cols: int, sy: int,
                     sx: int, scaled: bool = False) -> dict:
    """The window sum's launch shape on the current card (cached per
    shape): :data:`SHAPE_KEYS` from ``csrc/eye_tail.cu``'s
    ``window_sum_shape`` (its plan with the kernel's registers, local bytes
    and resident blocks per SM from the runtime)."""
    key = (torch.cuda.current_device(), eby, ebx, rows, cols, sy, sx,
           bool(scaled))
    if key not in _SHAPES:
        lib = load_kernel()
        out = (ctypes.c_int * len(SHAPE_KEYS))()
        _raise(lib, lib.window_sum_shape(eby, ebx, rows, cols, sy, sx,
                                         int(bool(scaled)), out),
               "window_sum_shape")
        _SHAPES[key] = dict(zip(SHAPE_KEYS, list(out)))
    return _SHAPES[key]


# the last launch_window_sum's shape (window_sum_shape), units, and the
# launch's grid and staging (``bulk``: cp.async.bulk copies, else loads)
last_launch = {}
_LAST = (ctypes.c_longlong * 2)()


def launch_window_sum(images: torch.Tensor, segments: np.ndarray, cols: int,
                      stride: Sequence[int],
                      scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(..., eby, ebx) float32 images on the card -> (..., epy, epx) sums
    of the disc's window at ``stride``: ``segments`` (rows, 2) are each
    window row's ``[start, end)`` columns of a ``rows x cols`` mask.
    ``scale`` (the leading shape, float32) multiplies each image before it
    is summed.  The images may be a strided view whose last axis is
    contiguous (the sweep's 128-lane tiles cut to ``nx``)."""
    _check(images, "images")
    lib = load_kernel()
    eby, ebx = images.shape[-2:]
    lead = tuple(images.shape[:-2])
    flat = images.reshape((-1, eby, ebx))
    if flat.stride(2) != 1 or flat.stride(1) < ebx:
        flat = flat.contiguous()
    B = flat.shape[0]
    rows = len(segments)
    sy, sx = (int(v) for v in stride)
    epy, epx = (eby - rows) // sy + 1, (ebx - cols) // sx + 1
    if epy < 1 or epx < 1:
        raise ValueError(f"a {rows} x {cols} window does not fit "
                         f"{eby} x {ebx} images")
    if scale is not None:
        _check(scale, "scale")
        if tuple(scale.shape) != lead:
            raise ValueError(f"scale has shape {tuple(scale.shape)}, the "
                             f"images' leading shape is {lead}")
        scale = scale.reshape(-1).contiguous()
    out = torch.empty((B, epy, epx), dtype=torch.float32, device=flat.device)
    if B:
        seg = np.ascontiguousarray(segments, dtype=np.int32)
        with torch.cuda.device(flat.device):
            shape = window_sum_shape(eby, ebx, rows, int(cols), sy, sx,
                                     scale is not None)
            stream = torch.cuda.current_stream(flat.device).cuda_stream
            err = lib.pupil_window_sum_launch(
                flat.data_ptr(), None if scale is None else scale.data_ptr(),
                out.data_ptr(), flat.stride(0), flat.stride(1), B, eby, ebx,
                sy, sx, seg.ctypes.data, rows, int(cols), stream)
        _raise(lib, err, "pupil_window_sum")
        launch_counts["eye_perceive"] += 1
        lib.window_sum_last_launch(_LAST)
        last_launch.clear()
        last_launch.update(shape, units=B * shape["bands"], grid=_LAST[0],
                           bulk=bool(_LAST[1]))
    return out.reshape(lead + (epy, epx))


def colorimetry_splits(P: int, npix: int) -> tuple:
    """``(S, chunk)``: the colorimetry's split of a position's ``npix``
    pixels over S units of ``chunk`` pixels (each unit holding some), from
    the shape alone.  A design has ``ceil(P / LANES) * S`` units; of the
    splits that make 1 to :data:`SPLIT_WAVES` waves of :data:`SLOTS` units
    (a split keeping a pixel a group at least), the one whose last wave is
    fullest, the fewest waves on a tie."""
    tiles = -(-P // LANES)
    most = -(-npix // GROUPS)
    best = None
    for waves in range(1, SPLIT_WAVES + 1):
        S = max(1, min(most, waves * SLOTS // tiles))
        chunk = -(-npix // S)
        S = -(-npix // chunk)
        units = tiles * S
        fill = units / (-(-units // SLOTS) * SLOTS)
        if best is None or fill > best[0]:
            best = (fill, S, chunk)
    return best[1], best[2]


def colorimetry_plan(D: int, P: int, npix: int) -> dict:
    """The colorimetry's launch for D stacks of ``npix`` pixels at ``P``
    positions: ``S`` and ``chunk`` (:func:`colorimetry_splits`, which fix
    the order of every sum and do not depend on D), ``tiles`` of
    :data:`LANES` positions, the units' ``grid`` (S, tiles, D), and the
    scratch sizes ``part`` and ``pos`` (floats) and ``done`` (ints)."""
    S, chunk = colorimetry_splits(P, npix)
    tiles = -(-P // LANES)
    return {"S": S, "chunk": chunk, "tiles": tiles, "grid": (S, tiles, D),
            "part": D * S * PARTIALS * P, "pos": D * POSITION_RESULTS * P,
            "done": D * tiles + D}


_COLOR_SHAPE = {}


def colorimetry_shape() -> dict:
    """The colorimetry kernels on the current card (cached per device):
    :data:`COLOR_SHAPE_KEYS` from ``csrc/eye_tail.cu``'s
    ``colorimetry_shape``."""
    dev = torch.cuda.current_device()
    if dev not in _COLOR_SHAPE:
        lib = load_kernel()
        out = (ctypes.c_int * len(COLOR_SHAPE_KEYS))()
        _raise(lib, lib.colorimetry_shape(out), "colorimetry_shape")
        _COLOR_SHAPE[dev] = dict(zip(COLOR_SHAPE_KEYS, list(out)))
    return _COLOR_SHAPE[dev]


def launch_colorimetry(stack: torch.Tensor, consts: np.ndarray,
                       inv_norm: float, with_image: bool) -> dict:
    """The colorimetry of a contiguous (D, 3, fy, fx, epy, epx) float32
    stack on the card: the (D,) tensors ``delta_e`` and ``ratio_sum``, the
    (D, epy, epx) ``u_eb`` and, with ``with_image``, the contiguous (D, fy,
    fx, 3, epy, epx) eye views ``image``; queued, with no host sync."""
    _check(stack, "the perception stack")
    if stack.dim() != 6 or stack.shape[1] != 3:
        raise ValueError("the colorimetry takes (D, 3, fy, fx, epy, epx) "
                         f"stacks, got {tuple(stack.shape)}")
    if not stack.is_contiguous():
        raise ValueError("the colorimetry takes a contiguous stack")
    consts = np.ascontiguousarray(consts, dtype=np.float32)
    if consts.shape != (NCONST,):
        raise ValueError(f"{NCONST} constants expected, got {consts.shape}")
    lib = load_kernel()
    D, _, fy, fx, epy, epx = stack.shape
    npix, P = fy * fx, epy * epx
    dev = stack.device
    out = {"delta_e": torch.empty(D, dtype=torch.float32, device=dev),
           "ratio_sum": torch.empty(D, dtype=torch.float32, device=dev),
           "u_eb": torch.empty((D, epy, epx), dtype=torch.float32,
                               device=dev)}
    if with_image:
        out["image"] = torch.empty((D, fy, fx, 3, epy, epx),
                                   dtype=torch.float32, device=dev)
    if D == 0 or npix == 0 or P == 0:
        return out
    plan = colorimetry_plan(D, P, npix)
    part = torch.empty(plan["part"], dtype=torch.float32, device=dev)
    pos = torch.empty(plan["pos"], dtype=torch.float32, device=dev)
    done = torch.empty(plan["done"], dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.colorimetry_launch(
            stack.data_ptr(),
            out["image"].data_ptr() if with_image else None,
            part.data_ptr(), pos.data_ptr(), done.data_ptr(),
            out["delta_e"].data_ptr(), out["ratio_sum"].data_ptr(),
            out["u_eb"].data_ptr(), consts.ctypes.data, NCONST,
            float(inv_norm), D, npix, P, plan["S"], plan["chunk"], stream)
    _raise(lib, err, "colorimetry")
    launch_counts["colorimetry"] += 1
    return out


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/eye_tail.cu``, and load its
    module now (``eye_tail_prepare`` reads each kernel's attributes), so
    that neither falls in the first tail; raises with the compiler's output
    if the build fails, or with the CUDA error if the load does."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("eye_tail")
        lib.pupil_window_sum_launch.argtypes = WINDOW_ARGTYPES
        lib.pupil_window_sum_launch.restype = ctypes.c_int
        lib.window_sum_shape.argtypes = [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.window_sum_shape.restype = ctypes.c_int
        lib.window_sum_last_launch.argtypes = [ctypes.c_void_p]
        lib.window_sum_last_launch.restype = None
        lib.colorimetry_launch.argtypes = COLOR_ARGTYPES
        lib.colorimetry_launch.restype = ctypes.c_int
        lib.colorimetry_shape.argtypes = [ctypes.c_void_p]
        lib.colorimetry_shape.restype = ctypes.c_int
        lib.eye_tail_prepare.argtypes = []
        lib.eye_tail_prepare.restype = ctypes.c_int
        lib.eye_tail_error_string.argtypes = [ctypes.c_int]
        lib.eye_tail_error_string.restype = ctypes.c_char_p
        _raise(lib, lib.eye_tail_prepare(), "eye_tail module load")
        _LIB = lib
    return _LIB
