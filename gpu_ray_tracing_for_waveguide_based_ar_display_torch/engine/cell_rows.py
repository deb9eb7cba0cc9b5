"""Kernel cell rows of synthetic LUTs, built on the device.

The host route to a kernel engine's rows is the synthetic-LUT -> cell-table
-> row pipeline: :func:`..luts.synthetic.make_synthetic_luts` (or the fused
:func:`..luts.packing.build_cell_tables_synthetic_batch`), then
:func:`.trace_rows.build_kernel_cell_params`.  This module splits it:

- :func:`synthetic_row_inputs` (host numpy) computes what needs a
  transcendental, exactly as the host route does (``cos``, ``sin``,
  ``exp``, ``np.angle``): each branch's efficiency profile, the cosine and
  sine of its rotation and the phasors of its diagonal (design-independent,
  drawn in :func:`..luts.synthetic._synth_quads`' order), and per design the
  angle cosines, n_glass, the TIR hops and phasors;
- :func:`cell_rows` turns them into the ``(D * C, PC)`` float32 rows: on a
  GPU by the CUDA kernel ``csrc/cell_rows.cu``, on the CPU by
  :func:`cell_rows_reference`, its plain PyTorch version.

Both use only correctly rounded operations (float64 ``+ - * /`` and
``sqrt``, float32 ``+ - * /``, float64 -> float32 rounding) in numpy's
order, so kernel, plain version and host route agree bit for bit.  The
kernel replaces host numpy, not a TPU kernel; it is bound by the bytes it
writes (2,816 B a cell row) and reads.  Its grid is :func:`rows_grid`
blocks, each owning a contiguous range of rows in tiles of :data:`TILE`;
:func:`rows_shape` reads the card's launch shape.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
from typing import Optional, Sequence

import numpy as np
import torch

from . import build
from .timing import EventTimer
from .trace_persistent import MAX_FC, MAX_OC, launch_counts
from .trace_rows import (
    PC, _EBR, _EBS, _EBT, _EDGE_TOL, _FC_BLK, _FC_STRIDE, _GAPS, _HOP2_ANG,
    _IC_BLK, _IC_SA, _IC_SB, _INIT_COS0, _INIT_JA, _INIT_JB, _INIT_SA,
    _INIT_SB, _OC_BLK, _OC_SOUT, _OC_STRIDE, _TIR_PH,
)
from ..design.geometry import DesignGeometry
from ..luts.synthetic import _profile, _stack_angles

# the angle cosines, by index: the in-coupler's air side, the IC, second IC
# order, FC and OC directions
COS_AIR, COS_IC, COS_IC2, COS_FC, COS_OC = range(5)
# a branch's ``extra`` in c = sqrt(p * cos_in / (cos_out * extra))
EXTRA_ONE, EXTRA_NG, EXTRA_INV_NG = range(3)
# the C parameters of cell_rows_launch: 8 pointers, 8 ints, tol, the stream
LAUNCH_ARGTYPES = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                   + [ctypes.c_float, ctypes.c_void_p])

# rows a tile of the kernel (csrc/cell_rows.cu)
TILE = 32
# cell_rows_shape's out[10], in its order
SHAPE_KEYS = ("grid", "threads", "tile", "buffers", "smem", "blocks_per_sm",
              "sms", "registers", "local_bytes", "pitch")


@dataclasses.dataclass
class RowInputs:
    """The host values of :func:`synthetic_row_inputs`; C = L*M*N cells per
    design, cid = (l*M + m)*N + n, B branches."""
    D: int
    L: int
    M: int
    N: int
    num_fc: int
    num_oc: int
    branch: np.ndarray    # (B, 7, C) float64: p, cos b, sin b, Re/Im e^{i d1},
                          # Re/Im e^{i d2}; design-independent
    table: np.ndarray     # (B, 4) int32: cos_in, cos_out, extra, row offset
    cosines: np.ndarray   # (D, 5, C) float64: cos of the angle tables
    glass: np.ndarray     # (D, 2) float64: n_glass, 1 / n_glass
    gaps: np.ndarray      # (D, C, 8) float64: the TIR hops
    phasors: np.ndarray   # (D, C, 18) float32: e^{i TIR}, e^{2i TIR} (re, im)
                          # per direction, the hop-2 angles of directions 0, 1
    # field name -> the page-locked tensor the field's array views
    pinned: dict = dataclasses.field(default_factory=dict, repr=False)

    @property
    def C(self) -> int:
        return self.L * self.M * self.N


def branch_table(num_fc: int, num_oc: int) -> np.ndarray:
    """(B, 4) int32 ``[cos_in, cos_out, extra, row offset]`` of every branch
    in :func:`..luts.synthetic._synth_quads`' order; the offset is where its
    8 Jones floats go in the cell row (:func:`.trace_rows.
    build_kernel_cell_params`: IC records [bit][branch], FC strips A0 B0 A1
    B1, OC strips [bit][branch A, B, C])."""
    rows = [(COS_AIR, COS_IC, EXTRA_NG, _INIT_JA),
            (COS_AIR, COS_IC2, EXTRA_NG, _INIT_JB),
            (COS_IC, COS_IC, EXTRA_ONE, _IC_BLK),          # ic2 -> ic2
            (COS_IC, COS_IC2, EXTRA_ONE, _IC_BLK + 8),     # ic2 -> ic3
            (COS_IC2, COS_IC, EXTRA_ONE, _IC_BLK + 16),    # ic3 -> ic2
            (COS_IC2, COS_IC2, EXTRA_ONE, _IC_BLK + 24)]   # ic3 -> ic3
    for s in range(num_fc):
        off = _FC_BLK + s * _FC_STRIDE
        rows += [(COS_IC, COS_IC, EXTRA_ONE, off),          # fc1 stay
                 (COS_IC, COS_FC, EXTRA_ONE, off + 8),      # fc1 fold
                 (COS_FC, COS_IC, EXTRA_ONE, off + 16),     # fc2 unfold
                 (COS_FC, COS_FC, EXTRA_ONE, off + 24)]     # fc2 stay
    for s in range(num_oc):
        off = _OC_BLK + s * _OC_STRIDE
        rows += [(COS_FC, COS_FC, EXTRA_ONE, off),          # oc1 stay
                 (COS_FC, COS_OC, EXTRA_ONE, off + 8),      # oc1 reverse
                 (COS_FC, COS_AIR, EXTRA_INV_NG, off + 16),  # oc1 out
                 (COS_OC, COS_FC, EXTRA_ONE, off + 24),     # oc2 unreverse
                 (COS_OC, COS_OC, EXTRA_ONE, off + 32),     # oc2 stay
                 (COS_OC, COS_AIR, EXTRA_INV_NG, off + 40)]  # oc2 out
    return np.asarray(rows, np.int32)


def rows_grid(total: int, resident: int) -> int:
    """The kernel's grid for ``total`` rows: a block per :data:`TILE` rows,
    at most ``resident`` (the card's resident blocks)."""
    return min(-(-total // TILE), resident)


def _branches(A: dict, seed: int):
    """Yield ``(p, beta, d1, d2)`` of every branch in the exact RNG draw
    order of :func:`..luts.synthetic._synth_quads`, line for line: each
    ``prof`` draws its four numbers before the ``jones`` it feeds draws its
    three (``ic1``'s two profiles both come first)."""
    L, M, N = A["L"], A["M"], A["N"]
    rng = np.random.default_rng(seed)
    u = (np.arange(M) / max(M - 1, 1) - 0.5)[None, None, :, None]
    v = (np.arange(N) / max(N - 1, 1) - 0.5)[None, None, None, :]
    l = np.arange(L)[None, :, None, None].astype(np.float64)

    def prof(base, amp):
        return _profile(
            base, amp, u, v, l,
            fx=rng.uniform(0.2, 0.8), fy=rng.uniform(0.2, 0.8),
            fl=rng.uniform(0.5, 2.0), phase=rng.uniform(0, 2 * np.pi),
        )

    def jones(p):
        beta = 0.15 * np.sin(2 * np.pi * (u + v) + l) + rng.uniform(-0.2, 0.2)
        d1 = rng.uniform(0, 2 * np.pi) + 0.3 * np.sin(4 * u + l)
        d2 = rng.uniform(0, 2 * np.pi) + 0.3 * np.cos(3 * v - l)
        return p, beta, d1, d2

    p_a = prof(0.50, 0.18)
    p_b = prof(0.12, 0.30)
    yield jones(p_a)
    yield jones(p_b)
    yield jones(prof(0.70, 0.10))
    yield jones(prof(0.12, 0.3))
    yield jones(prof(0.45, 0.2))
    yield jones(prof(0.35, 0.2))
    for s in range(A["num_fc"]):
        grade = 0.14 + 0.12 * s / max(A["num_fc"] - 1, 1)
        yield jones(prof(0.78, 0.06))
        yield jones(prof(grade, 0.2))
        yield jones(prof(0.04, 0.3))
        yield jones(prof(0.90, 0.04))
    for s in range(A["num_oc"]):
        frac = s / max(A["num_oc"] - 1, 1)
        p_out = 0.12 + 0.20 * frac
        p_stay = 0.82 - 0.30 * frac
        yield jones(prof(p_stay, 0.05))
        yield jones(prof(0.04, 0.3))
        yield jones(prof(p_out, 0.15))
        yield jones(prof(0.40, 0.2))
        yield jones(prof(0.40, 0.15))
        yield jones(prof(p_out * 0.8, 0.2))


def synthetic_row_inputs(geoms: Sequence[DesignGeometry], seed: int = 1234,
                         pinned: bool = False) -> RowInputs:
    """The host values of the designs' synthetic rows (all designs share
    (L, M, N) and strip counts), each computed as the host route computes
    it.  ``pinned``: the arrays live in page-locked memory (a CUDA build of
    torch), so the upload to the card is one asynchronous copy."""
    A = _stack_angles(geoms)
    D, L, M, N = A["D"], A["L"], A["M"], A["N"]
    S_fc, S_oc = A["num_fc"], A["num_oc"]
    if S_fc > MAX_FC or S_oc > MAX_OC:
        raise ValueError(f"the cell row holds at most {MAX_FC} FC and "
                         f"{MAX_OC} OC strips, got {S_fc} and {S_oc}")
    C = L * M * N
    table = branch_table(S_fc, S_oc)
    held = {}

    def empty(name, shape, dtype):
        if pinned:
            held[name] = torch.empty(shape, dtype=dtype, pin_memory=True)
            return held[name].numpy()
        return np.empty(shape, {torch.float64: np.float64,
                                torch.float32: np.float32}[dtype])

    branch = empty("branch", (len(table), 7, C), torch.float64)
    for b, (p, beta, d1, d2) in enumerate(_branches(A, seed)):
        # luts.synthetic._unitary's transcendentals, as it takes them
        e1 = np.exp(1j * d1)
        e2 = np.exp(1j * d2)
        for k, x in enumerate((p, np.cos(beta), np.sin(beta), e1.real,
                               e1.imag, e2.real, e2.imag)):
            branch[b, k].reshape(L, M, N)[...] = x[0]
    cosines = empty("cosines", (D, 5, C), torch.float64)
    for k, key in enumerate(("th_in_ic", "th_out_ic", "th_out_ic2",
                             "th_out_fc", "th_out_oc")):
        cosines[:, k] = np.cos(A[key]).reshape(D, C)
    glass = np.empty((D, 2))
    glass[:, 0] = A["n_g"].ravel()
    glass[:, 1] = (1.0 / A["n_g"]).ravel()
    gaps = empty("gaps", (D, C, 8), torch.float64)
    gaps[...] = np.stack([g.lut_gap for g in geoms]).reshape(D, C, 8)
    # luts.packing's phasors and trace_rows' hop-2 angles, on arrays of the
    # same shapes and strides
    tir = np.stack([g.lut_tir for g in geoms])           # (D, L, M, N, 4)
    tir_ph = np.exp(1j * tir).astype(np.complex64).reshape(D * C, 4)
    hop2 = np.exp(2j * tir).astype(np.complex64).reshape(D * C, 4)
    phasors = empty("phasors", (D, C, 18), torch.float32)
    ph = phasors.reshape(D * C, 18)
    ph[:, 0:8] = tir_ph.view(np.float32)
    ph[:, 8:16] = hop2.view(np.float32)
    ph[:, 16] = np.angle(hop2[:, 0])
    ph[:, 17] = np.angle(hop2[:, 1])
    return RowInputs(D=D, L=L, M=M, N=N, num_fc=S_fc, num_oc=S_oc,
                     branch=branch, table=table, cosines=cosines,
                     glass=glass, gaps=gaps, phasors=phasors, pinned=held)


def _eyebox(inputs: RowInputs, eyebox_range) -> np.ndarray:
    """The deposit rects as (D, M*N, 4) float64: ``eyebox_range`` is (M, N,
    4) for every design or (D, M, N, 4)."""
    eb = np.asarray(eyebox_range, np.float64)
    MN = inputs.M * inputs.N
    eb = eb.reshape(-1, MN, 4)
    if eb.shape[0] not in (1, inputs.D):
        raise ValueError(f"eyebox_range holds {eb.shape[0]} designs' rects, "
                         f"the inputs {inputs.D}")
    return np.broadcast_to(eb, (inputs.D, MN, 4)).copy()


def _times_complex(a, br, bi):
    """A float64 times a complex128 as numpy computes it: (a, 0) * (br, bi)."""
    zero = torch.zeros((), dtype=torch.float64, device=br.device)
    return a * br - zero * bi, a * bi + zero * br


def cell_rows_reference(inputs: RowInputs, eyebox_range,
                        eyebox_bins: Sequence[int] = (80, 120),
                        device="cpu") -> torch.Tensor:
    """The plain PyTorch version of the kernel: the (D * C, PC) float32 rows
    on ``device``, with the kernel's operations in the kernel's order (no
    scalar operands: every operand is a tensor of its type)."""
    dev = torch.device(device)
    D, C = inputs.D, inputs.C

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    f32 = torch.float32
    branch, cos = t(inputs.branch), t(inputs.cosines)
    glass = t(inputs.glass)
    extras = torch.cat([torch.ones((D, 1), dtype=torch.float64, device=dev),
                        glass], dim=1)                      # (D, 3)
    out = torch.zeros((D, C, PC), dtype=f32, device=dev)
    for b, (ci, co, ex, off) in enumerate(inputs.table.tolist()):
        p, cb, sb, e1r, e1i, e2r, e2i = branch[b]
        s = torch.sqrt(p * cos[:, ci] / (cos[:, co] * extras[:, ex:ex + 1]))
        vals = []
        for ur, ui in (_times_complex(cb, e1r, e1i),
                       _times_complex(-sb, e2r, e2i),
                       _times_complex(sb, e1r, e1i),
                       _times_complex(cb, e2r, e2i)):
            vals += _times_complex(s, ur, ui)
        out[:, :, off:off + 8] = torch.stack(vals, dim=-1).to(f32)
    c32 = cos.to(f32)
    ng = glass[:, :1].to(f32)
    air, ic, ic2, fc, oc = (c32[:, k] for k in range(5))
    out[:, :, _INIT_SA] = ic * ng
    out[:, :, _INIT_SB] = ic2 * ng
    out[:, :, _INIT_COS0] = air
    out[:, :, _OC_SOUT] = air / ng
    out[:, :, _GAPS:_GAPS + 8] = t(inputs.gaps).to(f32)
    ph = t(inputs.phasors)
    out[:, :, _TIR_PH:_TIR_PH + 16] = ph[..., :16]
    out[:, :, _HOP2_ANG:_HOP2_ANG + 2] = ph[..., 16:]
    eb = t(_eyebox(inputs, eyebox_range)).to(f32)          # (D, MN, 4)
    r = eb[:, None].expand(D, inputs.L, -1, 4).reshape(D, C, 4)
    out[:, :, _EBR:_EBR + 4] = r
    tol = torch.tensor(np.float32(_EDGE_TOL), device=dev)
    out[:, :, _EBT + 0] = r[..., 0] - tol
    out[:, :, _EBT + 1] = r[..., 1] + tol
    out[:, :, _EBT + 2] = r[..., 2] - tol
    out[:, :, _EBT + 3] = r[..., 3] + tol
    ny, nx = (torch.tensor(float(v), dtype=f32, device=dev)
              for v in eyebox_bins)
    out[:, :, _EBS + 0] = nx / (r[..., 1] - r[..., 0])
    out[:, :, _EBS + 1] = ny / (r[..., 3] - r[..., 2])
    out[:, :, _IC_SA] = ic
    out[:, :, _IC_SB] = ic2
    for s in range(inputs.num_fc):
        off = _FC_BLK + s * _FC_STRIDE
        out[:, :, off + 32] = ic
        out[:, :, off + 33] = fc
    for s in range(inputs.num_oc):
        off = _OC_BLK + s * _OC_STRIDE
        out[:, :, off + 48] = fc
        out[:, :, off + 49] = oc
    return out.reshape(D * C, PC)


def upload_inputs(inputs: RowInputs, eyebox_range, device) -> list:
    """The kernel's inputs on ``device``, in its argument order: branch,
    table, cosines, glass, gaps, phasors and the (D, M*N, 4) float64 deposit
    rects.  A page-locked array copies asynchronously (torch keeps its
    memory until the copy has run); any other copies at once."""
    def up(name, x):
        src = inputs.pinned.get(name)
        if src is None:
            src = torch.from_numpy(np.ascontiguousarray(x))
        return src.to(device, non_blocking=True)

    args = [up(n, getattr(inputs, n)) for n in
            ("branch", "table", "cosines", "glass", "gaps", "phasors")]
    args.append(up("eyebox", _eyebox(inputs, eyebox_range)))
    return args


def launch_rows(args: list, inputs: RowInputs,
                eyebox_bins: Sequence[int] = (80, 120),
                timer: Optional[EventTimer] = None) -> torch.Tensor:
    """One launch of the kernel on :func:`upload_inputs`' tensors: the
    (D * C, PC) float32 rows on their device.  ``timer`` records the span
    ``"rows"``."""
    dev = args[0].device
    if dev.type != "cuda":
        raise ValueError(f"the cell_rows kernel runs on cuda, not {dev}")
    lib = load_kernel()
    D, C = inputs.D, inputs.C
    rows = torch.empty((D * C, PC), dtype=torch.float32, device=dev)
    if D * C == 0:
        return rows
    ny, nx = eyebox_bins
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        with timer.span("rows") if timer else contextlib.nullcontext():
            err = lib.cell_rows_launch(
                *(a.data_ptr() for a in args), rows.data_ptr(), D, C,
                inputs.M * inputs.N, len(inputs.table), inputs.num_fc,
                inputs.num_oc, int(ny), int(nx), float(np.float32(_EDGE_TOL)),
                stream)
    if err != 0:
        msg = lib.cell_rows_error_string(err).decode()
        raise RuntimeError(f"cell_rows launch failed: {msg} ({err})")
    launch_counts["cell_rows"] += 1
    return rows


def rows_shape(total: int) -> dict:
    """The kernel's launch shape for ``total`` rows on the current card:
    :data:`SHAPE_KEYS` from ``csrc/cell_rows.cu``'s ``cell_rows_shape``
    (its grid, with the kernel's registers, local bytes and resident blocks
    per SM from the runtime)."""
    lib = load_kernel()
    out = (ctypes.c_int * len(SHAPE_KEYS))()
    err = lib.cell_rows_shape(int(total), out)
    if err != 0:
        msg = lib.cell_rows_error_string(err).decode()
        raise RuntimeError(f"cell_rows_shape failed: {msg} ({err})")
    return dict(zip(SHAPE_KEYS, list(out)))


def cell_rows(inputs: RowInputs, eyebox_range,
              eyebox_bins: Sequence[int] = (80, 120), device="cuda",
              timer: Optional[EventTimer] = None) -> torch.Tensor:
    """The (D * C, PC) float32 cell rows on ``device``: the CUDA kernel on a
    GPU (:func:`upload_inputs`, :func:`launch_rows`), the plain version on
    the CPU.  ``timer`` records the kernel's span ``"rows"``."""
    dev = torch.device(device)
    if dev.type == "cpu":
        return cell_rows_reference(inputs, eyebox_range, eyebox_bins, dev)
    if dev.type != "cuda":
        raise ValueError(f"cell_rows runs on cpu or cuda, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("cell_rows asked for a CUDA device but no CUDA "
                           "device is available")
    return launch_rows(upload_inputs(inputs, eyebox_range, dev), inputs,
                       eyebox_bins, timer)


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/cell_rows.cu``; raises with the
    compiler's output if the build fails."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("cell_rows")
        lib.cell_rows_launch.argtypes = LAUNCH_ARGTYPES
        lib.cell_rows_launch.restype = ctypes.c_int
        lib.cell_rows_shape.argtypes = [ctypes.c_longlong, ctypes.c_void_p]
        lib.cell_rows_shape.restype = ctypes.c_int
        lib.cell_rows_error_string.argtypes = [ctypes.c_int]
        lib.cell_rows_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB
