"""Persistent-slot Monte-Carlo trace: the CUDA kernel, its wrapper and its
plain PyTorch version.

Replaces ``engine/trace_pallas_persistent.py::make_persistent_trace_fn`` of
the JAX package: exact ("fma") or bf16-packed parameter selection, one or
several cells per block, single TIR hops or transit jumps, both spawn modes
and per-design geometry rows.

Each cell owns ``S = RT * 128`` slots.  A slot walks the state machine
IC 0/1, FC 2/3, OC 4/5, dead 6, awaiting respawn 7.  Out-coupled rays inside
the cell's eyebox rectangle add one to its ``(ny, nx)`` tile.  Dead slots
respawn under the runtime ``ctrl = [quota, spawn_iters]``:

- ``spawn_mode="count"``: at the start of iteration ``it`` every dead slot
  respawns if the cell's spawn count, as it stood at the start of the
  iteration, is below the target ``ctrl[0]``, or if ``it < ctrl[1]``; the
  count starts at ``S`` and grows by the respawns.  A cell stops when every
  slot is dead and the target is met, or at ``max_iters``.
- ``spawn_mode="gens"``: each slot counts its own generations (the first
  spawn is generation 1) and a dead slot respawns while ``gen < ctrl[0]`` or
  ``it < ctrl[1]`` (saturating spawn).  A cell stops when every slot is dead
  with ``gen >= ctrl[0]`` and ``it >= ctrl[1]``, or at ``max_iters``.
  ``nb[:, 2]`` is the sum of the slots' generations.

The cells may belong to ``D`` designs: ``geom_row`` is ``(D, PG)`` and the
cells are D contiguous runs of ``cpd = C / D``; cell ``c`` reads geometry
row ``c // cpd``.  Launch tiles come per cell, per design or one for all;
seed blocks per cell or one ``(cpd, RT, 128)`` block shared by every design
(cell ``c`` reads block ``c % cpd``).

``accum_mode="packed"`` reads each site's selection record from
``cell_params_packed`` (:func:`.trace_rows.pack_selection_params`: the
record's parameters rounded to bfloat16, widened back by a 16-bit shift) and
tests regions by the max chain ``max_e(x*nx_e + (y*ny_e + mc_e)) <= 0``;
everything else in the cell row stays float32.  ``cells_per_block = k``
(packed only) puts k consecutive cells of one design into one block, each
with ``RT / k`` rows of slots: per cell, tile, bounces and spawns are those
of the cell alone in a block; ``nb[:, 1]`` is the block's iteration count.
``transit_jump`` (packed, k = 1) lets a slot on a pure TIR hop advance to
the hop at which it next leaves ``eff_reg1`` (or ``eff_reg2``) or enters
the FC hull or the OC rectangle, in one iteration: position ``+= k * gap``,
bounces ``+= k - 1``, the TM field times the hop phasor to the power k, by
squaring (``jump_phase="pow2"``, k <= 15) or by ``cos / sin(k * angle)``
(``"cos"``, k <= 4095).  Jumps are within Monte-Carlo tolerance of single
hops, not bitwise (a ray within rounding of an edge may interact a hop
earlier or later).

The kernel (``csrc/persistent_trace.cu``) runs one thread block per cell
(or per k cells).
What bounds it on an H100: per-lane divergent ALU work (region tests, Jones
products, the branch roulette) and the block's barrier once per iteration;
it reads its rows and rays once and writes one histogram per cell.  Its
design answers that: slot state, cell row and geometry row live in shared
memory, and each iteration runs only a per-cell work list of the slots that
act (live, awaiting their first spawn, or respawning), so dead slots cost
nothing and live ones fill whole warps; deposits are float ``atomicAdd``s
into ``hist`` in device memory (every count stays below 2^24: exact and
order-free), which leaves a block of 2,048 slots small enough for two to
share an SM; strip records are read by index instead of the TPU's one-hot
selection, and the loops over half-plane edges stop at the given edge
counts.

Both versions use the same float32 operations in the same order, with no
fused multiply-add (the kernel is built with ``-fmad=false``) and
``rsqrt(x)`` written ``1 / sqrt(x)``, so on the card they agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from . import build
from .trace_rows import (
    LANES, MAX_EDGES, PC, PG, SEL_NW, pack_selection_params, rows_to_device,
    selection_row_offsets,
    _EBR, _EBS, _EBT, _FC_BLK, _FC_STRIDE, _G_FC_INVW, _G_FC_ROT, _G_FC_TOP,
    _G_HULL, _G_IC, _G_MC_HULL, _G_MC_R1, _G_MC_R2, _G_OC_BT, _G_OC_INVW,
    _G_OC_ROT, _G_OC_TOP, _G_R1, _G_R2, _GAPS, _HOP2_ANG, _HOP2_PH, _IC_BLK,
    _IC_SA, _IC_SB, _INIT_COS0, _INIT_JA, _INIT_JB, _INIT_SA, _INIT_SB,
    _OC_BLK, _OC_SOUT, _OC_STRIDE, _TIR_PH,
)
from ..ops.rng import draw24, xorshift32_step

MAX_FC = (_OC_BLK - _FC_BLK) // _FC_STRIDE   # strips the cell row has room for
MAX_OC = (_EBT - _OC_BLK) // _OC_STRIDE
_SMEM_LIMIT = 232_448   # bytes of shared memory one H100 block may use
_MASK32 = 0xFFFFFFFF
# the C parameters of persistent_trace_launch, in order: 8 pointers, 18 ints
# and the stream; of persistent_trace_occupancy: 6 ints and the result
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 18 + [ctypes.c_void_p]
OCCUPANCY_ARGTYPES = [ctypes.c_int] * 6 + [ctypes.c_void_p]

SPAWN_MODES = ("count", "gens")
ACCUM_MODES = ("fma", "select", "packed")   # "select" gives "fma"'s values
JUMP_PHASES = ("pow2", "cos")
MAX_CPB = 8         # cells one block can carry (the kernel's)
_STATE_WORDS = 9    # words of slot state in shared memory (the kernel's),
                    # and one more in gens spawn: the slot's generations
_JUMP_WORDS = 5 * MAX_EDGES + 8   # transit-jump reciprocals (the kernel's)
# the kernel's static shared memory, at most: per block cell three list
# lengths, three respawn counts (count spawn only), the spawn count and the
# bounce count; and ctrl; rounded up to 16 bytes
_STATIC_SMEM = -(-(8 * 4 * MAX_CPB + 8) // 16) * 16

# kernel launches by wrapper name; the wrapper adds one per launch and
# nothing else touches it except reset_launch_counts ("<name>_kernels":
# the device kernels a wrapper's calls launched, where a call could launch
# several)
launch_counts = {"persistent_trace": 0, "cell_trace": 0, "cell_rows": 0,
                 "eye_perceive": 0, "colorimetry": 0, "split_cells": 0,
                 "vector_trace": 0, "split_trace": 0,
                 "split_trace_backward": 0, "split_trace_kernels": 0,
                 "split_trace_backward_kernels": 0}


def reset_launch_counts() -> None:
    for k in launch_counts:
        launch_counts[k] = 0


def block_threads(slots: int, cells_per_block: int = 1) -> int:
    """Threads per block of ``slots`` slots over ``cells_per_block`` cells:
    each cell gets the largest group of 512/256/128/64/32 threads that
    divides its slots and keeps the block within 512 threads (512/256/128
    for one cell per block)."""
    k = cells_per_block
    per_cell = slots // k
    if slots % (k * LANES) == 0:
        for t in (512, 256, 128) if k == 1 else (256, 128, 64, 32):
            if t * k <= 512 and per_cell % t == 0:
                return t * k
    raise ValueError(f"slots ({slots}) must be a multiple of {LANES} per "
                     f"block cell ({k} cells of at most {MAX_CPB})")


def shared_bytes(slots: int, cells_per_block: int = 1, packed_words: int = 0,
                 transit_jump: bool = False, gens: bool = False) -> int:
    """Dynamic shared memory of one block of ``slots`` slots (must match the
    kernel's ``shared_bytes``): per block cell a cell row and its
    ``packed_words`` packed selection words; the geometry row, the
    transit-jump reciprocals, 9 words of state per slot (10 in gens spawn)
    and two lists of uint16 slot indices.  The histograms live in device
    memory, so the eyebox bins take none."""
    return (4 * (cells_per_block * (PC + 8 + packed_words) + PG
                 + (_JUMP_WORDS if transit_jump else 0)
                 + (_STATE_WORDS + int(gens)) * slots) + 2 * 2 * slots)


def check_block_fits(slots: int, cells_per_block: int = 1,
                     packed_words: int = 0, transit_jump: bool = False,
                     gens: bool = False) -> int:
    """The shared memory one block of the launch needs, static part
    included, in bytes; raises if an H100 block cannot have it (the launch
    never runs a smaller ``cells_per_block`` instead)."""
    need = shared_bytes(slots, cells_per_block, packed_words, transit_jump,
                        gens) + _STATIC_SMEM
    if need > _SMEM_LIMIT:
        raise ValueError(
            f"a block of {cells_per_block} cell(s) and {slots} slots needs "
            f"{need} B of shared memory (limit {_SMEM_LIMIT})")
    return need


def selection(accum_mode: str = "fma", transit_jump: bool = False,
              jump_phase: str = "pow2") -> int:
    """The kernel's ``sel``: 0 exact, 1 packed, 2 packed + jump by squaring,
    3 packed + jump by cos / sin."""
    return int(accum_mode == "packed") + (
        int(transit_jump) * (1 + JUMP_PHASES.index(jump_phase)))


def check_modes(accum_mode: str, cells_per_block: int, transit_jump: bool,
                jump_phase: str) -> None:
    """The refusals of the JAX package's kernel builder: ``transit_jump``
    needs packed selection and one cell per block, several cells per block
    need packed selection; ``"bf16"`` (interpret-only there) is not ported."""
    if accum_mode == "bf16":
        raise ValueError("accum_mode='bf16' is not ported (interpret-only in "
                         "the JAX package); use accum_mode='packed', the same "
                         "bf16 rounding of the selection records")
    if accum_mode not in ACCUM_MODES:
        raise ValueError(f"accum_mode must be one of {ACCUM_MODES}, "
                         f"got {accum_mode!r}")
    if not 1 <= cells_per_block <= MAX_CPB:
        raise ValueError(f"cells_per_block must be 1..{MAX_CPB}, "
                         f"got {cells_per_block}")
    if cells_per_block > 1 and accum_mode != "packed":
        raise ValueError("cells_per_block > 1 requires accum_mode='packed'")
    if transit_jump:
        if accum_mode != "packed" or cells_per_block != 1:
            raise ValueError("transit_jump requires accum_mode='packed' and "
                             "cells_per_block=1")
        if jump_phase not in JUMP_PHASES:
            raise ValueError(f"jump_phase must be one of {JUMP_PHASES}, "
                             f"got {jump_phase!r}")


def _check_inputs(cell_params, geom_row, rays_in, rng_in, ctrl, num_fc, num_oc,
                  edge_counts, eyebox_bins, max_iters, spawn_mode,
                  accum_mode="fma", cells_per_block=1, transit_jump=False,
                  jump_phase="pow2", cell_params_packed=None,
                  ) -> Tuple[int, int, int, int, int]:
    """Validate the launch; returns ``(C, S, cpd, rays_div, rng_mod)``: a
    block of ``S`` slots carries ``k = cells_per_block`` cells; block ``b``
    (cells ``b * k ..``) reads geometry row ``b * k // cpd``, launch tile
    ``b // rays_div`` and seed block ``b % rng_mod``."""
    dev = cell_params.device
    check_modes(accum_mode, cells_per_block, transit_jump, jump_phase)
    k = cells_per_block
    packed = accum_mode == "packed"
    if packed != (cell_params_packed is not None):
        raise ValueError("cell_params_packed must be given exactly when "
                         "accum_mode='packed' (see pack_selection_params)")
    tensors = [("cell_params", cell_params, torch.float32),
               ("geom_row", geom_row, torch.float32),
               ("rays_in", rays_in, torch.float32),
               ("rng_in", rng_in, torch.int32),
               ("ctrl", ctrl, torch.int32)]
    if packed:
        tensors.append(("cell_params_packed", cell_params_packed, torch.int32))
    for name, t, dt in tensors:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a tensor")
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, cell_params on {dev}")
        if t.dtype != dt:
            raise TypeError(f"{name} must be {dt}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if cell_params.dim() != 2 or cell_params.shape[1] != PC:
        raise ValueError(f"cell_params must be (C, {PC}), got {tuple(cell_params.shape)}")
    C = cell_params.shape[0]
    if geom_row.dim() != 2 or geom_row.shape[1] != PG or geom_row.shape[0] < 1:
        raise ValueError(f"geom_row must be (D, {PG}), got {tuple(geom_row.shape)}")
    D = geom_row.shape[0]
    if C % D:
        raise ValueError(f"cells ({C}) must split evenly over the {D} "
                         "designs of geom_row")
    cpd = max(C // D, 1)
    if C % k or cpd % k:
        raise ValueError(f"cells ({C}) and cells per design ({cpd}) must split "
                         f"evenly over cells_per_block ({k}): a block's cells "
                         "share one design")
    Cb, cpd_b = C // k, max(cpd // k, 1)   # blocks, and blocks per design
    if (rng_in.dim() != 3 or rng_in.shape[0] not in (Cb, cpd_b)
            or rng_in.shape[2] != LANES):
        raise ValueError(f"rng_in must be ({Cb} or {cpd_b} blocks, RT, {LANES}), "
                         f"got {tuple(rng_in.shape)}")
    RT = rng_in.shape[1]
    if RT % k:
        raise ValueError(f"the block's {RT} rows of slots must split evenly "
                         f"over cells_per_block ({k})")
    if (rays_in.dim() != 4 or rays_in.shape[0] not in (1, D, Cb)
            or tuple(rays_in.shape[1:]) != (6, RT, LANES)):
        raise ValueError(f"rays_in must be (R, 6, {RT}, {LANES}) with R = 1, "
                         f"D={D} or {Cb} blocks, got {tuple(rays_in.shape)}")
    rays_div = {Cb: 1, D: cpd_b, 1: max(Cb, 1)}[rays_in.shape[0]]
    rng_mod = max(rng_in.shape[0], 1)
    if spawn_mode not in SPAWN_MODES:
        raise ValueError(f"spawn_mode must be one of {SPAWN_MODES}, "
                         f"got {spawn_mode!r}")
    if tuple(ctrl.shape) != (2,):
        raise ValueError(f"ctrl must be (2,), got {tuple(ctrl.shape)}")
    if not (1 <= num_fc <= MAX_FC and 1 <= num_oc <= MAX_OC):
        raise ValueError(f"num_fc/num_oc ({num_fc}, {num_oc}) exceed the cell "
                         f"row's {MAX_FC}/{MAX_OC} strips")
    if packed and tuple(cell_params_packed.shape) != (
            C, (1 + num_fc + num_oc) * SEL_NW):
        raise ValueError(
            f"cell_params_packed must be ({C}, {(1 + num_fc + num_oc) * SEL_NW}), "
            f"got {tuple(cell_params_packed.shape)}")
    if len(edge_counts) != 3 or not all(0 <= e <= MAX_EDGES for e in edge_counts):
        raise ValueError(f"edge_counts must be 3 counts <= {MAX_EDGES}")
    if len(eyebox_bins) != 2 or min(eyebox_bins) < 1:
        raise ValueError(f"bad eyebox_bins {eyebox_bins}")
    if max_iters < 1:
        raise ValueError("max_iters must be positive")
    return C, RT * LANES, cpd, rays_div, rng_mod


def persistent_trace(cell_params: torch.Tensor, geom_row: torch.Tensor,
                     rays_in: torch.Tensor, rng_in: torch.Tensor,
                     ctrl: torch.Tensor, *, num_fc: int, num_oc: int,
                     edge_counts: Sequence[int], eyebox_bins: Sequence[int],
                     max_iters: int, spawn_mode: str = "count",
                     accum_mode: str = "fma", cells_per_block: int = 1,
                     transit_jump: bool = False, jump_phase: str = "pow2",
                     cell_params_packed: Optional[torch.Tensor] = None,
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Trace every cell of the batch; returns ``(hist, nb)``.

    - ``cell_params`` (C, 704) f32: the cell rows of :mod:`.trace_rows`.
    - ``geom_row`` (D, 320) f32: one geometry row per design, ``C % D == 0``;
      the cells are D contiguous runs of ``cpd = C / D``.
    - ``rays_in`` (R, 6, RT, 128) f32 with R = C, D or 1: launch fields (x,
      y, ter, tei, tmr, tmi) of every slot, also its respawn values: one tile
      per cell, per design or for every cell.
    - ``rng_in`` (C or cpd, RT, 128) int32: per-slot xorshift32 seeds (uint32
      bits), per cell or one block shared by every design (cell ``c`` reads
      block ``c % cpd``).
    - ``ctrl`` (2,) int32: ``[spawn target per cell, spawn_iters]`` in count
      mode, ``[generations per slot, spawn_iters]`` in gens mode.
    - ``accum_mode``: ``"fma"`` (or its synonym ``"select"``) reads float32
      records; ``"packed"`` reads ``cell_params_packed`` (C, (1 + num_fc +
      num_oc) * 25) int32, given exactly then.
    - ``cells_per_block = k > 1`` (packed only): a block of RT rows carries k
      consecutive cells of one design with ``RT / k`` rows each, so
      ``rays_in`` is (R, 6, RT, 128) with R = C / k, D or 1 (cell h of a
      block respawns from rows ``h * RT / k ..``) and ``rng_in`` (C / k or
      cpd / k, RT, 128): the contiguous reshape of per-cell (.., RT / k, 128)
      seeds.  ``C`` and ``cpd`` must be multiples of k.
    - ``transit_jump`` (packed, k = 1) with ``jump_phase`` "pow2" or "cos".
    - ``hist`` (C, ny, nx) f32 deposit counts; ``nb`` (C, 4) int32
      ``[bounces, iterations, spawned, 0]`` (the last column keeps the JAX
      kernel's overflow slot, always 0 here; iterations are the block's).

    A CPU tensor runs :func:`persistent_trace_reference`; a CUDA tensor
    launches the kernel or raises.
    """
    modes = dict(spawn_mode=spawn_mode, accum_mode=accum_mode,
                 cells_per_block=cells_per_block, transit_jump=transit_jump,
                 jump_phase=jump_phase, cell_params_packed=cell_params_packed)
    C, S, cpd, rays_div, rng_mod = _check_inputs(
        cell_params, geom_row, rays_in, rng_in, ctrl, num_fc, num_oc,
        edge_counts, eyebox_bins, max_iters, **modes)
    dev = cell_params.device
    if dev.type == "cpu":
        return persistent_trace_reference(
            cell_params, geom_row, rays_in, rng_in, ctrl, num_fc=num_fc,
            num_oc=num_oc, edge_counts=edge_counts, eyebox_bins=eyebox_bins,
            max_iters=max_iters, **modes)
    if dev.type != "cuda":
        raise ValueError(f"persistent_trace runs on cpu or cuda, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("persistent_trace got a CUDA tensor but no CUDA "
                           "device is available")
    ny, nx = eyebox_bins
    packed = accum_mode == "packed"
    pw = cell_params_packed.shape[1] if packed else 0
    threads = block_threads(S, cells_per_block)
    check_block_fits(S, cells_per_block, pw, transit_jump,
                     spawn_mode == "gens")
    lib = load_kernel()
    # every block zeroes its own cells' histograms before it deposits
    hist = torch.empty((C, ny, nx), dtype=torch.float32, device=dev)
    nb = torch.empty((C, 4), dtype=torch.int32, device=dev)
    if C == 0:
        return hist, nb
    sel = selection(accum_mode, transit_jump, jump_phase)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.persistent_trace_launch(
            cell_params.data_ptr(), geom_row.data_ptr(), rays_in.data_ptr(),
            rng_in.data_ptr(), ctrl.data_ptr(),
            cell_params_packed.data_ptr() if packed else None,
            hist.data_ptr(), nb.data_ptr(), C, cpd, rays_div, rng_mod,
            int(spawn_mode == "gens"), sel, cells_per_block, pw, S, num_fc,
            num_oc, *(int(e) for e in edge_counts), ny, nx, int(max_iters),
            threads, stream)
    if err != 0:
        msg = lib.persistent_trace_error_string(err).decode()
        raise RuntimeError(f"persistent_trace launch failed: {msg} ({err})")
    launch_counts["persistent_trace"] += 1
    return hist, nb


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/persistent_trace.cu``; raises
    with the compiler's output if the build fails."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("persistent_trace")
        lib.persistent_trace_launch.argtypes = LAUNCH_ARGTYPES
        lib.persistent_trace_launch.restype = ctypes.c_int
        lib.persistent_trace_occupancy.argtypes = OCCUPANCY_ARGTYPES
        lib.persistent_trace_occupancy.restype = ctypes.c_int
        lib.persistent_trace_error_string.argtypes = [ctypes.c_int]
        lib.persistent_trace_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_occupancy(slots: int, spawn_mode: str = "count",
                     accum_mode: str = "fma", cells_per_block: int = 1,
                     transit_jump: bool = False, jump_phase: str = "pow2",
                     packed_words: int = 0) -> dict:
    """What the card makes of the instantiation a launch of these modes
    runs, at ``slots`` slots per block and :func:`block_threads` threads:
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local memory per thread, dynamic and static shared bytes,
    and the blocks per SM its launch bounds ask for.  Needs the card."""
    lib = load_kernel()
    out = (ctypes.c_int * 6)()
    threads = block_threads(slots, cells_per_block)
    err = lib.persistent_trace_occupancy(
        int(spawn_mode == "gens"),
        selection(accum_mode, transit_jump, jump_phase), cells_per_block,
        packed_words, slots, threads, ctypes.addressof(out))
    if err != 0:
        msg = lib.persistent_trace_error_string(err).decode()
        raise RuntimeError(f"persistent_trace_occupancy failed: {msg} ({err})")
    keys = ("blocks_per_sm", "registers", "local_bytes", "dynamic_smem",
            "static_smem", "launch_bound_blocks")
    return dict(zip(keys, list(out)), threads=threads)


# ---------------------------------------------------------------------------
# plain PyTorch version


def _jones(j, ter, tei, tmr, tmi):
    """2x2 complex matvec; ``j`` = 8 coefficients (re/im interleaved)."""
    ar, ai, br, bi, cr, ci, dr, di = j
    return (ar * ter - ai * tei + br * tmr - bi * tmi,
            ar * tei + ai * ter + br * tmi + bi * tmr,
            cr * ter - ci * tei + dr * tmr - di * tmi,
            cr * tei + ci * ter + dr * tmi + di * tmr)


def _power(v):
    return v[0] * v[0] + v[1] * v[1] + v[2] * v[2] + v[3] * v[3]


def _rsqrt(v):
    """``1 / sqrt(v)`` as the kernels round it: the float32 square root
    correctly rounded (``sqrtf``), then its reciprocal.  The root is taken in
    float64 and rounded to float32, which is the correctly rounded float32
    root (53 >= 2 * 24 + 2 bits).  torch's float32 ``sqrt`` on the CPU is
    not correctly rounded, and in some processes one thread's share of a
    large tensor comes out rounded otherwise (F4 in ROADMAP.md)."""
    return 1.0 / torch.sqrt(torch.clamp(v, min=1e-30).double()).float()


def _bin(v, hi: int):
    """floor, clamped to [0, hi], as an index."""
    return torch.clamp(torch.floor(v), 0, hi).to(torch.int64)


_MC = {_G_HULL: _G_MC_HULL, _G_R1: _G_MC_R1, _G_R2: _G_MC_R2}


def unpack_selection(packed: torch.Tensor, num_fc: int,
                     num_oc: int) -> torch.Tensor:
    """The packed selection words (C, records * 25) int32 widened back to
    float32 and laid out as cell rows (C, PC + 8): each record's parameters
    at their cell-row offsets (:func:`.trace_rows.selection_row_offsets`),
    zeros elsewhere.  Reading it by offset gives what the kernel reads by
    (record, word)."""
    C = packed.shape[0]
    rows = selection_row_offsets(num_fc, num_oc)
    w = packed.reshape(C, len(rows), SEL_NW)
    vals = torch.stack([(w << 16).view(torch.float32),
                        (w & -65536).view(torch.float32)],
                       dim=-1).reshape(C, len(rows), 2 * SEL_NW)
    table = torch.zeros((C, PC + 8), dtype=torch.float32, device=packed.device)
    for r, (_, offs, qoffs) in enumerate(rows):
        table[:, offs] = vals[:, r, :34]
        if qoffs is not None:
            table[:, qoffs] = vals[:, r, 34:]
    return table


class _Rows:
    """The cell rows and each cell's geometry row as (C, 1) columns ``c(j)``
    and ``g(j)``; ``take(off)`` reads the cell rows at per-slot offsets, where
    offsets ``PC .. PC + 7`` read 0: the "no site" and "no branch C" records.
    ``take_sel`` reads the selection records: the same float32 rows, or with
    ``packed`` words their bfloat16 roundings, and then ``region`` is the max
    chain instead of the per-edge compare."""

    def __init__(self, cell_params: torch.Tensor, grows: torch.Tensor,
                 packed: Optional[torch.Tensor] = None, num_fc: int = 0,
                 num_oc: int = 0):
        self.cp = cell_params
        self.cpz = torch.cat([cell_params, cell_params.new_zeros(
            (cell_params.shape[0], 8))], dim=1)
        self.grows = grows
        self.max_chain = packed is not None
        self.sel = (unpack_selection(packed, num_fc, num_oc)
                    if packed is not None else self.cpz)

    def g(self, j):
        return self.grows[:, j:j + 1]

    def c(self, j):
        return self.cp[:, j:j + 1]

    def take(self, off):
        return torch.gather(self.cpz, 1, off)

    def take_sel(self, off):
        return torch.gather(self.sel, 1, off)

    def edge_values(self, base, n, x, y):
        """``x*nx_e + (y*ny_e + mc_e)`` of a region's first ``n`` edges."""
        g = self.g
        return [x * g(base + e) + (y * g(base + MAX_EDGES + e)
                                   + g(_MC[base] + e)) for e in range(n)]

    def region(self, base, n, x, y):
        g = self.g
        if self.max_chain:
            m = torch.full_like(x, -torch.inf)
            for d in self.edge_values(base, n, x, y):
                m = torch.maximum(m, d)
            return m <= 0.0
        inside = torch.ones_like(x, dtype=torch.bool)
        for e in range(n):
            inside = inside & (x * g(base + e) + y * g(base + MAX_EDGES + e)
                               <= g(base + 2 * MAX_EDGES + e))
        return inside

    def region_bound(self, base, n, x, y, recips, exit_: bool):
        """The max-chain test with the transit bound along each slot's hop
        line: ``d_e * r_e`` per edge, reduced by min (exit: the hop index at
        which the first edge is crossed outward) or by max (entry: the hop
        index from which every edge holds).  Returns ``(inside, bound)``."""
        m = torch.full_like(x, -torch.inf)
        b = torch.full_like(x, torch.inf if exit_ else -torch.inf)
        for d, r in zip(self.edge_values(base, n, x, y), recips):
            m = torch.maximum(m, d)
            b = torch.minimum(b, d * r) if exit_ else torch.maximum(b, d * r)
        return m <= 0.0, b

    def in_ic(self, px, py):
        dx = px - self.g(_G_IC)
        dy = py - self.g(_G_IC + 1)
        return dx * dx + dy * dy <= self.g(_G_IC + 2)


class _Jump:
    """Transit-jump constants of every cell, (C, 1) columns: per edge the
    slope of the hop line (direction 0: state 2; direction 1: states 3 and
    4) and its guarded reciprocal.  Exit (``rex``): the first hop index past
    edge e is ``floor(d_e * rex_e) + 1`` with ``rex_e = -1 / max(s_e, tiny)``;
    receding or parallel edges give a huge positive that never wins the min.
    Entry (``ren``): edge e holds from hop ``d_e * ren_e`` on, ``ren_e = 1 /
    max(-s_e, tiny)``.  ``rgap``: sign-preserving reciprocals of direction
    1's gap, magnitude clamped away from zero, for the OC rectangle's slab
    test."""

    def __init__(self, rows: _Rows, edge_counts, phase: str):
        g, c = rows.g, rows.c
        n_hull, n_r1, n_r2 = (int(e) for e in edge_counts)
        self.phase = phase
        self.kmax = 15.0 if phase == "pow2" else 4095.0
        gaps = [(c(_GAPS + 2 * d), c(_GAPS + 2 * d + 1)) for d in range(2)]

        def slopes(base, n, d):
            return [g(base + e) * gaps[d][0] + g(base + MAX_EDGES + e) * gaps[d][1]
                    for e in range(n)]

        def rex(sl):
            return [-(1.0 / torch.clamp(s, min=1e-30)) for s in sl]

        def ren(sl):
            return [1.0 / torch.clamp(-s, min=1e-30) for s in sl]

        self.rex_r1 = [rex(slopes(_G_R1, n_r1, d)) for d in range(2)]
        self.ren_h = [ren(slopes(_G_HULL, n_hull, d)) for d in range(2)]
        self.rex_r2 = rex(slopes(_G_R2, n_r2, 1))
        one = torch.ones_like(gaps[1][0])
        self.rgap = [torch.where(v >= 0.0, one, -one)
                     / torch.clamp(v.abs(), min=1e-12) for v in gaps[1]]


def _bounce_step(rows: _Rows, fields, state, rng, *, num_fc, num_oc,
                 edge_counts, eyebox_bins, jump: Optional[_Jump] = None):
    """One bounce of every live slot of a (C, S) block, shared by the plain
    versions of both trace kernels.

    ``fields`` = (x, y, ter, tei, tmr, tmi, cos_th, gx, gy); ``state`` and
    ``rng`` are int64.  Returns ``(fields, state, rng, alive, dep, code)``:
    ``alive`` marks the slots that began the bounce alive (with ``jump``: the
    bounces each slot made, its skipped hops included), ``dep`` those that
    out-coupled inside their cell's eyebox rectangle, into bin ``code = iy *
    nx + ix`` of its (ny, nx) tile."""
    x, y, ter, tei, tmr, tmi, cos_th, gx, gy = fields
    g, c, take, take_sel = rows.g, rows.c, rows.take, rows.take_sel
    n_hull, n_r1, n_r2 = (int(e) for e in edge_counts)
    ny, nx = eyebox_bins

    began = state < 6
    if jump is not None:
        # hop direction per slot: state 2 hops with direction 0, states 3 and
        # 4 with direction 1 (the bounds of slots that do not hop are unused)
        dirm0 = state == 2
        in_r1, ex_r1 = rows.region_bound(
            _G_R1, n_r1, x, y, [torch.where(dirm0, r0, r1) for r0, r1
                                in zip(*jump.rex_r1)], True)
    else:
        in_r1 = rows.region(_G_R1, n_r1, x, y)
    state = torch.where(began & ~in_r1, 6, state)
    alive = state < 6
    grp_ic = alive & (state <= 1)
    grp_fc = alive & ((state == 2) | (state == 3))
    grp_oc = alive & (state >= 4)
    bit = state & 1

    if jump is not None:
        in_hull, en_hull = rows.region_bound(
            _G_HULL, n_hull, x, y, [torch.where(dirm0, r0, r1) for r0, r1
                                    in zip(*jump.ren_h)], False)
    else:
        in_hull = rows.region(_G_HULL, n_hull, x, y)
    yrot = g(_G_FC_ROT) * x + g(_G_FC_ROT + 1) * y
    fc_strip = _bin((g(_G_FC_TOP) - yrot) * g(_G_FC_INVW), num_fc - 1)
    yr = g(_G_OC_ROT) * x + g(_G_OC_ROT + 1) * y
    in_rect = ((x >= g(_G_OC_BT)) & (x <= g(_G_OC_BT + 1))
               & (y >= g(_G_OC_BT + 2)) & (y <= g(_G_OC_BT + 3)))
    oc_strip = _bin((g(_G_OC_TOP) - yr) * g(_G_OC_INVW), num_oc - 1)
    hit_fc = grp_fc & in_hull
    hit_oc = grp_oc & in_rect
    interact = grp_ic | hit_fc | hit_oc

    # ---- site record by index: IC block, FC strip or OC strip
    fc_base = _FC_BLK + _FC_STRIDE * fc_strip
    oc_base = _OC_BLK + _OC_STRIDE * oc_strip
    ja_off = torch.where(grp_ic, _IC_BLK + 16 * bit, torch.where(
        grp_fc, fc_base + 16 * bit, torch.where(
            grp_oc, oc_base + 24 * bit, PC)))
    jb_off = torch.where(alive, ja_off + 8, PC)
    jc_off = torch.where(grp_oc, oc_base + 24 * bit + 16, PC)
    s_a = take_sel(torch.where(grp_ic, _IC_SA, torch.where(
        grp_fc, fc_base + 32, torch.where(grp_oc, oc_base + 48, PC))))
    s_b = take_sel(torch.where(grp_ic, _IC_SB, torch.where(
        grp_fc, fc_base + 33, torch.where(grp_oc, oc_base + 49, PC))))
    ja = [take_sel(ja_off + k) for k in range(8)]
    jb = [take_sel(jb_off + k) for k in range(8)]
    jc = [take_sel(jc_off + k) for k in range(8)]
    pol_a = _jones(ja, ter, tei, tmr, tmi)
    pol_b = _jones(jb, ter, tei, tmr, tmi)
    pol_c = _jones(jc, ter, tei, tmr, tmi)
    inv_cos = 1.0 / cos_th
    eff_a = _power(pol_a) * s_a * inv_cos
    eff_b = _power(pol_b) * s_b * inv_cos
    eff_c = _power(pol_c) * c(_OC_SOUT) * inv_cos

    # the stream advances only on an interaction
    rng_new = xorshift32_step(rng)
    u = draw24(rng_new)
    rng = torch.where(interact, rng_new, rng)
    br_a = interact & (u <= eff_a) & (eff_a > 0)
    br_b = interact & ~br_a & (u <= eff_a + eff_b) & (eff_b > 0)
    br_c = (hit_oc & ~br_a & ~br_b & (u <= eff_a + eff_b + eff_c)
            & (eff_c > 0))
    die = interact & ~(br_a | br_b | br_c)
    accept = br_a | br_b

    dirs = torch.where(br_a, torch.where(grp_oc, 1, 0),
                       torch.where(grp_oc, 3, torch.where(grp_fc, 1, 2)))
    ter_n = torch.where(br_a, pol_a[0], pol_b[0])
    tei_n = torch.where(br_a, pol_a[1], pol_b[1])
    tmr_n = torch.where(br_a, pol_a[2], pol_b[2])
    tmi_n = torch.where(br_a, pol_a[3], pol_b[3])
    inv = _rsqrt(_power((ter_n, tei_n, tmr_n, tmi_n)))
    phr = take(_TIR_PH + 2 * dirs)
    phi = take(_TIR_PH + 1 + 2 * dirs)
    ter_n, tei_n = ter_n * inv, tei_n * inv
    tr, ti = tmr_n * inv, tmi_n * inv
    tmr_n, tmi_n = phr * tr - phi * ti, phr * ti + phi * tr
    cos_n = torch.where(br_a, s_a, s_b)
    gx_n = take(_GAPS + 2 * dirs)
    gy_n = take(_GAPS + 1 + 2 * dirs)
    x_acc = x + gx_n
    y_acc = y + gy_n
    icin = rows.in_ic(x_acc, y_acc)
    st_a = torch.where(grp_oc, 4, torch.where(grp_fc, 2, torch.where(icin, 0, 2)))
    st_b = torch.where(grp_oc, 5, torch.where(grp_fc, 3, torch.where(icin, 1, 6)))
    st_acc = torch.where(br_a, st_a, st_b)

    # ---- deposit: branch C inside the cell's eyebox rectangle
    in_quad = ((x >= c(_EBT)) & (x <= c(_EBT + 1))
               & (y >= c(_EBT + 2)) & (y <= c(_EBT + 3)))
    dep = br_c & in_quad
    ix = _bin((x - c(_EBR)) * c(_EBS), nx - 1)
    iy = _bin((y - c(_EBR + 2)) * c(_EBS + 1), ny - 1)
    code = iy * nx + ix

    # ---- misses: TIR hops by the carried gap, FC fold-out to the OC, OC exits
    miss_fc2 = grp_fc & ~in_hull & (state == 2)
    miss_fc3 = grp_fc & ~in_hull & (state == 3)
    if jump is not None:
        in_r2, ex_r2 = rows.region_bound(_G_R2, n_r2, x, y, jump.rex_r2, True)
    else:
        in_r2 = rows.region(_G_R2, n_r2, x, y)
    fc3_to_oc = miss_fc3 & ~in_r2
    hop = (miss_fc2 | (miss_fc3 & in_r2)
           | (grp_oc & ~in_rect & (state == 4)))
    miss_oc5 = grp_oc & ~in_rect & (state == 5)
    h_phr = torch.where(miss_fc2, c(_HOP2_PH + 0), c(_HOP2_PH + 2))
    h_phi = torch.where(miss_fc2, c(_HOP2_PH + 1), c(_HOP2_PH + 3))
    if jump is not None:
        # OC rectangle entry along direction 1 (slab test), then the first
        # hop index at which something happens: exits at floor(u) + 1,
        # entries at ceil(u); one hop at least, no more than the phase carries
        t0x = (g(_G_OC_BT + 0) - x) * jump.rgap[0]
        t1x = (g(_G_OC_BT + 1) - x) * jump.rgap[0]
        t0y = (g(_G_OC_BT + 2) - y) * jump.rgap[1]
        t1y = (g(_G_OC_BT + 3) - y) * jump.rgap[1]
        en_rect = torch.maximum(torch.minimum(t0x, t1x),
                                torch.minimum(t0y, t1y))
        k_exit = torch.floor(ex_r1) + 1.0
        k_ent = torch.ceil(torch.where(grp_oc, en_rect, en_hull))
        kf = torch.minimum(k_exit, k_ent)
        kf = torch.where(miss_fc3,
                         torch.minimum(kf, torch.floor(ex_r2) + 1.0), kf)
        kf = torch.clamp(kf, 1.0, jump.kmax)
        ki = kf.to(torch.int64)
        began = began + torch.where(hop, ki - 1, 0)   # skipped hops count
        if jump.phase == "pow2":
            # phasor^ki by squaring, four bits
            zr, zi = h_phr, h_phi
            bit0 = (ki & 1) != 0
            h_phr = torch.where(bit0, zr, 1.0)
            h_phi = torch.where(bit0, zi, 0.0)
            for b in (2, 4, 8):
                zr, zi = zr * zr - zi * zi, 2.0 * zr * zi
                nrr = h_phr * zr - h_phi * zi
                nri = h_phr * zi + h_phi * zr
                bitb = (ki & b) != 0
                h_phr = torch.where(bitb, nrr, h_phr)
                h_phi = torch.where(bitb, nri, h_phi)
        else:
            th = kf * torch.where(miss_fc2, c(_HOP2_ANG + 0), c(_HOP2_ANG + 1))
            h_phr, h_phi = torch.cos(th), torch.sin(th)
        x_hop, y_hop = x + kf * gx, y + kf * gy
    else:
        x_hop, y_hop = x + gx, y + gy
    hop_tmr = h_phr * tmr - h_phi * tmi
    hop_tmi = h_phr * tmi + h_phi * tmr

    state = torch.where(accept, st_acc, torch.where(
        br_c | die | miss_oc5, 6, torch.where(fc3_to_oc, 4, state)))
    fields = (torch.where(accept, x_acc, torch.where(hop, x_hop, x)),
              torch.where(accept, y_acc, torch.where(hop, y_hop, y)),
              torch.where(accept, ter_n, ter),
              torch.where(accept, tei_n, tei),
              torch.where(accept, tmr_n, torch.where(hop, hop_tmr, tmr)),
              torch.where(accept, tmi_n, torch.where(hop, hop_tmi, tmi)),
              torch.where(accept, cos_n, cos_th),
              torch.where(accept, gx_n, gx),
              torch.where(accept, gy_n, gy))
    return fields, state, rng, began, dep, code


def persistent_trace_reference(cell_params, geom_row, rays_in, rng_in, ctrl, *,
                               num_fc, num_oc, edge_counts, eyebox_bins,
                               max_iters, spawn_mode="count", accum_mode="fma",
                               cells_per_block=1, transit_jump=False,
                               jump_phase="pow2", cell_params_packed=None):
    """The kernel's function in plain tensor code: the same state machine
    vectorised over a (C, slots per cell) tensor, with the same lockstep
    spawn schedule per cell.  Same signature and outputs as
    :func:`persistent_trace`."""
    C, S, cpd, rays_div, rng_mod = _check_inputs(
        cell_params, geom_row, rays_in, rng_in, ctrl, num_fc, num_oc,
        edge_counts, eyebox_bins, max_iters, spawn_mode, accum_mode,
        cells_per_block, transit_jump, jump_phase, cell_params_packed)
    dev = cell_params.device
    ny, nx = eyebox_bins
    quota, spawn_iters = (int(v) for v in ctrl.tolist())
    gens_mode = spawn_mode == "gens"
    f32, i64 = torch.float32, torch.int64
    k = cells_per_block
    Hs = S // k   # slots per cell: the block's rows split evenly over its cells

    cells = torch.arange(C, device=dev)
    blocks = torch.arange(C // k, device=dev)
    # each cell's design's geometry row, (C, PG)
    rows = _Rows(cell_params, geom_row.index_select(0, cells // cpd),
                 cell_params_packed, num_fc, num_oc)
    c, in_ic = rows.c, rows.in_ic
    jump = _Jump(rows, edge_counts, jump_phase) if transit_jump else None

    # cell h of block b respawns from rows h * Hs .. of the block's tile and
    # starts from rows h * Hs .. of its seed block
    rays = (rays_in.reshape(rays_in.shape[0], 6, k, Hs)
            .index_select(0, blocks // rays_div).permute(0, 2, 1, 3)
            .reshape(C, 6, Hs))
    x0, y0, ter0, tei0, tmr0, tmi0 = (rays[:, j] for j in range(6))
    S = Hs
    # per-slot init constants: every (re)spawn starts from the same fields
    pa0 = _jones([c(_INIT_JA + k) for k in range(8)], ter0, tei0, tmr0, tmi0)
    pb0 = _jones([c(_INIT_JB + k) for k in range(8)], ter0, tei0, tmr0, tmi0)
    inv_cos0 = 1.0 / c(_INIT_COS0)
    eff_a0 = _power(pa0) * c(_INIT_SA) * inv_cos0
    eff_ab0 = eff_a0 + _power(pb0) * c(_INIT_SB) * inv_cos0
    inv_a0 = _rsqrt(_power(pa0))
    inv_b0 = _rsqrt(_power(pb0))
    ta_r, ta_i = pa0[2] * inv_a0, pa0[3] * inv_a0
    tb_r, tb_i = pb0[2] * inv_b0, pb0[3] * inv_b0
    fld_a0 = (pa0[0] * inv_a0, pa0[1] * inv_a0,
              c(_TIR_PH + 0) * ta_r - c(_TIR_PH + 1) * ta_i,
              c(_TIR_PH + 0) * ta_i + c(_TIR_PH + 1) * ta_r)
    fld_b0 = (pb0[0] * inv_b0, pb0[1] * inv_b0,
              c(_TIR_PH + 4) * tb_r - c(_TIR_PH + 5) * tb_i,
              c(_TIR_PH + 4) * tb_i + c(_TIR_PH + 5) * tb_r)
    x1a0, y1a0 = x0 + c(_GAPS + 0), y0 + c(_GAPS + 1)
    x1b0, y1b0 = x0 + c(_GAPS + 4), y0 + c(_GAPS + 5)
    st1_a0 = torch.where(in_ic(x1a0, y1a0), 0, 2)
    icin_b0 = in_ic(x1b0, y1b0)

    x, y = x0.clone(), y0.clone()
    ter, tei, tmr, tmi = ter0.clone(), tei0.clone(), tmr0.clone(), tmi0.clone()
    cos_th = torch.ones((C, S), dtype=f32, device=dev)
    gx = torch.zeros((C, S), dtype=f32, device=dev)
    gy = torch.zeros_like(gx)
    state = torch.full((C, S), 7, dtype=i64, device=dev)
    rng = (rng_in.reshape(rng_mod, k, S).index_select(0, blocks % rng_mod)
           .reshape(C, S).to(i64) & _MASK32)
    gen = torch.ones((C, S), dtype=i64, device=dev)   # first spawn: gen 1
    bounces = torch.zeros((C,), dtype=i64, device=dev)
    spawned = torch.full((C,), S, dtype=i64, device=dev)
    iters = torch.full((C,), max_iters, dtype=i64, device=dev)
    done = torch.zeros((C,), dtype=torch.bool, device=dev)
    hist = torch.zeros((C * ny * nx,), dtype=i64, device=dev)
    cell_base = (torch.arange(C, device=dev, dtype=i64) * (ny * nx))[:, None]

    for it in range(max_iters):
        met = gen >= quota if gens_mode else spawned[:, None] >= quota
        exhausted = (state == 6) & met & (it >= spawn_iters)
        now_done = exhausted.all(dim=1) & ~done
        iters = torch.where(now_done, it, iters)
        done = done | now_done
        if bool(done.all()):
            break
        # a finished cell's body is a no-op (nothing respawns, nothing lives)

        # ---- respawn, decided on the quota as it stood at the iteration's
        # start (the cell's spawn count, or each slot's generations)
        rs = (state == 6) & (~met | (it < spawn_iters))
        if gens_mode:
            gen = gen + rs
        else:
            spawned = spawned + rs.sum(dim=1)
        state = torch.where(rs, 7, state)

        # ---- init (first IC interaction) of awaiting slots
        m7 = state == 7
        rng_new = xorshift32_step(rng)
        u = draw24(rng_new)
        rng = torch.where(m7, rng_new, rng)
        a = m7 & (u <= eff_a0)
        b = m7 & ~a & (u <= eff_ab0)
        st1 = torch.where(a, st1_a0, torch.where(b & icin_b0, 1, 6))
        live = (st1 < 6) & m7
        x = torch.where(live, torch.where(a, x1a0, x1b0), x)
        y = torch.where(live, torch.where(a, y1a0, y1b0), y)
        ter = torch.where(live, torch.where(a, fld_a0[0], fld_b0[0]), ter)
        tei = torch.where(live, torch.where(a, fld_a0[1], fld_b0[1]), tei)
        tmr = torch.where(live, torch.where(a, fld_a0[2], fld_b0[2]), tmr)
        tmi = torch.where(live, torch.where(a, fld_a0[3], fld_b0[3]), tmi)
        cos_th = torch.where(m7, torch.where(a, c(_IC_SA), c(_IC_SB)), cos_th)
        gx = torch.where(live, torch.where(a, c(_GAPS + 0), c(_GAPS + 4)), gx)
        gy = torch.where(live, torch.where(a, c(_GAPS + 1), c(_GAPS + 5)), gy)
        state = torch.where(m7, st1, state)

        # ---- one bounce for live slots; deposits go into the cell's tile
        fields, state, rng, alive, dep, code = _bounce_step(
            rows, (x, y, ter, tei, tmr, tmi, cos_th, gx, gy), state, rng,
            num_fc=num_fc, num_oc=num_oc, edge_counts=edge_counts,
            eyebox_bins=eyebox_bins, jump=jump)
        x, y, ter, tei, tmr, tmi, cos_th, gx, gy = fields
        bounces = bounces + alive.sum(dim=1)
        flat = (cell_base + code)[dep]
        hist.index_add_(0, flat, torch.ones_like(flat))

    if gens_mode:
        spawned = gen.sum(dim=1)
    # a block runs until its last cell is done
    iters = iters.reshape(-1, k).max(dim=1).values.repeat_interleave(k)
    nb = torch.stack([bounces, iters, spawned, torch.zeros_like(bounces)],
                     dim=1).to(torch.int32)
    return hist.to(torch.float32).reshape(C, ny, nx), nb


# ---------------------------------------------------------------------------


class PersistentTracer(nn.Module):
    """The persistent trace bound to one design: cell rows, the geometry row
    and, in packed selection, the packed words, held as buffers on the
    module's device.  ``cell_params`` is an array or a tensor (rows built on
    the card stay there)."""

    def __init__(self, cell_params, geom_row: np.ndarray, *,
                 num_fc: int, num_oc: int, edge_counts: Sequence[int],
                 eyebox_bins: Sequence[int], max_iters: int,
                 accum_mode: str = "fma", transit_jump: bool = False,
                 jump_phase: str = "pow2"):
        super().__init__()
        cp, gr = rows_to_device(cell_params, geom_row, "cpu")
        self.register_buffer("cell_params", cp)
        self.register_buffer("geom_row", gr)
        # the packed words are built once, here, where the rows are
        self.register_buffer("cell_params_packed", pack_selection_params(
            cp, num_fc, num_oc) if accum_mode == "packed" else None)
        self.num_fc, self.num_oc = int(num_fc), int(num_oc)
        self.edge_counts = tuple(int(e) for e in edge_counts)
        self.eyebox_bins = tuple(int(b) for b in eyebox_bins)
        self.max_iters = int(max_iters)
        self.accum_mode = accum_mode
        self.transit_jump = bool(transit_jump)
        self.jump_phase = jump_phase

    def forward(self, cell_ids, rays_in: torch.Tensor, rng_in: torch.Tensor,
                ctrl: torch.Tensor, cells_per_block: int = 1,
                spawn_mode: str = "count"):
        """Trace the cells ``cell_ids`` (a contiguous run reads its rows and
        packed words as views; any other set gathers them),
        ``cells_per_block`` of them to a block."""
        packed = self.cell_params_packed
        return persistent_trace(
            select_cells(self.cell_params, cell_ids), self.geom_row, rays_in,
            rng_in, ctrl, num_fc=self.num_fc, num_oc=self.num_oc,
            edge_counts=self.edge_counts, eyebox_bins=self.eyebox_bins,
            max_iters=self.max_iters, spawn_mode=spawn_mode,
            accum_mode=self.accum_mode, cells_per_block=cells_per_block,
            transit_jump=self.transit_jump, jump_phase=self.jump_phase,
            cell_params_packed=(None if packed is None
                                else select_cells(packed, cell_ids)))


def select_cells(rows: torch.Tensor, cell_ids) -> torch.Tensor:
    """The rows of ``cell_ids``: a view for a contiguous run, else a
    gather."""
    cid = np.asarray(cell_ids, np.int64)
    if len(cid) and np.array_equal(cid, np.arange(cid[0], cid[0] + len(cid))):
        return rows[int(cid[0]):int(cid[0]) + len(cid)]
    return rows.index_select(0, torch.from_numpy(cid).to(rows.device))


def hist_tiles_to_histogram(hist_tiles: torch.Tensor, cell_ids: np.ndarray,
                            L: int, M: int, N: int, ny: int,
                            nx: int) -> torch.Tensor:
    """(C, ny, >= nx) tiles of cells ``cell_ids`` -> (L, N, M, ny, nx)
    eyebox histogram on the tiles' device; cells not in ``cell_ids`` stay 0.
    Tiles wider than ``nx`` (the JAX kernel's 128-lane padding) are cut."""
    tiles = hist_tiles[:, :, :nx]
    cid = torch.as_tensor(np.asarray(cell_ids), dtype=torch.int64,
                          device=tiles.device)
    flat = tiles.new_zeros((L * M * N, ny, nx))
    flat.index_copy_(0, cid, tiles)
    return flat.reshape(L, M, N, ny, nx).permute(0, 2, 1, 3, 4).contiguous()
