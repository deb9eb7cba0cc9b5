"""Per-cell Monte-Carlo trace: the CUDA kernel, its wrapper and its plain
PyTorch version.

Replaces the device half of ``engine/trace_pallas.py`` of the JAX package
(``make_pallas_trace_fn``); its numpy packers live in :mod:`.trace_rows`.

Every ray of a cell is traced once.  *Full mode* starts from the launch
fields (x, y, ter, tei, tmr, tmi) with the first in-coupler interaction;
*resume mode* continues a saved 9-field state (adding cos_th, gap_x, gap_y)
with its state code and RNG stream.  A ray walks the state machine IC 0/1,
FC 2/3, OC 4/5 until it dies (6) or has run ``max_bounces`` iterations of
this call.  It reports at most one deposit code ``iy * nx + ix`` (-1: none);
the 9 fields, state and stream of every ray come back, so a scheduler
(:mod:`.cell_segments`) can compact the survivors and resume them.  The bounce
budget and the tile size are runtime arguments: one library serves every
segment.

The kernel (``csrc/cell_trace.cu``) runs lanes that refill from a per-cell
queue: each block owns a contiguous range of one cell's rays, and a lane
whose ray ends writes that ray's outputs and claims the next untraced ray of
the range, so a warp no longer waits for its slowest ray.  The launch shape
(threads per block, blocks per cell) follows :func:`launch_shape`.  What
bounds it on an H100: per-lane divergent ALU work; it reads every input once
and writes every output once.

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
from .trace_persistent import (
    MAX_FC, MAX_OC, _MASK32, _Rows, _bounce_step, _jones, _power, _rsqrt,
    launch_counts, select_cells,
)
from .trace_rows import (
    LANES, MAX_EDGES, PC, PG, rows_to_device,
    _GAPS, _IC_SA, _IC_SB, _INIT_COS0, _INIT_JA, _INIT_JB, _INIT_SA, _INIT_SB,
    _TIR_PH,
)
from ..ops.rng import draw24, xorshift32_step

# the C parameters of cell_trace_launch, in order: 10 pointers, 12 ints and
# the stream
LAUNCH_ARGTYPES = [ctypes.c_void_p] * 10 + [ctypes.c_int] * 12 + [ctypes.c_void_p]
BLOCK_THREADS = 128     # the rule's widest block (the kernel's launch bounds)
MAX_RAYS_PER_LANE = 10  # a block holds at most this many rays per lane ...
WAVE_BLOCKS = 16        # ... and a launch at least this many blocks per SM,
MIN_RAYS_PER_LANE = 2   # unless a block would then hold fewer per lane


def launch_shape(C: int, S: int, sms: int) -> Tuple[int, int]:
    """Threads per block and blocks per cell of a launch of ``C`` cells of
    ``S`` rays on a card of ``sms`` SMs (measured on an H100 with
    ``tools/k2_variants.py``; see ``PERF.md``).

    - Threads: 128, the kernel's launch bounds (48 registers: an SM holds
      10 such blocks; 256-thread blocks ran slower), halved (not below 32)
      while a one-block cell would leave a lane fewer than 2 rays: the
      segmented scheduler's 1-row resume tiles (128 rays) run 64 threads.
    - Blocks per cell, each owning a contiguous range of its cell's rays:
      enough that no block holds more than ``MAX_RAYS_PER_LANE`` rays per
      lane, so blocks are small and the last ones on the card end close
      together (a batch of 2,048 cells of 5,120 rays: 4 blocks of 1,280),
      and enough for ``WAVE_BLOCKS`` blocks per SM over the grid when the
      cells are few (144 cells of 5,120: 15 blocks of 341-342); but never
      fewer than ``MIN_RAYS_PER_LANE`` rays per lane.
    """
    if C < 1 or S < 1:
        raise ValueError(f"launch_shape needs C >= 1 and S >= 1, got {C}, {S}")
    threads = BLOCK_THREADS
    while threads > 32 and 2 * threads > S:
        threads //= 2
    want = max(-(-sms * WAVE_BLOCKS // C),
               -(-S // (threads * MAX_RAYS_PER_LANE)))
    most = max(1, S // (threads * MIN_RAYS_PER_LANE))
    return threads, max(1, min(want, most))


def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def _check_inputs(cell_params, geom_row, rays_in, rng_in, state_in, num_fc,
                  num_oc, edge_counts, eyebox_bins,
                  max_bounces) -> Tuple[int, int]:
    """Validate the launch; returns ``(C, S)``."""
    dev = cell_params.device
    named = [("cell_params", cell_params, torch.float32),
             ("geom_row", geom_row, torch.float32),
             ("rays_in", rays_in, torch.float32),
             ("rng_in", rng_in, torch.int32)]
    if state_in is not None:
        named.append(("state_in", state_in, torch.int32))
    for name, t, dt in named:
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
    if tuple(geom_row.shape) != (1, PG):
        raise ValueError(f"geom_row must be (1, {PG}), got {tuple(geom_row.shape)}")
    if rng_in.dim() != 3 or rng_in.shape[0] != C or rng_in.shape[2] != LANES:
        raise ValueError(f"rng_in must be (C={C}, RT, {LANES}), "
                         f"got {tuple(rng_in.shape)}")
    RT = rng_in.shape[1]
    nf = 6 if state_in is None else 9
    if tuple(rays_in.shape) != (C, nf, RT, LANES):
        raise ValueError(f"rays_in must be ({C}, {nf}, {RT}, {LANES}) in "
                         f"{'full' if state_in is None else 'resume'} mode, "
                         f"got {tuple(rays_in.shape)}")
    if state_in is not None and state_in.shape != rng_in.shape:
        raise ValueError(f"state_in must be {tuple(rng_in.shape)}, "
                         f"got {tuple(state_in.shape)}")
    if not (1 <= num_fc <= MAX_FC and 1 <= num_oc <= MAX_OC):
        raise ValueError(f"num_fc/num_oc ({num_fc}, {num_oc}) exceed the cell "
                         f"row's {MAX_FC}/{MAX_OC} strips")
    if len(edge_counts) != 3 or not all(0 <= e <= MAX_EDGES for e in edge_counts):
        raise ValueError(f"edge_counts must be 3 counts <= {MAX_EDGES}")
    if len(eyebox_bins) != 2 or min(eyebox_bins) < 1:
        raise ValueError(f"bad eyebox_bins {eyebox_bins}")
    if max_bounces < 1:
        raise ValueError("max_bounces must be positive")
    return C, RT * LANES


def cell_trace(cell_params: torch.Tensor, geom_row: torch.Tensor,
               rays_in: torch.Tensor, rng_in: torch.Tensor,
               state_in: Optional[torch.Tensor] = None, *, num_fc: int,
               num_oc: int, edge_counts: Sequence[int],
               eyebox_bins: Sequence[int], max_bounces: int):
    """Trace every ray of every cell once; returns ``(dep, nb, rays_out,
    state_out, rng_out)``.

    - ``cell_params`` (C, 704) f32, ``geom_row`` (1, 320) f32: the rows of
      :mod:`.trace_rows`.
    - ``rays_in`` (C, 6, RT, 128) f32 launch fields in full mode
      (``state_in is None``); (C, 9, RT, 128) in resume mode, with
      ``state_in`` (C, RT, 128) int32.
    - ``rng_in`` (C, RT, 128) int32: per-ray xorshift32 state (uint32 bits).
    - ``dep`` (C, RT, 128) int32: this call's deposit code per ray, or -1.
    - ``nb`` (C, 2) int32: ``[bounces, iterations]``: the iterations that the
      cell's rays began alive, summed, and the largest such count of one ray.
    - ``rays_out`` (C, 9, RT, 128) f32, ``state_out`` and ``rng_out``
      (C, RT, 128) int32: what resume mode takes.

    A CPU tensor runs :func:`cell_trace_reference`; a CUDA tensor launches
    the kernel or raises.
    """
    C, S = _check_inputs(cell_params, geom_row, rays_in, rng_in, state_in,
                         num_fc, num_oc, edge_counts, eyebox_bins, max_bounces)
    dev = cell_params.device
    if dev.type == "cpu":
        return cell_trace_reference(
            cell_params, geom_row, rays_in, rng_in, state_in, num_fc=num_fc,
            num_oc=num_oc, edge_counts=edge_counts, eyebox_bins=eyebox_bins,
            max_bounces=max_bounces)
    if dev.type != "cuda":
        raise ValueError(f"cell_trace runs on cpu or cuda, not {dev}")
    if not torch.cuda.is_available():
        raise RuntimeError("cell_trace got a CUDA tensor but no CUDA device "
                           "is available")
    lib = load_kernel()
    shape = tuple(rng_in.shape)
    dep = torch.empty(shape, dtype=torch.int32, device=dev)
    nb = torch.zeros((C, 2), dtype=torch.int32, device=dev)
    rays_out = torch.empty((C, 9) + shape[1:], dtype=torch.float32, device=dev)
    state_out = torch.empty(shape, dtype=torch.int32, device=dev)
    rng_out = torch.empty(shape, dtype=torch.int32, device=dev)
    if C == 0:
        return dep, nb, rays_out, state_out, rng_out
    ny, nx = eyebox_bins
    threads, blocks_per_cell = launch_shape(C, S, _sm_count(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.cell_trace_launch(
            cell_params.data_ptr(), geom_row.data_ptr(), rays_in.data_ptr(),
            None if state_in is None else state_in.data_ptr(),
            rng_in.data_ptr(), dep.data_ptr(), nb.data_ptr(),
            rays_out.data_ptr(), state_out.data_ptr(), rng_out.data_ptr(),
            C, S, num_fc, num_oc, *(int(e) for e in edge_counts), ny, nx,
            int(min(max_bounces, 2**31 - 1)), threads, blocks_per_cell,
            stream)
    if err != 0:
        msg = lib.cell_trace_error_string(err).decode()
        raise RuntimeError(f"cell_trace launch failed: {msg} ({err})")
    launch_counts["cell_trace"] += 1
    return dep, nb, rays_out, state_out, rng_out


_LIB = None


def load_kernel():
    """Build (at first use) and bind ``csrc/cell_trace.cu``; raises with the
    compiler's output if the build fails."""
    global _LIB
    if _LIB is None:
        lib = build.load_library("cell_trace")
        lib.cell_trace_launch.argtypes = LAUNCH_ARGTYPES
        lib.cell_trace_launch.restype = ctypes.c_int
        lib.cell_trace_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
        lib.cell_trace_occupancy.restype = ctypes.c_int
        lib.cell_trace_error_string.argtypes = [ctypes.c_int]
        lib.cell_trace_error_string.restype = ctypes.c_char_p
        _LIB = lib
    return _LIB


def kernel_occupancy(threads: int = BLOCK_THREADS) -> dict:
    """What the card makes of the kernel at ``threads`` threads per block:
    resident blocks per SM (``cudaOccupancyMaxActiveBlocksPerMultiprocessor``),
    registers and local memory per thread and static shared bytes.  Needs
    the card."""
    lib = load_kernel()
    out = (ctypes.c_int * 4)()
    err = lib.cell_trace_occupancy(int(threads), ctypes.addressof(out))
    if err != 0:
        msg = lib.cell_trace_error_string(err).decode()
        raise RuntimeError(f"cell_trace_occupancy failed: {msg} ({err})")
    keys = ("blocks_per_sm", "registers", "local_bytes", "static_smem")
    return dict(zip(keys, list(out)), threads=int(threads))


# ---------------------------------------------------------------------------
# plain PyTorch version


def cell_trace_reference(cell_params, geom_row, rays_in, rng_in, state_in=None,
                         *, num_fc, num_oc, edge_counts, eyebox_bins,
                         max_bounces, ray_iterations=False):
    """The kernel's function in plain tensor code, vectorised over a (C, S)
    block of rays.  Same signature and outputs as :func:`cell_trace`;
    ``ray_iterations=True`` appends each ray's iteration count, (C, RT, 128)
    int32 (the iterations it began alive), for measuring lane occupancy."""
    C, S = _check_inputs(cell_params, geom_row, rays_in, rng_in, state_in,
                         num_fc, num_oc, edge_counts, eyebox_bins, max_bounces)
    dev = cell_params.device
    i64 = torch.int64
    rows = _Rows(cell_params, geom_row.expand(C, -1))
    c = rows.c
    flat = rays_in.reshape(C, -1, S)
    x, y, ter, tei, tmr, tmi = (flat[:, k] for k in range(6))
    rng = rng_in.reshape(C, S).to(i64) & _MASK32

    if state_in is not None:
        cos_th, gx, gy = flat[:, 6], flat[:, 7], flat[:, 8]
        state = state_in.reshape(C, S).to(i64)
    else:
        # ---- init: first IC interaction from air.  A ray that dies here
        # keeps its launch position and fields and zero gaps.
        pa = _jones([c(_INIT_JA + k) for k in range(8)], ter, tei, tmr, tmi)
        pb = _jones([c(_INIT_JB + k) for k in range(8)], ter, tei, tmr, tmi)
        inv_cos0 = 1.0 / c(_INIT_COS0)
        eff_a = _power(pa) * c(_INIT_SA) * inv_cos0
        eff_ab = eff_a + _power(pb) * c(_INIT_SB) * inv_cos0
        rng = xorshift32_step(rng)
        u = draw24(rng)
        a = u <= eff_a
        b = ~a & (u <= eff_ab)
        pn = [torch.where(a, pa[k], pb[k]) for k in range(4)]
        inv = _rsqrt(_power(pn))
        # direction 0 (accept A) or 2 (accept B)
        phr = torch.where(a, c(_TIR_PH + 0), c(_TIR_PH + 4))
        phi = torch.where(a, c(_TIR_PH + 1), c(_TIR_PH + 5))
        tr, ti = pn[2] * inv, pn[3] * inv
        gx1 = torch.where(a, c(_GAPS + 0), c(_GAPS + 4))
        gy1 = torch.where(a, c(_GAPS + 1), c(_GAPS + 5))
        x1, y1 = x + gx1, y + gy1
        icin = rows.in_ic(x1, y1)
        state = torch.where(a, torch.where(icin, 0, 2),
                            torch.where(b & icin, 1, 6))
        live = state < 6
        cos_th = torch.where(a, c(_IC_SA), c(_IC_SB))
        x, y = torch.where(live, x1, x), torch.where(live, y1, y)
        ter = torch.where(live, pn[0] * inv, ter)
        tei = torch.where(live, pn[1] * inv, tei)
        tmr = torch.where(live, phr * tr - phi * ti, tmr)
        tmi = torch.where(live, phr * ti + phi * tr, tmi)
        gx = torch.where(live, gx1, 0.0)
        gy = torch.where(live, gy1, 0.0)

    fields = (x, y, ter, tei, tmr, tmi, cos_th, gx, gy)
    dep = torch.full((C, S), -1, dtype=i64, device=dev)
    bounces = torch.zeros((C,), dtype=i64, device=dev)
    iters = torch.zeros((C,), dtype=i64, device=dev)
    ray_its = (torch.zeros((C, S), dtype=torch.int32, device=dev)
               if ray_iterations else None)
    for _ in range(max_bounces):
        if not bool((state < 6).any()):
            break
        fields, state, rng, alive, hit, code = _bounce_step(
            rows, fields, state, rng, num_fc=num_fc, num_oc=num_oc,
            edge_counts=edge_counts, eyebox_bins=eyebox_bins)
        bounces = bounces + alive.sum(dim=1)
        iters = iters + alive.any(dim=1)
        if ray_iterations:
            ray_its += alive
        dep = torch.where(hit, code, dep)

    shape = tuple(rng_in.shape)
    rays_out = torch.stack(fields, dim=1).reshape((C, 9) + shape[1:])
    bits = torch.where(rng >= 2**31, rng - 2**32, rng)   # uint32 bits as int32
    out = (dep.to(torch.int32).reshape(shape),
           torch.stack([bounces, iters], dim=1).to(torch.int32), rays_out,
           state.to(torch.int32).reshape(shape),
           bits.to(torch.int32).reshape(shape))
    return out + (ray_its.reshape(shape),) if ray_iterations else out


def lane_occupancy(ray_its: torch.Tensor, warp: int = 32) -> float:
    """The share of lane-iterations that stepped a live ray when every ray
    has its own lane and a warp of ``warp`` consecutive rays runs until its
    longest ray ends (the kernel's earlier design): Σ iterations /
    Σ over warps of (``warp`` × the warp's longest ray)."""
    its = ray_its.reshape(-1, warp).to(torch.int64)
    lanes = warp * its.max(dim=1).values.sum()
    return float(its.sum()) / float(lanes) if int(lanes) else 1.0


# ---------------------------------------------------------------------------
# deposits -> histogram


def cell_hist_base(cell_ids, M: int, N: int, ny: int, nx: int) -> np.ndarray:
    """Flat offset of each cell's (ny, nx) tile in the (L, N, M, ny, nx)
    histogram; cell id = ``(l * M + m) * N + n``."""
    cid = np.asarray(cell_ids, np.int64)
    l, mn = cid // (M * N), cid % (M * N)
    return ((l * N + mn % N) * M + mn // N) * (ny * nx)


def scatter_deposits(hist_flat: torch.Tensor, dep: torch.Tensor,
                     base: torch.Tensor) -> int:
    """Add one to ``hist_flat[base[c] + dep[c, k]]`` for every deposit code
    ``dep[c, k] >= 0``, in place; returns the number of deposits.  Whole
    counts in float32 sum exactly in any order (below 2^24 per bin)."""
    d = dep.reshape(dep.shape[0], -1).to(torch.int64)
    flat = (base[:, None] + d)[d >= 0]
    hist_flat.index_add_(0, flat, torch.ones_like(flat, dtype=hist_flat.dtype))
    return flat.numel()


def deposits_to_histogram_cells(dep: torch.Tensor, cell_ids, L: int, M: int,
                                N: int, ny: int, nx: int) -> torch.Tensor:
    """(C, RT, 128) terminal deposits of cells ``cell_ids`` -> the
    (L, N, M, ny, nx) float32 histogram on ``dep``'s device."""
    hist = torch.zeros((L, N, M, ny, nx), dtype=torch.float32,
                       device=dep.device)
    base = torch.from_numpy(cell_hist_base(cell_ids, M, N, ny, nx)).to(dep.device)
    scatter_deposits(hist.view(-1), dep, base)
    return hist


# ---------------------------------------------------------------------------


class CellTracer(nn.Module):
    """The per-cell trace bound to one design: cell rows and the geometry
    row held as buffers on the module's device.  ``cell_params`` is an array
    or a tensor (rows built on the card stay there)."""

    def __init__(self, cell_params, geom_row: np.ndarray, *,
                 num_fc: int, num_oc: int, edge_counts: Sequence[int],
                 eyebox_bins: Sequence[int], max_bounces: int):
        super().__init__()
        cp, gr = rows_to_device(cell_params, geom_row, "cpu")
        self.register_buffer("cell_params", cp)
        self.register_buffer("geom_row", gr)
        self.kw = dict(num_fc=int(num_fc), num_oc=int(num_oc),
                       edge_counts=tuple(int(e) for e in edge_counts),
                       eyebox_bins=tuple(int(b) for b in eyebox_bins))
        self.max_bounces = int(max_bounces)

    def rows(self, cell_ids) -> torch.Tensor:
        """The cell rows of ``cell_ids`` (a view for a contiguous run)."""
        return select_cells(self.cell_params, cell_ids)

    def forward(self, cell_ids, rays_in: torch.Tensor, rng_in: torch.Tensor,
                state_in: Optional[torch.Tensor] = None,
                max_bounces: Optional[int] = None):
        """Trace the cells ``cell_ids``: full mode, or resume mode with
        ``state_in``; ``max_bounces`` defaults to the tracer's budget."""
        return cell_trace(
            self.rows(cell_ids), self.geom_row, rays_in, rng_in, state_in,
            max_bounces=self.max_bounces if max_bounces is None else max_bounces,
            **self.kw)
