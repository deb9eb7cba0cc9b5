"""Segmented scheduling of the per-cell trace: bounce budgets with per-cell
compaction between them.

Replaces ``engine/pallas_segments.py`` of the JAX package.  The mean ray dies
after a few bounces while a cell's slowest ray runs for a hundred or more, so
a trace to the end spends most of its late iterations on lanes whose ray is
dead.  The scheduler

1. runs :func:`.trace_cell.cell_trace` in full mode with a bounce budget;
2. moves each cell's survivors to the front of its tile (a stable per-cell
   partition) and shrinks the tile to the batch's largest survivor count,
   rounded up to a power-of-two number of 128-ray rows;
3. runs the kernel again in resume mode on the smaller tile, until every ray
   is dead or the total budget is spent.

Per-ray RNG streams carry across segments, and the last segment gets exactly
the budget that is left, so the result is identical to one trace with the
whole budget.  All bulk data stays on the device; each segment pulls two
integers (its bounce count and the largest survivor count).
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch

from .timing import EventTimer
from .trace_cell import cell_hist_base, cell_trace, scatter_deposits
from .trace_rows import LANES


def _compact(rays_out, st_out, rng_out, alive, k: int):
    """The first ``k`` rays of each cell's stable partition, alive rays
    first, as resume-mode inputs (C, 9, k/128, 128), (C, k/128, 128) x 2."""
    C = st_out.shape[0]
    order = torch.sort((~alive).to(torch.uint8), dim=1,
                       stable=True).indices[:, :k]
    rf = torch.gather(rays_out.reshape(C, 9, -1), 2,
                      order[:, None, :].expand(C, 9, k))
    st = torch.gather(st_out.reshape(C, -1), 1, order)
    rg = torch.gather(rng_out.reshape(C, -1), 1, order)
    rt = k // LANES
    return (rf.reshape(C, 9, rt, LANES), st.reshape(C, rt, LANES),
            rg.reshape(C, rt, LANES))


class SegmentedCellTracer:
    """Drives the per-cell kernel segment by segment."""

    def __init__(self, *, num_fc: int, num_oc: int,
                 edge_counts: Sequence[int], eyebox_bins: Sequence[int],
                 max_bounces: int, segment_bounces: int = 24, hist_dims=None):
        if segment_bounces < 1:
            raise ValueError("segment_bounces must be positive")
        self.kw = dict(num_fc=int(num_fc), num_oc=int(num_oc),
                       edge_counts=tuple(int(e) for e in edge_counts),
                       eyebox_bins=tuple(int(b) for b in eyebox_bins))
        self.max_bounces = int(max_bounces)
        self.segment_bounces = int(segment_bounces)
        self._hist_dims = hist_dims   # (L, M, N) for the histogram form
        self.deposits = 0             # deposits of the last trace()

    def trace(self, cell_params, geom_row, rays_in, rng_in, hist_base=None,
              out: Optional[torch.Tensor] = None,
              timer: Optional[EventTimer] = None):
        """Returns ``(deps, total_bounces)``, ``deps`` a list of one (C, K)
        deposit-code tensor per segment, or ``(histogram, total_bounces)``
        when ``hist_base`` (C,) gives each cell's flat histogram offset: the
        deposits are then added to the (L, N, M, ny, nx) histogram on the
        device after every segment (into ``out`` when one is given).
        ``timer`` collects the spans ``kernel``, ``compact`` and ``scatter``."""
        C, _, rt, _ = rays_in.shape
        dev = rays_in.device
        timer = timer if timer is not None else EventTimer("cpu")
        hist = None
        if hist_base is not None:
            L, M, N = self._hist_dims
            ny, nx = self.kw["eyebox_bins"]
            hist = out if out is not None else torch.zeros(
                (L, N, M, ny, nx), dtype=torch.float32, device=dev)
            hist_base = torch.as_tensor(hist_base).to(dev, torch.int64)
        deps = []
        total = 0
        self.deposits = 0
        budget = self.max_bounces
        # the last segment gets exactly the budget that is left, so the
        # total cutoff equals max_bounces
        seg = min(self.segment_bounces, budget)
        with timer.span("kernel"):
            res = cell_trace(cell_params, geom_row, rays_in, rng_in,
                             max_bounces=seg, **self.kw)
        while True:
            dep, nb, rays_out, st_out, rng_out = res
            budget -= seg
            with timer.span("compact"):
                alive = st_out.reshape(C, -1) < 6
                n_bounces, max_alive = torch.stack(
                    [nb[:, 0].sum(), alive.sum(dim=1).max()]).tolist()
            total += n_bounces
            if hist is not None:
                with timer.span("scatter"):
                    self.deposits += scatter_deposits(hist.view(-1), dep,
                                                      hist_base)
            else:
                deps.append(dep.reshape(C, -1))
            if max_alive == 0 or budget <= 0:
                break
            # a power-of-two number of rows, capped at the current tile: the
            # first tile need not be a power of two (5,000 rays -> 40 rows)
            rt = min(1 << (-(-max_alive // LANES) - 1).bit_length(), rt)
            with timer.span("compact"):
                rays2, st2, rng2 = _compact(rays_out, st_out, rng_out, alive,
                                            rt * LANES)
            seg = min(self.segment_bounces, budget)
            with timer.span("kernel"):
                res = cell_trace(cell_params, geom_row, rays2, rng2, st2,
                                 max_bounces=seg, **self.kw)
        return (hist if hist is not None else deps), total


def deps_to_histogram(deps, cell_ids, L: int, M: int, N: int, ny: int,
                      nx: int) -> torch.Tensor:
    """Per-segment deposit tensors of cells ``cell_ids`` -> the
    (L, N, M, ny, nx) float32 histogram, on their device."""
    dev = deps[0].device
    hist = torch.zeros((L, N, M, ny, nx), dtype=torch.float32, device=dev)
    base = torch.from_numpy(cell_hist_base(cell_ids, M, N, ny, nx)).to(dev)
    for dp in deps:
        scatter_deposits(hist.view(-1), dp, base)
    return hist
