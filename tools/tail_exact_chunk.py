#!/usr/bin/env python3
"""Time the chunk of the per-cell splitting kernel that ``simulate
--tail-exact`` launches, with the port of the working directory.

    python3 /path/to/tools/tail_exact_chunk.py [--reps 5] [--record PATH]

Run from the root of a checkout (this one, or an unpacked older commit:
the script uses only entry points every version of the port has, so
``sh chip_compare.sh PARENT OUT TAG PHASES "python3 $PWD/tools/
tail_exact_chunk.py"`` times both trees in one call).  The chunk is
``cli._tail_hybrid``'s: ``ExactTailHybrid(points_per_pass=1,
capacity=8192, max_steps=1024)`` over the 100 x 75 x 3 grid, 512 cells
spread over it, one launch point (TE and TM: 2 launch seeds).  It prints
one line of JSON: the kernel's time (CUDA events, ``--reps`` launches after
one), the tiles' SHA-256 (equal between trees that agree bit for bit), the
steps, peak, stepped widths and ledgers, and the launch's shape where the
port records it.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import sys
from pathlib import Path


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--record", default=None, metavar="PATH")
    opts = parser.parse_args()
    sys.path.insert(0, os.getcwd())
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        hybrid, pipeline, splitting,
    )

    if not torch.cuda.is_available():
        print("tail_exact_chunk: FAIL: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    sim = pipeline.Simulator(cfg=TraceConfig(), device=dev,
                             engine="splitting")
    hy = hybrid.ExactTailHybrid(sim, points_per_pass=1, capacity=8192,
                                max_steps=1024)
    cells = np.linspace(0, sim.L * sim.M * sim.N - 1, hy._cpb).astype(
        np.int64)
    a = hy._trace.args(cells, hy._seeds(1, 1_000_003))
    out = splitting.launch_split_cells(a)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(opts.reps):
        splitting.launch_split_cells(a)
    end.record()
    torch.cuda.synchronize()
    rec = {"tree": os.getcwd(), "cells": a.C, "capacity": a.capacity,
           "ms": start.elapsed_time(end) / opts.reps,
           "tiles_sha256": hashlib.sha256(
               out.tiles.cpu().numpy().tobytes()).hexdigest(),
           "steps": int(out.steps.max()), "peak": int(out.peak.max()),
           "work": int(out.work.sum()), "pruned": float(out.pruned.sum()),
           "trunc": float(out.trunc.sum()),
           "launch": getattr(splitting, "last_launch", {}).get(
               "split_cells")}
    print(f"tail_exact_chunk {json.dumps(rec)}", flush=True)
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(rec, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
