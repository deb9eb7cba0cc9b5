#!/usr/bin/env python3
"""Where the device time of the plain-PyTorch engines goes, on one GPU.

    python3 tools/engine_profile.py [--out PATH]

Run from the repository root.  Profiles, with ``torch.profiler``, (1) one
batch of the vector engine at the reference width (the paper design, the
first 2,048 of the 100 x 75 x 3 cells, 5,000 host-seeded rays per cell,
segments of 24 bounces, seeding not profiled) and (2) one batch of the
per-cell splitting engine at the exact runs' width (the first 256 cells, 2
launch positions, threshold 1e-6, 8,192-slot wavefronts).  Each is run once
unprofiled on a small batch first, so the profile holds no first-use cost.
Prints, per engine, the wall of the profiled batch, the device and host
time the profiler totals (its tables' last lines) and the device's idle
share of the wall, and the operators by device time; ``--out`` also
writes the tables there.
"""

from __future__ import annotations

import argparse
import re
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def total(table: str, kind: str) -> float:
    """Seconds of the profiler's ``Self <kind> time total`` line."""
    value, unit = re.search(rf"Self {kind} time total: ([0-9.]+)(us|ms|s)",
                            table).groups()
    return float(value) * {"us": 1e-6, "ms": 1e-3, "s": 1.0}[unit]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default=None, metavar="PATH",
                        help="write the profiler's tables here")
    opts = parser.parse_args()
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("engine_profile: no GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        pipeline,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.timing import (
        EventTimer,
    )

    dev = torch.device("cuda")
    tables = []

    def run(name, fn):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        table = prof.key_averages().table(sort_by="cuda_time_total",
                                          row_limit=20,
                                          max_name_column_width=60)
        dev_s, cpu_s = (total(table, kind) for kind in ("CUDA", "CPU"))
        print(f"{name}: wall {wall:.3f} s, device {dev_s:.3f} s, host "
              f"{cpu_s:.3f} s (profiled), device idle "
              f"{1 - dev_s / wall:.1%} of the wall", flush=True)
        print(table, flush=True)
        tables.append(f"{name}\n{table}")

    sim = pipeline.Simulator(cfg=TraceConfig(), device=dev, engine="vector",
                             segmented=True)
    chunk = np.arange(2048)
    sim.trace_batch_compacted(chunk[:64], 5000, 0)
    rays = sim._vector_rays(chunk, 5000, 0)
    hist = torch.zeros((sim.L, sim.N, sim.M, *sim.cfg.eyebox_bins),
                       device=dev)
    run("vector batch (2,048 cells x 5,000 rays)",
        lambda: sim._trace_vector(rays, hist, EventTimer("cpu"),
                                  sim._segment_bounces))
    del sim, rays, hist
    torch.cuda.empty_cache()

    split = pipeline.Simulator(cfg=TraceConfig(rays_per_fov=2), device=dev,
                               engine="splitting")
    split.trace_batch(np.arange(8), 2, 0)
    run("splitting batch (256 cells x 2 positions)",
        lambda: split.trace_batch(np.arange(256), 2, 0))
    if opts.out:
        Path(opts.out).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.out).write_text("\n\n".join(tables))
    return 0


if __name__ == "__main__":
    sys.exit(main())
