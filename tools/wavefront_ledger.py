#!/usr/bin/env python3
"""The weight ledger of ``optimize``'s differentiable trace at one design.

    python3 tools/wavefront_ledger.py [--fov-x 16] [--fov-y 12]
        [--rays-per-fov 16] [--capacity 4096] [--trace-steps 64]
        [--soft-binning] [--device cpu]

Run from the repository root.  Traces the launch wavefront that ``optimize``
builds (the paper design, synthetic LUTs, its seeding) once through the
global splitting engine in ``optimize``'s configuration (the tables as an
argument, a fixed number of steps, threshold 1e-4) at the unapodized tables,
without gradients, and prints the launch weight and the weight truncated,
pruned and deposited: how much of the wavefront a capacity holds.
"""

from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--fov-x", type=int, default=16)
    parser.add_argument("--fov-y", type=int, default=12)
    parser.add_argument("--rays-per-fov", type=int, default=16)
    parser.add_argument("--capacity", type=int, default=4096)
    parser.add_argument("--trace-steps", type=int, default=64)
    parser.add_argument("--soft-binning", action="store_true")
    parser.add_argument("--device", default="cpu")
    opts = parser.parse_args()
    sys.path.insert(0, str(ROOT))
    import torch

    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        splitting, trace_vector as tv,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.io import (
        load_or_synthesize,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (
        build_cell_tables,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.opt import (
        grating_opt as opt,
    )

    M, N = opts.fov_x, opts.fov_y
    cfg = TraceConfig(num_fov_x=M, num_fov_y=N,
                      rays_per_fov=opts.rays_per_fov, max_bounces=2048)
    geom = generate_geometry(num_fov_x=M, num_fov_y=N)
    tables = build_cell_tables(geom, load_or_synthesize(geom))
    tgeom = build_trace_geometry(geom)
    rays0 = opt._launch_rays(geom, cfg, opts.rays_per_fov, None, opts.device)
    trace = splitting.make_splitting_trace_fn(
        tables, tgeom, cfg, capacity=opts.capacity, weight_threshold=1e-4,
        table_arg=True, fixed_steps=opts.trace_steps,
        soft_binning=opts.soft_binning, device=opts.device)
    T = {k: (v.to(opts.device) if torch.is_tensor(v) else v)
         for k, v in tv.as_tables(tables).items()}
    t0 = time.perf_counter()
    with torch.no_grad():
        _, out_w, trunc, pruned, steps = trace(rays0, T)
    wall = time.perf_counter() - t0
    n0 = len(rays0["x"])
    print(f"{M} x {N} FoV x {opts.rays_per_fov} rays = {n0:,} launch rays, "
          f"capacity {opts.capacity:,}, {steps} steps: truncated "
          f"{float(trunc):.6g}, pruned {float(pruned):.6g}, deposited "
          f"{float(out_w):.6g} of {n0:,} launched ({wall:.2f} s on "
          f"{opts.device})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
