#!/usr/bin/env python3
"""The deposits that the vector engines move on a CUDA card when the
deposit bin divides the bin width by a tensor, not by a Python scalar.

    python3 tools/deposit_bin_moves.py [--record PATH]

Run from the repository root on a machine with one CUDA card.  torch on the
card divides a float32 tensor by a Python scalar through the scalar's
reciprocal, so a position on a bin edge can land in the neighbouring bin;
``engine.trace_vector.deposit_bin`` divides by tensors, as the CPU rounds
either form.  Each engine below runs with ``deposit_bin`` as it is and with
the scalar-division form (``deposit_bin_scalar``, put in its place in
``trace_vector`` and ``splitting``), the same seeds, and the histograms are
compared bin by bin:

- ``vector``: ``simulate --engine vector``'s trace at the reference
  workload (100 x 75 x 3 cells, 5,000 rays a cell, segmented; the vector
  run of ``chip_smoke.py``'s phase 12), run as is, in the scalar form, and
  as is again (two runs of one form must agree bit for bit);
- ``sweep``: the CLI's default sweep through the vector sweep (8 designs;
  design 3's histogram and every design's efficiencies);
- ``global``: the global splitting engine on the 3 x 2 fixture of phase
  13d (weights, not counts).

The vector engine's trace calls run its plain version here
(``trace_vector.vector_trace_reference``, put in place of the routing
``vector_trace``), and the global engine's its own
(``splitting.split_trace_reference`` in place of ``split_trace``): on the
card they otherwise launch ``csrc/vector_trace.cu`` and
``csrc/split_trace.cu``, which take the bin in the tensor form and call
no ``deposit_bin``.

Prints one JSON object per engine, each with the card's name and power
limit; ``--record`` writes them as one JSON list.
"""
import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli  # noqa: E402
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (  # noqa: E402
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (  # noqa: E402
    generate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (  # noqa: E402
    pipeline, seeding, splitting, trace_vector as tv,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (  # noqa: E402
    build_trace_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import (  # noqa: E402
    make_synthetic_luts,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts.packing import (  # noqa: E402
    build_cell_tables,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (  # noqa: E402
    design_sweep,
)

AS_IS = tv.deposit_bin


def deposit_bin_scalar(ebr: torch.Tensor, x, y, ny: int, nx: int):
    """``deposit_bin`` with the bin width divided by Python scalars."""
    e0, e1, e2, e3 = ebr.unbind(0)
    in_quad = ((x >= e0 - tv._EDGE_TOL) & (x <= e1 + tv._EDGE_TOL)
               & (y >= e2 - tv._EDGE_TOL) & (y <= e3 + tv._EDGE_TOL))
    dxb = (e1 - e0) / nx
    dyb = (e3 - e2) / ny
    ix = tv._bin((x - e0) / dxb, nx - 1)
    iy = tv._bin((y - e2) / dyb, ny - 1)
    return in_quad, iy * nx + ix


def use(fn) -> None:
    tv.deposit_bin = fn
    splitting.deposit_bin = fn


def host(h) -> np.ndarray:
    return h.cpu().numpy() if torch.is_tensor(h) else np.asarray(h)


def compare(a: np.ndarray, b: np.ndarray) -> dict:
    d = np.abs(a.astype(np.float64) - b.astype(np.float64))
    return {"bins": int(a.size), "bins_differ": int((a != b).sum()),
            "abs_diff_sum": float(d.sum()), "max_abs_diff": float(d.max()),
            "sums": [float(a.sum(dtype=np.float64)),
                     float(b.sum(dtype=np.float64))]}


def eff_rel(a: dict, b: dict) -> float:
    return max(abs(b[k] / a[k] - 1.0) for k in a)


def card() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip()


def vector(dev) -> dict:
    sim = pipeline.Simulator(cfg=TraceConfig(), device=dev, engine="vector",
                             segmented=True)
    runs = []
    for fn in (AS_IS, deposit_bin_scalar, AS_IS):
        use(fn)
        t0 = time.perf_counter()
        res = sim.run(num_iter=1, evaluate_metrics=False)
        torch.cuda.synchronize()
        runs.append((host(res.histogram), res.efficiencies,
                     time.perf_counter() - t0))
    use(AS_IS)
    e = compare(runs[0][0], runs[1][0])
    e.update(engine="vector", deposits_moved=e["abs_diff_sum"] / 2,
             as_is_repeat_bins_differ=int((runs[0][0] != runs[2][0]).sum()),
             efficiencies_rel=eff_rel(runs[1][1], runs[0][1]),
             wall_s=[r[2] for r in runs])
    return e


def sweep(dev) -> dict:
    sargs = cli.build_parser().parse_args(["sweep", "--engine", "vector"])
    designs, _ = cli.sweep_designs(sargs)
    cfg = cli.sweep_config(sargs)
    runs = []
    for fn in (AS_IS, deposit_bin_scalar):
        use(fn)
        sw = design_sweep.run_design_sweep(designs, cfg, device=dev,
                                           keep_histograms=(3,))
        runs.append((host(sw.histograms[0]), np.asarray(sw.efficiencies),
                     np.asarray(sw.bounces)))
    use(AS_IS)
    e = compare(runs[0][0], runs[1][0])
    a, b = runs[1][1], runs[0][1]
    e.update(engine="sweep", designs=len(designs), histogram="design 3",
             deposits_moved=e["abs_diff_sum"] / 2,
             efficiencies_rel=float(np.abs(b / a - 1.0).max()),
             bounces_equal=bool(np.array_equal(runs[0][2], runs[1][2])))
    return e


def global_engine(dev) -> dict:
    cfg = TraceConfig(num_fov_x=3, num_fov_y=2, rays_per_fov=4,
                      rng_mode="fast", seed=2)
    geom = generate_geometry(num_fov_x=3, num_fov_y=2)
    tables = build_cell_tables(geom, make_synthetic_luts(geom))
    tgeom = build_trace_geometry(geom)
    b = seeding.build_ray_batch(geom, cfg)
    runs = []
    for fn in (AS_IS, deposit_bin_scalar):
        use(fn)
        rays = tv.make_ray_state(b["x"], b["y"], b["te"], b["tm"], b["cid"],
                                 b["idx"], b["rng"], device=dev)
        r = splitting.run_splitting(tables, tgeom, cfg, rays,
                                    capacity=1 << 15, weight_threshold=1e-5,
                                    max_steps=300, device=dev)
        runs.append((host(r.histogram), r.steps, r.out_coupled))
    use(AS_IS)
    e = compare(runs[0][0], runs[1][0])
    e.update(engine="global", steps=[runs[0][1], runs[1][1]],
             out_coupled=[runs[0][2], runs[1][2]])
    return e


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--record", default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    tv.vector_trace = tv.vector_trace_reference
    splitting.split_trace = splitting.split_trace_reference
    name = card()
    out = []
    for fn in (vector, sweep, global_engine):
        e = fn(dev)
        e["card"] = name
        print(json.dumps(e), flush=True)
        out.append(e)
    if args.record:
        os.makedirs(os.path.dirname(os.path.abspath(args.record)),
                    exist_ok=True)
        with open(args.record, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
