"""Command-line interface of the port: the ``simulate`` subcommand.

    python -m gpu_ray_tracing_for_waveguide_based_ar_display_torch simulate [...]

The defaults run the main path: the paper design at the reference workload
(100 x 75 FoV x 3 wavelengths, 5,000 rays per FoV x 4 iterations folded into
one spawn target, a 100,000-bounce bound, 80 x 120 eyebox bins) on
``--device cuda``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.models import presets

from .config import TraceConfig


def _design(args):
    """The chosen preset with any ``--set FIELD=VALUE`` overrides applied."""
    d = presets.get(args.design)
    fields = {f.name for f in dataclasses.fields(d)}
    repl = {}
    for ov in args.overrides:
        key, sep, val = ov.partition("=")
        key = key.strip()
        if not sep or key not in fields:
            raise SystemExit(f"--set expects FIELD=VALUE with a WaveguideDesign "
                             f"field; got {ov!r}")
        cur = getattr(d, key)
        try:
            if isinstance(cur, tuple):
                elem = type(cur[0]) if cur else float
                repl[key] = tuple(elem(v) for v in val.split(","))
            elif isinstance(cur, bool):
                repl[key] = val.strip().lower() in ("1", "true", "yes")
            elif isinstance(cur, int):
                repl[key] = int(val)
            else:
                repl[key] = float(val)
        except ValueError:
            raise SystemExit(f"--set {key}: cannot parse {val!r} as "
                             f"{type(cur).__name__}")
    return dataclasses.replace(d, **repl) if repl else d


def _check_image_writer() -> None:
    try:
        import cv2  # noqa: F401
    except ImportError:
        try:
            import PIL  # noqa: F401
        except ImportError:
            raise SystemExit("--image needs cv2 or PIL to write the PNG; "
                             "neither is installed (drop --image)")


def cmd_simulate(args) -> int:
    from .engine.pipeline import Simulator, format_report

    if args.image:
        _check_image_writer()   # fail before the trace, not after it
    cfg = TraceConfig(num_fov_x=args.fov_x, num_fov_y=args.fov_y,
                      rays_per_fov=args.rays_per_fov, num_iter=args.num_iter,
                      max_bounces=args.max_bounces, seed=args.seed,
                      pupil_sampling=args.pupil_sampling)
    sim = Simulator(design=_design(args), cfg=cfg, luts_dir=args.luts_dir,
                    geometry_simplify_tol=args.simplify_tol,
                    device=args.device, persistent_slots=args.slots)
    res = sim.run(cells_per_batch=args.cells_per_batch, verbose=args.verbose)
    print(format_report(res))
    if args.image and res.metrics is not None:
        from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.eval.image import (
            save_eyebox_center_view,
        )

        save_eyebox_center_view(args.image, res.metrics.output_image)
        print(f"Eyebox center view written to {args.image}")
    if args.save_histogram:
        np.save(args.save_histogram, res.histogram)
        print(f"eyebox histogram written to {args.save_histogram}")
    if args.json:
        out = {
            "device": str(sim.device),
            "efficiencies": res.efficiencies,
            "delta_e": res.metrics.delta_e if res.metrics else None,
            "u_fov": res.metrics.u_fov if res.metrics else None,
            "u_eyebox": res.metrics.u_eyebox if res.metrics else None,
            "starved_eye_positions": (res.metrics.starved_eye_positions
                                      if res.metrics else None),
            "rays_traced": res.rays_traced,
            "total_bounces": res.total_bounces,
            "trace_seconds": res.trace_seconds,
        }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="gpu_ray_tracing_for_waveguide_based_ar_display_torch",
        description="Waveguide AR display ray tracer (PyTorch + CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("simulate",
                       help="full-color Monte-Carlo simulation + metrics")
    p.add_argument("--design", default="paper_default",
                   choices=sorted(presets.PRESETS), help="design preset")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="FIELD=VALUE",
                   help="override a WaveguideDesign field (repeatable)")
    p.add_argument("--fov-x", type=int, default=100, help="FoV grid columns")
    p.add_argument("--fov-y", type=int, default=75, help="FoV grid rows")
    p.add_argument("--luts-dir", default=None,
                   help="directory with lut_*_fullColor.npy (synthetic if absent)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--rays-per-fov", type=int, default=5000)
    p.add_argument("--num-iter", type=int, default=4,
                   help="iterations, folded into one spawn target per cell")
    p.add_argument("--max-bounces", type=int, default=100_000)
    p.add_argument("--cells-per-batch", type=int, default=2048)
    p.add_argument("--slots", type=int, default=2048,
                   help="persistent slots per cell")
    p.add_argument("--simplify-tol", type=float, default=0.0)
    p.add_argument("--pupil-sampling", default="uniform",
                   choices=("uniform", "r2"))
    p.add_argument("--device", default="cuda",
                   help="'cuda' runs the CUDA kernel; 'cpu' its plain "
                        "PyTorch version")
    p.add_argument("--image", default="",
                   help="write the eye-view PNG here (needs cv2 or PIL)")
    p.add_argument("--json", default=None, help="write metrics JSON here")
    p.add_argument("--save-histogram", default=None, metavar="PATH",
                   help="write the (L, FoVy, FoVx, 80, 120) histogram as .npy")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_simulate)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
