#!/usr/bin/env python3
"""First-use cost of ``simulate``'s device tail, each case in a fresh process.

    python3 tools/tail_first_use.py [--record PATH]

Run from the repository root on a machine with one CUDA card.  The tail's
library (``csrc/eye_tail.cu``) is built first, in this process; then each
case starts a new Python process, so that nothing of the tail is loaded
yet, builds a random (3, 75, 100, 80, 120) float32 histogram on the card
(the reference workload's shape) and times with the host clock, each step
ending in ``torch.cuda.synchronize()``.  Two routes:

- ``kernels``: what ``simulate`` runs since the tail's kernels: the
  library bound and its module loaded (``eye_tail.load_kernel``, which a
  ``Simulator`` does in its setup), then the perception
  (``eye_perceived_torch``), the colorimetry with the eye-view image
  (``colorimetry_torch``) and the pull of its result;
- ``library``: the plain versions on the card: ``pupil_conv`` (one cuDNN
  ``conv2d``, TF32 off), ``_make_eval_core`` with the image (eager kernels
  and cuBLAS) and the same pull;

and ``sum``: the efficiencies' float64 per-colour sum of the histogram
(``Simulator._tail``'s ``histogram.sum(dim=(1, 2, 3, 4),
dtype=torch.float64)``) and its pull.  Each route runs ``cold`` (its first
calls of the process, twice over: the second pass is loaded) and
``behind_work``: its first calls enqueued behind about 0.5 s of device work
(``torch.cuda._sleep``; the kernels' bind before it, as in a run), the time
until all is done against ``work_only``, the device work alone.

Prints one JSON object per case, each with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

ROUTES = ("kernels", "library", "sum")
CASES = [(r, m) for r in ROUTES for m in ("cold", "behind_work")] + [
    ("work", "work_only")]
SPIN_CYCLES = 850_000_000   # about 0.5 s of device spin at 1.7 GHz


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()


def case(route: str, mode: str) -> dict:
    import torch

    sys.path.insert(0, os.getcwd())
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    def synced(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    torch.zeros(1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hist = torch.rand((3, 75, 100, 80, 120), device="cuda", generator=gen)
    torch.cuda.synchronize()
    out = {"route": route, "case": mode, "card": nvidia_smi()}
    mask = metrics.pupil_mask(30)
    inv_norm = metrics._inv_norm(1.0)

    def tail():
        if route == "kernels":
            perc = metrics.eye_perceived_torch(hist)
            return metrics.colorimetry_torch(perc, with_image=True)
        if route == "library":
            perc = metrics.pupil_conv(hist, torch.as_tensor(
                mask, dtype=torch.float32, device="cuda"), (8, 12))
            return metrics._make_eval_core(True)(perc[None], inv_norm)
        return {"sums": hist.sum(dim=(1, 2, 3, 4), dtype=torch.float64)}

    if route == "kernels":
        out["bind_s"] = synced(eye_tail.load_kernel)[1]
    if mode == "work_only":
        out["work_s"] = synced(lambda: torch.cuda._sleep(SPIN_CYCLES))[1]
        return out
    if mode == "behind_work":
        res, out["work_and_tail_s"] = synced(
            lambda: (torch.cuda._sleep(SPIN_CYCLES), tail())[1])
        out["pull_s"] = synced(lambda: {k: v.cpu() for k, v in res.items()}
                               )[1]
        return out
    for p in ("first", "loaded"):
        if route == "sum":
            res, out[f"{p}_sum_s"] = synced(tail)
        elif route == "kernels":
            perc, out[f"{p}_perception_s"] = synced(
                lambda: metrics.eye_perceived_torch(hist))
            res, out[f"{p}_colorimetry_s"] = synced(
                lambda: metrics.colorimetry_torch(perc, with_image=True))
        else:
            kernel = torch.as_tensor(mask, dtype=torch.float32, device="cuda")
            perc, out[f"{p}_perception_s"] = synced(
                lambda: metrics.pupil_conv(hist, kernel, (8, 12)))
            res, out[f"{p}_colorimetry_s"] = synced(
                lambda: metrics._make_eval_core(True)(perc[None], inv_norm))
        out[f"{p}_pull_s"] = synced(
            lambda: {k: v.cpu() for k, v in res.items()})[1]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="also write the cases here as JSON")
    parser.add_argument("--case", nargs=2, help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.case:
        print(json.dumps(case(*opts.case)))
        return 0
    sys.path.insert(0, os.getcwd())
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build,
    )

    build.build("eye_tail")   # the nvcc build is not a first use
    results = []
    for route, mode in CASES:
        run = subprocess.run([sys.executable, __file__, "--case", route,
                              mode], capture_output=True, text=True,
                             timeout=600)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if opts.record:
        with open(opts.record, "w") as f:
            json.dump({"cases": results}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
