#!/usr/bin/env python3
"""First-use cost of ``simulate``'s device tail, each case in a fresh process.

    python3 tools/tail_first_use.py [--record PATH]

Run from the repository root on a machine with one CUDA card.  Each case
starts a new Python process, so that none of the tail's kernels is loaded
yet, builds a random (3, 75, 100, 80, 120) float32 histogram on the card
(the reference workload's shape) and times with the host clock, each step
ending in ``torch.cuda.synchronize()``:

- ``cold``: the perception (``eye_perceived_torch``), the colorimetry with
  the eye-view image (``colorimetry_torch``) and the pull of its result,
  as the first calls of the process;
- ``warm``: the same after a warm-up of both on a (3, 1, 1, 80, 120) zero
  histogram, and the warm-up's own time;
- ``warm_behind_work``: the warm-up enqueued behind about 0.5 s of device
  work (``torch.cuda._sleep``): the time until both are done, against
  ``work_only``, the device work alone.

Prints the card's name and power limit, then one JSON object per case.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

CASES = ("cold", "warm", "work_only", "warm_behind_work")
SPIN_CYCLES = 850_000_000   # about 0.5 s of device spin at 1.7 GHz


def case(name: str) -> dict:
    import torch

    sys.path.insert(0, os.getcwd())
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    def synced(fn):
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    def warm_up():
        metrics.colorimetry_torch(metrics.eye_perceived_torch(
            torch.zeros((3, 1, 1, 80, 120), device="cuda")), with_image=True)

    torch.zeros(1, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(0)
    hist = torch.rand((3, 75, 100, 80, 120), device="cuda", generator=gen)
    torch.cuda.synchronize()
    out = {"case": name}
    if name == "warm":
        out["warm_up_s"] = synced(warm_up)[1]
    elif name == "work_only":
        out["work_s"] = synced(lambda: torch.cuda._sleep(SPIN_CYCLES))[1]
    elif name == "warm_behind_work":
        out["work_and_warm_up_s"] = synced(
            lambda: (torch.cuda._sleep(SPIN_CYCLES), warm_up()))[1]
    perc, out["perception_s"] = synced(
        lambda: metrics.eye_perceived_torch(hist))
    res, out["colorimetry_s"] = synced(
        lambda: metrics.colorimetry_torch(perc, with_image=True))
    out["pull_s"] = synced(lambda: metrics.result_to_host(res, 7, 8))[1]
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="also write the cases here as JSON")
    parser.add_argument("--case", choices=CASES, help=argparse.SUPPRESS)
    opts = parser.parse_args()
    if opts.case:
        print(json.dumps(case(opts.case)))
        return 0
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip()
    print(f"card: {card}")
    results = []
    for name in CASES:
        run = subprocess.run([sys.executable, __file__, "--case", name],
                             capture_output=True, text=True, timeout=600)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    if opts.record:
        with open(opts.record, "w") as f:
            json.dump({"card": card, "cases": results}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
