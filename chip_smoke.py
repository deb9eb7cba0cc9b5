#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one NVIDIA GPU.

    python3 chip_smoke.py [--record PATH]

Run from the repository root.  Phases:

1. the card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the ``nvcc`` build of every kernel with its ``-Xptxas -v`` report;
2. each kernel against its plain PyTorch version on the card, at the main
   path's per-cell width (paper design, 8 x 6 FoV x 3 wavelengths = 144
   cells, 2,048 slots, spawn target 20,000, 100,000-iteration bound); the
   histogram and the bounce and spawn counts must be identical; both are
   timed with CUDA events after a warm-up;
3. the main path at full width through the port's ``Simulator``: the paper
   design at the reference workload (100 x 75 FoV x 3 wavelengths, 5,000
   rays per FoV x 4 iterations folded into one target of 20,000 per cell,
   80 x 120 eyebox bins), with launch counts reset just before it and read
   just after it;
4. only with ``--profile PATH``: one more run of the same ``Simulator``
   under ``torch.profiler``, giving the device's busy time, the kernel's and
   the histogram copy's device time and the device's idle share of the run;
   the profiler's table goes to PATH.

Any failure exits non-zero without the result line.  On success the line
before the last is the kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  ``--record PATH`` also writes every
number measured to PATH as JSON.  The port's host timings run with
transparent huge pages off: the port imports the JAX package's numpy modules,
whose package ``__init__`` turns them off for the process.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"
KERNEL_SOURCE = f"{PORT}/csrc/persistent_trace.cu"
REPLACES = ("gpu_ray_tracing_for_waveguide_based_ar_display_tpu/engine/"
            "trace_pallas_persistent.py:233")


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> str:
    """Registers, shared memory and spills from nvcc's -Xptxas -v output."""
    keep = [ln.strip() for ln in log.splitlines()
            if re.search(r"registers|spill|smem", ln)]
    return " | ".join(keep) if keep else "(no ptxas report)"


def cuda_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profile_run(sim, path: str) -> dict:
    """One more ``sim.run()`` under ``torch.profiler``: device busy time
    (sum of the device's self times), the kernel's and the device-to-host
    copies' share of it, and the idle share of the host-clock window."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        res = sim.run(evaluate_metrics=False)
        torch.cuda.synchronize()
        window = time.perf_counter() - t0
    ka = prof.key_averages()
    # device-side events only, as the profiler's own "Self CUDA time total"
    # counts them (host ops carry their children's device time as well)
    dev = {e.key: e.self_device_time_total / 1e6 for e in ka
           if e.device_type == DeviceType.CUDA and not e.is_user_annotation}
    busy = sum(dev.values())
    kernel = sum(t for k, t in dev.items() if "persistent_trace_kernel" in k)
    dtoh = sum(t for k, t in dev.items() if "Memcpy DtoH" in k)
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    Path(path).write_text(ka.table(sort_by="self_device_time_total",
                                   row_limit=25))
    if busy <= 0:
        fail("the profiler recorded no device time")
    return {"window_s": window, "trace_s": res.trace_seconds,
            "device_busy_s": busy, "kernel_device_s": kernel,
            "dtoh_copy_s": dtoh, "idle_share": 1.0 - busy / window,
            "timings": res.timings}


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH",
                        help="write every measured number here as JSON")
    parser.add_argument("--profile", default=None, metavar="PATH",
                        help="profile one more full run; table to PATH")
    opts = parser.parse_args()
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: no GPU to run on")
    if not (ROOT / PORT / "__init__.py").is_file():
        fail(f"the port package {PORT}/ is not next to chip_smoke.py")
    sys.path.insert(0, str(ROOT))
    record = {}

    # ---- phase 1: card, versions, kernel builds
    smi = nvidia_smi()
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"python {sys.version.split()[0]}, "
          f"{torch.cuda.get_device_name(0)} x {torch.cuda.device_count()}")
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, pipeline, trace_persistent as tp,
    )

    t0 = time.perf_counter()
    lib_path = build.build("persistent_trace")
    info = build.build_info["persistent_trace"]
    if info["log"]:
        print(f"nvcc build persistent_trace: {info['seconds']:.2f} s "
              f"({time.perf_counter() - t0:.2f} s with checks) -> "
              f"{lib_path.name}")
    else:
        print(f"nvcc build persistent_trace: {lib_path.name} already built, "
              "not rebuilt")
    print(f"ptxas: {ptxas_summary(info['log'])}")
    record["card"] = smi
    record["torch"] = torch.__version__
    record["cuda"] = torch.version.cuda
    record["build_seconds"] = info["seconds"]
    record["ptxas"] = ptxas_summary(info["log"])
    dev = torch.device("cuda")

    # ---- phase 2: kernel vs plain at the main path's per-cell width
    cfg2 = TraceConfig(num_fov_x=8, num_fov_y=6, rays_per_fov=5000, num_iter=4)
    sim2 = pipeline.Simulator(cfg=cfg2, device=dev, persistent_slots=2048)
    target = cfg2.rays_per_fov * cfg2.num_iter
    n2 = sim2.L * sim2.M * sim2.N
    slots, _ = sim2._slots_gens(target)
    import numpy as np

    rays_in, rng_in = sim2._device_ray_blocks(np.arange(n2), slots)
    ctrl = sim2._pers_ctrl(target)
    tr = sim2.tracer
    args = (tr.cell_params, tr.geom_row, rays_in, rng_in, ctrl)
    kw = dict(num_fc=tr.num_fc, num_oc=tr.num_oc, edge_counts=tr.edge_counts,
              eyebox_bins=tr.eyebox_bins, max_iters=tr.max_iters)
    hk, nbk = tp.persistent_trace(*args, **kw)            # warm-up + result
    torch.cuda.synchronize()
    hp, nbp = tp.persistent_trace_reference(*args, **kw)  # warm-up + result
    torch.cuda.synchronize()
    ms_kernel = cuda_ms(lambda: tp.persistent_trace(*args, **kw), 5)
    ms_plain = cuda_ms(lambda: tp.persistent_trace_reference(*args, **kw), 1)
    max_abs = float((hk - hp).abs().max())
    same_hist = bool(torch.equal(hk, hp))
    same_nb = bool(torch.equal(nbk[:, [0, 2]], nbp[:, [0, 2]]))
    nbk_h = nbk.cpu().numpy()
    print(f"phase 2: {n2} cells x {slots} slots, target {target}: kernel "
          f"{ms_kernel:.3f} ms, plain {ms_plain:.3f} ms; deposits "
          f"{float(hk.sum()):.0f} vs {float(hp.sum()):.0f}, bounces "
          f"{int(nbk_h[:, 0].sum())} vs {int(nbp[:, 0].sum())}, spawned "
          f"{int(nbk_h[:, 2].sum())} vs {int(nbp[:, 2].sum())}, iterations "
          f"max {int(nbk_h[:, 1].max())}; max |hist diff| {max_abs}")
    record["phase2"] = {
        "cells": n2, "slots": slots, "target": target,
        "kernel_ms": ms_kernel, "plain_ms": ms_plain,
        "deposits": float(hk.sum()), "bounces": int(nbk_h[:, 0].sum()),
        "spawned": int(nbk_h[:, 2].sum()),
        "max_iterations": int(nbk_h[:, 1].max()),
        "max_abs_err": max_abs, "hist_identical": same_hist,
        "nb_identical": same_nb,
        "bounces_per_s_kernel": int(nbk_h[:, 0].sum()) / (ms_kernel / 1e3),
    }
    if not (same_hist and same_nb):
        fail(f"kernel disagrees with its plain version (hist identical "
             f"{same_hist}, bounces/spawned identical {same_nb}, max |diff| "
             f"{max_abs})")
    if float(hk.sum()) <= 0:
        fail("phase 2 made no deposits")
    del sim2, hk, hp, args, rays_in, rng_in

    # ---- phase 3: the main path at full width
    cfg = TraceConfig()   # reference workload: 100 x 75 x 3, 5,000 x 4 rays
    torch.cuda.reset_peak_memory_stats()
    tp.reset_launch_counts()
    t0 = time.perf_counter()
    sim = pipeline.Simulator(cfg=cfg, device=dev)
    res = sim.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(tp.launch_counts)
    peak = torch.cuda.max_memory_allocated()
    n_cells = sim.L * sim.M * sim.N
    target = cfg.rays_per_fov * cfg.num_iter
    batches = math.ceil(n_cells / 2048)
    met = res.metrics
    print(pipeline.format_report(res))
    print(f"phase 3: {n_cells} cells, target {target} rays/cell: wall "
          f"{wall:.3f} s (setup {sim.setup_seconds:.3f} s), trace "
          f"{res.trace_seconds:.3f} s, kernel "
          f"{res.timings.get('kernel_ms', float('nan')):.1f} ms, seeding "
          f"{res.timings['seed_s']:.3f} s, assembly "
          f"{res.timings['assemble_s']:.3f} s, metrics "
          f"{res.timings.get('metrics_s', float('nan')):.3f} s; bounces "
          f"{res.total_bounces:,} ({res.bounces_per_second:.4g}/s), rays "
          f"{res.rays_traced:,}; launches {launches}; peak device memory "
          f"{peak / 2**20:.1f} MiB; jax loaded: {'jax' in sys.modules}")
    record["phase3"] = {
        "cells": n_cells, "target": target, "wall_s": wall,
        "setup_s": sim.setup_seconds, "trace_s": res.trace_seconds,
        "timings": res.timings, "total_bounces": res.total_bounces,
        "bounces_per_s": res.bounces_per_second,
        "rays_traced": res.rays_traced, "efficiencies": res.efficiencies,
        "delta_e": met.delta_e, "u_fov": met.u_fov, "u_eyebox": met.u_eyebox,
        "launches": launches, "batches": batches, "peak_bytes": peak,
        "max_iterations": int(res.cell_stats[:, 1].max()),
    }
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=2))

    vals = list(res.efficiencies.values()) + [met.delta_e, met.u_fov,
                                              met.u_eyebox]
    if not all(math.isfinite(v) for v in vals):
        fail(f"non-finite metric in {vals}")
    per_colour = res.histogram.sum(axis=(1, 2, 3, 4), dtype=np.float64)
    if (per_colour <= 0).any():
        fail(f"a colour has no deposits: {per_colour}")
    if (res.cell_stats[:, 2] < target).any():
        fail(f"{int((res.cell_stats[:, 2] < target).sum())} cells spawned "
             f"fewer than {target} rays")
    want = sum(res.efficiencies.values()) / sim.L * target * n_cells
    got = float(res.histogram.sum(dtype=np.float64))
    if abs(got - want) > 1e-6 * want:
        fail(f"histogram sum {got} vs efficiencies x rays {want}")
    if launches["persistent_trace"] != batches:
        fail(f"persistent_trace launched {launches['persistent_trace']} "
             f"times, expected one per batch ({batches})")
    if "jax" in sys.modules:
        fail("the port loaded jax")

    # ---- phase 4 (optional): where the device time of one run goes
    if opts.profile:
        record["profile"] = profile_run(sim, opts.profile)
        print(f"phase 4: {json.dumps(record['profile'])}")
        if opts.record:
            Path(opts.record).write_text(json.dumps(record, indent=2))

    print(json.dumps({"kernels": [{
        "name": "persistent_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": launches["persistent_trace"],
        "max_abs_err": max_abs, "ms": ms_kernel, "plain_ms": ms_plain}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
