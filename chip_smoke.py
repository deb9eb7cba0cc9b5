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
   the profiler's table goes to PATH;
5. the kernel against its plain version in the sweep's modes: the paper
   design swept over 3 coupler periods (D = 3 geometry rows, one launch tile
   per design, one shared seed block), 4 x 3 FoV x 3 wavelengths, 256 slots,
   in gens spawn saturated to iteration 256 (``ctrl = [1, 256]``), gens
   spawn with two generations (``[2, 0]``) and count spawn (target 256); the
   histogram and the bounce and spawn counts must be identical; both are
   timed with CUDA events;
6. the design sweep at full width through the port's
   ``run_design_sweep_persistent``, with launch counts reset just before
   each sweep and read just after it: the CLI's default sweep (8 coupler
   periods over 370-405 nm, 100 x 75 FoV x 3 wavelengths = 180,000 cells in
   one launch, 256 rays per FoV, gens spawn saturated to iteration 256,
   2,048-bounce bound) and the README's count sweep (16 periods, 360,000
   cells in one launch, 2,048 rays per FoV, count spawn), both with metrics;
   design 3 of each must equal its solo sweep bit for bit.

Any failure exits non-zero without the result line.  On success the line
before the last is the kernels' JSON summary and the last line is
``{"ok": true, "device": {...}}``.  ``--record PATH`` also writes every
number measured to PATH as JSON.  The port's package ``__init__`` turns
transparent huge pages off for the process (``GRT_KEEP_THP=1`` keeps them),
so its host timings run with THP off.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"
JAX_PACKAGE = PORT[:-len("torch")] + "tpu"   # the reference, never imported
KERNEL_SOURCE = f"{PORT}/csrc/persistent_trace.cu"
REPLACES = f"{JAX_PACKAGE}/engine/trace_pallas_persistent.py:233"
# one NVIDIA H100 SXM (data sheet, 700 W): FP32 rate outside the tensor
# cores and HBM rate, for the bounds of the kernel line
PEAK_FP32_OPS = 67e12
PEAK_HBM_BYTES = 3.35e12


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


def bound_ms(inputs, outputs, nb, n_r1: int):
    """The least time the card could take for one launch, and what sets it.

    Bytes: every input read once and every output written once.  Operations:
    the float32 work every bounce does at least, the r1 containment test
    (two multiplies, an add and a compare: 4 operations per edge), times
    this run's bounces; the Jones products, strip selection and
    roulette of the bounces that interact are not counted, so the bound is a
    floor."""
    import torch

    nbytes = sum(t.numel() * t.element_size() for t in (*inputs, *outputs))
    ops = float(nb[:, 0].to(torch.int64).sum()) * 4 * n_r1
    t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
    t_ops = ops / PEAK_FP32_OPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def jax_modules() -> list:
    """Modules of jax or of the JAX package loaded in this process."""
    return sorted(m for m in sys.modules
                  if m == "jax" or m.startswith(("jax.", JAX_PACKAGE)))


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
    bound2, bound_by2 = bound_ms(args, (hk, nbk), nbk, tr.edge_counts[1])
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
        "bound_ms": bound2, "bound_by": bound_by2,
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
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")

    # ---- phase 4 (optional): where the device time of one run goes
    if opts.profile:
        record["profile"] = profile_run(sim, opts.profile)
        print(f"phase 4: {json.dumps(record['profile'])}")
        if opts.record:
            Path(opts.record).write_text(json.dumps(record, indent=2))
    main_launches = launches["persistent_trace"]
    del sim, res

    # ---- phase 5: the kernel against its plain version in the sweep's modes
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        trace_rows,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine.trace_geometry import (
        build_trace_geometry,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.sweep import (
        design_sweep,
    )

    cfg5 = TraceConfig(num_fov_x=4, num_fov_y=3, rays_per_fov=256,
                       max_bounces=2048)
    designs5 = [dataclasses.replace(WaveguideDesign(), lambda_ic=p, lambda_oc=p)
                for p in (370.0, 387.5, 405.0)]
    rows5 = design_sweep.prepare_chunk(designs5, cfg5, 256)
    inputs5 = (torch.from_numpy(rows5.cell_params).to(dev),
               torch.from_numpy(rows5.geom_rows).to(dev),
               torch.from_numpy(rows5.rays).to(dev),
               torch.from_numpy(design_sweep.shared_seed_block(cfg5, 256)
                                .view(np.int32)).to(dev))
    kw5 = dict(num_fc=rows5.tgeoms[0].num_fc, num_oc=rows5.tgeoms[0].num_oc,
               edge_counts=rows5.edge_counts, eyebox_bins=cfg5.eyebox_bins,
               max_iters=cfg5.max_bounces)
    modes = [{"mode": "count", "ctrl": [target, 0], "designs": 1,
              "cells": n2, "slots": slots, "ms": ms_kernel,
              "plain_ms": ms_plain, "bound_ms": bound2, "bound_by": bound_by2,
              "max_abs_err": max_abs}]
    for mode, ctrl5 in (("gens", [1, 256]), ("gens", [2, 0]),
                        ("count", [256, 0])):
        a5 = inputs5 + (torch.tensor(ctrl5, dtype=torch.int32, device=dev),)
        kw = dict(kw5, spawn_mode=mode)
        hk, nbk = tp.persistent_trace(*a5, **kw)
        torch.cuda.synchronize()
        hp, nbp = tp.persistent_trace_reference(*a5, **kw)
        torch.cuda.synchronize()
        ms_k = cuda_ms(lambda: tp.persistent_trace(*a5, **kw), 5)
        ms_p = cuda_ms(lambda: tp.persistent_trace_reference(*a5, **kw), 1)
        err = float((hk - hp).abs().max())
        same = (torch.equal(hk, hp)
                and torch.equal(nbk[:, [0, 2]], nbp[:, [0, 2]]))
        b5, by5 = bound_ms(a5, (hk, nbk), nbk, kw5["edge_counts"][1])
        nbh = nbk.cpu().numpy()
        entry = {"mode": mode, "ctrl": ctrl5, "designs": 3,
                 "cells": int(nbh.shape[0]), "slots": 256, "ms": ms_k,
                 "plain_ms": ms_p, "bound_ms": b5, "bound_by": by5,
                 "max_abs_err": err, "identical": same,
                 "deposits": float(hk.sum()),
                 "bounces": int(nbh[:, 0].astype(np.int64).sum()),
                 "spawned": int(nbh[:, 2].astype(np.int64).sum()),
                 "max_iterations": int(nbh[:, 1].max())}
        modes.append(entry)
        print(f"phase 5: {json.dumps(entry)}")
        if not same:
            fail(f"kernel disagrees with its plain version in {mode} mode, "
                 f"ctrl {ctrl5} (max |diff| {err})")
        if entry["deposits"] <= 0:
            fail(f"phase 5 {mode} {ctrl5} made no deposits")
    record["phase5"] = modes[1:]
    del hk, hp, inputs5, a5

    # ---- phase 6: the design sweep at full width
    sweeps = (("cli_default", ["sweep", "--metrics"]),
              ("readme_count", ["sweep", "--num-designs", "16",
                                "--spawn-mode", "count", "--spawn-iters", "0",
                                "--rays-per-fov", "2048", "--metrics"]))
    sweep_launches = 0
    record["phase6"] = {}
    for name, argv in sweeps:
        sargs = cli.build_parser().parse_args(argv)
        designs, _ = cli.sweep_designs(sargs)
        cfg6 = cli.sweep_config(sargs)
        kw6 = dict(spawn_iters=sargs.spawn_iters, spawn_mode=sargs.spawn_mode,
                   slots=sargs.slots, evaluate_metrics=sargs.metrics,
                   device=dev)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        tp.reset_launch_counts()
        t0 = time.perf_counter()
        r6 = design_sweep.run_design_sweep_persistent(
            designs, cfg6, keep_histograms=[3], **kw6)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
        n_launch = tp.launch_counts["persistent_trace"]
        peak6 = torch.cuda.max_memory_allocated()
        sweep_launches += n_launch
        solo = design_sweep.run_design_sweep_persistent(
            designs[3:4], cfg6, keep_histograms=True, **kw6)
        n_cells6 = len(designs) * 3 * cfg6.num_fov_x * cfg6.num_fov_y
        bounces6 = int(r6.bounces.sum())
        slots6 = min(cfg6.rays_per_fov, 2048)
        n_r1 = min(trace_rows.edge_counts(build_trace_geometry(
            generate_geometry(d, cfg6.num_fov_x, cfg6.num_fov_y), 0.05))[1]
            for d in designs)
        nbytes = (n_cells6 * (trace_rows.PC + cfg6.eyebox_bins[0]
                              * cfg6.eyebox_bins[1] + 4) * 4
                  + len(designs) * (trace_rows.PG + 6 * slots6) * 4
                  + n_cells6 // len(designs) * slots6 * 4 + 8)
        t_bytes = nbytes / PEAK_HBM_BYTES * 1e3
        t_ops = bounces6 * 4 * n_r1 / PEAK_FP32_OPS * 1e3
        tm = r6.timings
        entry = {
            "designs": len(designs), "cells": n_cells6,
            "spawn_mode": sargs.spawn_mode, "spawn_iters": sargs.spawn_iters,
            "rays_per_fov": cfg6.rays_per_fov, "slots": slots6,
            "wall_s": wall6, "host_prep_s": tm["prep_s"],
            "seed_s": tm["seed_s"], "upload_s": tm["upload_s"],
            "keep_s": tm["keep_s"], "pull_s": tm["pull_s"],
            "metrics_s": tm.get("metrics_s"), "kernel_ms": tm["kernel_ms"],
            "reduce_ms": tm["reduce_ms"],
            "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "bounces": bounces6, "bounces_per_s": bounces6 / wall6,
            "kernel_bounces_per_s": bounces6 / (tm["kernel_ms"] / 1e3),
            "launches": n_launch, "peak_bytes": peak6,
            "designs_per_hour": len(designs) / wall6 * 3600,
            "efficiencies": r6.efficiencies.tolist(),
            "delta_e": [m.delta_e for m in r6.metrics],
            "u_fov": [m.u_fov for m in r6.metrics],
            "u_eyebox": [m.u_eyebox for m in r6.metrics]}
        record["phase6"][name] = entry
        if opts.record:
            Path(opts.record).write_text(json.dumps(record, indent=2))
        print(f"phase 6 {name}: {len(designs)} designs, {n_cells6:,} cells "
              f"in {n_launch} launch(es): wall {wall6:.3f} s (host prep "
              f"{tm['prep_s']:.3f} s, seeds {tm['seed_s']:.3f} s, upload "
              f"{tm['upload_s']:.3f} s, design 3's histogram to the host "
              f"{tm['keep_s']:.3f} s, metrics "
              f"{tm.get('metrics_s', 0.0):.3f} s), kernel "
              f"{tm['kernel_ms']:.1f} ms, reduction and pupil integration "
              f"{tm['reduce_ms']:.1f} ms (kernel bound "
              f"{entry['bound_ms']:.3f} ms, "
              f"{entry['bound_by']}); bounces {bounces6:,} "
              f"({bounces6 / wall6:.4g}/s end to end, "
              f"{entry['kernel_bounces_per_s']:.4g}/s kernel); peak device "
              f"memory {peak6 / 2**20:.1f} MiB; "
              f"{entry['designs_per_hour']:,.0f} designs/hour")
        eff = r6.efficiencies
        if eff.shape != (len(designs), 3) or not (np.isfinite(eff).all()
                                                   and (eff > 0).all()):
            fail(f"phase 6 {name}: efficiencies not all positive and finite: "
                 f"{eff.tolist()}")
        mvals = entry["delta_e"] + entry["u_fov"] + entry["u_eyebox"]
        if len(r6.metrics) != len(designs) or not all(
                math.isfinite(v) for v in mvals):
            fail(f"phase 6 {name}: non-finite metrics {mvals}")
        if not (np.array_equal(r6.histograms[0], solo.histograms[0])
                and r6.bounces[3] == solo.bounces[0]
                and np.array_equal(r6.efficiencies[3], solo.efficiencies[0])):
            fail(f"phase 6 {name}: design 3 differs from its solo sweep")
        if n_launch != 1:
            fail(f"phase 6 {name}: {n_launch} launches for one chunk")
        del r6, solo
    if jax_modules():
        fail(f"the port loaded {jax_modules()}")

    print(json.dumps({"kernels": [{
        "name": "persistent_trace", "route": "cuda", "source": KERNEL_SOURCE,
        "replaces": REPLACES, "launches": main_launches + sweep_launches,
        "max_abs_err": max(m["max_abs_err"] for m in modes),
        "ms": ms_kernel, "plain_ms": ms_plain, "bound_ms": bound2,
        "bound_by": bound_by2, "library_ms": None, "modes": modes}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
