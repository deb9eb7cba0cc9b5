"""Command-line interface of the port: the ``simulate``, ``sweep``,
``plot-design`` and ``optimize`` subcommands.

    python -m gpu_ray_tracing_for_waveguide_based_ar_display_torch simulate [...]
    python -m gpu_ray_tracing_for_waveguide_based_ar_display_torch sweep [...]
    python -m gpu_ray_tracing_for_waveguide_based_ar_display_torch plot-design [...]
    python -m gpu_ray_tracing_for_waveguide_based_ar_display_torch optimize [...]

``simulate``'s defaults run the main path: the paper design at the reference
workload (100 x 75 FoV x 3 wavelengths, 5,000 rays per FoV x 4 iterations,
each iteration a relaunch in gens spawn, a 100,000-bounce bound, 80 x 120
eyebox bins) through the persistent kernel and write the eye-view PNG
``Eyebox Center View.png`` into the working directory, as the JAX CLI's
``simulate --engine pallas_persistent`` does; ``--image ''`` writes none.
Every engine keeps the histogram on the device and runs the perception and
the float32 colorimetry there, the eye-view image included
(:func:`run_options`); only the metrics and the image leave the device,
unless ``--heatmaps`` or ``--save-histogram`` asks for the histogram.  The
JAX CLI evaluates on the host in float64 whenever it writes the image, so
the printed metrics differ from the JAX CLI's in their last digits.
``--spawn-mode``, ``--spawn-iters``, ``--fold-iterations``, ``--error-bars``,
``--wavelengths``, ``--checkpoint`` and ``--dense-eyebox`` mean what they
mean in the JAX CLI and default as there; ``--spawn-mode count
--fold-iterations`` is the faster path that weighs launch points by their
rays' inverse lifetime.  Only ``--engine`` defaults otherwise: to the
kernel (``persistent``), where the JAX CLI defaults to ``jnp`` (here
``vector``) because its Pallas kernels compile only on a TPU.
``simulate --engine cell`` runs the same workload through the per-cell
kernel: 4 relaunches of 5,000 rays per cell, each batch seeded anew (the
JAX package's ``--engine pallas``); ``--engine vector`` the same relaunches through the
vector tracer in plain PyTorch, in bounce segments with the survivors
compacted between them (the JAX package's ``--engine jnp``);
``--engine splitting`` the zero-variance branch expectation, with
``--rays-per-fov`` launch positions per cell (at most 4,096: a cell's
8,192-slot wavefront holds two children per position).  ``--heatmaps PNG``
writes the per-FoV efficiency heatmaps, one panel per colour.
``sweep``'s run the JAX package's ``sweep --engine pallas_persistent``: 8
coupler periods over 370-405 nm, 256 rays per FoV, gens spawn saturated to
iteration 256, a 2,048-bounce bound, 100 x 75 FoV; ``sweep --engine
vector`` traces the same designs' rays once each through the vector tracer
(the JAX package's default sweep engine, ``jnp``).  All run on ``--device
cuda`` unless ``--device cpu`` asks for the plain PyTorch trace.
``plot-design`` writes the design's k-space, layout and angular-response
plots (matplotlib).
``simulate --tail-boost`` (persistent engine) and ``--tail-exact`` (any
engine) patch the Monte-Carlo-starved tail of the eyebox-uniformity metric
(:mod:`.engine.hybrid`): pilot-selected cells re-resolved by tier-boosted
passes of the persistent kernel, or by the exact splitting engine, spliced
into the perception stack.  ``optimize`` runs Adam on the per-strip grating
apodization (``--params apodization``, the default) or on grating periods
and orientations (``--params lambda_ic,phi_ic``, ``lambda_tied,phi_tied``)
through the differentiable splitting tracer (:mod:`.opt`).
``simulate --mesh N`` shards the persistent engine's cell axis over the N
ranks of a torchrun world (:mod:`.parallel.shard`)::

    python -m torch.distributed.run --standalone --nproc-per-node N \
        -m gpu_ray_tracing_for_waveguide_based_ar_display_torch simulate --mesh N

rank 0 prints the report and writes the files.  ``simulate --profile-dir
DIR`` writes a ``torch.profiler`` trace of the run into DIR.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import os
import sys
import time

import numpy as np

from .config import TraceConfig
from .models import presets


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
                             "neither is installed (pass --image '')")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--design", default="paper_default",
                   choices=sorted(presets.PRESETS), help="design preset")
    p.add_argument("--set", action="append", default=[], dest="overrides",
                   metavar="FIELD=VALUE",
                   help="override a WaveguideDesign field (repeatable)")
    p.add_argument("--fov-x", type=int, default=100, help="FoV grid columns")
    p.add_argument("--fov-y", type=int, default=75, help="FoV grid rows")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--device", default="cuda",
                   help="'cuda' runs the CUDA kernel; 'cpu' its plain "
                        "PyTorch version")


def sweep_designs(args):
    """The design list of ``sweep``: a Cartesian grid of ``--sweep
    FIELD=MIN:MAX:N`` axes, else ``--num-designs`` coupler periods (both
    gratings) over ``--period-min .. --period-max``; returns the designs and
    the swept field names."""
    base = _design(args)
    if not args.sweep:
        periods = np.linspace(args.period_min, args.period_max,
                              args.num_designs)
        return [dataclasses.replace(base, lambda_ic=float(p),
                                    lambda_oc=float(p))
                for p in periods], ["lambda_ic"]
    fields = {f.name for f in dataclasses.fields(base)}
    axes, conv = [], {}
    for spec in args.sweep:
        key, sep, rng = spec.partition("=")
        parts = rng.split(":")
        if not sep or key not in fields or len(parts) != 3:
            raise SystemExit(f"--sweep expects FIELD=MIN:MAX:N over a "
                             f"WaveguideDesign field; got {spec!r}")
        cur = getattr(base, key)
        # bool before int: bool is an int subclass
        if isinstance(cur, (tuple, bool)):
            raise SystemExit(f"--sweep {key}: {type(cur).__name__}-valued "
                             "fields cannot sweep over a linspace; use --set "
                             "per run")
        conv[key] = int if isinstance(cur, int) else float
        vals = np.linspace(float(parts[0]), float(parts[1]), int(parts[2]))
        if conv[key] is int:
            # integer fields (num_fc, num_oc, ...) take the unique rounded
            # grid points
            vals = np.unique(np.rint(vals).astype(int))
        axes.append((key, vals))
    keys = [k for k, _ in axes]
    designs = [dataclasses.replace(base, **{k: conv[k](v)
                                            for k, v in zip(keys, vals)})
               for vals in itertools.product(*(v for _, v in axes))]
    return designs, keys


def sweep_config(args) -> TraceConfig:
    """The trace configuration of ``sweep``."""
    return TraceConfig(num_fov_x=args.fov_x, num_fov_y=args.fov_y,
                       rays_per_fov=args.rays_per_fov,
                       max_bounces=args.max_bounces, seed=args.seed)


def cmd_sweep(args) -> int:
    from .sweep import SweepResult, run_design_sweep, run_design_sweep_persistent

    if args.metrics and args.engine != "persistent":
        print("--metrics requires --engine persistent", file=sys.stderr)
        return 2
    designs, keys = sweep_designs(args)
    cfg = sweep_config(args)

    def run(group):
        if args.engine == "vector":
            return run_design_sweep(group, cfg, device=args.device)
        return run_design_sweep_persistent(
            group, cfg, spawn_iters=args.spawn_iters,
            spawn_mode=args.spawn_mode, slots=args.slots,
            evaluate_metrics=args.metrics, device=args.device)

    # one launch must share strip counts; a sweep over num_fc / num_oc
    # groups designs by count and stitches results back in design order
    t0 = time.perf_counter()
    by_counts = {}
    for i, d in enumerate(designs):
        by_counts.setdefault((d.num_fc, d.num_oc), []).append(i)
    if len(by_counts) == 1:
        res = run(designs)
    else:
        eff = np.empty((len(designs), 3))
        bounces = np.empty(len(designs), np.int64)
        mets = [None] * len(designs)
        for idxs in by_counts.values():
            r = run([designs[i] for i in idxs])
            eff[idxs] = r.efficiencies
            bounces[idxs] = r.bounces
            for j, i in enumerate(idxs):
                mets[i] = r.metrics[j] if r.metrics is not None else None
        res = SweepResult(designs=designs, histograms=None, efficiencies=eff,
                          bounces=bounces,
                          metrics=mets if args.metrics else None)
    wall = time.perf_counter() - t0
    print(f"{len(designs)} designs in {wall:.2f} s "
          f"({len(designs) / wall * 3600:,.0f} designs/hour, "
          f"{int(res.bounces.sum()):,} bounces)")

    def label(d):
        return " ".join(f"{k}={getattr(d, k):.4g}" for k in keys)

    for i, (d, eff) in enumerate(zip(res.designs, res.efficiencies)):
        line = (f"{label(d)} -> efficiency B/G/R = "
                f"{eff[0]*100:6.3f}% {eff[1]*100:6.3f}% {eff[2]*100:6.3f}%")
        if res.metrics is not None:
            m = res.metrics[i]
            line += (f"  dE={m.delta_e:6.2f} u_fov={m.u_fov:.4f} "
                     f"u_eb={m.u_eyebox:.4f}")
        print(line)
    best = int(np.argmax(res.efficiencies.mean(axis=1)))
    print(f"best mean efficiency: design {best} ({label(res.designs[best])})")
    if res.metrics is not None:
        best_de = min(range(len(res.metrics)),
                      key=lambda i: res.metrics[i].delta_e)
        print(f"lowest color dispersion: design {best_de} "
              f"(dE={res.metrics[best_de].delta_e:.2f}, "
              f"{label(res.designs[best_de])})")
    return 0


def _check_matplotlib(args) -> None:
    """``--dense-eyebox PNG`` and ``--heatmaps`` plot with matplotlib: fail
    before the trace when it is missing, not after."""
    needs = [name for flag, name in (
        (args.dense_eyebox and args.dense_eyebox != "-", "--dense-eyebox PNG"),
        (args.heatmaps, "--heatmaps")) if flag]
    if needs:
        try:
            import matplotlib  # noqa: F401
        except ImportError:
            raise SystemExit(f"matplotlib is required for {', '.join(needs)};"
                             " drop the PNG (use '--dense-eyebox -' for the "
                             "metrics only)")


def _host_histogram(hist) -> np.ndarray:
    """The histogram as numpy: a device tensor comes through pinned host
    memory."""
    import torch

    if not isinstance(hist, torch.Tensor):
        return np.asarray(hist)
    if hist.device.type == "cuda":
        buf = torch.empty(hist.shape, dtype=hist.dtype, pin_memory=True)
        buf.copy_(hist)
        return buf.numpy()
    return hist.numpy()


def _check_tail_flags(args) -> None:
    """``--tail-boost`` / ``--tail-exact``: one of them, on a single run
    the splice can patch; refused before the Simulator is built."""
    if args.tail_boost and args.tail_exact:
        raise SystemExit("choose ONE of --tail-boost / --tail-exact")
    if not (args.tail_boost or args.tail_exact):
        return
    which = "--tail-boost" if args.tail_boost else "--tail-exact"
    if args.tail_boost and args.engine != "persistent":
        raise SystemExit(
            "--tail-boost requires --engine persistent (the boost tiers "
            "reuse the persistent kernel's runtime spawn target)")
    for flag, name in ((args.error_bars, "--error-bars"),
                       (args.dense_eyebox, "--dense-eyebox"),
                       (args.checkpoint, "--checkpoint"),
                       (args.wavelengths, "--wavelengths"),
                       (args.mesh, "--mesh")):
        if flag:
            raise SystemExit(
                f"{which} does not compose with {name} (the tail splice "
                "patches the single-run perception stack)")


def _check_mesh_flags(args) -> None:
    """``--mesh N``: the persistent engine, under a torchrun world of N
    ranks; refused before anything is built."""
    if not args.mesh:
        return
    if args.engine != "persistent":
        # the Simulator shards only the persistent engine's cells; running
        # one device silently would defeat the flag
        raise SystemExit(
            "--mesh requires --engine persistent (the other engines run on "
            "one device; the vector engine's mesh path is the "
            "parallel.shard API)")
    launch = (f"python -m torch.distributed.run --standalone "
              f"--nproc-per-node {args.mesh} -m "
              "gpu_ray_tracing_for_waveguide_based_ar_display_torch "
              f"simulate --mesh {args.mesh} ...")
    world = os.environ.get("WORLD_SIZE")
    if world is None:
        raise SystemExit(f"--mesh {args.mesh} runs one process per rank "
                         f"under torchrun: {launch}")
    if int(world) != args.mesh:
        raise SystemExit(f"--mesh {args.mesh}: the torchrun world has "
                         f"{world} ranks; launch {args.mesh}: {launch}")


def run_options(args) -> dict:
    """The keyword arguments ``simulate`` passes to ``Simulator.run`` (and
    to a hybrid's ``run``) for its parsed flags: on every engine the
    histogram stays on the device, and the perception and the colorimetry
    with the eye-view image run there (``histogram_device``,
    ``metrics_device``)."""
    return dict(
        cells_per_batch=args.cells_per_batch,
        wavelengths=(tuple(int(w) for w in args.wavelengths.split(","))
                     if args.wavelengths else None),
        checkpoint_path=args.checkpoint, error_groups=args.error_bars,
        dense_metrics=bool(args.dense_eyebox), histogram_device=True,
        metrics_device=True)


def _tail_hybrid(args, sim):
    """The tail-patched hybrid of ``--tail-boost`` / ``--tail-exact``, or
    None."""
    if args.tail_boost:
        from .engine.hybrid import TailBoostHybrid

        return TailBoostHybrid(sim, tau_select=args.tail_tau_select,
                               tau_target=args.tail_tau_target,
                               max_boost=args.tail_max_boost)
    if args.tail_exact:
        from .engine.hybrid import ExactTailHybrid

        # one launch point per pass = two (TE, TM) branch trees in the buffer
        # at once, which keeps a cell's widest wavefront under 8,192 slots
        # at the 1e-6 threshold
        return ExactTailHybrid(sim, tau=args.tail_tau_select,
                               points_per_pass=1, capacity=8192,
                               max_steps=1024)
    return None


def _tail_report(diags) -> str:
    """The hybrid's line under the metric report."""
    if diags.tail_rays > 0:
        tiers = ", ".join(
            f"{int(k)}x:{v}" for k, v in sorted(diags.tiers.items()))
        return (
            f"  [tail boost: {diags.selected_cells} starvation-risk cells "
            f"(worst pilot window < {diags.tau_select:g}) re-resolved by "
            f"{diags.tail_rays:,} boosted rays in tiers [{tiers}] and "
            f"spliced into the perception stack — the metrics above use "
            f"the patched rows; one-time pilot {diags.pilot_seconds:.1f} s "
            f"+ tail {diags.tail_seconds:.1f} s, MC bulk "
            f"{diags.mc_seconds:.1f} s]")
    return (
        f"  [exact tail: {diags.selected_cells} starvation-risk cells "
        f"(expected worst window < {diags.tau_select:g}) replaced by "
        f"their zero-variance branch expectation and spliced into the "
        f"perception stack — the metrics above use the patched rows; "
        f"pruned weight {diags.exact_pruned:.3g} bounds the threshold "
        f"bias; one-time pilot {diags.pilot_seconds:.1f} s + tail "
        f"{diags.tail_seconds:.1f} s, MC bulk {diags.mc_seconds:.1f} s]")


def cmd_simulate(args) -> int:
    _check_tail_flags(args)
    _check_mesh_flags(args)
    if args.image:
        _check_image_writer()   # fail before the trace, not after it
    _check_matplotlib(args)
    if not args.mesh:
        return _simulate(args, None)
    import torch
    import torch.distributed as dist

    from .parallel.shard import make_mesh

    mesh = make_mesh((args.mesh,), ("cells",),
                     device_type=torch.device(args.device).type)
    try:
        return _simulate(args, mesh)
    finally:
        dist.destroy_process_group()


def vector_segmented(device) -> bool:
    """Whether ``simulate --engine vector`` traces each batch in bounce
    segments with the survivors compacted between them (the ``Simulator``'s
    ``segmented``), on ``device``; both schedules give the same result bit
    for bit.  On the CPU the plain version's steps cost in proportion to
    the batch, so segments win; on a GPU a batch is one kernel launch,
    which compactions between segments only add to."""
    import torch

    return torch.device(device).type != "cuda"


def _simulate(args, mesh) -> int:
    """``simulate``'s run, on one device or (``mesh``) on every rank of
    the mesh; with a mesh rank 0 alone reports and writes files."""
    from .engine.pipeline import Simulator, format_report
    from .parallel.shard import describe_mesh, mesh_device
    from .utils import torch_trace

    cfg = TraceConfig(num_fov_x=args.fov_x, num_fov_y=args.fov_y,
                      rays_per_fov=args.rays_per_fov, num_iter=args.num_iter,
                      max_bounces=args.max_bounces, seed=args.seed,
                      pupil_sampling=args.pupil_sampling)
    sim = Simulator(design=_design(args), cfg=cfg, luts_dir=args.luts_dir,
                    geometry_simplify_tol=args.simplify_tol,
                    device=mesh_device(mesh) if mesh else args.device,
                    persistent_slots=args.slots,
                    engine=args.engine, spawn_mode=args.spawn_mode,
                    spawn_iters=args.spawn_iters,
                    fold_iterations=args.fold_iterations,
                    pers_accum_mode=args.accum_mode,
                    segmented=(args.engine == "vector" and vector_segmented(
                        mesh_device(mesh) if mesh else args.device)),
                    mesh=mesh)
    lead = mesh is None or mesh.get_rank() == 0
    hy = _tail_hybrid(args, sim)
    diags = None
    with torch_trace(args.profile_dir if lead else None,
                     cuda=sim.device.type == "cuda"):
        if hy is not None:
            res, diags = hy.run(verbose=args.verbose, **run_options(args))
        else:
            res = sim.run(verbose=args.verbose and lead,
                          **run_options(args))
    if not lead:
        return 0
    if mesh is not None:
        print(describe_mesh(mesh))
    print(format_report(res))
    if args.profile_dir:
        print(f"profiler trace written into {args.profile_dir}")
    if diags is not None:
        print(_tail_report(diags))
    if res.metric_stderr:
        print("MC standard errors (jackknife over num_iter groups):")
        for k, v in res.metric_stderr.items():
            print(f"  {k:<10} +/- {v:.3g}")
    if res.dense is not None and args.dense_eyebox != "-":
        from .eval.image import save_eyebox_luminance_map

        save_eyebox_luminance_map(args.dense_eyebox, res.dense.eye_luminance)
        print(f"dense eyebox luminance map written to {args.dense_eyebox}")
    if args.image and res.metrics is not None:
        from .eval.image import save_eyebox_center_view

        save_eyebox_center_view(args.image, res.metrics.output_image)
        print(f"Eyebox center view written to {args.image}")
    if args.heatmaps:
        from .eval.image import save_fov_efficiency_heatmaps

        save_fov_efficiency_heatmaps(args.heatmaps,
                                     _host_histogram(res.histogram))
        print(f"FoV efficiency heatmaps written to {args.heatmaps}")
    if args.save_histogram:
        np.save(args.save_histogram, _host_histogram(res.histogram))
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
            "metric_stderr": res.metric_stderr,
        }
        if diags is not None:
            out["tail_boost"] = {
                "mode": "boost" if args.tail_boost else "exact",
                "exact_pruned": diags.exact_pruned,
                "selected_cells": diags.selected_cells,
                "tail_rays": diags.tail_rays,
                "tiers": {str(int(k)): v for k, v in diags.tiers.items()},
                "tau_select": diags.tau_select,
                "tau_target": diags.tau_target,
                "min_pilot_count": diags.min_pilot_count,
                "min_tail_expected": diags.min_tail_expected,
                "pilot_seconds": diags.pilot_seconds,
                "tail_seconds": diags.tail_seconds,
            }
        if res.dense is not None:
            out["dense"] = {
                "delta_e": res.dense.delta_e,
                "u_fov": res.dense.u_fov,
                "u_eyebox": res.dense.u_eyebox,
                "starved_eye_positions": res.dense.starved_eye_positions,
                "eye_positions": list(res.dense.eye_luminance.shape),
            }
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    return 0


def cmd_plot_design(args) -> int:
    from .design.geometry import generate_geometry
    from .design.plotting import plot_design

    geom = generate_geometry(_design(args), args.fov_x, args.fov_y)
    for path in plot_design(geom, prefix=args.prefix):
        print(f"wrote {path}")
    return 0


def cmd_optimize(args) -> int:
    from .design.geometry import generate_geometry
    from .engine.trace_geometry import build_trace_geometry
    from .luts.io import load_or_synthesize
    from .luts.packing import build_cell_tables
    from .opt import optimize_apodization, optimize_grating

    cfg = TraceConfig(num_fov_x=args.fov_x, num_fov_y=args.fov_y,
                      rays_per_fov=args.rays_per_fov,
                      max_bounces=args.max_bounces, seed=args.seed)
    geom = generate_geometry(_design(args), args.fov_x, args.fov_y)
    luts = load_or_synthesize(geom, args.luts_dir)
    tables = build_cell_tables(geom, luts)
    tgeom = build_trace_geometry(geom)
    t0 = time.perf_counter()
    kw = dict(rays_per_fov=args.rays_per_fov, steps=args.steps,
              learning_rate=args.lr, capacity=args.capacity,
              fixed_steps=args.trace_steps, pupil_bins=args.pupil_loss,
              device=args.device)
    if args.params == "apodization":
        res = optimize_apodization(geom, tables, tgeom, cfg, **kw)
    else:
        opt_params = tuple(s.strip() for s in args.params.split(","))
        res = optimize_grating(geom, tables, tgeom, cfg,
                               opt_params=opt_params, **kw)
    wall = time.perf_counter() - t0
    print(f"{args.steps} Adam steps in {wall:.1f} s; "
          f"loss {res.loss_history[0]:.4f} -> {res.loss_history[-1]:.4f}")
    print(f"efficiency  {res.efficiency[0]*100:.3f}% -> "
          f"{res.efficiency[1]*100:.3f}%")
    print(f"FoV nonuniformity  {res.nonuniformity[0]:.3f} -> "
          f"{res.nonuniformity[1]:.3f}")
    if args.params == "apodization":
        print("s_fc:", " ".join(f"{s:.3f}" for s in res.s_fc))
        print("s_oc:", " ".join(f"{s:.3f}" for s in res.s_oc))
        payload = {"s_fc": res.s_fc.tolist(), "s_oc": res.s_oc.tolist()}
    else:
        for k, v in res.params.items():
            print(f"{k}: {getattr(geom.design, k):.4f} -> {v:.4f}")
        payload = {"params": res.params}
    if args.json:
        with open(args.json, "w") as f:
            json.dump({
                **payload,
                "loss_history": res.loss_history.tolist(),
                "efficiency": res.efficiency,
                "nonuniformity": res.nonuniformity,
            }, f, indent=2)
        print(f"wrote {args.json}")
    return 0


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="gpu_ray_tracing_for_waveguide_based_ar_display_torch",
        description="Waveguide AR display ray tracer (PyTorch + CUDA)")
    sub = parser.add_subparsers(dest="command", required=True)

    p = sub.add_parser("simulate",
                       help="full-color Monte-Carlo simulation + metrics")
    _add_common(p)
    p.add_argument("--luts-dir", default=None,
                   help="directory with lut_*_fullColor.npy (synthetic if absent)")
    p.add_argument("--rays-per-fov", type=int, default=5000)
    p.add_argument("--engine", default="persistent",
                   choices=("persistent", "cell", "vector", "splitting"),
                   help="persistent = slot-persistent kernel; "
                        "cell = per-cell kernel, every ray seeded anew; "
                        "vector = the vector tracer in plain PyTorch (the "
                        "JAX engine jnp), compacted between bounce segments; "
                        "splitting = deterministic zero-variance transport: "
                        "the exact branch expectation, --rays-per-fov "
                        "becomes the launch positions per cell (small grids)")
    p.add_argument("--num-iter", type=int, default=4,
                   help="iterations: relaunched, each seeded anew, or folded "
                        "into one spawn target per cell (persistent, "
                        "--fold-iterations)")
    p.add_argument("--spawn-mode", default="gens", choices=("gens", "count"),
                   help="persistent engine's respawn: gens = a quota of "
                        "generations per slot, every launch point weighed "
                        "equally (the default, as in the JAX CLI); count = "
                        "a per-cell spawn target, faster, but it weighs "
                        "launch points by their rays' inverse lifetime")
    p.add_argument("--spawn-iters", type=int, default=0,
                   help="saturating-spawn iteration budget (persistent; 0 = "
                        "off)")
    p.add_argument("--fold-iterations", default=False,
                   action=argparse.BooleanOptionalAction,
                   help="trace num_iter x rays_per_fov in one pass per cell "
                        "(persistent; continued RNG streams, the drain tail "
                        "paid once); off by default, as in the JAX CLI: "
                        "one relaunch per iteration.  --spawn-mode count "
                        "--fold-iterations is the fast, biased path")
    p.add_argument("--error-bars", action="store_true",
                   help="jackknife Monte-Carlo standard errors over the "
                        "num_iter groups (persistent; needs num_iter >= 2, "
                        "suspends folding)")
    p.add_argument("--wavelengths", default=None,
                   help="comma-separated wavelength indices to trace (e.g. "
                        "'1' = green only)")
    p.add_argument("--checkpoint", default=None,
                   help="resumable checkpoint path (.npz)")
    p.add_argument("--dense-eyebox", default=None, metavar="PNG", nargs="?",
                   const="-",
                   help="also evaluate the metrics at every valid eye "
                        "position and, given a PNG path (needs matplotlib), "
                        "save the full-resolution eyebox luminance map; "
                        "'-' or no value: metrics only")
    p.add_argument("--max-bounces", type=int, default=100_000)
    p.add_argument("--cells-per-batch", type=int, default=2048)
    p.add_argument("--slots", type=int, default=2048,
                   help="persistent slots per cell (persistent engine)")
    p.add_argument("--accum-mode", default="fma",
                   choices=("fma", "select", "packed"),
                   help="persistent engine's parameter selection: fma = exact "
                        "float32 records (select: the same values); packed = "
                        "records rounded to bfloat16, within Monte-Carlo "
                        "tolerance of fma, not bitwise")
    p.add_argument("--simplify-tol", type=float, default=0.0)
    p.add_argument("--pupil-sampling", default="uniform",
                   choices=("uniform", "r2"))
    p.add_argument("--image", default="Eyebox Center View.png",
                   help="write the eye-view PNG here, from the device "
                        "colorimetry's image (needs cv2 or PIL; '' writes "
                        "none)")
    p.add_argument("--heatmaps", default="", metavar="PNG",
                   help="write the 3-panel per-FoV efficiency heatmaps here "
                        "(needs matplotlib)")
    p.add_argument("--json", default=None, help="write metrics JSON here")
    p.add_argument("--save-histogram", default=None, metavar="PATH",
                   help="write the (L, FoVy, FoVx, 80, 120) histogram as .npy")
    p.add_argument("--tail-boost", action="store_true",
                   help="tail-patched transport (engine/hybrid.py): "
                        "pilot-selected starvation-risk (FoV, eye-window) "
                        "cells are re-resolved by tier-boosted passes of "
                        "the same kernel and spliced into the perception "
                        "stack, so u_eyebox carries information at default "
                        "budgets (requires --engine persistent)")
    p.add_argument("--tail-exact", action="store_true",
                   help="like --tail-boost, but the tail rows are the exact "
                        "branch expectation of the per-cell splitting "
                        "engine (zero variance); works with any bulk engine")
    p.add_argument("--tail-tau-select", type=float, default=30.0,
                   metavar="COUNT", help="select cells whose worst pilot "
                                         "window count is below this")
    p.add_argument("--tail-tau-target", type=float, default=20.0,
                   metavar="COUNT", help="post-boost expected count floor "
                                         "of the worst window")
    p.add_argument("--tail-max-boost", type=float, default=1024.0,
                   metavar="X", help="boost tier cap (bounds the tail's cost "
                                     "for windows dark by the physics)")
    p.add_argument("--mesh", type=int, default=0, metavar="N",
                   help="shard the persistent engine's cell axis over the N "
                        "ranks of a torchrun world (python -m "
                        "torch.distributed.run --nproc-per-node N ...); N "
                        "must divide each batch's cell count")
    p.add_argument("--profile-dir", default="", metavar="DIR",
                   help="write a torch.profiler trace of the run into DIR")
    p.add_argument("--verbose", action="store_true")
    p.set_defaults(fn=cmd_simulate)

    p = sub.add_parser("plot-design",
                       help="k-space / layout / angular-response plots")
    _add_common(p)
    p.add_argument("--prefix", default="design", help="output file prefix")
    p.set_defaults(fn=cmd_plot_design)

    p = sub.add_parser("sweep", help="batched design sweep (default: coupler "
                                     "period; --sweep for arbitrary fields)")
    _add_common(p)
    p.add_argument("--num-designs", type=int, default=8)
    p.add_argument("--period-min", type=float, default=370.0)
    p.add_argument("--period-max", type=float, default=405.0)
    p.add_argument("--sweep", action="append", default=[],
                   metavar="FIELD=MIN:MAX:N",
                   help="sweep any WaveguideDesign field over a linspace "
                        "(repeatable; multiple axes form a Cartesian grid), "
                        "e.g. --sweep lambda_ic=370:405:16 "
                        "--sweep thickness=0.5:0.9:4")
    p.add_argument("--rays-per-fov", type=int, default=256)
    p.add_argument("--max-bounces", type=int, default=2048)
    p.add_argument("--engine", default="persistent",
                   choices=("persistent", "vector"),
                   help="persistent = the slot-persistent kernel; vector = "
                        "the vector tracer, every design's rays traced once")
    p.add_argument("--spawn-iters", type=int, default=256,
                   help="saturating-spawn budget (iterations)")
    p.add_argument("--spawn-mode", default="gens", choices=("gens", "count"),
                   help="count = exact per-cell sample target (set "
                        "--spawn-iters 0 with it)")
    p.add_argument("--slots", type=int, default=None,
                   help="persistent lanes per cell (default "
                        "min(rays_per_fov, 2048))")
    p.add_argument("--metrics", action="store_true",
                   help="also evaluate the display metrics per design on "
                        "the device and report the lowest-dispersion design "
                        "(persistent engine)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser(
        "optimize",
        help="gradient-based grating design (differentiable splitting "
             "tracer + Adam)")
    _add_common(p)
    p.add_argument("--luts-dir", default=None,
                   help="directory with lut_*_fullColor.npy (synthetic if absent)")
    p.add_argument("--rays-per-fov", type=int, default=16)
    p.add_argument("--max-bounces", type=int, default=2048)
    p.add_argument("--steps", type=int, default=40, help="Adam steps")
    p.add_argument("--lr", type=float, default=0.15)
    p.add_argument("--capacity", type=int, default=4096,
                   help="splitting wavefront buffer slots")
    p.add_argument("--trace-steps", type=int, default=64,
                   help="fixed differentiable trace depth (steps)")
    p.add_argument("--params", default="apodization",
                   help="'apodization' (per-strip amplitudes) or a comma "
                        "list of grating parameters, e.g. 'lambda_ic,phi_ic' "
                        "or 'lambda_tied,phi_tied' (differentiable analytic "
                        "tables)")
    p.add_argument("--pupil-loss", type=int, default=0, metavar="BINS",
                   help="score the eyebox-uniformity loss term on "
                        "pupil-integrated radiance (a disc of BINS bins over "
                        "every valid eye position, what the evaluation "
                        "metrics measure) instead of raw 0.1 mm bins; 30 = "
                        "the 3 mm evaluation pupil")
    p.add_argument("--json", default=None, help="write the optimized design here")
    p.set_defaults(fn=cmd_optimize)
    return parser


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
