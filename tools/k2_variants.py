#!/usr/bin/env python3
"""Launch shapes and register caps of the per-cell kernel (K2) on one
NVIDIA GPU, each held bit for bit to the wrapper's own launch.

    python3 tools/k2_variants.py [--record PATH] [--builds 256:1,128:10,...]
                                 [--p7-shapes 128:15,256:4,...]
                                 [--p8-shapes 128:4,256:1,...] [--reps 5]
                                 [--parent-src DIR]

Run from the repository root.  Next to the shipped build of
``csrc/cell_trace.cu`` (launch bounds of 128 threads) it compiles, into
files of its own under ``build/kernels/k2_variants/``, one copy of the
source for each ``MAX_THREADS:MIN_BLOCKS`` of ``--builds``: the widest block
the copy takes and the blocks per SM its ``__launch_bounds__`` ask for,
which caps registers (65,536 / (MAX_THREADS x MIN_BLOCKS)).  It prints each
build's registers, spills and resident blocks per SM.  Then it times
full-mode launches with the whole 100,000-iteration budget on two fixtures
of the paper design:

- ``p7``: ``chip_smoke.py`` phase 7's 144 cells (8 x 6 FoV x 3 wavelengths)
  of 5,000 rays (5,120 slots);
- ``p8``: one batch of the cell engine at full width, the first 2,048 of
  the reference workload's 22,500 cells, 5,000 rays each;

at each launch shape ``threads:blocks_per_cell`` and each build that takes
it, in two rounds (the second in reverse order), with CUDA events over
``--reps`` launches after a warm-up.  Every variant's outputs must equal the
shipped launch's bit for bit, or the script exits 1.  It also reports the
lane occupancy a one-thread-per-ray design would have on each fixture (from
the plain version's per-ray iteration counts).  With ``--parent-src DIR``
(the ``csrc/`` of an earlier tree whose ``cell_trace_launch`` takes one
block width and no blocks per cell, one thread per ray) it also builds that
kernel with the same flags and times it on both fixtures, parent, shipped,
shipped, parent, each launch held bit for bit to the shipped one.

Last, whether warps that mix interaction groups cost time: phase 7's rays
after 24 iterations are resumed with the rest of the budget from two
orders of the same tile, live rays first in their own order (what the
segmented scheduler's compaction gives) and live rays sorted by group (IC,
FC, OC), so that a warp's first claims share a group; each output of the
one, put back in ray order, must equal the other's.  ``--record PATH``
writes every number as JSON.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def fail(msg: str) -> None:
    print(f"k2_variants: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def pairs(text: str):
    return [tuple(int(v) for v in s.split(":")) for s in text.split(",")]


def ptxas_lines(log: str) -> list:
    return [ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln]


def compile_kernel(build, src: Path, out: Path) -> str:
    """``src`` built with the shared flags into ``out``; returns the log."""
    out.parent.mkdir(parents=True, exist_ok=True)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                           str(build.CSRC), "-o", str(out), str(src)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"{src} did not build:\n{proc.stderr}")
    return proc.stdout + proc.stderr


def bind(lib, n_ints: int):
    lib.cell_trace_launch.argtypes = ([ctypes.c_void_p] * 10
                                      + [ctypes.c_int] * n_ints
                                      + [ctypes.c_void_p])
    lib.cell_trace_launch.restype = ctypes.c_int
    return lib


def build_variant(build, tc, max_threads: int, min_blocks: int):
    """The shipped source with other launch bounds, in its own library."""
    src = (build.CSRC / "cell_trace.cu").read_text()
    for old, new in (
            (f"constexpr int MAX_THREADS = {tc.BLOCK_THREADS};",
             f"constexpr int MAX_THREADS = {max_threads};"),
            ("__launch_bounds__(MAX_THREADS)",
             f"__launch_bounds__(MAX_THREADS, {min_blocks})")):
        if old not in src:
            fail(f"csrc/cell_trace.cu no longer holds {old!r}")
        src = src.replace(old, new)
    cu = build.BUILD_DIR / "k2_variants" / f"cell_trace_{max_threads}_{min_blocks}.cu"
    cu.parent.mkdir(parents=True, exist_ok=True)
    cu.write_text(src)
    log = compile_kernel(build, cu, cu.with_suffix(".so"))
    lib = bind(ctypes.CDLL(str(cu.with_suffix(".so"))), 12)
    lib.cell_trace_occupancy.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.cell_trace_occupancy.restype = ctypes.c_int
    return lib, log


def occupancy(lib, threads: int) -> int:
    out = (ctypes.c_int * 4)()
    if lib.cell_trace_occupancy(threads, ctypes.addressof(out)) != 0:
        fail(f"cell_trace_occupancy failed at {threads} threads")
    return out[0]


def launch(lib, rows, geom, rays, rng, kw, threads, blocks_per_cell=None):
    """One full-mode launch of ``lib``; ``blocks_per_cell=None`` is the
    earlier interface (one thread per ray, no blocks per cell)."""
    import torch

    C, S = rng.shape[0], int(rng[0].numel())
    dep = torch.empty_like(rng)
    nb = torch.zeros((C, 2), dtype=torch.int32, device=rng.device)
    ro = torch.empty((C, 9) + tuple(rng.shape[1:]), dtype=torch.float32,
                     device=rng.device)
    so, go = torch.empty_like(rng), torch.empty_like(rng)
    shape = [threads] + ([] if blocks_per_cell is None else [blocks_per_cell])
    err = lib.cell_trace_launch(
        rows.data_ptr(), geom.data_ptr(), rays.data_ptr(), None,
        rng.data_ptr(), dep.data_ptr(), nb.data_ptr(), ro.data_ptr(),
        so.data_ptr(), go.data_ptr(), C, S, kw["num_fc"], kw["num_oc"],
        *kw["edge_counts"], *kw["eyebox_bins"], kw["max_bounces"], *shape,
        torch.cuda.current_stream().cuda_stream)
    if err != 0:
        fail(f"launch at {shape} failed ({err})")
    return dep, nb, ro, so, go


def time_ms(fn, reps: int) -> float:
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--record", default=None)
    ap.add_argument("--builds", default="256:1,128:10,128:12,128:16")
    ap.add_argument("--p7-shapes", default="128:15,256:4,256:7,128:4,128:20")
    ap.add_argument("--p8-shapes", default="128:4,256:1,256:2,128:1,128:2")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--parent-src", default=None, metavar="DIR")
    opts = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        TraceConfig,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, pipeline, trace_cell as tc,
    )

    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True).stdout.strip()
    print(f"card: {card}")
    record = {"card": card, "builds": {}, "fixtures": {}}

    shipped = tc.load_kernel()
    libs = {(tc.BLOCK_THREADS, 1): (
        shipped, build.build_info["cell_trace"]["log"] or "(built earlier)")}
    for t, k in pairs(opts.builds):
        libs[(t, k)] = build_variant(build, tc, t, k)
    for (t, k), (lib, log) in libs.items():
        widths = [w for w in (256, 128, 64) if w <= t]
        occ = {w: occupancy(lib, w) for w in widths}
        record["builds"][f"{t}:{k}"] = {"ptxas": ptxas_lines(log),
                                        "blocks_per_sm": occ}
        print(f"build {t}:{k}{' (shipped)' if lib is shipped else ''}: "
              f"{' | '.join(ptxas_lines(log))}; blocks per SM at "
              f"{widths} threads: {[occ[w] for w in widths]}")

    def fixture(cfg, n_cells):
        sim = pipeline.Simulator(cfg=cfg, device=dev, engine="cell")
        cells = np.arange(n_cells)
        rays, rng = sim._cell_blocks(cells, cfg.rays_per_fov, 0)
        return (sim.tracer.rows(cells), sim.tracer.geom_row, rays, rng,
                dict(sim.tracer.kw, max_bounces=cfg.max_bounces))

    fixtures = {
        "p7": (fixture(TraceConfig(num_fov_x=8, num_fov_y=6,
                                   rays_per_fov=5000, num_iter=1), 144),
               pairs(opts.p7_shapes)),
        "p8": (fixture(TraceConfig(), 2048), pairs(opts.p8_shapes)),
    }
    for name, ((rows, geom, rays, rng, kw), shp) in fixtures.items():
        C, S = rng.shape[0], int(rng[0].numel())
        ref = tc.cell_trace(rows, geom, rays, rng, **kw)
        *_, its = tc.cell_trace_reference(rows, geom, rays, rng, **kw,
                                          ray_iterations=True)
        bounces = int(ref[1][:, 0].to(torch.int64).sum())
        occ1 = tc.lane_occupancy(its)
        del its
        entry = {"cells": C, "slots": S, "bounces": bounces,
                 "shipped_shape": list(tc.launch_shape(C, S,
                                                       tc._sm_count(dev))),
                 "one_thread_per_ray_lane_occupancy": occ1, "runs": []}
        print(f"{name}: {C} cells x {S} slots, {bounces} bounces; the "
              f"rule's shape {entry['shipped_shape']}; one thread per "
              f"ray would keep {occ1:.4f} of its lanes busy")
        variants = [(key, t, b) for key in libs for t, b in shp
                    if t <= key[0]]
        for order in (variants, variants[::-1]):
            for key, t, b in order:
                lib = libs[key][0]

                def run(lib=lib, t=t, b=b):
                    return launch(lib, rows, geom, rays, rng, kw, t, b)

                out = run()
                torch.cuda.synchronize()
                if not all(torch.equal(a, r) for a, r in zip(out, ref)):
                    fail(f"{name} build {key}, {t}:{b} differs from the "
                         "shipped launch")
                ms = time_ms(run, opts.reps)
                entry["runs"].append({"build": "%d:%d" % key, "threads": t,
                                      "blocks_per_cell": b, "ms": ms,
                                      "bounces_per_s": bounces / ms * 1e3})
                print(f"{name} build {key[0]}:{key[1]}, {t} threads x {b} "
                      f"blocks per cell: {ms:.4f} ms "
                      f"({bounces / ms * 1e3:.4g} bounces/s)")
        record["fixtures"][name] = entry
    record["groups"] = group_orders(tc, fixtures["p7"][0], opts.reps)
    if opts.parent_src:
        record["parent"] = against_parent(tc, build, fixtures, opts)
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=2))
    return 0


def against_parent(tc, build, fixtures, opts) -> dict:
    """The earlier one-thread-per-ray kernel of ``opts.parent_src`` against
    the shipped one, full mode, whole budget: parent, shipped, shipped,
    parent on each fixture."""
    import torch

    src = Path(opts.parent_src).resolve() / "cell_trace.cu"
    out = build.BUILD_DIR / "k2_variants" / "cell_trace_parent.so"
    compile_kernel(build, src, out)
    lib = bind(ctypes.CDLL(str(out)), 11)
    result = {}
    for name, ((rows, geom, rays, rng, kw), _) in fixtures.items():
        def shipped():
            return tc.cell_trace(rows, geom, rays, rng, **kw)

        def parent():
            return launch(lib, rows, geom, rays, rng, kw, 128)

        ref = shipped()
        got = parent()
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, ref)):
            fail(f"{name}: the parent kernel's outputs differ")
        times = {"parent": [], "shipped": []}
        for who in ("parent", "shipped", "shipped", "parent"):
            fn = parent if who == "parent" else shipped
            times[who].append(time_ms(fn, opts.reps))
        print(f"{name} against the parent kernel: parent {times['parent']} "
              f"ms, shipped {times['shipped']} ms")
        result[name] = times
    return result


def group_orders(tc, fix, reps: int) -> dict:
    """Resume phase 7's survivors of 24 iterations from two orders of the
    same tile: live rays first (stable), and live rays sorted by group."""
    import torch

    rows, geom, rays, rng, kw = fix
    _, _, ro, so, rgo = tc.cell_trace(rows, geom, rays, rng,
                                      **dict(kw, max_bounces=24))
    C = so.shape[0]
    st = so.reshape(C, -1)
    group = torch.where(st <= 1, 0, torch.where(st <= 3, 1,
                                                torch.where(st <= 5, 2, 3)))
    rest = dict(kw, max_bounces=kw["max_bounces"] - 24)
    tiles, outs, times = {}, {}, {}
    for name, key in (("live first", (st >= 6).to(torch.uint8)),
                      ("by group", group)):
        order = torch.sort(key, dim=1, stable=True).indices
        tiles[name] = (
            torch.gather(ro.reshape(C, 9, -1), 2,
                         order[:, None].expand(C, 9, -1)).reshape(ro.shape),
            torch.gather(rgo.reshape(C, -1), 1, order).reshape(rgo.shape),
            torch.gather(st, 1, order).reshape(so.shape))
        dep, nb, r_out, s_out, g_out = tc.cell_trace(rows, geom, *tiles[name],
                                                     **rest)
        back = torch.argsort(order, dim=1)   # tile position of each ray
        outs[name] = [nb] + [torch.gather(t.reshape(C, -1), 1, back)
                             for t in (dep, s_out, g_out)] + [
            torch.gather(r_out.reshape(C, 9, -1), 2,
                         back[:, None].expand(C, 9, -1))]
        times[name] = []
    a, b = outs.values()
    if not all(torch.equal(x, y) for x, y in zip(a, b)):
        fail("the two orders of the resume tile give different outputs")
    for name in (*tiles, *reversed(list(tiles))):
        times[name].append(time_ms(
            lambda name=name: tc.cell_trace(rows, geom, *tiles[name], **rest),
            reps))
    live = int((st < 6).sum())
    print(f"groups: {live} live rays of {st.numel()} resumed; live first "
          f"{times['live first']} ms, by group {times['by group']} ms")
    return {"live_rays": live, "ms": times}


if __name__ == "__main__":
    sys.exit(main())
