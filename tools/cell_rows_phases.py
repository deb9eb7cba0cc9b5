#!/usr/bin/env python3
"""Where a launch of the cell-rows kernel spends its time, on one NVIDIA
GPU: per phase of ``csrc/cell_rows.cu`` (or another version of it), with
its achieved HBM rate, and the lane instructions of the calls its float64
and float32 arithmetic makes.

    python3 tools/cell_rows_phases.py [--record PATH] [--cases a,b]
        [--reps 10] [--src PATH]

Run from the repository root.  It compiles, into
``build/kernels/cell_rows_phases/``, the source as it is and a copy in
which the marks (``ROWS_BEGIN``, ``ROWS_MARK``, ``ROWS_END``; empty in the
shipped build) are defined.  A mark ends the phase its number names (the
source's ``// ROWS_MARK phases:`` line): every thread reads the SM's cycle
counter (``clock64``) and adds the cycles since its previous mark to that
phase, in registers; the sums over all threads (lane-cycles) give each
phase's share.  A source without the line (the kernel as it was before its
redesign: a block a tile of 16 rows, the tile zeroed, the Jones items, the
scalar columns on 16 threads, the copy-out) gets marks at its zeroing and
barrier, its Jones items, its scalar columns, its second barrier and its
copy-out.  Each case's rows from both builds are held to the shipped
kernel's (``engine/cell_rows.py::launch_rows``) bit for bit; the kernel's
time is the unmarked build's (CUDA events, ``--reps`` launches behind
device spin).  The achieved rate: the rows written once and the inputs read
once over that time (``chip_smoke.py`` phase 19's bytes).  The cases are
phase 19's: the reference design (22,500 cells), the README's count sweep
(6b, 16 designs) and the CLI's default sweep (6c, 8 designs).  With the
lane instructions of ``__ddiv_rn``, ``__dsqrt_rn`` and IEEE float division
from their SASS (``tools/sass_paths.py``), it recounts the operation bound:
the larger of the FP64 instructions over the FP64 lanes' rate and all
instructions over the issue rate.  ``--record PATH`` writes every number
as JSON.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
NPHASE = 8

PRELUDE = f"""
#include <cuda_runtime.h>
__device__ unsigned long long g_rows_cycles[{NPHASE}];
#define ROWS_BEGIN()                                                   \\
  unsigned long long rows_acc_[{NPHASE}] = {{0}};                        \\
  unsigned long long rows_last_ = clock64()
#define ROWS_MARK(k)                                                   \\
  do {{                                                                 \\
    const unsigned long long t_ = clock64();                           \\
    rows_acc_[k] += t_ - rows_last_;                                   \\
    rows_last_ = t_;                                                   \\
  }} while (0)
#define ROWS_END()                                                     \\
  do {{                                                                 \\
    _Pragma("unroll")                                                  \\
    for (int k_ = 0; k_ < {NPHASE}; ++k_)                               \\
      if (rows_acc_[k_]) atomicAdd(&g_rows_cycles[k_], rows_acc_[k_]); \\
  }} while (0)
"""

EPILOGUE = f"""
extern "C" int rows_phase_reset() {{
  unsigned long long z[{NPHASE}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_rows_cycles, z, sizeof(z));
}}

extern "C" int rows_phase_read(unsigned long long* cycles) {{
  return (int)cudaMemcpyFromSymbol(cycles, g_rows_cycles, {NPHASE} * 8);
}}
"""

# the kernel before its redesign: marks at its zeroing and barrier, Jones
# items, scalar columns, second barrier and copy-out
PARENT_MARKS = (
    ("  __shared__ __align__(16) float tile[TILE * PC];\n",
     "  __shared__ __align__(16) float tile[TILE * PC];\n  ROWS_BEGIN();\n"),
    ("tile[k] = 0.0f;\n  __syncthreads();\n",
     "tile[k] = 0.0f;\n  __syncthreads();\n  ROWS_MARK(1);\n"),
    ("  // the scalar columns, one thread per row\n",
     "  ROWS_MARK(2);\n  // the scalar columns, one thread per row\n"),
    ("  }\n  __syncthreads();\n\n  // the tile's rows are contiguous",
     "  }\n  ROWS_MARK(3);\n  __syncthreads();\n  ROWS_MARK(4);\n\n"
     "  // the tile's rows are contiguous"),
    ("out[k] = src[k];\n}",
     "out[k] = src[k];\n  ROWS_MARK(5);\n  ROWS_END();\n}"),
)

# float64 operations of a (branch, row) item besides its division and
# square root: the scale's two products, eight real-times-complex products
# of 6 operations; float32 operations of a row's scalar columns besides its
# three divisions
ITEM_F64_PLAIN = 2 + 8 * 6
ROW_F32_PLAIN = 11
ROW_F32_DIVS = 3


def fail(msg: str) -> None:
    print(f"cell_rows_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def marked_source(src: str) -> tuple:
    """``(source with marks, phase names, parent)``: the source's own marks,
    or the parent kernel's inserted."""
    parent = "// ROWS_MARK phases:" not in src
    if parent:
        for old, new in PARENT_MARKS:
            if src.count(old) != 1:
                fail(f"the source has no ROWS_MARK line and is not the "
                     f"parent kernel (no {old!r})")
            src = src.replace(old, new)
        src = "// ROWS_MARK phases: zero jones scalars barrier store\n" + src
    m = re.search(r"^// ROWS_MARK phases:(.*)$", src, re.M)
    return src, ["start"] + m.group(1).split(), parent


def build_libs(build, cr, src: str, marked: str) -> tuple:
    """The source as it is and its marked copy, compiled side by side;
    each build's registers and spills from ``-Xptxas -v``."""
    out_dir = build.BUILD_DIR / "cell_rows_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, text in (("plain", src), ("marks", PRELUDE + marked
                                       + EPILOGUE)):
        cu = out_dir / f"cell_rows_{tag}.cu"
        cu.write_text(text)
        so = out_dir / f"cell_rows_{tag}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs.append((tag, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs, logs = [], {}
    for tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc ({tag}): {log}")
        logs[tag] = " | ".join(ln.strip() for ln in log.splitlines()
                               if "registers" in ln or "spill" in ln)
        print(f"{tag} build: {logs[tag]}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.cell_rows_launch.argtypes = cr.LAUNCH_ARGTYPES
        lib.cell_rows_launch.restype = ctypes.c_int
        lib.cell_rows_error_string.argtypes = [ctypes.c_int]
        lib.cell_rows_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    libs[1].rows_phase_read.argtypes = [ctypes.c_void_p]
    return libs[0], libs[1], logs


def launch(lib, args, inputs, bins):
    """``lib``'s rows of ``inputs`` (as ``cell_rows.launch_rows`` calls
    it)."""
    import numpy as np
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        cell_rows as cr,
    )

    D, C = inputs.D, inputs.C
    rows = torch.empty((D * C, cr.PC), dtype=torch.float32,
                       device=args[0].device)
    err = lib.cell_rows_launch(
        *(a.data_ptr() for a in args), rows.data_ptr(), D, C,
        inputs.M * inputs.N, len(inputs.table), inputs.num_fc,
        inputs.num_oc, int(bins[0]), int(bins[1]),
        float(np.float32(cr._EDGE_TOL)), torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"launch: {lib.cell_rows_error_string(err).decode()}")
    return rows


def cases():
    """phase 19's cases: name and the designs' geometries and rects."""
    import numpy as np
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
        WaveguideDesign,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.design import (
        generate_geometry,
    )

    g = generate_geometry(WaveguideDesign(), 100, 75)
    yield "reference", [g], g.eyebox_range
    for name, argv in (("6b", ["sweep", "--num-designs", "16", "--spawn-mode",
                               "count", "--spawn-iters", "0",
                               "--rays-per-fov", "2048"]),
                       ("6c", ["sweep"])):
        sargs = cli.build_parser().parse_args(argv)
        designs, _ = cli.sweep_designs(sargs)
        cfg = cli.sweep_config(sargs)
        geoms = [generate_geometry(d, cfg.num_fov_x, cfg.num_fov_y)
                 for d in designs]
        yield name, geoms, np.stack([x.eyebox_range for x in geoms])


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH")
    parser.add_argument("--cases", default=None, metavar="LIST",
                        help="comma-separated case names (default: all)")
    parser.add_argument("--reps", type=int, default=10)
    parser.add_argument("--src", default=None, metavar="PATH",
                        help="the source to split (default: the shipped one)")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "tools"))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, cell_rows as cr,
    )

    import chip_smoke
    import sass_paths

    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi()
    clock = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True,
        text=True).stdout.split()
    mhz = float(clock[0]) if clock else 1980.0
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    print(f"card: {card}; max SM clock {mhz:.0f} MHz, {sms} SMs",
          flush=True)
    calls = sass_paths.call_counts(build, build.BUILD_DIR / "sass_paths")
    item_f64 = (ITEM_F64_PLAIN + calls["ddiv_rn"]["path"]
                + calls["dsqrt_rn"]["path"])
    item_f64_fp64 = (ITEM_F64_PLAIN + calls["ddiv_rn"]["fp64"]
                     + calls["dsqrt_rn"]["fp64"])
    row_f32 = ROW_F32_PLAIN + ROW_F32_DIVS * calls["div"]["path"]
    print("SASS fast paths (lane instructions; FP64 of them; static): "
          + ", ".join(f"{k} {calls[k]['path']} ({calls[k]['fp64']}; "
                      f"{calls[k]['static']})"
                      for k in ("ddiv_rn", "dsqrt_rn", "div"))
          + f"; a (branch, row) item {item_f64} instructions, "
          f"{item_f64_fp64} of them FP64; a row's scalar columns "
          f"{row_f32}", flush=True)
    src_path = Path(opts.src or build.CSRC / "cell_rows.cu")
    src = src_path.read_text()
    marked, names, parent = marked_source(src)
    plain_lib, marks_lib, logs = build_libs(build, cr, src, marked)
    record = {"card": card, "max_sm_mhz": mhz, "sms": sms,
              "src": opts.src or "csrc/cell_rows.cu", "parent_form": parent,
              "phases": names[1:], "builds": logs, "sass_calls": calls,
              "item_instructions": item_f64,
              "item_fp64_instructions": item_f64_fp64,
              "row_f32_instructions": row_f32, "cases": {}}
    bins = (80, 120)
    wanted = set(opts.cases.split(",")) if opts.cases else None
    for name, geoms, eb in cases():
        if wanted is not None and name not in wanted:
            continue
        inputs = cr.synthetic_row_inputs(geoms, seed=1234, pinned=True)
        args = cr.upload_inputs(inputs, eb, dev)
        ship = cr.launch_rows(args, inputs, bins)
        got = launch(plain_lib, args, inputs, bins)
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(lambda: launch(plain_lib, args, inputs,
                                                 bins), opts.reps)
        if marks_lib.rows_phase_reset() != 0:
            fail("could not reset the marks")
        torch.cuda.synchronize()
        torch.cuda._sleep(170_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        got_m = launch(marks_lib, args, inputs, bins)
        t1.record()
        torch.cuda.synchronize()
        same = [bool(torch.equal(x.view(torch.int32), ship.view(torch.int32)))
                for x in (got, got_m)]
        if not all(same):
            fail(f"{name}: the source's kernel or its marked copy differs "
                 f"from the shipped kernel (plain, marked: {same})")
        cycles = (ctypes.c_ulonglong * NPHASE)()
        if marks_lib.rows_phase_read(cycles) != 0:
            fail("could not read the marks")
        marked_ms = t0.elapsed_time(t1)
        total = sum(cycles[k] for k in range(1, len(names)))
        n = ship.shape[0]
        nbytes = ship.numel() * 4 + sum(a.numel() * a.element_size()
                                        for a in args)
        t_bytes = nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3
        # the FP64 pipe's lanes, or every instruction at the issue rate
        items = len(inputs.table) * n
        t_ops = max(items * item_f64_fp64 / chip_smoke.PEAK_FP64_LANES,
                    (items * item_f64 + n * row_f32)
                    / chip_smoke.PEAK_FP32_ADDS) * 1e3
        r = {"designs": inputs.D, "rows": n, "branches": len(inputs.table),
             "ms": ms, "marked_ms": marked_ms, "bytes": nbytes,
             "gb_s": nbytes / (ms * 1e-3) / 1e9, "bound_bytes_ms": t_bytes,
             "bound_ops_ms": t_ops, "lane_cycles": total, "phases": {}}
        for k in range(1, len(names)):
            share = cycles[k] / total if total else 0.0
            r["phases"][names[k]] = {"share": share,
                                     "lane_cycles": int(cycles[k])}
        record["cases"][name] = r
        split = ", ".join(f"{k} {v['share'] * 100:.1f} %"
                          for k, v in r["phases"].items())
        print(f"{name}: {inputs.D} design(s), {n:,} rows, "
              f"{len(inputs.table)} branches: kernel {ms:.4f} ms "
              f"({r['gb_s']:.0f} GB/s of {nbytes / 1e6:.1f} MB), marked "
              f"copy {marked_ms:.4f} ms (both equal to the shipped kernel "
              f"bit for bit); bound: bytes {t_bytes:.4f} ms, operations "
              f"{t_ops:.4f} ms; lane-cycles by phase: {split}", flush=True)
        del ship, got, got_m, args, inputs
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
