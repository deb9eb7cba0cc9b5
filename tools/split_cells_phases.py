#!/usr/bin/env python3
"""Where a launch of the per-cell splitting kernel spends its time, on one
NVIDIA GPU: per phase of a cell's step in ``csrc/split_cells.cu``.

    python3 tools/split_cells_phases.py [--record PATH] [--check] [--reps 3]

Run from the repository root.  It compiles, into a directory of its own
under ``build/kernels/split_cells_phases/``, a copy of the source in which
the phase marks (``SC_MARK``, ``SC_COUNT``, ``SC_MAX``; empty in the shipped
build) are defined: each mark is a block barrier after which thread 0 of
block 0 reads the GPU's global timer (``%globaltimer``, nanoseconds) and
adds the time since the previous mark to the phase the mark ends.  The
phase names come from the source's ``// SC_MARK phases:`` line; the marks'
own barriers make the copy a little slower than the shipped kernel.  On
``chip_smoke.py`` phase 21's chunks (``chip_smoke.split_cases``) it times
the shipped kernel with CUDA events (``--reps`` launches after a warm-up),
at its own cluster size and at each other (each held to the first bit for
bit), runs the copy once, holds the copy's outputs to the shipped kernel's bit
for bit, and prints for block 0's cell the time of each phase summed over
the launch, its count and its mean, per step and in all, with the counters
(deposits, passes, passes with deposits, runs of one bin, the longest
run).  ``--check`` also holds the shipped kernel to the plain version on
the card, bit for bit in tiles, steps, peak and work (the ledgers within
1e-6 relative).  ``--record PATH`` writes every number as JSON.  It imports
nothing of JAX.
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
NPHASE = 32
NCOUNT = 8
# the source's SC_COUNT / SC_MAX counters 0-5: block 0's deposits, passes,
# passes with deposits, runs of one bin (each 32 deposits' groups of one
# bin) and the longest, and the cluster size
COUNTS = ("deposits", "passes", "passes_with_deposits", "runs", "longest_run",
          "cluster")

PRELUDE = f"""
#include <cuda_runtime.h>
__device__ unsigned long long g_sc_ns[{NPHASE}];
__device__ unsigned long long g_sc_n[{NPHASE}];
__device__ unsigned long long g_sc_last;
__device__ unsigned long long g_sc_cnt[{NCOUNT}];
__device__ __forceinline__ unsigned long long sc_now() {{
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}}
#define SC_MARK(k)                                                     \\
  do {{                                                                 \\
    __syncthreads();                                                   \\
    if (blockIdx.x == 0 && threadIdx.x == 0) {{                         \\
      const unsigned long long t_ = sc_now();                          \\
      if ((k) > 0) {{                                                   \\
        g_sc_ns[k] += t_ - g_sc_last;                                  \\
        g_sc_n[k] += 1;                                                \\
      }}                                                                \\
      g_sc_last = t_;                                                  \\
    }}                                                                  \\
  }} while (0)
#define SC_COUNT(k, v)                                                 \\
  do {{                                                                 \\
    if (blockIdx.x == 0)                                               \\
      atomicAdd(&g_sc_cnt[k], (unsigned long long)(v));                \\
  }} while (0)
#define SC_MAX(k, v)                                                   \\
  do {{                                                                 \\
    if (blockIdx.x == 0)                                               \\
      atomicMax(&g_sc_cnt[k], (unsigned long long)(v));                \\
  }} while (0)
"""

EPILOGUE = f"""
extern "C" int split_cells_phase_reset() {{
  unsigned long long z[{NPHASE}] = {{0}};
  cudaError_t e = cudaMemcpyToSymbol(g_sc_ns, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_sc_n, z, sizeof(z));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_sc_cnt, z, {NCOUNT} * sizeof(long long));
  return (int)e;
}}

extern "C" int split_cells_phase_read(unsigned long long* ns,
                                      unsigned long long* n,
                                      unsigned long long* cnt) {{
  cudaError_t e = cudaMemcpyFromSymbol(ns, g_sc_ns, {NPHASE} * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(n, g_sc_n, {NPHASE} * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, g_sc_cnt, {NCOUNT} * 8);
  return (int)e;
}}
"""


def fail(msg: str) -> None:
    print(f"split_cells_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_names(src: str) -> list:
    """The names after ``// SC_MARK phases:``: mark k ends phase k."""
    m = re.search(r"^// SC_MARK phases:(.*)$", src, re.M)
    if not m or "#ifndef SC_MARK" not in src:
        fail("csrc/split_cells.cu has no SC_MARK phase list")
    return ["start"] + m.group(1).split()


def build_copy(build, splitting) -> ctypes.CDLL:
    out_dir = build.BUILD_DIR / "split_cells_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "split_cells_marks.cu"
    cu.write_text(PRELUDE + (build.CSRC / "split_cells.cu").read_text()
                  + EPILOGUE)
    so = out_dir / "split_cells_marks.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc: {proc.stdout}{proc.stderr}")
    lib = splitting.bind_library(ctypes.CDLL(str(so)))
    lib.split_cells_phase_reset.restype = ctypes.c_int
    lib.split_cells_phase_read.argtypes = [ctypes.c_void_p] * 3
    lib.split_cells_phase_read.restype = ctypes.c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH")
    parser.add_argument("--check", action="store_true",
                        help="also hold the kernel to its plain version")
    parser.add_argument("--reps", type=int, default=3)
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, splitting,
    )

    import chip_smoke

    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip().splitlines()[0]
    print(f"card: {card}", flush=True)
    names = phase_names((build.CSRC / "split_cells.cu").read_text())
    shipped = splitting.load_kernel()
    copy = build_copy(build, splitting)
    record = {"card": card, "phases": names[1:], "cases": {}}
    for name, trace, cells, seeds, reps, _ in chip_smoke.split_cases(dev):
        a = trace.args(cells, seeds)
        out = splitting.launch_split_cells(a)
        torch.cuda.synchronize()
        shape = dict(splitting.last_launch["split_cells"])
        r = {"cells": a.C, "points": a.P, "capacity": a.capacity,
             "launch": shape,
             "ms": chip_smoke.cuda_ms(
                 lambda: splitting.launch_split_cells(a), opts.reps),
             "ms_by_cluster": {}}
        for q in splitting.CLUSTER_SIZES:
            differ = chip_smoke.split_bits_differ(
                splitting.launch_split_cells(a, cluster=q), out)
            if any(differ.values()):
                fail(f"{name}: clusters of {q} differ from the launch's "
                     f"own size: {differ}")
            r["ms_by_cluster"][q] = chip_smoke.cuda_ms(
                lambda: splitting.launch_split_cells(a, cluster=q),
                opts.reps)
        splitting._LIB = copy
        try:
            if copy.split_cells_phase_reset() != 0:
                fail("could not reset the marks")
            got = splitting.launch_split_cells(a)
            torch.cuda.synchronize()
        finally:
            splitting._LIB = shipped
        differ = chip_smoke.split_bits_differ(got, out)
        if any(differ.values()):
            fail(f"{name}: the timed copy differs from the shipped kernel: "
                 f"{differ}")
        ns = (ctypes.c_ulonglong * NPHASE)()
        cnt = (ctypes.c_ulonglong * NPHASE)()
        counters = (ctypes.c_ulonglong * NCOUNT)()
        if copy.split_cells_phase_read(ns, cnt, counters) != 0:
            fail("could not read the marks")
        steps = int(out.steps[0])
        total = sum(ns[1:len(names)]) / 1e3
        r["block0"] = {"steps": steps, "work": int(out.work[0]),
                       "peak": int(out.peak[0]), "marked_us": total,
                       **{k: int(counters[i]) for i, k in enumerate(COUNTS)}}
        r["phase_us"] = {}
        for k in range(1, len(names)):
            if cnt[k]:
                r["phase_us"][names[k]] = {
                    "total": ns[k] / 1e3, "count": int(cnt[k]),
                    "mean": ns[k] / 1e3 / cnt[k],
                    "per_step": ns[k] / 1e3 / max(steps, 1),
                    "share": ns[k] / 1e3 / total if total else 0.0}
        if opts.check:
            ref = splitting.split_cells_reference(a)
            torch.cuda.synchronize()
            e = chip_smoke.split_compare(out, ref)
            r["plain_equal"] = bool(e["ok"] and e["bits_differ"] == 0)
            if not r["plain_equal"]:
                fail(f"{name}: the kernel differs from its plain version: "
                     f"{e}")
        record["cases"][name] = r
        split = ", ".join(f"{k} {v['per_step']:.2f}"
                          for k, v in r["phase_us"].items())
        counted = {k: r["block0"][k] for k in COUNTS}
        print(f"{name}: {a.C} cells, K {a.capacity}: kernel {r['ms']:.3f} ms "
              f"({json.dumps(shape)}; by cluster size "
              f"{json.dumps(r['ms_by_cluster'])}); block 0's cell: {steps} "
              f"steps, {r['block0']['work']:,} slot-steps, {total:.1f} µs "
              f"marked; µs a step: {split}; counters {json.dumps(counted)}"
              + (f"; plain version equal {r['plain_equal']}"
                 if opts.check else ""), flush=True)
        del a, out, got
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
