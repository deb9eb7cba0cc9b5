#!/usr/bin/env python3
"""What the parts of the per-cell splitting kernel cost, on one NVIDIA GPU:
variants of ``csrc/split_cells.cu`` timed against the shipped kernel.

    python3 tools/split_cells_variants.py [--variants a,b] [--cases a,b]
        [--barriers] [--record PATH]

Run from the repository root.  Each variant is the shipped source (and its
headers) with a few lines replaced, compiled by ``nvcc`` with the shipped
flags into ``build/kernels/split_cells_variants/<name>/``; its registers
and spills are printed.  On ``chip_smoke.py`` phase 21's chunks
(``chip_smoke.split_cases``) each variant is timed with CUDA events beside
the shipped kernel (before and after it, in one process), and the entries of
its outputs that differ in their bits from the shipped kernel's are
counted.  A variant that leaves out work (``exact_tests_off``) gives wrong
outputs on purpose: it measures what that work costs.  ``--barriers`` also
times a block barrier, a cluster barrier with its release and acquire
(``cooperative_groups``' ``cluster.sync()``), one with a relaxed arrival,
and a ``__threadfence`` before a block barrier, each 20,000 times in one
launch, at 1, 128 and 256 clusters of 2 and 4 blocks of 256 threads.
``--record PATH`` writes every number as JSON.  It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# name -> (what it measures, [(file, shipped text, replacement)])
VARIANTS = {
    "exact_tests_off": (
        "the warp's exact half-plane tests left out (wrong outputs)",
        [("split_cells.cu",
          "    for (unsigned open = __ballot_sync(FULL, cls == 2 && (k == 0 "
          "|| in[0]));",
          "    for (unsigned open = 0;")]),
    "coarse_grid": (
        "the region grid as PR 16 read it: an open cell tests all three "
        "regions (same outputs)",
        [("split_cells.cu",
          "  return sub_codes[((-1 - v) * sub + sv) * sub + su];",
          "  return 0x2A;")]),
    "three_blocks": (
        "__launch_bounds__(256, 3): 80 registers, three blocks an SM",
        [("split_cells.cu", "constexpr int MIN_BLOCKS = 2;",
          "constexpr int MIN_BLOCKS = 3;")]),
    "step_fence": (
        "a __threadfence before a cluster's step-end barrier",
        [("split_cells.cu",
          "    // barrier's release and acquire order them at cluster scope\n",
          "    // barrier's release and acquire order them at cluster scope\n"
          "    if (Q > 1) __threadfence();\n")]),
}

BARRIER_SRC = r"""
#include <cooperative_groups.h>
#include <cuda_runtime.h>
namespace cg = cooperative_groups;

__global__ void block_bar(int n) {
  for (int i = 0; i < n; ++i) __syncthreads();
}
__global__ void cluster_bar(int n) {
  for (int i = 0; i < n; ++i) cg::this_cluster().sync();
}
__global__ void relaxed_bar(int n) {
  for (int i = 0; i < n; ++i) {
    asm volatile("barrier.cluster.arrive.relaxed.aligned;" ::: "memory");
    asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
  }
}
__global__ void fence_bar(int n) {
  for (int i = 0; i < n; ++i) {
    __threadfence();
    __syncthreads();
  }
}

// kind 0-3 as above; returns the microseconds a barrier (-1 on an error)
extern "C" float barrier_us(int kind, int clusters, int q, int n) {
  void (*k[4])(int) = {block_bar, cluster_bar, relaxed_bar, fence_bar};
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(clusters * q);
  cfg.blockDim = dim3(256);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = q;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaLaunchKernelEx(&cfg, k[kind], n);
  cudaEventRecord(a);
  cudaLaunchKernelEx(&cfg, k[kind], n);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms = 0.0f;
  cudaEventElapsedTime(&ms, a, b);
  cudaEventDestroy(a);
  cudaEventDestroy(b);
  return cudaGetLastError() == cudaSuccess ? ms * 1e3f / n : -1.0f;
}
"""


def fail(msg: str) -> None:
    print(f"split_cells_variants: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compile_variant(build, name: str, edits: list) -> tuple:
    """Build one variant: (name, library path or None, nvcc's report)."""
    d = build.BUILD_DIR / "split_cells_variants" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in [*build.CSRC.glob("*.cuh"), build.CSRC / "split_cells.cu"]:
        text = src.read_text()
        for fname, old, new in edits:
            if fname == src.name:
                if old not in text:
                    fail(f"{name}: {old!r} is not in csrc/{fname}")
                text = text.replace(old, new)
        (d / src.name).write_text(text)
    so = d / "split_cells.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d),
                           "-o", str(so), str(d / "split_cells.cu")],
                          capture_output=True, text=True)
    return name, so if proc.returncode == 0 else None, proc.stdout + proc.stderr


def barriers(build) -> dict:
    d = build.BUILD_DIR / "split_cells_variants"
    d.mkdir(parents=True, exist_ok=True)
    cu, so = d / "barriers.cu", d / "barriers.so"
    cu.write_text(BARRIER_SRC)
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-o",
                           str(so), str(cu)], capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.barrier_us.argtypes = [ctypes.c_int] * 4
    lib.barrier_us.restype = ctypes.c_float
    out = {}
    kinds = ("block", "cluster", "cluster_relaxed", "fence_block")
    for clusters in (1, 128, 256):
        for q in (1, 2, 4):
            if clusters * q > 528:
                continue
            for kind, label in enumerate(kinds):
                if q == 1 and kind in (1, 2):
                    continue
                us = lib.barrier_us(kind, clusters, q, 20000)
                if us < 0:
                    fail(f"the {label} barrier at {clusters} x {q} failed")
                out[f"{label} {clusters}x{q}"] = us
    print(f"barriers (µs each): {json.dumps(out)}", flush=True)
    return out


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--cases", default=None,
                        help="phase 21's cases to time (default: all)")
    parser.add_argument("--barriers", action="store_true")
    parser.add_argument("--record", default=None, metavar="PATH")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, splitting,
    )

    import chip_smoke

    card = chip_smoke.nvidia_smi()
    print(f"card: {card}", flush=True)
    names = [v for v in opts.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        fail(f"unknown variants {sorted(unknown)}")
    shipped = splitting.load_kernel()
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        built = list(pool.map(lambda v: compile_variant(
            build, v, VARIANTS[v][1]), names))
    record = {"card": card, "variants": {}, "cases": {}}
    libs = {}
    for name, so, log in built:
        if so is None:
            fail(f"{name}: nvcc: {log}")
        record["variants"][name] = {"what": VARIANTS[name][0],
                                    "ptxas": chip_smoke.ptxas_summary(log)}
        print(f"{name} ({VARIANTS[name][0]}): "
              f"{record['variants'][name]['ptxas']}", flush=True)
        libs[name] = splitting.bind_library(ctypes.CDLL(str(so)))
    dev = torch.device("cuda")
    cases = opts.cases.split(",") if opts.cases else None
    for case, trace, cells, seeds, _, _ in chip_smoke.split_cases(dev):
        if cases and case not in cases:
            continue
        a = trace.args(cells, seeds)
        ref = splitting.launch_split_cells(a)
        torch.cuda.synchronize()
        row = {"shipped": chip_smoke.cuda_ms(
            lambda: splitting.launch_split_cells(a), 3)}
        for name, lib in libs.items():
            splitting._LIB = lib
            splitting._SHAPES.clear()
            try:
                got = splitting.launch_split_cells(a)
                torch.cuda.synchronize()
                shape = dict(splitting.last_launch["split_cells"])
                row[name] = {
                    "ms": chip_smoke.cuda_ms(
                        lambda: splitting.launch_split_cells(a), 3),
                    "bits_differ": sum(chip_smoke.split_bits_differ(
                        got, ref).values()),
                    "cluster": shape["cluster"],
                    "blocks_per_sm": shape["blocks_per_sm"]}
            finally:
                splitting._LIB = shipped
                splitting._SHAPES.clear()
        row["shipped_again"] = chip_smoke.cuda_ms(
            lambda: splitting.launch_split_cells(a), 3)
        record["cases"][case] = row
        print(f"{case}: {json.dumps(row)}", flush=True)
    if opts.barriers:
        record["barrier_us"] = barriers(build)
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
