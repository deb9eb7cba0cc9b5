#!/usr/bin/env python3
"""Where a launch of the vector kernel spends its time, on one NVIDIA GPU:
per phase of a warp's bounce loop in ``csrc/vector_trace.cu``, with the
loop's counters.

    python3 tools/vector_trace_phases.py [--record PATH] [--cases a,b]
        [--reps 3] [--src PATH]

Run from the repository root.  It compiles, into a directory of its own
under ``build/kernels/vector_trace_phases/``, a copy of the source in which
the marks (``VT_BEGIN``, ``VT_MARK``, ``VT_COUNT``, ``VT_END``; empty in the
shipped build) are defined.  A mark ends the phase its number names (the
source's ``// VT_MARK phases:`` line): the first active lane of the warp
reads the SM's cycle counter (``clock64``) and adds the cycles since the
warp's previous mark to that phase, so a warp's time is cut into phases
even where its lanes diverge (a block barrier cannot be used in a
divergent loop).  The sums over all warps give each phase's share of the
warps' time, leaving out the phase named ``count``: the counters' own
time, printed apart.  A counter adds a value summed over the active lanes: warp
steps and lane bounces (their ratio over 32 is the lane occupancy),
bounces whose position the coarse grid leaves open and warp steps with
such a lane, the same under the refined grid, exact region tests and the
edges they evaluate, interactions and rays taken.  The marks' own work
makes the copy slower than the shipped kernel, so the shares, not the
copy's time, are the result; each phase's milliseconds are its share of
the shipped kernel's time (CUDA events, ``--reps`` launches after a
warm-up).  On ``chip_smoke.py`` phase 22's calls
(``chip_smoke.vector_cases``) it holds the copy's outputs to the shipped
kernel's bit for bit.  ``--record PATH`` writes every number as JSON.  It
imports nothing of JAX.  ``--src PATH`` marks that source in place of
``csrc/vector_trace.cu`` (another version of the kernel with the same
marks and the same launch function, such as an earlier commit's kernel
with marks added); the shipped build is still the timed one.
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
NPHASE = 16
NCOUNT = 16
# the source's VT_COUNT counters, in its order (C_WARP_STEPS ...)
COUNTS = ("warp_steps", "bounces", "open_coarse", "open_coarse_warp_steps",
          "open_fine", "open_fine_warp_steps", "exact_tests", "edges",
          "interactions", "rays")

PRELUDE = f"""
#include <cuda_runtime.h>
#define VT_ON 1
__device__ unsigned long long g_vt_cycles[{NPHASE}];
__device__ unsigned long long g_vt_marks[{NPHASE}];
__device__ unsigned long long g_vt_cnt[{NCOUNT}];
// each warp's sums, at most 32 warps a block
__shared__ unsigned long long vt_acc[32][{NPHASE}];
__shared__ unsigned long long vt_n[32][{NPHASE}];
__shared__ unsigned long long vt_cnt[32][{NCOUNT}];
__shared__ unsigned long long vt_last[32];
#define VT_BEGIN()                                                      \\
  do {{                                                                  \\
    const int w_ = threadIdx.x >> 5;                                    \\
    if ((threadIdx.x & 31) == 0) {{                                      \\
      for (int k_ = 0; k_ < {NPHASE}; ++k_) vt_acc[w_][k_] = vt_n[w_][k_] = 0; \\
      for (int k_ = 0; k_ < {NCOUNT}; ++k_) vt_cnt[w_][k_] = 0;           \\
      vt_last[w_] = clock64();                                          \\
    }}                                                                   \\
    __syncwarp();                                                       \\
  }} while (0)
#define VT_MARK(k)                                                      \\
  do {{                                                                  \\
    const unsigned m_ = __activemask();                                 \\
    if ((int)(threadIdx.x & 31) == __ffs(m_) - 1) {{                     \\
      const int w_ = threadIdx.x >> 5;                                  \\
      const unsigned long long t_ = clock64();                          \\
      vt_acc[w_][k] += t_ - vt_last[w_];                                \\
      vt_n[w_][k] += 1;                                                 \\
      vt_last[w_] = t_;                                                 \\
    }}                                                                   \\
  }} while (0)
#define VT_COUNT(k, v)                                                  \\
  do {{                                                                  \\
    const unsigned m_ = __activemask();                                 \\
    const unsigned s_ = __reduce_add_sync(m_, (unsigned)(v));           \\
    if ((int)(threadIdx.x & 31) == __ffs(m_) - 1)                       \\
      atomicAdd(&vt_cnt[threadIdx.x >> 5][k], (unsigned long long)s_);  \\
  }} while (0)
#define VT_END()                                                        \\
  do {{                                                                  \\
    __syncwarp();                                                       \\
    if ((threadIdx.x & 31) == 0) {{                                      \\
      const int w_ = threadIdx.x >> 5;                                  \\
      for (int k_ = 0; k_ < {NPHASE}; ++k_) {{                            \\
        if (vt_acc[w_][k_]) atomicAdd(&g_vt_cycles[k_], vt_acc[w_][k_]);  \\
        if (vt_n[w_][k_]) atomicAdd(&g_vt_marks[k_], vt_n[w_][k_]);       \\
      }}                                                                 \\
      for (int k_ = 0; k_ < {NCOUNT}; ++k_)                               \\
        if (vt_cnt[w_][k_]) atomicAdd(&g_vt_cnt[k_], vt_cnt[w_][k_]);     \\
    }}                                                                   \\
  }} while (0)
"""

EPILOGUE = f"""
extern "C" int vector_trace_phase_reset() {{
  unsigned long long z[{NPHASE}] = {{0}};
  cudaError_t e = cudaMemcpyToSymbol(g_vt_cycles, z, sizeof(z));
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(g_vt_marks, z, sizeof(z));
  if (e == cudaSuccess)
    e = cudaMemcpyToSymbol(g_vt_cnt, z, {NCOUNT} * sizeof(long long));
  return (int)e;
}}

extern "C" int vector_trace_phase_read(unsigned long long* cycles,
                                       unsigned long long* marks,
                                       unsigned long long* cnt) {{
  cudaError_t e = cudaMemcpyFromSymbol(cycles, g_vt_cycles, {NPHASE} * 8);
  if (e == cudaSuccess)
    e = cudaMemcpyFromSymbol(marks, g_vt_marks, {NPHASE} * 8);
  if (e == cudaSuccess) e = cudaMemcpyFromSymbol(cnt, g_vt_cnt, {NCOUNT} * 8);
  return (int)e;
}}
"""


def fail(msg: str) -> None:
    print(f"vector_trace_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase_names(src: str) -> list:
    """The names after ``// VT_MARK phases:``: mark k ends phase k."""
    m = re.search(r"^// VT_MARK phases:(.*)$", src, re.M)
    if not m or "#ifndef VT_MARK" not in src:
        fail("csrc/vector_trace.cu has no VT_MARK phase list")
    return ["start"] + m.group(1).split()


def bind(lib: ctypes.CDLL, tv) -> ctypes.CDLL:
    """``lib``'s launch and error functions typed as ``load_kernel`` types
    them."""
    lib.vector_trace_launch.argtypes = tv.LAUNCH_ARGTYPES
    lib.vector_trace_launch.restype = ctypes.c_int
    lib.vector_trace_error_string.argtypes = [ctypes.c_int]
    lib.vector_trace_error_string.restype = ctypes.c_char_p
    return lib


def build_copy(build, tv, src: str) -> ctypes.CDLL:
    out_dir = build.BUILD_DIR / "vector_trace_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "vector_trace_marks.cu"
    cu.write_text(PRELUDE + src + EPILOGUE)
    so = out_dir / "vector_trace_marks.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc: {proc.stdout}{proc.stderr}")
    log = (proc.stdout + proc.stderr).splitlines()
    print("marked copy: " + " | ".join(
        ln.strip() for ln in log if "registers" in ln or "spill" in ln),
        flush=True)
    lib = bind(ctypes.CDLL(str(so)), tv)
    lib.vector_trace_phase_reset.restype = ctypes.c_int
    lib.vector_trace_phase_read.argtypes = [ctypes.c_void_p] * 3
    lib.vector_trace_phase_read.restype = ctypes.c_int
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH")
    parser.add_argument("--cases", default=None, metavar="LIST",
                        help="comma-separated case names (default: all)")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--src", default=None, metavar="PATH",
                        help="the marked source (default: the shipped one)")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, trace_vector as tv,
    )

    import chip_smoke

    dev = torch.device("cuda")
    card = chip_smoke.nvidia_smi()
    print(f"card: {card}", flush=True)
    record = {"card": card, "cases": {}}
    src = Path(opts.src or build.CSRC / "vector_trace.cu").read_text()
    names = phase_names(src)
    shipped = tv.load_kernel()
    copy = build_copy(build, tv, src)
    record.update(src=opts.src or "csrc/vector_trace.cu", phases=names[1:])
    wanted = set(opts.cases.split(",")) if opts.cases else None
    for name, a, _ in chip_smoke.vector_cases(dev):
        if wanted is not None and name not in wanted:
            continue
        out = tv.launch_vector_trace(a)
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(lambda: tv.launch_vector_trace(a),
                                  opts.reps)
        tv._LIB = copy
        try:
            if copy.vector_trace_phase_reset() != 0:
                fail("could not reset the marks")
            torch.cuda.synchronize()
            t0 = torch.cuda.Event(enable_timing=True)
            t1 = torch.cuda.Event(enable_timing=True)
            t0.record()
            got = tv.launch_vector_trace(a)
            t1.record()
            torch.cuda.synchronize()
        finally:
            tv._LIB = shipped
        e = chip_smoke.vector_compare(got, out)
        if not e["ok"]:
            fail(f"{name}: the marked copy differs from the shipped "
                 f"kernel: {e}")
        cycles = (ctypes.c_ulonglong * NPHASE)()
        marks = (ctypes.c_ulonglong * NPHASE)()
        counters = (ctypes.c_ulonglong * NCOUNT)()
        if copy.vector_trace_phase_read(cycles, marks, counters) != 0:
            fail("could not read the marks")
        counted = [k for k in range(1, len(names)) if names[k] != "count"]
        total = sum(cycles[k] for k in counted)
        cnt = {k: int(counters[i]) for i, k in enumerate(COUNTS)}
        bounces = int(out.bounces.sum())
        D, R = a.rays["x"].shape
        r = {"designs": D, "rays": D * R, "mode": a.mode,
             "max_bounces": a.max_bounces, "steps": int(out.steps),
             "bounces": bounces, "ms": ms,
             "marked_ms": t0.elapsed_time(t1), "warp_cycles": total,
             "count_cycles": sum(int(cycles[k]) for k in range(
                 1, len(names)) if names[k] == "count"),
             "counters": cnt, "phases": {}}
        if cnt["warp_steps"]:
            r["lane_occupancy"] = cnt["bounces"] / (32 * cnt["warp_steps"])
            for k in ("open_coarse", "open_fine"):
                r[f"{k}_share"] = cnt[k] / max(cnt["bounces"], 1)
                r[f"{k}_warp_share"] = (cnt[f"{k}_warp_steps"]
                                        / cnt["warp_steps"])
        for k in counted:
            if marks[k]:
                share = cycles[k] / total if total else 0.0
                r["phases"][names[k]] = {
                    "share": share, "ms": share * ms,
                    "cycles": int(cycles[k]), "marks": int(marks[k])}
        record["cases"][name] = r
        split = ", ".join(f"{k} {v['share'] * 100:.1f} % ({v['ms']:.3f} ms)"
                          for k, v in r["phases"].items())
        print(f"{name}: {D} design(s), {D * R:,} rays, {a.mode}: kernel "
              f"{ms:.3f} ms, marked copy {r['marked_ms']:.3f} ms (equal bit "
              f"for bit); steps {r['steps']}, bounces {bounces:,}; lane "
              f"occupancy {r.get('lane_occupancy', float('nan')):.4f}; "
              f"split of the warps' time: {split}; counters "
              f"{json.dumps(cnt)}", flush=True)
        del out, got
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
