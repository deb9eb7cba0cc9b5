#!/usr/bin/env python3
"""Where a call of the global splitting engine's kernels spends its time, on
one NVIDIA GPU: per phase of the persistent kernels of
``csrc/split_trace.cu``, and per grid barrier.

    python3 tools/split_trace_phases.py [--record PATH] [--check] [--reps 5]

Run from the repository root.  It compiles, into a directory of its own
under ``build/kernels/split_trace_phases/``, a copy of the source whose grid
barrier also has block 0 write the GPU's global timer (``%globaltimer``,
nanoseconds) each time it leaves a barrier, and a kernel that passes the
same barrier in a loop.  On ``chip_smoke.py`` phase 23's four traces
(``chip_smoke.trace_cases``: ``optimize``'s README apodization and joint
cases, the stop-tested trace of 18 cells in 32,768 slots, the whole
wavefront of 262,144 slots) it times the shipped forward and backward
kernels with CUDA events (``--reps`` calls after a warm-up), runs the copy
once each, holds the copy's outputs to the shipped kernel's bit for bit,
and splits the copy's call at its barriers:
the mean time of each phase of a step (the time from one barrier to the
next, so each phase includes its barrier), the phases before the first
step and the steps run.  Forward, a step is the step itself, then the
sort's passes, each a counting phase (h) and a scatter phase (s), the last
scatter placing the kept children in the tape (the deposits' adds run in
the counting phase after their sort's last pass); backward, the adjoint,
the passes and the table add.  Then the barrier alone: 2,000 barriers at
each grid the traces used.  ``--check`` also holds the shipped kernels to
their plain versions (the plain backward of the stop-tested trace takes
about 30 s).  ``--record PATH`` writes every number as JSON.  It imports
nothing of JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
MARKS = 16384


def fail(msg: str) -> None:
    print(f"split_trace_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def instrumented_source(src: str) -> str:
    """``csrc/split_trace.cu`` with block 0's barrier exits timed and a
    barrier-loop kernel added."""
    end = "    __threadfence();\n  }\n  __syncthreads();\n}\n\n// a count summed"
    if src.count(end) != 1 or src.count("namespace {\n") != 1:
        fail("csrc/split_trace.cu's grid_sync is not where this tool looks")
    src = src.replace(end, """    __threadfence();
    if (blockIdx.x == 0) {
      unsigned long long now;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now));
      const unsigned g = bar[1];
      if (g < MARKS) g_marks[g] = now;
    }
  }
  __syncthreads();
}

// a count summed""")
    src = src.replace("namespace {\n", "namespace {\nconstexpr unsigned MARKS = "
                      f"{MARKS};\n__device__ unsigned long long g_marks[MARKS];\n")
    return src + """
namespace {
__global__ void barrier_loop(unsigned* bar, int n) {
  for (int i = 0; i < n; ++i) grid_sync(bar);
}
}  // namespace

extern "C" int split_trace_marks(unsigned long long* out, int n) {
  return (int)cudaMemcpyFromSymbol(out, g_marks, n * sizeof(long long));
}

extern "C" int split_trace_barrier_loop(int grid, int n, void* bar,
                                        void* stream) {
  unsigned* b = static_cast<unsigned*>(bar);
  void* args[] = {&b, &n};
  return (int)cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_loop), dim3(grid), dim3(THREADS),
      args, 0, static_cast<cudaStream_t>(stream));
}
"""


def build_copy(build, splitting) -> ctypes.CDLL:
    out_dir = build.BUILD_DIR / "split_trace_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "split_trace_marks.cu"
    cu.write_text(instrumented_source((build.CSRC / "split_trace.cu")
                                      .read_text()))
    so = out_dir / "split_trace_marks.so"
    cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
           "-o", str(so), str(cu)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        fail(f"nvcc: {proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(str(so))
    lib.split_trace_forward.argtypes = splitting._FORWARD_ARGTYPES
    lib.split_trace_forward.restype = ctypes.c_int
    lib.split_trace_backward.argtypes = splitting._BACKWARD_ARGTYPES
    lib.split_trace_backward.restype = ctypes.c_int
    lib.split_trace_scratch_bytes.argtypes = [ctypes.POINTER(ctypes.c_int),
                                              ctypes.c_int]
    lib.split_trace_scratch_bytes.restype = ctypes.c_size_t
    lib.split_trace_error_string.argtypes = [ctypes.c_int]
    lib.split_trace_error_string.restype = ctypes.c_char_p
    lib.split_trace_marks.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.split_trace_barrier_loop.argtypes = [ctypes.c_int, ctypes.c_int,
                                             ctypes.c_void_p, ctypes.c_void_p]
    return lib


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH")
    parser.add_argument("--check", action="store_true",
                        help="also hold the kernels to their plain versions")
    parser.add_argument("--reps", type=int, default=5)
    opts = parser.parse_args()
    import numpy as np
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
    shipped = splitting.load_trace_kernel()
    copy = build_copy(build, splitting)

    def bits(x, y) -> int:
        return int((x.contiguous().view(torch.int32)
                    != y.contiguous().view(torch.int32)).sum())

    def ms(fn) -> float:
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(opts.reps):
            fn()
        end.record()
        torch.cuda.synchronize()
        return start.elapsed_time(end) / opts.reps

    def marked(fn, what: str):
        """One call through the copy: its output and its barriers' exit
        times (ns; index g: barrier g, from 1)."""
        splitting._TRACE_LIB = copy
        try:
            out = fn()
            torch.cuda.synchronize()
        finally:
            splitting._TRACE_LIB = shipped
        n = int(splitting.last_launch[what]["counters"][
            splitting._CNT_BARRIERS])
        if n >= MARKS:
            fail(f"{n} barriers: more than the copy keeps")
        buf = (ctypes.c_ulonglong * (n + 1))()
        if copy.split_trace_marks(buf, n + 1) != 0:
            fail("could not read the barrier times")
        return out, np.array(buf[:], dtype=np.int64), n

    def split(t, head: int, names: list, steps: int) -> dict:
        """Mean µs of each phase of a step, and of the phases before."""
        per = len(names)
        d = np.diff(t[1:]) / 1e3          # d[k]: barrier k+1 to k+2
        body = d[head - 1:head - 1 + per * steps]
        if steps == 0 or len(body) != per * steps:
            fail(f"{len(d)} phases do not split into {head} + {steps} x "
                 f"{per}")
        return {"head_us": float(t[head] - t[1]) / 1e3,
                "phase_us": dict(zip(names, body.reshape(steps, per)
                                     .mean(0).round(3).tolist())),
                "steps_run": steps}

    record = {"card": card, "cases": {}}
    grids = set()
    for name, a, _ in chip_smoke.trace_cases(dev):
        r = {}
        out = splitting.launch_split_trace(a, keep_tape=True)
        torch.cuda.synchronize()
        ran = int((out.tape.widths[:-1] > 0).sum())
        fl = dict(splitting.last_launch["split_trace"])
        r["forward_ms"] = ms(lambda: splitting.launch_split_trace(
            a, keep_tape=True))
        copy_out, t, n = marked(lambda: splitting.launch_split_trace(
            a, keep_tape=True), "split_trace")
        if bits(copy_out.hist, out.hist) or copy_out.steps != out.steps:
            fail(f"{name}: the timed copy's forward differs")
        dpasses = (a.hist_size.bit_length() + 7) // 8
        names = ["step"] + [f"{x}{p}" for p in range(4) for x in "hs"]
        names += ["deposit"] if dpasses == 4 else []
        head = 1 + 8 * (a.rays.shape[1] > 0)
        r["forward"] = dict(split(t, head, names, ran), barriers=n,
                            grid=fl["grid"],
                            blocks_per_sm=fl["blocks_per_sm"])
        rng = np.random.default_rng(23)
        gh = torch.from_numpy(rng.standard_normal(a.hist_size).astype(
            np.float32)).to(dev)
        dk = splitting.launch_split_trace_backward(a, out.tape, gh)
        torch.cuda.synchronize()
        bl = dict(splitting.last_launch["split_trace_backward"])
        r["backward_ms"] = ms(lambda: splitting.launch_split_trace_backward(
            a, out.tape, gh))
        copy_dk, t, n = marked(lambda: splitting.launch_split_trace_backward(
            a, out.tape, gh), "split_trace_backward")
        if any(bits(x, y) for x, y in zip(dk, copy_dk)):
            fail(f"{name}: the timed copy's backward differs")
        passes = ((a.rec.shape[1] + 5 * a.cell.shape[1]).bit_length()
                  + 7) // 8
        names = (["adjoint"] + [f"{x}{p}" for p in range(passes)
                                for x in "hs"] + ["add"])
        r["backward"] = dict(split(t, 1, names, ran), barriers=n,
                             grid=bl["grid"],
                             blocks_per_sm=bl["blocks_per_sm"])
        grids |= {fl["grid"], bl["grid"]}
        if opts.check:
            t0 = time.perf_counter()
            ref = splitting.split_trace_reference(a, keep_tape=True)
            wr = ref.tape.widths.long().cpu()
            same = (out.steps == ref.steps and bits(out.hist, ref.hist) == 0
                    and torch.equal(out.tape.widths.long().cpu(), wr)
                    and sum(bits(out.tape.fields[k, :, :int(wr[k])],
                                  ref.tape.fields[k, :, :int(wr[k])])
                            for k in range(len(wr))) == 0)
            dr = splitting.split_trace_backward_reference(a, ref.tape, gh)
            same = same and not any(bits(x, y) for x, y in zip(dk, dr))
            r["plain_equal"] = bool(same)
            r["plain_s"] = time.perf_counter() - t0
            if not same:
                fail(f"{name}: the kernels differ from their plain versions")
        record["cases"][name] = r
        print(f"{name}: {json.dumps(r)}", flush=True)
    bar = torch.zeros(2, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    record["barrier_us"] = {}
    for g in sorted(grids):
        loops = 2000
        err = copy.split_trace_barrier_loop(g, 10, bar.data_ptr(), stream)
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        err = err or copy.split_trace_barrier_loop(g, loops, bar.data_ptr(),
                                                   stream)
        end.record()
        torch.cuda.synchronize()
        if err:
            fail(f"the barrier loop at grid {g}: error {err}")
        record["barrier_us"][g] = start.elapsed_time(end) * 1e3 / loops
    print(f"barrier alone (µs) by grid: {json.dumps(record['barrier_us'])}",
          flush=True)
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
