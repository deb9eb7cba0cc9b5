#!/usr/bin/env python3
"""Where a launch of the window-sum kernel spends its time, on one NVIDIA
GPU: per phase of ``csrc/eye_tail.cu``'s ``pupil_window_sum`` (or another
version of it), with its achieved HBM rate, the window chains in flight an
SM, and its shared-memory loads and bank wavefronts an add.

    python3 tools/window_sum_phases.py [--record PATH] [--cases a,b]
        [--reps 5] [--src PATH]

Run from the repository root.  It compiles, into
``build/kernels/window_sum_phases/``, the source as it is and a copy in
which the marks (``WS_BEGIN``, ``WS_MARK``, ``WS_END``; empty in the
shipped build) are defined.  A mark ends the phase its number names (the
source's ``// WS_MARK phases:`` line): every thread reads the SM's cycle
counter (``clock64``) and adds the cycles since its previous mark to that
phase, in registers, so a lane's time is cut into phases however the warp
diverges; the sums over all threads (lane-cycles) give each phase's share.
A source without the line (the kernel as it was before its redesign: one
block an image, the image staged by loads and stores, one thread a window)
gets marks at its staging, its barrier and its sums.  Each case's output of
both builds is held to the shipped kernel's (``metrics.pupil_window_sum``)
bit for bit; the kernel's time is the unmarked build's (CUDA events,
``--reps`` launches behind device spin).  Derived numbers: the achieved
rate, the images' bytes read once and the windows written once over that
time; the chains in flight an SM, the summing lane-cycles times the windows
a lane sums, over the SMs times the marked launch's cycles at the card's
maximum SM clock (``nvidia-smi clocks.max.sm``); the shared loads an add
and bank wavefronts an add, counted from the source's loops and its first
warp's addresses (a model of the card's banks, not a measurement).  The
cases are ``chip_smoke.py`` phase 20's perception cases: the reference
histogram at strides (8, 12) and (1, 1), the sweep's scaled 128-lane tiles.
``--record PATH`` writes every number as JSON.  It imports nothing of
JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
NPHASE = 8

PRELUDE = f"""
#include <cuda_runtime.h>
#define WS_ON 1
__device__ unsigned long long g_ws_cycles[{NPHASE}];
#define WS_BEGIN()                                                     \\
  unsigned long long ws_acc_[{NPHASE}] = {{0}};                          \\
  unsigned long long ws_last_ = clock64()
#define WS_MARK(k)                                                     \\
  do {{                                                                 \\
    const unsigned long long t_ = clock64();                           \\
    ws_acc_[k] += t_ - ws_last_;                                       \\
    ws_last_ = t_;                                                     \\
  }} while (0)
#define WS_END()                                                       \\
  do {{                                                                 \\
    _Pragma("unroll")                                                  \\
    for (int k_ = 0; k_ < {NPHASE}; ++k_)                               \\
      if (ws_acc_[k_]) atomicAdd(&g_ws_cycles[k_], ws_acc_[k_]);       \\
  }} while (0)
"""

EPILOGUE = f"""
extern "C" int window_sum_phase_reset() {{
  unsigned long long z[{NPHASE}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_ws_cycles, z, sizeof(z));
}}

extern "C" int window_sum_phase_read(unsigned long long* cycles) {{
  return (int)cudaMemcpyFromSymbol(cycles, g_ws_cycles, {NPHASE} * 8);
}}
"""

# the kernel before its redesign: marks at its staging, barrier and sums
PARENT_MARKS = (
    ("pupil_window_sum(const Window w, const Disc disc) {\n",
     "pupil_window_sum(const Window w, const Disc disc) {\n  WS_BEGIN();\n"),
    ("  __syncthreads();\n  const int nout = w.epy * w.epx;",
     "  WS_MARK(1);\n  __syncthreads();\n  WS_MARK(2);\n"
     "  const int nout = w.epy * w.epx;"),
    ("    dst[o] = acc;\n  }\n}",
     "    dst[o] = acc;\n  }\n  WS_MARK(3);\n  WS_END();\n}"),
)


def fail(msg: str) -> None:
    print(f"window_sum_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def marked_source(src: str) -> tuple:
    """``(source with marks, phase names, parent)``: the source's own marks,
    or the parent kernel's inserted."""
    parent = "// WS_MARK phases:" not in src
    if parent:
        for old, new in PARENT_MARKS:
            if src.count(old) != 1:
                fail(f"the source has no WS_MARK line and is not the "
                     f"parent kernel (no {old!r})")
            src = src.replace(old, new)
        src = "// WS_MARK phases: stage barrier sum\n" + src
    m = re.search(r"^// WS_MARK phases:(.*)$", src, re.M)
    return src, ["start"] + m.group(1).split(), parent


def build_libs(build, eye_tail, src: str, marked: str) -> tuple:
    """The source as it is and its marked copy, compiled side by side."""
    out_dir = build.BUILD_DIR / "window_sum_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, text in (("plain", src), ("marks", PRELUDE + marked
                                       + EPILOGUE)):
        cu = out_dir / f"window_sum_{tag}.cu"
        cu.write_text(text)
        so = out_dir / f"window_sum_{tag}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs.append((tag, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    libs = []
    for tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc ({tag}): {log}")
        print(f"{tag} build: " + " | ".join(
            ln.strip() for ln in log.splitlines()
            if "registers" in ln or "spill" in ln), flush=True)
        lib = ctypes.CDLL(str(so))
        lib.pupil_window_sum_launch.argtypes = eye_tail.WINDOW_ARGTYPES
        lib.pupil_window_sum_launch.restype = ctypes.c_int
        lib.eye_tail_error_string.argtypes = [ctypes.c_int]
        lib.eye_tail_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    libs[1].window_sum_phase_read.argtypes = [ctypes.c_void_p]
    return libs[0], libs[1]


def launch(lib, h, mask, stride, scale):
    """``lib``'s window sum of ``h`` (as ``eye_tail.launch_window_sum``
    calls it)."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    eby, ebx = h.shape[-2:]
    flat = h.reshape((-1, eby, ebx))
    rows, cols = np.shape(mask)
    sy, sx = stride
    seg = np.ascontiguousarray(metrics.pupil_segments(mask), np.int32)
    out = torch.empty((flat.shape[0], (eby - rows) // sy + 1,
                       (ebx - cols) // sx + 1), device=h.device)
    err = lib.pupil_window_sum_launch(
        flat.data_ptr(), None if scale is None else scale.data_ptr(),
        out.data_ptr(), flat.stride(0), flat.stride(1), flat.shape[0], eby,
        ebx, sy, sx, seg.ctypes.data, rows, cols,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"launch: {lib.eye_tail_error_string(err).decode()}")
    return out.reshape(tuple(h.shape[:-2]) + tuple(out.shape[-2:]))


def _wavefronts32(bases) -> int:
    """Bank wavefronts of one 4-byte shared load whose lanes read
    ``bases`` (words) plus one offset: the most distinct words in a bank."""
    per_bank = {}
    for b in set(bases):
        per_bank.setdefault(b % 32, set()).add(b)
    return max(len(v) for v in per_bank.values())


def _wavefronts128(bases) -> int:
    """Bank wavefronts of one 16-byte shared load (four phases of eight
    lanes): in each phase, the most distinct 16-byte chunks in a group of
    four banks."""
    total = 0
    for q in range(0, len(bases), 8):
        per = {}
        for b in set(bases[q:q + 8]):
            per.setdefault((b // 4) % 8, set()).add(b // 4)
        total += max(len(v) for v in per.values())
    return total


def lds_model(parent: bool, eby: int, ebx: int, mask, stride) -> dict:
    """Shared loads an add and bank wavefronts an add of the source's
    loops, from its first warp's window bases."""
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    segs = metrics.pupil_segments(mask).tolist()
    lens = [e - s for s, e in segs]
    adds = sum(lens)
    rows, cols = np.shape(mask)
    sy, sx = stride
    epy, epx = (eby - rows) // sy + 1, (ebx - cols) // sx + 1
    if parent:   # thread o sums window o
        bases = [(o // epx) * sy * ebx + (o % epx) * sx
                 for o in range(min(32, epy * epx))]
        return {"lds_width": 4, "loads_per_add": 1.0,
                "wavefronts_per_add": float(_wavefronts32(bases))}
    p = eye_tail.window_sum_plan(eby, ebx, rows, cols, sy, sx)
    bases = []
    for it in range(min(32, p["active"])):
        q, item = divmod(it, p["items"])
        wy, xb = divmod(item, p["xblocks"])
        bases.append(q * p["stage_floats"] + wy * sy * ebx
                     + xb * p["k"] * sx)
    if p["form"] == 1:
        loads = sum((e - 1) // 4 - s // 4 + 1 for s, e in segs if e > s)
        return {"lds_width": 16, "loads_per_add": loads / adds,
                "wavefronts_per_add": loads * _wavefronts128(bases) / adds}
    if p["form"] == 2:
        K = p["k"]
        loads = sum(n + K - 1 if n >= K - 1 else K * n for n in lens)
        per_add = loads / (K * adds)
        return {"lds_width": 4, "loads_per_add": per_add,
                "wavefronts_per_add": per_add * _wavefronts32(bases)}
    return {"lds_width": 4, "loads_per_add": 1.0,
            "wavefronts_per_add": float(_wavefronts32(bases))}


def cases(dev):
    """phase 20's perception cases: name, images, stride, scale."""
    import torch

    import chip_smoke

    gen = torch.Generator(device=dev).manual_seed(20)
    h = torch.rand(chip_smoke.TAIL_HISTOGRAM, generator=gen, device=dev)
    h = torch.where(h < 0.2, 0.0, h)
    h[:, 0, 0, :40, :40] = 0.0
    yield "stride_8_12", h, (8, 12), None
    yield "stride_1_1", h, (1, 1), None
    tiles = torch.zeros((h.numel() // (80 * 120), 80, 128), device=dev)
    tiles[:, :, :120] = h.reshape(-1, 80, 120)
    del h
    factor = 0.5 + torch.rand(tiles.shape[0], device=dev,
                              generator=torch.Generator(
                                  device=dev).manual_seed(21))
    yield "sweep_6a_tiles", tiles[:, :, :120], (8, 12), factor


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--record", default=None, metavar="PATH")
    parser.add_argument("--cases", default=None, metavar="LIST",
                        help="comma-separated case names (default: all)")
    parser.add_argument("--reps", type=int, default=5)
    parser.add_argument("--src", default=None, metavar="PATH",
                        help="the source to split (default: the shipped one)")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
    )

    import chip_smoke

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
    src_path = Path(opts.src or build.CSRC / "eye_tail.cu")
    src = src_path.read_text()
    marked, names, parent = marked_source(src)
    plain_lib, marks_lib = build_libs(build, eye_tail, src, marked)
    record = {"card": card, "max_sm_mhz": mhz, "sms": sms,
              "src": opts.src or "csrc/eye_tail.cu", "parent_form": parent,
              "phases": names[1:], "cases": {}}
    mask = metrics.pupil_mask(30)
    wanted = set(opts.cases.split(",")) if opts.cases else None
    for name, h, stride, scale in cases(dev):
        if wanted is not None and name not in wanted:
            continue
        ship = metrics.pupil_window_sum(h, mask, stride, scale)
        got = launch(plain_lib, h, mask, stride, scale)
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(
            lambda: launch(plain_lib, h, mask, stride, scale), opts.reps)
        if marks_lib.window_sum_phase_reset() != 0:
            fail("could not reset the marks")
        torch.cuda.synchronize()
        torch.cuda._sleep(170_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        got_m = launch(marks_lib, h, mask, stride, scale)
        t1.record()
        torch.cuda.synchronize()
        same = [bool(torch.equal(x.view(torch.int32), ship.view(torch.int32)))
                for x in (got, got_m)]
        if not all(same):
            fail(f"{name}: the source's kernel or its marked copy differs "
                 f"from the shipped kernel (plain, marked: {same})")
        cycles = (ctypes.c_ulonglong * NPHASE)()
        if marks_lib.window_sum_phase_read(cycles) != 0:
            fail("could not read the marks")
        marked_ms = t0.elapsed_time(t1)
        total = sum(cycles[k] for k in range(1, len(names)))
        eby, ebx = h.shape[-2:]
        n_images = h.numel() // (eby * ebx)
        nbytes = (n_images * eby * ebx + ship.numel()) * 4
        r = {"stride": list(stride), "scaled": scale is not None,
             "images": n_images, "ms": ms, "marked_ms": marked_ms,
             "gb_s": nbytes / (ms * 1e-3) / 1e9, "bytes": nbytes,
             "lane_cycles": total, "phases": {}}
        for k in range(1, len(names)):
            share = cycles[k] / total if total else 0.0
            r["phases"][names[k]] = {"share": share,
                                     "lane_cycles": int(cycles[k])}
        k_win = 1
        if not parent:
            plan = eye_tail.window_sum_plan(eby, ebx, *mask.shape, *stride)
            # the source's own windows a thread (a variant may set another)
            dense_k = re.search(r"constexpr int DENSE_K = (\d+);", src)
            k_win = (int(dense_k.group(1)) if dense_k and plan["form"] == 2
                     else plan["k"])
            r["plan"] = plan
        elapsed = marked_ms * 1e-3 * mhz * 1e6
        r["chains_per_sm"] = (r["phases"]["sum"]["lane_cycles"] * k_win
                              / (sms * elapsed))
        r.update(lds_model(parent, eby, ebx, mask, stride))
        record["cases"][name] = r
        split = ", ".join(f"{k} {v['share'] * 100:.1f} %"
                          for k, v in r["phases"].items())
        print(f"{name}: {n_images:,} images at stride {stride}"
              f"{', scaled' if scale is not None else ''}: kernel "
              f"{ms:.4f} ms ({r['gb_s']:.0f} GB/s), marked copy "
              f"{marked_ms:.4f} ms (both equal to the shipped kernel bit "
              f"for bit); lane-cycles by phase: {split}; chains in flight "
              f"an SM {r['chains_per_sm']:.1f}; {r['lds_width']}-byte shared "
              f"loads an add {r['loads_per_add']:.3f}, bank wavefronts an "
              f"add {r['wavefronts_per_add']:.3f} (model)", flush=True)
        del ship, got, got_m
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
