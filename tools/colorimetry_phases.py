#!/usr/bin/env python3
"""Where a launch of the colorimetry kernels spends its time, on one NVIDIA
GPU: per phase of ``csrc/eye_tail.cu``'s colorimetry (or another version of
it), with its achieved HBM rate, the (pixel, position) chains in flight an
SM, and the lane instructions of an item from the SASS of its calls.

    python3 tools/colorimetry_phases.py [--record PATH] [--cases a,b]
        [--reps 10] [--src PATH]

Run from the repository root.  It compiles, into
``build/kernels/colorimetry_phases/``, the source as it is and a copy in
which the marks (``COLOR_BEGIN``, ``COLOR_MARK``, ``COLOR_END``; empty in
the shipped build) are defined.  A mark ends the phase its number names
(the source's ``// COLOR_MARK phases:`` line): every thread reads the SM's
cycle counter (``clock64``) and adds the cycles since its previous mark to
that phase, in registers; the sums over all threads (lane-cycles) give each
phase's share.  A source without the line (the kernels as they were before
their redesign: ``colorimetry_partials`` then ``colorimetry_finish``) gets
marks at its items, its partial reduction, the finish's image pass (each
block's walk of the peak partials and its slice of the division), the
finish's walk of the position partials and the design's sum.  Each case's
outputs of both builds are held to the shipped kernel's
(``metrics.colorimetry_stack``): the source's build and its marked copy
bit for bit to each other; the eye views bit for bit to the shipped
kernel's; the metrics bit for bit when the source is the shipped one, else
within 1e-5 relative, the largest relative change recorded.  The kernel's
time is the unmarked build's (CUDA events, ``--reps`` launch calls behind
device spin).  Derived numbers: the achieved rate, the stack read once and
the image and results written once over that time; the chains in flight
an SM, the items' lane-cycles over the SMs times the marked launch's cycles
at the card's maximum SM clock (``nvidia-smi clocks.max.sm``); the bound
recounted as lane instructions, each library call of an item at its SASS
fast path (``tools/sass_paths.py``) and every other operation at one, over
the card's issue rate (``chip_smoke.PEAK_FP32_ADDS``).  The cases are
``chip_smoke.py`` phase 20's: ``simulate``'s stack with the image, an
8-design sweep stack, the dense scan's 51 x 91 positions.  ``--record
PATH`` writes every number as JSON.  It imports nothing of JAX.
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
__device__ unsigned long long g_color_cycles[{NPHASE}];
#define COLOR_BEGIN()                                                  \\
  unsigned long long color_acc_[{NPHASE}] = {{0}};                       \\
  unsigned long long color_last_ = clock64()
#define COLOR_MARK(k)                                                  \\
  do {{                                                                 \\
    const unsigned long long t_ = clock64();                           \\
    color_acc_[k] += t_ - color_last_;                                 \\
    color_last_ = t_;                                                  \\
  }} while (0)
#define COLOR_END()                                                    \\
  do {{                                                                 \\
    _Pragma("unroll")                                                  \\
    for (int k_ = 0; k_ < {NPHASE}; ++k_)                               \\
      if (color_acc_[k_]) atomicAdd(&g_color_cycles[k_], color_acc_[k_]); \\
  }} while (0)
"""

EPILOGUE = f"""
extern "C" int color_phase_reset() {{
  unsigned long long z[{NPHASE}] = {{0}};
  return (int)cudaMemcpyToSymbol(g_color_cycles, z, sizeof(z));
}}

extern "C" int color_phase_read(unsigned long long* cycles) {{
  return (int)cudaMemcpyFromSymbol(cycles, g_color_cycles, {NPHASE} * 8);
}}
"""

# the kernels before their redesign: marks at the items, the partials'
# reduction, the finish's image pass, its position walk and the design sum
PARENT_MARKS = (
    ("colorimetry_partials(const Color a, const Consts k) {\n"
     "  __shared__ float red[NPART][GROUPS][LANES];\n",
     "colorimetry_partials(const Color a, const Consts k) {\n"
     "  __shared__ float red[NPART][GROUPS][LANES];\n  COLOR_BEGIN();\n"),
    ("  red[P_DE][ty][tx] = de;\n",
     "  COLOR_MARK(1);\n  red[P_DE][ty][tx] = de;\n"),
    ("  if (ty != 0 || p >= a.P) return;\n",
     "  if (ty != 0 || p >= a.P) {\n    COLOR_MARK(2);\n    COLOR_END();\n"
     "    return;\n  }\n"),
    ("    out[(size_t)q * a.P] = r;\n  }\n}",
     "    out[(size_t)q * a.P] = r;\n  }\n  COLOR_MARK(2);\n  COLOR_END();\n}"),
    ("  __shared__ float red[2][COLOR_THREADS];\n  __shared__ int last;\n",
     "  __shared__ float red[2][COLOR_THREADS];\n  __shared__ int last;\n"
     "  COLOR_BEGIN();\n"),
    ("  if (blockIdx.y != 0) return;\n",
     "  COLOR_MARK(3);\n  if (blockIdx.y != 0) {\n    COLOR_END();\n"
     "    return;\n  }\n"),
    ("  if (!last) return;\n  // the design's last position block",
     "  COLOR_MARK(4);\n  if (!last) {\n    COLOR_END();\n    return;\n  }\n"
     "  // the design's last position block"),
    ("    a.ratio_sum[d] = red[1][0];\n  }\n}",
     "    a.ratio_sum[d] = red[1][0];\n  }\n  COLOR_MARK(5);\n  COLOR_END();\n}"),
)

# an item's library calls (csrc/eye_tail.cu: the Lab channels, CIEDE2000,
# the eye view's sRGB curve and its division by the peak), and its other
# operations: of the 159 + 40 operations of chip_smoke.py's count, those
# that are not these calls
ITEM_CALLS = {"div": 13, "powf": 5, "hypotf": 4, "sqrtf": 5, "atan2f": 2,
              "fmodf": 2, "sinf": 2, "cosf": 4, "expf": 1}
IMAGE_CALLS = {"powf": 3, "div": 3}
ITEM_PLAIN = 159 - sum(ITEM_CALLS.values())
IMAGE_PLAIN = 40 - sum(IMAGE_CALLS.values())


def fail(msg: str) -> None:
    print(f"colorimetry_phases: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def marked_source(src: str) -> tuple:
    """``(source with marks, phase names, parent)``: the source's own marks,
    or the parent kernels' inserted."""
    parent = "// COLOR_MARK phases:" not in src
    if parent:
        for old, new in PARENT_MARKS:
            if src.count(old) != 1:
                fail(f"the source has no COLOR_MARK line and is not the "
                     f"parent kernel (no {old!r})")
            src = src.replace(old, new)
        src = ("// COLOR_MARK phases: items reduce image finish design\n"
               + src)
    m = re.search(r"^// COLOR_MARK phases:(.*)$", src, re.M)
    return src, ["start"] + m.group(1).split(), parent


def parent_splits(P: int, npix: int) -> tuple:
    """The split rule of the kernels before their redesign: ``(S, chunk,
    chunk2)`` for about 264 blocks a design."""
    tiles = -(-P // 32)
    want = -(-264 // tiles)
    S = max(1, min(want, -(-npix // 8)))
    chunk = -(-npix // S)
    S = -(-npix // chunk)
    chunk2 = -(-3 * npix // max(1, min(want, -(-3 * npix // 8))))
    return S, chunk, chunk2


def build_libs(build, eye_tail, src: str, marked: str, parent: bool):
    """The source as it is and its marked copy, compiled side by side."""
    out_dir = build.BUILD_DIR / "colorimetry_phases"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = []
    for tag, text in (("plain", src), ("marks", PRELUDE + marked
                                       + EPILOGUE)):
        cu = out_dir / f"colorimetry_{tag}.cu"
        cu.write_text(text)
        so = out_dir / f"colorimetry_{tag}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(build.CSRC),
               "-o", str(so), str(cu)]
        procs.append((tag, so, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)))
    argtypes = (eye_tail.COLOR_ARGTYPES if not parent else
                [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_float]
                + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    libs, logs = [], {}
    for tag, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            fail(f"nvcc ({tag}): {log}")
        logs[tag] = " | ".join(
            ln.strip() for ln in log.splitlines()
            if ("registers" in ln or "spill" in ln or "Function" in ln)
            and ("colorimetry" in ln or "registers" in ln
                 or "spill" in ln))
        print(f"{tag} build: {logs[tag]}", flush=True)
        lib = ctypes.CDLL(str(so))
        lib.colorimetry_launch.argtypes = argtypes
        lib.colorimetry_launch.restype = ctypes.c_int
        lib.eye_tail_error_string.argtypes = [ctypes.c_int]
        lib.eye_tail_error_string.restype = ctypes.c_char_p
        libs.append(lib)
    libs[1].color_phase_read.argtypes = [ctypes.c_void_p]
    return libs[0], libs[1], logs


def launch(lib, parent: bool, stack, consts, inv_norm: float,
           with_image: bool) -> dict:
    """``lib``'s colorimetry of ``stack`` (as
    ``eye_tail.launch_colorimetry`` calls it, or the parent's launch)."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail,
    )

    D, _, fy, fx, epy, epx = stack.shape
    npix, P = fy * fx, epy * epx
    dev = stack.device
    f32 = torch.float32
    out = {"delta_e": torch.empty(D, dtype=f32, device=dev),
           "ratio_sum": torch.empty(D, dtype=f32, device=dev),
           "u_eb": torch.empty((D, epy, epx), dtype=f32, device=dev)}
    if with_image:
        out["image"] = torch.empty((D, fy, fx, 3, epy, epx), dtype=f32,
                                   device=dev)
    if parent:
        S, chunk, chunk2 = parent_splits(P, npix)
        extra, npos, ndone = [chunk2], D * 2 * P, D
        npart = D * S * eye_tail.PARTIALS * P
    else:
        plan = eye_tail.colorimetry_plan(D, P, npix)
        S, chunk, extra = plan["S"], plan["chunk"], []
        npart, npos, ndone = plan["part"], plan["pos"], plan["done"]
    part = torch.empty(npart, dtype=f32, device=dev)
    pos = torch.empty(npos, dtype=f32, device=dev)
    done = torch.empty(ndone, dtype=torch.int32, device=dev)
    err = lib.colorimetry_launch(
        stack.data_ptr(), out["image"].data_ptr() if with_image else None,
        part.data_ptr(), pos.data_ptr(), done.data_ptr(),
        out["delta_e"].data_ptr(), out["ratio_sum"].data_ptr(),
        out["u_eb"].data_ptr(), consts.ctypes.data, eye_tail.NCONST,
        float(inv_norm), D, npix, P, S, chunk, *extra,
        torch.cuda.current_stream().cuda_stream)
    if err:
        fail(f"launch: {lib.eye_tail_error_string(err).decode()}")
    return out


def cases(dev):
    """phase 20's colorimetry cases: name, stack, with the image."""
    import torch
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        metrics,
    )

    import chip_smoke

    gen = torch.Generator(device=dev).manual_seed(20)
    h = torch.rand(chip_smoke.TAIL_HISTOGRAM, generator=gen, device=dev)
    h = torch.where(h < 0.2, 0.0, h)
    h[:, 0, 0, :40, :40] = 0.0
    perc = metrics.eye_perceived_torch(h)
    dense = metrics.eye_perceived_conv(h, stride=(1, 1))
    del h
    yield "simulate", perc[None], True
    stack = perc[None] * torch.rand(
        (8,) + chip_smoke.TAIL_HISTOGRAM[:3] + (1, 1), generator=gen,
        device=dev)
    stack[5, :, 3, 7] = 0.0
    yield "sweep", stack.contiguous(), False
    del stack
    yield "dense", dense[None], False


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
        build,
    )
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.eval import (
        eye_tail, metrics,
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
    item_ops = ITEM_PLAIN + sum(n * calls[k]["path"]
                                for k, n in ITEM_CALLS.items())
    image_ops = IMAGE_PLAIN + sum(n * calls[k]["path"]
                                  for k, n in IMAGE_CALLS.items())
    print("SASS fast paths (lane instructions; static): "
          + ", ".join(f"{k} {calls[k]['path']} ({calls[k]['static']})"
                      for k in ITEM_CALLS)
          + f"; an item {item_ops} lane instructions ({ITEM_PLAIN} plain "
          f"operations and {sum(ITEM_CALLS.values())} calls), its eye view "
          f"{image_ops} more", flush=True)
    src_path = Path(opts.src or build.CSRC / "eye_tail.cu")
    src = src_path.read_text()
    marked, names, parent = marked_source(src)
    plain_lib, marks_lib, logs = build_libs(build, eye_tail, src, marked,
                                            parent)
    record = {"card": card, "max_sm_mhz": mhz, "sms": sms,
              "src": opts.src or "csrc/eye_tail.cu", "parent_form": parent,
              "phases": names[1:], "builds": logs, "sass_calls": calls,
              "item_instructions": item_ops,
              "image_instructions": image_ops, "cases": {}}
    consts = np.ascontiguousarray(metrics.colorimetry_constants(),
                                  dtype=np.float32)
    inv_norm = metrics._inv_norm(20000.0)
    wanted = set(opts.cases.split(",")) if opts.cases else None
    for name, stack, with_image in cases(dev):
        if wanted is not None and name not in wanted:
            continue
        ship = metrics.colorimetry_stack(stack, inv_norm, with_image)
        got = launch(plain_lib, parent, stack, consts, inv_norm, with_image)
        torch.cuda.synchronize()
        ms = chip_smoke.device_ms(lambda: launch(
            plain_lib, parent, stack, consts, inv_norm, with_image),
            opts.reps)
        if marks_lib.color_phase_reset() != 0:
            fail("could not reset the marks")
        torch.cuda.synchronize()
        torch.cuda._sleep(170_000_000)
        t0 = torch.cuda.Event(enable_timing=True)
        t1 = torch.cuda.Event(enable_timing=True)
        t0.record()
        got_m = launch(marks_lib, parent, stack, consts, inv_norm,
                       with_image)
        t1.record()
        torch.cuda.synchronize()
        ship = {k: v.cpu().numpy() for k, v in ship.items()}
        got = {k: v.cpu().numpy() for k, v in got.items()}
        got_m = {k: v.cpu().numpy() for k, v in got_m.items()}

        def bits_equal(x, y):
            return all(np.array_equal(x[k].view(np.int32), y[k].view(np.int32))
                       for k in x)

        if not bits_equal(got, got_m):
            fail(f"{name}: the marked copy differs from the source's build")
        rel = {k: float((np.abs(got[k] - ship[k])
                         / np.maximum(np.abs(ship[k]), 1e-30)).max())
               for k in ("delta_e", "ratio_sum", "u_eb")}
        image_same = (not with_image
                      or np.array_equal(got["image"].view(np.int32),
                                        ship["image"].view(np.int32)))
        if not image_same:
            fail(f"{name}: the eye views differ from the shipped kernel's")
        if not parent and not bits_equal(got, ship):
            fail(f"{name}: the source's build differs from the shipped "
                 f"kernel")
        if max(rel.values()) > 1e-5 or not np.array_equal(
                got["u_eb"] == 0, ship["u_eb"] == 0):
            fail(f"{name}: metrics beyond 1e-5 of the shipped kernel's: "
                 f"{rel}")
        cycles = (ctypes.c_ulonglong * NPHASE)()
        if marks_lib.color_phase_read(cycles) != 0:
            fail("could not read the marks")
        marked_ms = t0.elapsed_time(t1)
        total = sum(cycles[k] for k in range(1, len(names)))
        D, _, fy, fx, epy, epx = stack.shape
        items = D * fy * fx * epy * epx
        nbytes = (stack.numel() + D * (2 + epy * epx)
                  + (stack.numel() if with_image else 0)) * 4
        t_bytes = nbytes / chip_smoke.PEAK_HBM_BYTES * 1e3
        t_ops = (items * (item_ops + (image_ops if with_image else 0))
                 / chip_smoke.PEAK_FP32_ADDS * 1e3)
        elapsed = marked_ms * 1e-3 * mhz * 1e6
        S = (parent_splits(epy * epx, fy * fx)[0] if parent
             else eye_tail.colorimetry_splits(epy * epx, fy * fx)[0])
        r = {"shape": list(stack.shape), "image": with_image,
             "splits": S, "ms": ms, "marked_ms": marked_ms,
             "bytes": nbytes, "gb_s": nbytes / (ms * 1e-3) / 1e9,
             "bound_bytes_ms": t_bytes, "bound_ops_ms": t_ops,
             "metrics_rel_to_shipped": rel, "image_equal": image_same,
             "lane_cycles": total,
             "chains_per_sm": cycles[1] / (sms * elapsed), "phases": {}}
        for k in range(1, len(names)):
            share = cycles[k] / total if total else 0.0
            r["phases"][names[k]] = {"share": share,
                                     "lane_cycles": int(cycles[k])}
        record["cases"][name] = r
        split = ", ".join(f"{k} {v['share'] * 100:.1f} %"
                          for k, v in r["phases"].items())
        print(f"{name}: stack {tuple(stack.shape)}"
              f"{' with the image' if with_image else ''}, {S} splits: "
              f"kernel {ms:.4f} ms ({r['gb_s']:.0f} GB/s), marked copy "
              f"{marked_ms:.4f} ms; bound: bytes {t_bytes:.4f} ms, lane "
              f"instructions {t_ops:.4f} ms; against the shipped kernel: "
              f"image {'equal' if with_image else '-'}, metrics "
              + ", ".join(f"{k} {v:.3g}" for k, v in rel.items())
              + f" relative; lane-cycles by phase: {split}; chains in "
              f"flight an SM {r['chains_per_sm']:.1f}", flush=True)
        del stack
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
