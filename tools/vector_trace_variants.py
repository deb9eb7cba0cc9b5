#!/usr/bin/env python3
"""What the parts of the vector kernel's design buy, on one NVIDIA GPU:
variants of ``csrc/vector_trace.cu`` timed against the shipped kernel.

    python3 tools/vector_trace_variants.py [--variants a,b] [--cases a,b]
        [--reps 3] [--record PATH]

Run from the repository root.  Each variant is the shipped source (and its
headers) with a few lines replaced, compiled by ``nvcc`` with the shipped
flags into ``build/kernels/vector_trace_variants/<name>/``; its registers
and spills are printed.  On ``chip_smoke.py`` phase 22's calls
(``chip_smoke.vector_cases``) each variant is timed with CUDA events
beside the shipped kernel (``chip_smoke.device_ms``: ``--reps`` launches
queued behind 0.1 s of device spin; two rounds in one process, each the
shipped kernel, the variants, the shipped kernel again, the second round's
variants in the reverse order), and the entries of its outputs that differ in
their bits from the shipped kernel's are counted: every variant here
changes how the work is scheduled or laid out, not what it computes, so
each must count none.  ``--record PATH`` writes every number as JSON.  It
imports nothing of JAX.
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

_RANGE = ("  *out = rays < MAX_RAYS_PER_THREAD ? (int)rays : "
          "MAX_RAYS_PER_THREAD;")
_REFILL = "constexpr int REFILL = 8; "
_BLOCKS = "constexpr int MIN_BLOCKS = 4;"

# name -> (what it measures, [(file, shipped text, replacement)])
VARIANTS = {
    "one_ray_a_lane": (
        "no refill: a block's range is one ray a thread, each lane traces "
        "one ray (the parent's schedule) with the warp's region tests",
        [("vector_trace.cu", _RANGE, "  *out = 1;")]),
    "range_2": (
        "2 rays a thread in every block's range (shipped: sized to about "
        "ten waves, 2 to 8)",
        [("vector_trace.cu", _RANGE, "  *out = 2;")]),
    "range_4": (
        "4 rays a thread in every block's range (the first form's)",
        [("vector_trace.cu", _RANGE, "  *out = 4;")]),
    "range_8": (
        "8 rays a thread in every block's range",
        [("vector_trace.cu", _RANGE, "  *out = 8;")]),
    "range_16": (
        "16 rays a thread in every block's range",
        [("vector_trace.cu", _RANGE, "  *out = 16;")]),
    "refill_4": (
        "a warp claims rays once 4 lanes are free (shipped: 8)",
        [("vector_trace.cu", _REFILL, "constexpr int REFILL = 4; ")]),
    "refill_16": (
        "a warp claims rays once 16 lanes are free (shipped: 8)",
        [("vector_trace.cu", _REFILL, "constexpr int REFILL = 16; ")]),
    "blocks_3": (
        "__launch_bounds__(256, 3): up to 80 registers (shipped: 4, 64)",
        [("vector_trace.cu", _BLOCKS, "constexpr int MIN_BLOCKS = 3;")]),
    "blocks_2": (
        "__launch_bounds__(256, 2): up to 128 registers (shipped: 4, 64)",
        [("vector_trace.cu", _BLOCKS, "constexpr int MIN_BLOCKS = 2;")]),
    "threads_128": (
        "blocks of 128 threads, 8 an SM at up to 64 registers (shipped: "
        "256, 4)",
        [("vector_trace.cu", "constexpr int THREADS = 256;",
          "constexpr int THREADS = 128;"),
         ("vector_trace.cu", _BLOCKS, "constexpr int MIN_BLOCKS = 8;")]),
    "one_strip": (
        "the record key with only the strip division that the ray's group "
        "reads (site_key computes both)",
        [("vector_trace.cu",
          "        key = site_key(geo, x, y, state, grp_fc, grp_oc, a.num_fc, "
          "a.num_oc,\n                       in_rect);",
          "        in_rect = x >= geo.g[G_B0] - EDGE_TOL\n"
          "                  && x <= geo.g[G_B1] + EDGE_TOL\n"
          "                  && y >= geo.g[G_B2] - EDGE_TOL\n"
          "                  && y <= geo.g[G_B3] + EDGE_TOL;\n"
          "        int site = 0;\n"
          "        if (grp_fc) {\n"
          "          const float yrot = geo.g[G_FCR0] * x + geo.g[G_FCR1] * y;\n"
          "          site = 1 + bin_of(__fdiv_rn(geo.g[G_FC_TOP] - yrot,\n"
          "                                      geo.g[G_FC_WIDTH]),\n"
          "                            a.num_fc - 1);\n"
          "        } else if (grp_oc) {\n"
          "          const float yr = geo.g[G_OCR0] * x + geo.g[G_OCR1] * y;\n"
          "          site = 1 + a.num_fc\n"
          "                 + bin_of(__fdiv_rn(geo.g[G_OC_TOP] - yr,\n"
          "                                    geo.g[G_OC_WIDTH]),\n"
          "                          a.num_oc - 1);\n"
          "        }\n"
          "        key = site * 2 + (state & 1);")]),
    "ldg_records": (
        "the record loads through the read-only data cache (__ldg)",
        [("vector_trace.cu",
          "  for (int k = 0; k < 24; ++k) jr[k] = t.rec[k * t.s_rec + key];\n"
          "  const float s_a = t.rec[24 * t.s_rec + key];\n"
          "  const float s_b = t.rec[25 * t.s_rec + key];",
          "  for (int k = 0; k < 24; ++k) jr[k] = __ldg(t.rec + k * t.s_rec + key);\n"
          "  const float s_a = __ldg(t.rec + 24 * t.s_rec + key);\n"
          "  const float s_b = __ldg(t.rec + 25 * t.s_rec + key);")]),
    "coarse_rows": (
        "the refined rows left out: every region of a cell the coarse grid "
        "leaves open takes the warp's exact test where the step reads it",
        [("step_common.cuh",
          "  return sub_codes[((-1 - v) * sub + sv) * sub + su];",
          "  return 0x2A;")]),
}


def fail(msg: str) -> None:
    print(f"vector_trace_variants: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def compile_variant(build, name: str, edits: list) -> tuple:
    """Build one variant: (name, library path or None, nvcc's report)."""
    d = build.BUILD_DIR / "vector_trace_variants" / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in [*build.CSRC.glob("*.cuh"), build.CSRC / "vector_trace.cu"]:
        text = src.read_text()
        for fname, old, new in edits:
            if fname == src.name:
                if old not in text:
                    fail(f"{name}: {old!r} is not in csrc/{fname}")
                text = text.replace(old, new)
        (d / src.name).write_text(text)
    so = d / "vector_trace.so"
    proc = subprocess.run([build.nvcc_path(), *build.NVCC_FLAGS, "-I", str(d),
                           "-o", str(so), str(d / "vector_trace.cu")],
                          capture_output=True, text=True)
    return name, so if proc.returncode == 0 else None, proc.stdout + proc.stderr


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--variants", default=",".join(VARIANTS))
    parser.add_argument("--cases", default=None,
                        help="phase 22's calls to time (default: all)")
    parser.add_argument("--reps", type=int, default=3)
    parser.add_argument("--record", default=None, metavar="PATH")
    opts = parser.parse_args()
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA device")
    sys.path.insert(0, str(ROOT))
    from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
        build, trace_vector as tv,
    )

    import chip_smoke
    sys.path.insert(0, str(ROOT / "tools"))
    from vector_trace_phases import bind

    card = chip_smoke.nvidia_smi()
    print(f"card: {card}", flush=True)
    names = [v for v in opts.variants.split(",") if v]
    unknown = set(names) - set(VARIANTS)
    if unknown:
        fail(f"unknown variants {sorted(unknown)}")
    shipped = tv.load_kernel()
    with concurrent.futures.ThreadPoolExecutor(max(1, len(names))) as pool:
        built = list(pool.map(lambda v: compile_variant(
            build, v, VARIANTS[v][1]), names))
    record = {"card": card, "shipped": chip_smoke.vector_occupancy(),
              "variants": {}, "cases": {}}
    libs = {}
    for name, so, log in built:
        if so is None:
            fail(f"{name}: nvcc: {log}")
        record["variants"][name] = {"what": VARIANTS[name][0],
                                    "ptxas": chip_smoke.ptxas_summary(log)}
        print(f"{name} ({VARIANTS[name][0]}): "
              f"{record['variants'][name]['ptxas']}", flush=True)
        libs[name] = bind(ctypes.CDLL(str(so)), tv)
    dev = torch.device("cuda")
    cases = opts.cases.split(",") if opts.cases else None
    for case, a, _ in chip_smoke.vector_cases(dev):
        if cases and case not in cases:
            continue
        ref = tv.launch_vector_trace(a)
        torch.cuda.synchronize()
        row = {"shipped": {"ms": []}}
        for name, lib in libs.items():
            tv._LIB = lib
            try:
                e = chip_smoke.vector_compare(tv.launch_vector_trace(a), ref)
            finally:
                tv._LIB = shipped
            row[name] = {"ms": [], "bits_differ": sum(
                e["fields_differ"].values()) + (not e["bounces_equal"])
                + (not e["steps_equal"])}
        # two rounds, the shipped kernel first and last in each, the
        # variants in one order and then the other
        order = list(libs)
        for _ in range(2):
            for name in ["shipped", *order, "shipped"]:
                tv._LIB = libs.get(name, shipped)
                try:
                    row[name]["ms"].append(chip_smoke.device_ms(
                        lambda: tv.launch_vector_trace(a), opts.reps))
                finally:
                    tv._LIB = shipped
            order.reverse()
        record["cases"][case] = row
        print(f"{case}: " + ", ".join(
            f"{k} {' / '.join(f'{m:.3f}' for m in v['ms'])} ms"
            + (f" ({v['bits_differ']} differ)" if v.get("bits_differ")
               else "") for k, v in row.items()), flush=True)
        del ref
    if opts.record:
        Path(opts.record).parent.mkdir(parents=True, exist_ok=True)
        Path(opts.record).write_text(json.dumps(record, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
