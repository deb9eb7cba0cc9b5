"""Lane instructions of a CUDA library call's fast path, from its SASS.

Imported by ``tools/cell_rows_phases.py`` and ``tools/colorimetry_phases.py``
(run on a machine with an NVIDIA GPU and the CUDA toolkit).  It compiles,
into ``build/kernels/sass_paths/``, one small kernel a call (``powf(x, y)``,
``x / y`` as IEEE division, ``__ddiv_rn``, ...) beside a frame kernel that
loads and stores the same operands with one add, with the repository's
``nvcc`` flags, and reads their SASS with ``cuobjdump -sass``.  A call's
count is the shortest path through its kernel's control-flow graph, entry to
``EXIT`` (a subroutine ``CALL`` costs its own shortest path to ``RET``),
less the frame's, plus the frame's add: the instructions its fast path
issues, a floor for any input (a special case that branches to a shorter
path would lower it; predicated instructions count, as they issue).  The
static count (every instruction the kernel holds, its subroutines
included) is kept beside it.  FP64 instructions (``D*`` and the 64-bit
``MUFU`` forms) are counted apart, as they issue at half the FP32 lanes.
"""

from __future__ import annotations

import heapq
import re
import shutil
import subprocess
from pathlib import Path

# name -> (C type, expression of the operands x and y)
CALLS = {
    "powf": ("float", "powf(x, y)"),
    "div": ("float", "x / y"),
    "sqrtf": ("float", "sqrtf(x)"),
    "hypotf": ("float", "hypotf(x, y)"),
    "atan2f": ("float", "atan2f(x, y)"),
    "fmodf": ("float", "fmodf(x, y)"),
    "sinf": ("float", "sinf(x)"),
    "cosf": ("float", "cosf(x)"),
    "expf": ("float", "expf(x)"),
    "ddiv_rn": ("double", "__ddiv_rn(x, y)"),
    "dsqrt_rn": ("double", "__dsqrt_rn(x)"),
}

INSTR = re.compile(r"/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;")
FUNCTION = re.compile(r"Function\s*:\s*(\S+)")
TARGET = re.compile(r"0x([0-9a-f]+)")


def probe_source() -> str:
    """One kernel a call and one frame kernel a type: ``o[i] = f(x[i],
    y[i])`` over exactly the launched threads (no bounds test, no early
    exit)."""
    out = ["#include <cuda_runtime.h>", "#include <math.h>"]
    for t in ("float", "double"):
        out.append(f'extern "C" __global__ void frame_{t}(const {t}* a, '
                   f'const {t}* b, {t}* o) {{ const int i = threadIdx.x; '
                   f'const {t} x = a[i], y = b[i]; o[i] = x + y; }}')
    for name, (t, expr) in CALLS.items():
        out.append(f'extern "C" __global__ void probe_{name}(const {t}* a, '
                   f'const {t}* b, {t}* o) {{ const int i = threadIdx.x; '
                   f'const {t} x = a[i], y = b[i]; o[i] = {expr}; }}')
    return "\n".join(out) + "\n"


def cuobjdump_path(nvcc: str) -> str:
    found = shutil.which("cuobjdump")
    if found:
        return found
    cand = Path(nvcc).parent / "cuobjdump"
    if cand.is_file():
        return str(cand)
    raise RuntimeError("cuobjdump not found beside nvcc or on PATH")


def parse_sass(text: str) -> dict:
    """``{function: [(address, predicated, opcode, operands)]}`` of
    ``cuobjdump -sass`` output."""
    funcs, cur = {}, None
    for line in text.splitlines():
        m = FUNCTION.search(line)
        if m:
            cur = funcs.setdefault(m.group(1), [])
            continue
        m = INSTR.search(line)
        if m and cur is not None:
            body = m.group(2).strip()
            pred = body.startswith("@")
            if pred:
                body = body.split(None, 1)[1] if " " in body else ""
            op, _, rest = body.partition(" ")
            cur.append((int(m.group(1), 16), pred, op, rest))
    return funcs


def _is_fp64(op: str, rest: str) -> bool:
    return (op.startswith(("DADD", "DMUL", "DFMA", "DSETP", "DMNMX"))
            or (op.startswith("MUFU") and "64" in op))


def shortest_path(instrs: list, start: int = 0, until: str = "EXIT",
                  memo: dict = None) -> tuple:
    """``(instructions, fp64 instructions)`` on the shortest path from the
    instruction at ``start`` (an address) to the first ``until`` opcode
    taken (``EXIT`` for a kernel, ``RET`` for a subroutine)."""
    memo = {} if memo is None else memo
    at = {addr: k for k, (addr, _, _, _) in enumerate(instrs)}
    if start not in at:
        raise ValueError(f"no instruction at {start:#x}")

    def cost(k):
        _, _, op, rest = instrs[k]
        n, f = 1, int(_is_fp64(op, rest))
        if op.startswith("CALL"):
            tgt = int(TARGET.findall(rest)[-1], 16)
            if tgt not in memo:
                memo[tgt] = (0, 0)   # a recursive call costs its entry only
                memo[tgt] = shortest_path(instrs, tgt, "RET", memo)
            n, f = n + memo[tgt][0], f + memo[tgt][1]
        return n, f

    k0 = at[start]
    best = {k0: cost(k0)}
    heap = [(best[k0][0], best[k0][1], k0)]
    while heap:
        n, f, k = heapq.heappop(heap)
        if (n, f) != best.get(k):
            continue
        _, pred, op, rest = instrs[k]
        if op.startswith(until):
            return n, f
        nxt = []
        ends = op.startswith(("EXIT", "RET", "BPT"))
        if op.startswith(("BRA", "JMP")):
            nxt.append(at.get(int(TARGET.findall(rest)[-1], 16)))
            if pred:
                nxt.append(k + 1)
        elif not ends or pred:
            nxt.append(k + 1)
        for j in nxt:
            if j is None or j >= len(instrs):
                continue
            cn, cf = cost(j)
            cand = (n + cn, f + cf)
            if j not in best or cand < best[j]:
                best[j] = cand
                heapq.heappush(heap, (cand[0], cand[1], j))
    raise ValueError(f"no {until} reachable from {start:#x}")


def call_counts(build, out_dir: Path) -> dict:
    """``{call: {"path": n, "fp64": f, "static": s}}``: each call's fast
    path (its kernel's shortest path less its frame's, plus the frame's
    add) with its FP64 instructions, and its kernel's static size less the
    frame's.  Compiles the probes with ``build.NVCC_FLAGS``."""
    out_dir.mkdir(parents=True, exist_ok=True)
    cu = out_dir / "sass_probes.cu"
    cu.write_text(probe_source())
    so = out_dir / "sass_probes.so"
    nvcc = build.nvcc_path()
    proc = subprocess.run([nvcc, *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc (sass probes): {proc.stdout}{proc.stderr}")
    sass = subprocess.run([cuobjdump_path(nvcc), "-sass", str(so)],
                          capture_output=True, text=True, check=True).stdout
    (out_dir / "sass_probes.sass").write_text(sass)
    funcs = parse_sass(sass)
    frames = {t: shortest_path(funcs[f"frame_{t}"]) for t in
              ("float", "double")}
    sizes = {t: len(funcs[f"frame_{t}"]) for t in ("float", "double")}
    out = {}
    for name, (t, _) in CALLS.items():
        fn = funcs[f"probe_{name}"]
        n, f = shortest_path(fn)
        fn0, f0 = frames[t]
        out[name] = {"path": n - fn0 + 1,
                     "fp64": f - f0 + (1 if t == "double" else 0),
                     "static": len(fn) - sizes[t] + 1}
    return out
