"""Run one cell of the benchmark on this machine's NVIDIA GPU and print its
result as the last line of standard output::

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics from a ``torch.profiler`` trace of the window.  The
numbers that decided ``correct`` close standard error and the result line.
Exits non-zero, printing no result, without a CUDA device, or if JAX or the
JAX package was loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return "unknown"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "unknown"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    # every cache the program or its libraries keep lives in the checkout
    build = ROOT / "build"
    os.environ.setdefault("TORCH_EXTENSIONS_DIR", str(build / "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", str(build / "triton"))
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_spec(ROOT)
    wl = {w["name"]: w for w in spec["workloads"]}.get(args.workload)
    if wl is None:
        print(f"no workload {args.workload!r} in BENCHMARK.json",
              file=sys.stderr)
        return 2
    t_imports = time.perf_counter()
    import torch

    t_torch = time.perf_counter()
    if not torch.cuda.is_available() or torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " available", file=sys.stderr)
        return 2
    t_card = time.perf_counter()
    print(f"card: {_power_limit()}", file=sys.stderr)
    print(f"start {t_imports - T_START:.3f} s, torch {t_torch - t_imports:.3f}"
          f" s, device count {t_card - t_torch:.3f} s, nvidia-smi "
          f"{time.perf_counter() - t_card:.3f} s", file=sys.stderr)
    line = harness.run_cell(spec, args.workload, args.seed, args.seconds,
                            bool(args.trace), device="cuda",
                            t_start=T_START)
    found = harness.forbidden_modules()
    if found:
        print(f"forbidden modules loaded: {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
