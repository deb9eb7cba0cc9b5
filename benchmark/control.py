"""Readings that set the check's limits, at the cell's own size, on the
card: for each seed one request of the cell's traffic, its sampled designs
(one in each half of each launch) traced again by the reference, and the
gaps of the program (the lower readings) and of the control (the upper
readings): the same request run with the program's bfloat16-packed
selection records, the precision below the configuration's float32::

    python3 benchmark/control.py --workload sweep.screen --seeds 1,2,3 \\
        --control-seeds 1,2 --out chiprun_out/control.json

The benchmark's runs do not run this.
"""

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from benchmark import harness

    spec = harness.load_spec(ROOT)
    _, config, traffic = harness.load_cell(spec, args.workload)
    mod = harness.load_module(harness.HERE / "entries"
                              / f"{config['entry']}.py")
    control = {int(s) for s in args.control_seeds.split(",") if s}
    rows = []
    for seed in (int(s) for s in args.seeds.split(",")):
        entry = mod.Entry(config, traffic, seed, "cuda")
        entry.setup()
        t0 = time.perf_counter()
        rec = entry.request(0)
        t_req = time.perf_counter() - t0
        r, ds = entry.sample([rec])
        t0 = time.perf_counter()
        ref = entry.reference(r, ds)
        t_ref = time.perf_counter() - t0
        row = {"seed": seed, "designs": ds, "request_s": t_req,
               "reference_s": t_ref, "program": entry.gaps(r, ds, ref),
               "each": [entry.gaps(r, [d], [f]) for d, f in zip(ds, ref)]}
        if seed in control:
            entry.accum_mode = "packed"
            row["control"] = entry.gaps(entry.request(0), ds, ref)
        rows.append(row)
        print(json.dumps(row), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
