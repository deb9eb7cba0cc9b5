"""The benchmark's machinery: it reads ``BENCHMARK.json`` and, by the names
there, a cell's configuration (``configs/<name>.json``), its traffic mix
(``traffic/<name>.json``), the driver of the configuration's entry point
(``entries/<entry>.py``) and the readers of its per-layer metrics
(``layers/<metric>.py``); it runs one cell as one process: set-up with one
warm-up request, a closed loop of whole requests for the window, an optional
``torch.profiler`` trace of the window, the check of the outputs against the
plain reference, and the result line.

An entry's driver is a module with a class ``Entry(config, traffic, seed,
device)`` that has ``setup()`` (imports, kernel builds and the warm-up
request), ``request(k) -> record``, ``end_to_end(records, window_s) ->
dict``, ``spans(data)`` (a context manager that, in the traced run, wraps the
program's layers in named profiler ranges and collects what the readers
need into ``data``), ``layer_data(records, data)``, ``release()`` and
``check(records) -> [(name, value, limit), ...]``.  A layer's reader is a
module with ``read(ctx) -> float or None``.
"""

from __future__ import annotations

import contextlib
import importlib.util
import json
import os
import re
import sys
import tempfile
import time
import traceback
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# top-level module names that no run may load: JAX, its libraries and the
# JAX package that the port was made from
FORBIDDEN = ("jax", "jaxlib", "flax",
             "gpu_ray_tracing_for_waveguide_based_ar_display_tpu")


def forbidden_modules(modules=None) -> list:
    """The forbidden top-level names among ``modules`` (default: the loaded
    modules), each compared whole: the part before the first dot."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".", 1)[0] for m in names} & set(FORBIDDEN))


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    """A module of the benchmark loaded from its file (names may hold
    dots, so not by import)."""
    name = "benchmark_" + re.sub(r"\W", "_", str(path.relative_to(HERE)))
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _listed(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(spec: dict, workload: str) -> tuple:
    """The cell's end-to-end metrics and its per-layer metrics."""
    e2e = [m for m in spec["end_to_end"] if _listed(m, workload)]
    names = {m["name"] for m in e2e}
    layers = [m for m in spec["per_layer"]
              if _listed(m, workload) and m["moves"] in names]
    return e2e, layers


def load_cell(spec: dict, workload: str, overrides=None) -> tuple:
    """(workload entry, configuration, traffic) by name; ``overrides``
    (tests) replaces keys of the configuration's ``workload`` and of the
    traffic."""
    wl = {w["name"]: w for w in spec["workloads"]}.get(workload)
    if wl is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    config = load_json(HERE / "configs" / f"{wl['config']}.json")
    traffic = load_json(HERE / "traffic" / f"{wl['traffic']}.json")
    if overrides:
        config = dict(config, workload=dict(config["workload"],
                                            **overrides.get("workload", {})))
        traffic = dict(traffic, **overrides.get("traffic", {}))
    return wl, config, traffic


# ---------------------------------------------------------------------------
# the profiler's trace


def _kernel_name(name: str) -> str:
    """A kernel's base name: no return type, template arguments or
    parameters."""
    name = re.sub(r"^void\s+", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0:
            break
        elif depth == 0:
            out.append(ch)
    return "".join(out).strip() or name


def _union(intervals) -> list:
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize_trace(events: list, window: str = "window") -> dict:
    """Device time in the window of a Chrome trace's events (``ts`` and
    ``dur`` in microseconds): ``busy_s`` (the union of kernels, copies and
    fills), ``window_s``, ``kernels`` (seconds by kernel base name),
    ``device_ops`` (the ten largest) and ``idle_gaps`` (the ten longest
    gaps with no device activity, each named after the innermost benchmark
    span open on the host at its midpoint)."""
    spans = [e for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"]
    wins = [e for e in spans if e["name"] == window]
    if not wins:
        return {}
    w0 = wins[0]["ts"]
    w1 = w0 + wins[0]["dur"]
    dev, kernels = [], {}
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS:
            continue
        a, b = max(e["ts"], w0), min(e["ts"] + e["dur"], w1)
        if b <= a:
            continue
        dev.append((a, b))
        name = (_kernel_name(e["name"]) if e["cat"] == "kernel"
                else e["cat"])
        kernels[name] = kernels.get(name, 0.0) + (b - a) * 1e-6
    busy = _union(dev)
    gaps, t = [], w0
    for a, b in busy + [[w1, w1]]:
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    inner = [e for e in spans if e["name"] != window]

    def label(a, b):
        mid = 0.5 * (a + b)
        open_ = [e for e in inner if e["ts"] <= mid < e["ts"] + e["dur"]]
        return max(open_, key=lambda e: e["ts"])["name"] if open_ else window

    longest = sorted(gaps, key=lambda g: g[0] - g[1])[:10]
    return {
        "busy_s": sum(b - a for a, b in busy) * 1e-6,
        "window_s": (w1 - w0) * 1e-6,
        "kernels": kernels,
        "device_ops": sorted(([k, v] for k, v in kernels.items()),
                             key=lambda kv: -kv[1])[:10],
        "idle_gaps": [[label(a, b), (b - a) * 1e-6] for a, b in longest],
    }


@contextlib.contextmanager
def profiled(on: bool, out: dict):
    """A ``torch.profiler`` trace of the block (host and device) when
    ``on``; its summary lands in ``out`` (see :func:`summarize_trace`)."""
    if not on:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        yield
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.unlink(path)
    out.update(summarize_trace(events))


def span(name: str):
    """A named range on the profiler's host timeline (a no-op unless a
    profiler records)."""
    import torch

    return torch.profiler.record_function(name)


# ---------------------------------------------------------------------------
# one run


class LayerContext:
    """What a per-layer reader reads: the window's request records, the
    trace's summary, what the entry collected in the traced run, the
    configuration and the cell's traffic."""

    def __init__(self, records, trace, data, config, traffic):
        self.records = records
        self.trace = trace
        self.data = data
        self.config = config
        self.traffic = traffic

    @property
    def designs(self) -> int:
        return sum(r["designs"] for r in self.records)

    def roofline(self, kernel: str):
        return load_module(HERE / "roofline" / f"{kernel}.py")


def run_cell(spec: dict, workload: str, seed: int, seconds: float,
             trace: bool, *, device: str = "cuda", t_start=None,
             overrides=None, log=sys.stderr) -> dict:
    """One run of a cell; returns the result line's object (``checks``
    last).  ``t_start``: the host clock when the process started."""
    import torch

    if t_start is None:
        t_start = time.perf_counter()
    wl, config, traffic = load_cell(spec, workload, overrides)
    e2e_spec, layer_spec = cell_metrics(spec, workload)
    entry = load_module(HERE / "entries" / f"{config['entry']}.py").Entry(
        config, traffic, seed, device)
    t_entry = time.perf_counter()
    entry.setup()
    setup_s = time.perf_counter() - t_start
    print(f"setup {setup_s:.3f} s: {t_entry - t_start:.3f} s to the entry's "
          f"set-up", file=log)

    records, attempted, failed = [], 0, 0
    trace_out, data = {}, {}
    with profiled(trace, trace_out), entry.spans(data if trace else None):
        with span("window"):
            t0 = time.perf_counter()
            k = 0
            while True:
                attempted += entry.designs_per_request
                try:
                    with span("request"):
                        records.append(entry.request(k))
                except Exception:   # a failed request counts, the loop goes on
                    failed += entry.designs_per_request
                    traceback.print_exc(file=log)
                k += 1
                if time.perf_counter() - t0 >= seconds:
                    break
            window_s = time.perf_counter() - t0

    on_gpu = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if on_gpu else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_gpu else "cpu",
           "count": 1,
           "memory_peak_bytes": (int(torch.cuda.max_memory_allocated())
                                 if on_gpu else 0)}
    print(f"window {window_s:.3f} s: {len(records)} requests",
          file=log)
    if trace:
        entry.layer_data(records, data)
    entry.release()
    t_check = time.perf_counter()
    checks = entry.check(records) if records else []
    print(f"check {time.perf_counter() - t_check:.1f} s", file=log)
    correct = (bool(records) and failed == 0
               and all(v <= lim for _, v, lim in checks))

    metrics = {}
    if not trace:
        values = dict(entry.end_to_end(records, window_s), setup_s=setup_s)
        for m in e2e_spec:
            if m["name"] in values:
                metrics[m["name"]] = {"value": values[m["name"]],
                                      "unit": m["unit"]}
    else:
        ctx = LayerContext(records, trace_out, data, config, traffic)
        for m in layer_spec:
            value = load_module(HERE / "layers" / f"{m['name']}.py").read(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if trace_out:
            dev["busy_s"] = trace_out["busy_s"]
            dev["window_s"] = trace_out["window_s"]
    line = {"correct": correct, "attempted": attempted, "failed": failed,
            "metrics": metrics, "device": dev}
    if trace and trace_out:
        line["breakdown"] = {"device_ops": trace_out["device_ops"],
                             "idle_gaps": trace_out["idle_gaps"]}
    line["checks"] = {name: {"value": v, "limit": lim}
                      for name, v, lim in checks}
    return line
