"""Driver of the persistent design sweep: each request is one
``run_design_sweep_persistent`` call over the request's designs, as ``sweep
--metrics`` makes it (gens spawn saturated to ``spawn_iters``, the display
metrics on the device, no histogram kept), in chunks of
``designs_per_batch`` designs.

The check: one request drawn from the seed and, in each half of each of
its launches, one design drawn from the seed (eight of the 64 designs of
four 16-design launches), traced again together by the plain reference
(:mod:`benchmark.reference.sweep`) from their fields, the workload and the
seed; the program's efficiencies, bounces and metrics against the
reference's, the largest gap over the designs.
"""

from __future__ import annotations

import contextlib
import sys
import time

import numpy as np
import torch

from benchmark import generator, harness
from benchmark.reference import sweep as reference

PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"
SALT_REQUEST, SALT_DESIGN = 101, 102
FLOOR = 1e-3   # metrics below this compare absolutely (u_eyebox reads 0)


def _worst(a: float, b: float) -> float:
    """The larger gap; a NaN wins, so that it fails its limit."""
    if a != a or b != b:
        return float("nan")
    return max(a, b)


def _design(cls, fields: dict):
    return cls(**{k: tuple(v) if isinstance(v, list) else v
                  for k, v in fields.items()})


class Entry:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str,
                 accum_mode=None):
        # a negative seed maps to a non-negative one (numpy's and the
        # port's seeding take those); every other seed is itself
        self.config, self.traffic = config, traffic
        self.seed = int(seed) % 2**63
        self.work = config["workload"]
        self.device = device
        self.accum_mode = accum_mode or self.work["accum_mode"]
        self.designs_per_request = int(traffic["designs_per_request"])

    def setup(self) -> None:
        import importlib

        self.cfgmod = importlib.import_module(f"{PORT}.config")
        self.ds = importlib.import_module(f"{PORT}.sweep.design_sweep")
        w = self.work
        self.cfg = self.cfgmod.TraceConfig(
            num_fov_x=w["num_fov_x"], num_fov_y=w["num_fov_y"],
            rays_per_fov=w["rays_per_fov"], max_bounces=w["max_bounces"],
            eyebox_bins=tuple(w["eyebox_bins"]), seed=self.seed)
        self.eval_cfg = self.cfgmod.EvalConfig(
            pupil_mask_bins=w["pupil_mask_bins"], eye_step_y=w["eye_stride"][0],
            eye_step_x=w["eye_stride"][1])
        t0 = time.perf_counter()
        self._run(generator.WARMUP)
        print(f"warm-up request {time.perf_counter() - t0:.3f} s",
              file=sys.stderr)

    def fields(self, k: int) -> list:
        """The designs of request ``k``; the warm-up request has two
        launches' worth (every shape of the window, and a chunk's prep
        behind a trace), not a whole request."""
        traffic = self.traffic
        if k == generator.WARMUP:
            per = int(traffic["designs_per_batch"])
            traffic = dict(traffic, designs_per_request=min(
                2 * per, self.designs_per_request))
        return generator.request_designs(self.config, traffic, self.seed, k)

    def _run(self, k: int):
        w = self.work
        designs = [_design(self.cfgmod.WaveguideDesign, f)
                   for f in self.fields(k)]
        res = self.ds.run_design_sweep_persistent(
            designs, self.cfg, lut_seed=w["lut_seed"],
            spawn_iters=w["spawn_iters"], spawn_mode=w["spawn_mode"],
            slots=w["slots"], evaluate_metrics=True, eval_cfg=self.eval_cfg,
            designs_per_batch=self.traffic["designs_per_batch"],
            device=self.device, accum_mode=self.accum_mode)
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return res

    def request(self, k: int) -> dict:
        t0 = time.perf_counter()
        res = self._run(k)
        t = res.timings
        print(f"request {k}: {time.perf_counter() - t0:.3f} s, kernel "
              f"{t.get('kernel_ms', 0):.1f} ms, prep {t['prep_s']:.3f} s "
              f"(geometry {t['prep_geometry_s']:.3f}, host rows "
              f"{t['prep_host_rows_s']:.3f}), metrics "
              f"{t.get('metrics_s', 0):.3f} s", file=sys.stderr)
        return {"k": k, "designs": len(res.designs),
                "efficiencies": np.asarray(res.efficiencies),
                "bounces": np.asarray(res.bounces),
                "metrics": [(m.delta_e, m.u_fov, m.u_eyebox,
                             m.starved_eye_positions) for m in res.metrics],
                "timings": dict(res.timings)}

    def end_to_end(self, records: list, window_s: float) -> dict:
        designs = sum(r["designs"] for r in records)
        return {"designs_per_hour": designs / window_s * 3600.0}

    @contextlib.contextmanager
    def spans(self, data):
        """In the traced run (``data`` not None): the sweep's layers in
        named profiler ranges (prep, trace, reduce, metrics)."""
        if data is None:
            yield
            return
        ds, tp = self.ds, self.ds.trace_persistent
        saved = {(ds, n): getattr(ds, n) for n in
                 ("prepare_chunk", "_chunk_reduce", "_chunk_perceive",
                  "evaluate_batch")}
        saved[(tp, "persistent_trace")] = tp.persistent_trace
        names = {"prepare_chunk": "prep", "_chunk_reduce": "reduce",
                 "_chunk_perceive": "reduce", "evaluate_batch": "metrics",
                 "persistent_trace": "trace"}

        def ranged(fn, name):
            def call(*a, **kw):
                with harness.span(name):
                    return fn(*a, **kw)
            return call

        for (mod, n), fn in saved.items():
            setattr(mod, n, ranged(fn, names[n]))
        try:
            yield
        finally:
            for (mod, n), fn in saved.items():
                setattr(mod, n, fn)

    def layer_data(self, records: list, data: dict) -> None:
        """Each design's whole-system region edges (from the reference's
        geometry) times its bounces, the launches, and a floor of the
        deposits, for the trace kernel's roofline.

        The deposits' floor comes from the efficiencies, after the window,
        so that nothing is added to the traced device time: a design's
        efficiencies times the nominal rays of its cells are the sum of
        each cell's deposits times its Wald factor, nominal over spawned
        rays, and that factor is at most 1 where every slot spawned its
        quota, as the gens spawn's saturation makes it."""
        edges = {}
        bounce_edges = 0
        w = self.work
        slots, gens = reference.launch_shape(w["rays_per_fov"], w["slots"])
        fov_cells = w["num_fov_x"] * w["num_fov_y"]
        deposits = 0.0
        for r in records:
            for f, b in zip(self.fields(r["k"]), r["bounces"]):
                key = tuple(sorted((k, str(v)) for k, v in f.items()))
                if key not in edges:
                    edges[key] = reference.r1_edges(f, w)
                bounce_edges += int(b) * edges[key]
            deposits += (float(np.sum(r["efficiencies"]))
                         * slots * gens * fov_cells)
        data["edge_bounces"] = bounce_edges
        data["deposits"] = deposits
        data["launches"] = sum(r["timings"].get("launches", 0)
                               for r in records)

    def release(self) -> None:
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()

    def sample(self, records: list) -> tuple:
        """The request that the check compares, drawn from the seed, and in
        each half of each of its launches of ``designs_per_batch`` designs
        one design drawn from the seed: a launch or half a launch whose
        designs come out wrong is always among them."""
        r = records[generator.pick(self.seed, len(records), SALT_REQUEST)]
        n, per = r["designs"], int(self.traffic["designs_per_batch"])
        picks = []
        for a in range(0, n, per):
            b = min(a + per, n)
            for lo, hi in ((a, (a + b + 1) // 2), ((a + b + 1) // 2, b)):
                if hi > lo:
                    picks.append(lo + generator.pick(
                        self.seed, hi - lo, SALT_DESIGN + len(picks)))
        return r, picks

    def reference(self, record: dict, ds: list) -> list:
        fields = self.fields(record["k"])
        times = {}
        out = reference.designs_result([fields[d] for d in ds], self.work,
                                       self.seed, device=self.device,
                                       times=times)
        print("reference of designs " + ", ".join(map(str, ds)) + ": "
              + ", ".join(f"{k} {v:.3f}" for k, v in times.items()),
              file=sys.stderr)
        return out

    @staticmethod
    def gaps(record: dict, ds: list, refs: list) -> dict:
        """The program's answers for designs ``ds`` of ``record`` against the
        reference's, each the largest over the designs: the relative gap of
        the three efficiencies, the relative gap of the bounces, the gap of
        the three metrics (relative, absolute below ``FLOOR``) and the
        difference of the starved eye positions."""
        out = {"eff_gap": 0.0, "bounce_gap": 0.0, "metric_gap": 0.0,
               "starved_gap": 0.0}
        for d, ref in zip(ds, refs):
            eff = record["efficiencies"][d]
            prog = record["metrics"][d]
            m = ref.metrics
            one = {
                "eff_gap": float(np.max(np.abs(eff - ref.efficiencies)
                                        / ref.efficiencies)),
                "bounce_gap": abs(int(record["bounces"][d]) - ref.bounces)
                / ref.bounces,
                "metric_gap": float(np.max([
                    abs(p - q) / max(abs(q), FLOOR) for p, q in zip(
                        prog[:3], (m.delta_e, m.u_fov, m.u_eyebox))])),
                "starved_gap": float(abs(prog[3] - m.starved_eye_positions)),
            }
            out = {k: _worst(out[k], one[k]) for k in out}
        return out

    def check(self, records: list) -> list:
        """Each gap of :meth:`gaps` for the sampled designs, with its limit
        (the configuration's ``checks``)."""
        r, ds = self.sample(records)
        gaps = self.gaps(r, ds, self.reference(r, ds))
        lim = self.config["checks"]
        return [(name, gaps[name], lim[name]) for name in lim]
