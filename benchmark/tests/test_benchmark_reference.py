"""The plain reference at a tiny size: it runs, and it gives what the
program's plain path gives (the program's CUDA kernels equal their plain
versions bit for bit, so on the card it is the same comparison); the
control, the program's bfloat16-packed selection, is refused."""

import dataclasses
import io

import numpy as np

from benchmark import harness
from benchmark.reference import sweep as reference

PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"


def _work(tiny):
    _, config, traffic = harness.load_cell(harness.load_spec(),
                                           "sweep.screen", tiny)
    return config, traffic


def test_reference_equals_the_programs_plain_path(tiny, seed):
    import importlib

    config, traffic = _work(tiny)
    w = config["workload"]
    cfgmod = importlib.import_module(f"{PORT}.config")
    ds = importlib.import_module(f"{PORT}.sweep.design_sweep")
    fields = dict(config["design"], lambda_ic=381.7, lambda_oc=381.7)
    design = cfgmod.WaveguideDesign(**{k: tuple(v) if isinstance(v, list)
                                       else v for k, v in fields.items()})
    cfg = cfgmod.TraceConfig(num_fov_x=w["num_fov_x"],
                             num_fov_y=w["num_fov_y"],
                             rays_per_fov=w["rays_per_fov"],
                             max_bounces=w["max_bounces"], seed=seed)
    res = ds.run_design_sweep_persistent(
        [design], cfg, spawn_iters=w["spawn_iters"], slots=w["slots"],
        evaluate_metrics=True, device="cpu")
    [ref] = reference.designs_result([fields], w, seed, device="cpu")
    assert int(res.bounces[0]) == ref.bounces > 0
    np.testing.assert_allclose(res.efficiencies[0], ref.efficiencies,
                               rtol=1e-6)
    m = res.metrics[0]
    np.testing.assert_allclose([m.delta_e, m.u_fov],
                               [ref.metrics.delta_e, ref.metrics.u_fov],
                               rtol=1e-5)
    assert m.starved_eye_positions == ref.metrics.starved_eye_positions
    assert ref.deposits > 0
    assert reference.r1_edges(fields, w) > 0


def test_control_packed_selection_is_not_correct(tiny, seed, monkeypatch):
    """The control: the program with its bfloat16-packed selection records
    (the precision below the configuration's float32) in the program's
    place; its run must come out not correct."""
    entry = harness.load_module(harness.HERE / "entries" / "sweep.py")
    real = entry.Entry.__init__

    def packed(self, *a, **kw):
        real(self, *a, **kw)
        self.accum_mode = "packed"

    monkeypatch.setattr(entry.Entry, "__init__", packed)
    monkeypatch.setattr(harness, "load_module",
                        lambda path, _real=harness.load_module:
                        entry if path.name == "sweep.py"
                        and path.parent.name == "entries" else _real(path))
    line = harness.run_cell(harness.load_spec(), "sweep.screen", seed, 0.0,
                            False, device="cpu", overrides=tiny,
                            log=io.StringIO())
    assert line["correct"] is False
    failed = [n for n, c in line["checks"].items() if c["value"] > c["limit"]]
    assert failed


def test_designs_traced_together_equal_each_alone(tiny, seed):
    """The batched reference of several designs gives each design what its
    own trace gives, bit for bit."""
    config, _ = _work(tiny)
    w = config["workload"]
    fields = [dict(config["design"], lambda_ic=p, lambda_oc=p)
              for p in (372.4, 388.0, 401.9)]
    together = reference.designs_result(fields, w, seed, device="cpu")
    for f, t in zip(fields, together):
        [alone] = reference.designs_result([f], w, seed, device="cpu")
        assert t.bounces == alone.bounces and t.deposits == alone.deposits
        np.testing.assert_array_equal(t.efficiencies, alone.efficiencies)
        assert dataclasses.astuple(t.metrics) == dataclasses.astuple(
            alone.metrics)
