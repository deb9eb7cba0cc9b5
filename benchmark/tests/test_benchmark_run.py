"""A whole run of the sweep cell on the CPU at a tiny size (the harness's
look for a chip skipped): the result line's keys, ``correct`` true on the
program's plain path, and ``correct`` false under each fault that the timed
path can have."""

import io

import numpy as np
import pytest
import torch

from benchmark import harness

PORT = "gpu_ray_tracing_for_waveguide_based_ar_display_torch"
CONTRACT_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def _run(tiny, seed, trace=False):
    return harness.run_cell(harness.load_spec(), "sweep.screen", seed, 0.0,
                            trace, device="cpu", overrides=tiny,
                            log=io.StringIO())


def test_result_line_has_the_contract_keys_and_checks_last(tiny, seed):
    line = _run(tiny, seed)
    assert set(line) == CONTRACT_KEYS | {"checks"}
    assert list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["attempted"] == 2 and line["failed"] == 0
    assert set(line["metrics"]) == {"designs_per_hour", "setup_s"}
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(line["device"]) == {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    assert set(line["checks"]) == {"eff_gap", "bounce_gap", "metric_gap",
                                   "starved_gap"}
    for c in line["checks"].values():
        assert c["value"] <= c["limit"]


def test_traced_run_reports_per_layer_metrics(tiny, seed):
    line = _run(tiny, seed, trace=True)
    assert line["correct"] is True
    # on the CPU no kernel runs: only the host span's metric is read
    assert set(line["metrics"]) == {"prep_host_s.sweep"}
    assert line["device"]["window_s"] > 0
    assert list(line)[-1] == "checks"


@pytest.fixture
def sweep_module():
    import importlib

    return importlib.import_module(f"{PORT}.sweep.design_sweep")


def test_state_left_unchanged_fails(tiny, seed, sweep_module, monkeypatch):
    tp = sweep_module.trace_persistent
    real = tp.persistent_trace

    def unchanged(*a, **kw):
        tiles, nb = real(*a, **kw)
        return torch.zeros_like(tiles), torch.zeros_like(nb)

    monkeypatch.setattr(tp, "persistent_trace", unchanged)
    line = _run(tiny, seed)
    assert line["correct"] is False
    assert line["checks"]["eff_gap"]["value"] > line["checks"]["eff_gap"]["limit"]


def test_half_the_batch_left_out_fails(tiny, seed, sweep_module,
                                       monkeypatch):
    real = sweep_module._chunk_reduce

    def half(tiles, nb, nd, n_cells, *rest):
        keep = tiles.clone().reshape(nd, n_cells, *tiles.shape[1:])
        keep[:, n_cells // 2:] = 0
        eff, bounces, factor = real(keep.reshape(tiles.shape), nb, nd,
                                    n_cells, *rest)
        return eff * 2.0, bounces, factor

    monkeypatch.setattr(sweep_module, "_chunk_reduce", half)
    line = _run(tiny, seed)
    assert line["correct"] is False


# two launches of four designs a request: the check compares four of the
# eight, one in each half of each launch
LAUNCHES = {"designs_per_request": 8, "designs_per_batch": 4}


@pytest.mark.parametrize("fault", ["half_zeroed", "half_stale",
                                   "second_launch_stale"])
@pytest.mark.parametrize("run_seed", [2**31 + 4099, 7, 2**32 + 77])
def test_half_of_a_launch_left_out_fails(tiny, run_seed, fault, sweep_module,
                                         monkeypatch):
    """Designs of a launch left out: the second half of each launch's
    designs zeroed, or given the first half's rows (stale), or a request's
    second launch given its first launch's rows; every seed fails."""
    tiny["traffic"].update(LAUNCHES)
    w = tiny["workload"]
    n_cells = 3 * w["num_fov_x"] * w["num_fov_y"]
    tp = sweep_module.trace_persistent
    real = tp.persistent_trace
    calls = []

    def faulty(*a, **kw):
        tiles, nb = real(*a, **kw)
        nd = tiles.shape[0] // n_cells
        calls.append((tiles.clone(), nb.clone()))
        if fault == "second_launch_stale":
            return calls[-2] if len(calls) % 2 == 0 else (tiles, nb)
        t = tiles.reshape(nd, n_cells, *tiles.shape[1:])
        b = nb.reshape(nd, n_cells, *nb.shape[1:])
        h = nd // 2
        if fault == "half_zeroed":
            t[h:], b[h:] = 0, 0
        else:
            t[h:], b[h:] = t[:nd - h].clone(), b[:nd - h].clone()
        return t.reshape(tiles.shape), b.reshape(nb.shape)

    monkeypatch.setattr(tp, "persistent_trace", faulty)
    line = _run(tiny, run_seed)
    assert line["correct"] is False
    assert line["attempted"] == 8 and line["failed"] == 0


def test_every_half_of_every_launch_is_sampled(tiny):
    """The check's sample holds one design from each half of each launch,
    for any seed, whole launches or a shorter last one."""
    _, config, traffic = harness.load_cell(harness.load_spec(),
                                           "sweep.screen", tiny)
    mod = harness.load_module(harness.HERE / "entries" / "sweep.py")
    for n, per in ((32, 16), (8, 4), (2, 1), (7, 4)):
        traffic = dict(traffic, designs_per_request=n, designs_per_batch=per)
        for s in (0, 5, 2**31 + 4099, 2**40 + 3):
            entry = mod.Entry(config, traffic, s, "cpu")
            recs = [{"designs": n, "k": k} for k in range(5)]
            _, picks = entry.sample(recs)
            halves = []
            for a in range(0, n, per):
                b = min(a + per, n)
                m = (a + b + 1) // 2
                halves += [(a, m)] + ([(m, b)] if b > m else [])
            assert len(picks) == len(halves)
            assert all(lo <= d < hi for d, (lo, hi) in zip(picks, halves))


def test_an_answer_altered_where_it_is_made_fails(tiny, seed, sweep_module,
                                                  monkeypatch):
    real = sweep_module._chunk_reduce

    def altered(*a, **kw):
        eff, bounces, factor = real(*a, **kw)
        return eff * (1.0 + 1e-3), bounces, factor

    monkeypatch.setattr(sweep_module, "_chunk_reduce", altered)
    line = _run(tiny, seed)
    assert line["correct"] is False


def test_summarize_trace_measures_busy_time_and_names_gaps():
    ev = [
        {"ph": "X", "cat": "user_annotation", "name": "window", "ts": 0.0,
         "dur": 1000.0},
        {"ph": "X", "cat": "user_annotation", "name": "prep", "ts": 100.0,
         "dur": 300.0},
        {"ph": "X", "cat": "kernel", "ts": 0.0, "dur": 100.0,
         "name": "void persistent_trace_kernel<true, 0, false>(Args)"},
        {"ph": "X", "cat": "kernel", "ts": 50.0, "dur": 100.0,
         "name": "(anonymous namespace)::persistent_trace_kernel<true, 0, "
                 "false>((anonymous namespace)::Args)"},
        {"ph": "X", "cat": "gpu_memcpy", "ts": 600.0, "dur": 100.0,
         "name": "Memcpy DtoH"},
        {"ph": "X", "cat": "kernel", "ts": 990.0, "dur": 50.0, "name": "k"},
    ]
    out = harness.summarize_trace(ev)
    assert out["window_s"] == pytest.approx(1e-3)
    assert out["busy_s"] == pytest.approx(260e-6)
    assert out["kernels"]["persistent_trace_kernel"] == pytest.approx(200e-6)
    assert out["kernels"]["k"] == pytest.approx(10e-6)
    assert out["idle_gaps"][0] == ["prep", pytest.approx(450e-6)]
    assert out["idle_gaps"][1] == ["window", pytest.approx(290e-6)]


def test_no_jax_check_compares_whole_top_level_names():
    assert harness.forbidden_modules([
        f"{PORT}", f"{PORT}.engine", "jaxtyping", "jax_like.x",
        "gpu_ray_tracing_for_waveguide_based_ar_display_tpux"]) == []
    assert harness.forbidden_modules(["jax.numpy", "numpy"]) == ["jax"]
    assert harness.forbidden_modules(
        ["gpu_ray_tracing_for_waveguide_based_ar_display_tpu.engine.oracle",
         "flax", "jaxlib.xla_client"]) == [
        "flax", "gpu_ray_tracing_for_waveguide_based_ar_display_tpu",
        "jaxlib"]


def test_benchmark_sources_import_no_jax_and_the_reference_no_program():
    import ast

    for path in harness.HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        names = set()
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names |= {a.name for a in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
                names.add(node.module)
        assert harness.forbidden_modules(names) == [], path
        if "reference" in path.parts:
            assert not any(n.split(".")[0] in (PORT, "benchmark")
                           for n in names), path
