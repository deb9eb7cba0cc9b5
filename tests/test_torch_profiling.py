"""PyTorch port: ``utils/profiling.py`` (``Timers``, ``torch_trace`` and
``simulate --profile-dir``) and ``luts/io.py::save_luts``, against the JAX
package's."""

import time

import numpy as np

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.luts import (
    io as jio,
    make_synthetic_luts as jmake_synthetic_luts,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.design import (
    generate_geometry as jgenerate_geometry,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_tpu.utils import (
    profiling as jprofiling,
)

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.luts import io
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.utils import (
    Timers, profiling, torch_trace,
)


def _drive(timers):
    for name in ("seed", "trace", "seed", "metrics", "trace", "trace"):
        with timers.scope(name):
            pass
    return timers


def test_timers_as_jax(monkeypatch):
    """The same scopes under the same clock give the same totals, counts
    and report."""
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    monkeypatch.setattr(time, "perf_counter", lambda: float(next(ticks)))
    got = _drive(Timers())
    ticks = iter(np.arange(0.0, 100.0, 0.25))
    want = _drive(jprofiling.Timers())
    assert got.totals == want.totals and got.counts == want.counts
    assert got.report() == want.report()
    assert got.counts == {"seed": 2, "trace": 3, "metrics": 1}


def test_torch_trace_off_and_on(tmp_path):
    with torch_trace(""):
        pass
    with torch_trace(None):
        pass
    with torch_trace(str(tmp_path / "t")):
        sum(range(10))
    assert len(list((tmp_path / "t").glob("*.pt.trace.json"))) == 1
    assert profiling.torch_trace is torch_trace


def test_simulate_profile_dir_writes_a_trace(tmp_path, capsys):
    out = tmp_path / "prof"
    assert cli.main(["simulate", "--device", "cpu", "--fov-x", "2", "--fov-y",
                     "2", "--rays-per-fov", "64", "--num-iter", "1",
                     "--slots", "128", "--max-bounces", "300", "--image", "",
                     "--profile-dir", str(out)]) == 0
    traces = list(out.glob("*.pt.trace.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert '"traceEvents"' in text and "aten::" in text
    assert f"profiler trace written into {out}" in capsys.readouterr().out


def test_save_luts_files_bitwise_jax(tmp_path):
    luts = jmake_synthetic_luts(jgenerate_geometry(num_fov_x=4, num_fov_y=3))
    io.save_luts(luts, str(tmp_path / "port"))
    jio.save_luts(luts, str(tmp_path / "jax"))
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert len(names) == 7
    assert sorted(p.name for p in (tmp_path / "port").iterdir()) == names
    for n in names:
        assert ((tmp_path / "port" / n).read_bytes()
                == (tmp_path / "jax" / n).read_bytes())
    back = io.load_luts(str(tmp_path / "port"))
    np.testing.assert_array_equal(back.fc1, luts.fc1)
