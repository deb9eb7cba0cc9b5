"""PyTorch port: its defaults are the JAX package's, and count spawn's bias.

(1) Every public function and class that both packages define under the
same relative module path takes the same default for every parameter both
declare, and the ``simulate``, ``sweep``, ``optimize`` and ``plot-design``
parsers parse no arguments to the same values.  Parameters and flags that
only one package has are not compared defaults; the flags are listed.  The
differences allowed are listed once, in ``SIGNATURE_EXCEPTIONS`` and
``CLI_EXCEPTIONS``, each with its reason.  Nothing here compiles JAX.

(2) Count spawn with folding weighs launch points by their rays' inverse
lifetime, so its efficiencies sit below those of the vector engine (the JAX
``jnp`` engine's counterpart, equal weights); the default, gens spawn
without folding, does not.  Over several seeds at a small grid, the mean gap
of the count-spawn folded path exceeds 4 standard errors and the default's
stays within 3.  Plain PyTorch on the CPU, one torch thread.
"""

import dataclasses
import importlib
import inspect
from pathlib import Path

import numpy as np
import pytest
import torch

from gpu_ray_tracing_for_waveguide_based_ar_display_tpu import cli as jcli

from gpu_ray_tracing_for_waveguide_based_ar_display_torch import cli
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.config import (
    TraceConfig,
)
from gpu_ray_tracing_for_waveguide_based_ar_display_torch.engine import (
    hybrid,
    pipeline,
)

JAX_PKG = jcli.__name__.rsplit(".", 1)[0]
PORT_PKG = cli.__name__.rsplit(".", 1)[0]
REPO = Path(__file__).resolve().parents[1]

# (module, qualified name, parameter): (JAX default, port default) -- reason
SIGNATURE_EXCEPTIONS = {
    # the JAX package defaults to its portable tracer because its Pallas
    # kernels compile only on a TPU; the port defaults to its CUDA kernel,
    # the counterpart of "pallas_persistent" ("vector" stands for "jnp")
    ("engine.pipeline", "Simulator", "engine"): ("jnp", "persistent"),
    # None takes the Simulator's segment_bounces (the vector engine's
    # segments), where the JAX method fixes its own
    ("engine.pipeline", "Simulator.trace_batch_compacted", "segment_bounces"):
        (64, None),
}
# the dtype of design/diff.py: jnp.float32 there, torch.float32 here
DTYPE_MODULE = "design.diff"

# parser dest: (JAX default, port default) -- the same engine choice
CLI_EXCEPTIONS = {
    ("simulate", "engine"): ("jnp", "persistent"),
    ("sweep", "engine"): ("jnp", "persistent"),
}
# flags that only one CLI has.  The JAX CLI's --fetch-luts is a download
# and its --interpret runs Pallas in interpret mode; its sweep and
# plot-design accept --luts-dir and ignore it (the sweep synthesises LUTs
# per design).  The port adds --device everywhere and simulate --slots (the
# Simulator's persistent_slots, 2,048 in both packages).
JAX_ONLY_FLAGS = {("simulate", "fetch_luts"), ("sweep", "interpret"),
                  ("sweep", "luts_dir"), ("plot-design", "luts_dir")}
PORT_ONLY_FLAGS = {(c, "device") for c in ("simulate", "sweep", "optimize",
                                           "plot-design")} | {
    ("simulate", "slots")}


def _shared_modules() -> list:
    """Module paths (relative, dotted) that both packages define."""
    jroot = REPO / JAX_PKG
    out = []
    for path in sorted(jroot.rglob("*.py")):
        rel = path.relative_to(jroot).with_suffix("")
        if rel.name == "__main__" or not (REPO / PORT_PKG / path.relative_to(
                jroot)).is_file():
            continue
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        out.append(".".join(parts))
    return out


def _callables(mod) -> dict:
    """Public functions and classes defined in ``mod``, and the public
    methods of those classes, by qualified name."""
    out = {}
    for name, obj in vars(mod).items():
        if name.startswith("_") or getattr(obj, "__module__", None) != \
                mod.__name__:
            continue
        if inspect.isfunction(obj):
            out[name] = obj
        elif inspect.isclass(obj):
            out[name] = obj
            for m, f in vars(obj).items():
                if not m.startswith("_") and inspect.isfunction(f):
                    out[f"{name}.{m}"] = f
    return out


def _norm(v):
    """A default as a comparable value: the two packages' config
    dataclasses are distinct classes with the same fields."""
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return type(v).__name__, _norm(dataclasses.asdict(v))
    if isinstance(v, np.ndarray):
        return "ndarray", v.dtype.str, v.tolist()
    if isinstance(v, dict):
        return {k: _norm(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return type(v)(_norm(x) for x in v)
    return v


def _default_diffs() -> dict:
    """(module, qualified name, parameter) -> (JAX default, port default)
    of every parameter both signatures declare with unequal defaults."""
    diffs = {}
    for rel in _shared_modules():
        jmod = importlib.import_module(f"{JAX_PKG}.{rel}" if rel else JAX_PKG)
        pmod = importlib.import_module(f"{PORT_PKG}.{rel}" if rel
                                       else PORT_PKG)
        jfns, pfns = _callables(jmod), _callables(pmod)
        for name in sorted(set(jfns) & set(pfns)):
            jp = inspect.signature(jfns[name]).parameters
            pp = inspect.signature(pfns[name]).parameters
            for arg in sorted(set(jp) & set(pp)):
                a, b = jp[arg].default, pp[arg].default
                if _norm(a) != _norm(b):
                    diffs[(rel, name, arg)] = (a, b)
    return diffs


def test_shared_signatures_take_the_jax_defaults():
    """Every difference is one of the listed exceptions, and each listed
    exception still exists."""
    diffs = _default_diffs()
    dtypes = {k for k in diffs if k[0] == DTYPE_MODULE and k[2] == "dtype"}
    assert all(a.__name__ == "float32" and b is torch.float32
               for a, b in (diffs[k] for k in dtypes)), dtypes
    rest = {k: v for k, v in diffs.items() if k not in dtypes}
    assert rest == SIGNATURE_EXCEPTIONS
    assert dtypes
    assert len(_shared_modules()) >= 30


def _jax_namespace(monkeypatch, argv) -> dict:
    """The JAX CLI's parsed arguments: its parser is built inside
    ``main``, so each command function is swapped for one that keeps
    them."""
    seen = {}
    for fn in ("cmd_simulate", "cmd_sweep", "cmd_optimize",
               "cmd_plot_design"):
        monkeypatch.setattr(jcli, fn, lambda args: seen.update(vars(args)))
    jcli.main(argv)
    return seen


@pytest.mark.parametrize("command", ["simulate", "sweep", "optimize",
                                     "plot-design"])
def test_cli_defaults_are_the_jax_cli_defaults(monkeypatch, command):
    want = _jax_namespace(monkeypatch, [command])
    got = vars(cli.build_parser().parse_args([command]))
    for ns in (want, got):
        ns.pop("fn")
    only_jax = {(command, k) for k in set(want) - set(got)}
    only_port = {(command, k) for k in set(got) - set(want)}
    assert only_jax <= JAX_ONLY_FLAGS and only_port <= PORT_ONLY_FLAGS
    diffs = {(command, k): (want[k], got[k])
             for k in set(want) & set(got) if want[k] != got[k]}
    assert diffs == {k: v for k, v in CLI_EXCEPTIONS.items()
                     if k[0] == command}


def test_simulate_with_no_flags_runs_gens_spawn_unfolded(monkeypatch):
    """``simulate`` builds the Simulator with gens spawn and no folding on
    the persistent engine."""
    built = {}

    class Stop(Exception):
        pass

    def fake(**kw):
        built.update(kw)
        raise Stop

    monkeypatch.setattr(pipeline, "Simulator", fake)
    with pytest.raises(Stop):
        cli.main(["simulate", "--device", "cpu", "--image", ""])
    assert built["engine"] == "persistent"
    assert built["spawn_mode"] == "gens"
    assert built["fold_iterations"] is False


# ---------------------------------------------------------------------------
# (2) the bias of count spawn with folding

BIAS_SEEDS = range(1, 6)
# randomised low-discrepancy pupil points (unbiased, as the uniform ones)
# cut the share of each seed's scatter that the shared pupil points carry
BIAS_CFG = dict(num_fov_x=4, num_fov_y=3, rays_per_fov=2048, num_iter=2,
                pupil_sampling="r2")
BIAS_SLOTS = 256


@pytest.fixture(scope="module")
def gaps():
    """Per seed, the pooled (mean over R, G, B) relative gap of each
    persistent path's efficiencies to the vector engine's on the same
    seed: 4 x 3 FoV x 3 wavelengths, 2,048 rays x 2 iterations, 256 slots,
    r2 pupil points, the LUTs and geometry of seed 0.  The vector Simulator
    of each seed is seed 0's with another ``cfg.seed`` (its tracer and
    region grids do not depend on the seed), as the boost hybrid makes its
    pilot.  Seeds 1-5 put count spawn folded 4.8 standard errors low and
    the default 0.4 within; one seed's gap scatters ~1.7 %."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        vector = pipeline.Simulator(cfg=TraceConfig(**BIAS_CFG), device="cpu",
                                    engine="vector", segmented=True)
        out = {"default": [], "count_folded": []}
        for seed in BIAS_SEEDS:
            ref = hybrid.TailBoostHybrid.make_pilot_sim(vector, seed).run(
                evaluate_metrics=False)
            kw = dict(cfg=TraceConfig(**BIAS_CFG, seed=seed), geom=vector.geom,
                      luts=vector.luts, device="cpu",
                      persistent_slots=BIAS_SLOTS)
            for name, extra in (
                    ("default", {}),
                    ("count_folded", dict(spawn_mode="count",
                                          fold_iterations=True))):
                res = pipeline.Simulator(**kw, **extra).run(
                    evaluate_metrics=False)
                out[name].append(np.mean(
                    [res.efficiencies[k] / ref.efficiencies[k] - 1
                     for k in ("R", "G", "B")]))
        return {k: np.asarray(v) for k, v in out.items()}
    finally:
        torch.set_num_threads(n)


def _mean_and_stderr(x):
    return float(x.mean()), float(x.std(ddof=1) / np.sqrt(len(x)))


def test_count_spawn_folded_is_biased_low(gaps):
    mean, se = _mean_and_stderr(gaps["count_folded"])
    print(f"count spawn, folded: gap {mean:+.4f} +- {se:.4f}")
    assert mean < -4 * se


def test_default_is_unbiased(gaps):
    mean, se = _mean_and_stderr(gaps["default"])
    print(f"default (gens spawn, unfolded): gap {mean:+.4f} +- {se:.4f}")
    assert abs(mean) <= 3 * se
