"""The run on the card at a tiny size: the program's kernels come out
correct against the reference, the control (bfloat16-packed selection)
does not.  Marked ``cuda``; skips without a card::

    python3 -m pytest -q -m cuda benchmark/tests
"""

import io

import pytest
import torch

from benchmark import harness


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the port's CUDA kernels)")
    return "cuda"


def _run(tiny, seed, device):
    return harness.run_cell(harness.load_spec(), "sweep.screen", seed, 0.0,
                            False, device=device, overrides=tiny,
                            log=io.StringIO())


@pytest.mark.cuda
def test_kernels_are_correct_on_the_card(tiny, seed, cuda_device):
    line = _run(tiny, seed, cuda_device)
    assert line["correct"] is True
    assert line["device"]["platform"] == "gpu"
    assert line["device"]["memory_peak_bytes"] > 0


@pytest.mark.cuda
def test_control_is_refused_on_the_card(tiny, seed, cuda_device):
    mod = harness.load_module(harness.HERE / "entries" / "sweep.py")
    _, config, traffic = harness.load_cell(harness.load_spec(),
                                           "sweep.screen", tiny)
    entry = mod.Entry(config, traffic, seed, cuda_device,
                      accum_mode="packed")
    entry.setup()
    rec = entry.request(0)
    r, ds = entry.sample([rec])
    gaps = entry.gaps(r, ds, entry.reference(r, ds))
    assert any(gaps[n] > lim for n, lim in config["checks"].items())
