"""The traffic generator: the same seed gives the same designs."""

import numpy as np

from benchmark import generator, harness


def _cell():
    _, config, traffic = harness.load_cell(harness.load_spec(),
                                           "sweep.screen")
    return config, traffic


def test_design_draw_repeats_for_a_seed(seed):
    config, traffic = _cell()
    a = generator.request_designs(config, traffic, seed, 3)
    b = generator.request_designs(config, traffic, seed, 3)
    assert a == b
    assert a != generator.request_designs(config, traffic, seed + 1, 3)
    assert a != generator.request_designs(config, traffic, seed, 4)


def test_stratified_draw_spans_the_range_alike(seed):
    config, traffic = _cell()
    n = traffic["designs_per_request"]
    lo, hi = traffic["vary"]["low"], traffic["vary"]["high"]
    for s in (0, seed, 2**33 + 5):
        v = generator.request_values(traffic, s, 0)
        assert len(v) == n and np.all(np.diff(v) > 0)
        part = (v - lo) / (hi - lo) * n
        assert np.array_equal(np.floor(part), np.arange(n))
    designs = generator.request_designs(config, traffic, seed, 0)
    assert all(d["lambda_ic"] == d["lambda_oc"] for d in designs)


def test_pick_is_in_range_and_repeats(seed):
    assert generator.pick(seed, 7, 1) == generator.pick(seed, 7, 1)
    assert all(0 <= generator.pick(s, 3, 2) < 3 for s in range(50))


def test_keys_and_values_not_implemented_are_refused():
    import pytest

    _, traffic = _cell()
    generator.validate(traffic)
    for bad in ({"clients": 4}, {"loop": "open"}, {"kind": "tokens"},
                {"vary": dict(traffic["vary"], draw="uniform")},
                {"vary": dict(traffic["vary"], skew=2.0)}):
        with pytest.raises(ValueError):
            generator.validate(dict(traffic, **bad))
