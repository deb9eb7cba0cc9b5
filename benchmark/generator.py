"""The one traffic generator: a traffic mix's JSON parameters and the run's
seed give the inputs of every request.

A design-sweep mix (``"kind": "designs"``) sends requests of
``designs_per_request`` designs: the configuration's design with each field
of ``vary.fields`` set to one value drawn over ``[vary.low, vary.high)``.
``"draw": "stratified"`` draws value i of a request uniformly in the i-th of
``designs_per_request`` equal parts of the range, so every request spans the
range alike and only the order of the work within it depends on the seed;
values are sorted, as an engineer lays out a sweep.  Request ``k`` of seed
``s`` is the same on every run and every commit.  Every mix is a closed
loop of one client; a mix that names a key or a value this generator does
not implement is refused.
"""

from __future__ import annotations

import numpy as np

WARMUP = -1   # the request index of the warm-up request


KEYS = {"name", "kind", "designs_per_request", "designs_per_batch", "vary",
        "why"}
VARY_KEYS = {"fields", "low", "high", "draw"}


def validate(traffic: dict) -> None:
    """Refuse a mix with a key or a value that is not implemented here."""
    extra = (set(traffic) - KEYS) | (set(traffic.get("vary", {})) - VARY_KEYS)
    if extra:
        raise ValueError(f"traffic keys not implemented: {sorted(extra)}")
    if traffic.get("kind") != "designs":
        raise ValueError(f"unknown traffic kind {traffic.get('kind')!r}")
    if traffic["vary"]["draw"] != "stratified":
        raise ValueError(f"unknown draw {traffic['vary']['draw']!r}")


def request_values(traffic: dict, seed: int, k: int) -> np.ndarray:
    """The swept values of request ``k`` (``WARMUP`` for the warm-up)."""
    validate(traffic)
    vary = traffic["vary"]
    n = int(traffic["designs_per_request"])
    rng = np.random.default_rng([int(seed), k + 1, 7])
    lo, hi = float(vary["low"]), float(vary["high"])
    u = (np.arange(n) + rng.random(n)) / n
    return lo + (hi - lo) * u


def request_designs(config: dict, traffic: dict, seed: int, k: int) -> list:
    """The design field dicts of request ``k``: the configuration's design
    with the varied fields set."""
    fields = traffic["vary"]["fields"]
    return [dict(config["design"], **{f: float(v) for f in fields})
            for v in request_values(traffic, seed, k)]


def pick(seed: int, n: int, salt: int) -> int:
    """An index in [0, n) drawn from the seed, for the sample that the
    correctness check compares."""
    return int(np.random.default_rng([int(seed), salt]).integers(n))
