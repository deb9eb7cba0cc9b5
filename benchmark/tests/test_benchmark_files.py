"""BENCHMARK.json and the files it names: they parse, keep to the
contract's shapes and characters, and every name finds its file."""

import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
HERE = harness.HERE


@pytest.fixture(scope="module")
def spec():
    return harness.load_spec()


def test_spec_keys(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"]
    assert 1 <= spec["run_seconds"] <= 51
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_every_name_and_unit_uses_the_allowed_characters(spec):
    names = [c["name"] for c in spec["configs"]]
    for w in spec["workloads"]:
        names += [w["name"], w["config"], w["traffic"]]
    for m in spec["end_to_end"] + spec["per_layer"]:
        names.append(m["name"])
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for c in spec["configs"]:
        names += c["reduced"]
    for n in names:
        assert NAME.match(n), n
    for text in ([c["why"] for c in spec["configs"] + spec["workloads"]]
                 + [m["layer"] for m in spec["per_layer"]]
                 + [c["source"] for c in spec["configs"]]):
        assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_names_are_unique(spec):
    for group in ("configs", "workloads"):
        names = [e["name"] for e in spec[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_every_config_and_traffic_file_parses(spec):
    for c in spec["configs"]:
        cfg = harness.load_json(harness.ROOT / c["file"])
        assert cfg["name"] == c["name"]
        assert (HERE / "entries" / f"{cfg['entry']}.py").is_file()
        assert set(cfg["reduced"]) == set(c["reduced"])
        assert set(cfg["checks"]) and all(
            isinstance(v, (int, float)) for v in cfg["checks"].values())
    for path in sorted((HERE / "traffic").glob("*.json")):
        t = json.loads(path.read_text())
        assert t["name"] == path.stem
    for w in spec["workloads"]:
        assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
        assert w["chips"] in (1, 4)


def test_every_metric_has_its_reader_and_cells(spec):
    e2e = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in e2e
    cells = {w["name"] for w in spec["workloads"]}
    for m in spec["per_layer"]:
        assert (HERE / "layers" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
    for w in cells:
        e, layers = harness.cell_metrics(spec, w)
        assert len(e) >= 2 and layers
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
