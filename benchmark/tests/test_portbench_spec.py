"""BENCHMARK.json against the contract's shape, and every file a cell
needs found by name."""
import json
import re

import pytest

from benchmark import harness

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def spec():
    return harness.spec()


def test_top_level_keys_and_size():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((harness.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert 1 <= s["run_seconds"] <= 51 and isinstance(s["run_seconds"], int)
    assert s["paths"] == ["benchmark"]
    assert len(s["command"]) <= 32


def test_names_units_and_keys():
    s = spec()
    for e in s["configs"]:
        assert set(e) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(e["name"]) and e["file"].startswith("benchmark/")
        assert all(NAME.match(k) for k in e["reduced"])
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and len(w["why"]) <= 200
    assert sum(w["chips"] == 4 for w in s["workloads"]) <= \
        max(1, len(s["workloads"]) // 4)
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
    for m in s["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in s["workloads"]}) == \
        len(s["workloads"])


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  harness.spec()["workloads"]])
def test_cell_found_by_name(cell):
    c = harness.Cell(cell)
    assert c.config["name"] == c.entry["config"]
    assert "setup_s" in {m["name"] for m in c.end_to_end}
    assert len(c.end_to_end) >= 2
    assert c.per_layer
    reported = {m["name"] for m in c.end_to_end}
    assert callable(c.client.drive)
    for m in c.end_to_end:
        assert callable(harness.reader(m["name"]).read)
    for m in c.per_layer:
        assert m["moves"] in reported
        assert callable(harness.reader(m["name"]).read)
    for fn in ("prepare", "run", "keep", "answer"):
        assert callable(getattr(c.query, fn))
    assert callable(c.reference.compute) and callable(c.reference.compare)


@pytest.mark.parametrize("entry", harness.spec()["configs"],
                         ids=lambda e: e["name"])
def test_config_files_state_their_cut(entry):
    cfg = json.loads((harness.ROOT / entry["file"]).read_text())
    assert set(cfg["reduced"]) == set(entry["reduced"])
    for key in ("source", "assumed", "deployment", "precision"):
        assert cfg[key]
