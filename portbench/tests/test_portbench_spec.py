"""BENCHMARK.json against the benchmark's contract, and the loader finding
every piece by name."""
import json
import re

import pytest

from portbench import spec

BENCH = spec.benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(BENCH["command"]) <= 32
    assert all(not w.startswith("/") and ".." not in w
               for w in BENCH["command"])


def test_whole_check_fits_with_24_cells():
    runs = 2 + 14 * 24
    total = runs * (BENCH["run_seconds"] + 60) + 24 * 2 * 90 + 1200
    assert total <= 43200


def test_names_units_and_keys():
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source", "workloads"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves", "workloads"})):
        for entry in BENCH[group]:
            assert set(entry) <= keys, (group, entry)
            assert NAME.match(entry["name"]), entry["name"]
            assert (group, entry["name"]) not in seen
            seen.add((group, entry["name"]))
            if "unit" in entry:
                assert UNIT.match(entry["unit"]), entry["unit"]
                assert entry["better"] in ("lower", "higher")
            for text in ("why", "layer", "source"):
                if text in entry:
                    assert 1 <= len(entry[text]) <= 200
                    assert "\n" not in entry[text] and "\t" not in entry[text]


def test_bounds():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25
               for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", CELLS)
def test_cell_reports_enough(cell):
    c = spec.load_cell(cell)
    names = [m["name"] for m in c.end_to_end]
    assert "setup_s" in names and len(names) >= 2
    assert c.per_layer
    e2e = set(names)
    for m in c.per_layer:
        assert m["moves"] in e2e, (cell, m["name"])


@pytest.mark.parametrize("cell", CELLS)
def test_loader_finds_cell_pieces(cell):
    c = spec.load_cell(cell)
    entry = next(w for w in BENCH["workloads"] if w["name"] == cell)
    assert c.chips == entry["chips"] == 1
    assert c.config["name"] == entry["config"]
    assert spec.driver(c.driver).check
    # An exact comparison (a switch the configuration fixes) has limit 0.
    assert c.limits and all(v >= 0 for v in c.limits.values())


@pytest.mark.parametrize("metric", PER_LAYER)
def test_loader_finds_reader(metric):
    assert callable(spec.reader(metric))


def test_configs_files_and_reduced():
    for c in BENCH["configs"]:
        assert c["file"].startswith("portbench/configs/")
        with open(spec.ROOT / c["file"]) as fp:
            cfg = json.load(fp)
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"] == []
        assert cfg["flops"], "run python3 -m portbench.flops"
        assert any(w["config"] == c["name"] for w in BENCH["workloads"])


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell")
