"""`BENCHMARK.json` and the data files keep to the benchmark's contract:
names, units and keys; every cell's files exist; every per-layer
metric's cells report the end-to-end metric it moves; the run length
fits a full check of 24 cells."""

import os
import re

import pytest

from vapbench.common import HERE, ROOT, benchmark, cell_metrics, load_json

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
B = benchmark()
CELLS = {w["name"]: w for w in B["workloads"]}


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys():
    assert set(B) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert B["paths"] == ["vapbench"]
    assert 1 <= len(B["command"]) <= 32 and all(map(_line, B["command"]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) < 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in B["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("vapbench/") and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in B["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        for k in ("name", "config", "traffic"):
            assert NAME.match(w[k]), w[k]
        assert w["chips"] in (1, 4) and _line(w["why"])
        names.append(w["name"])
    for m in B["end_to_end"] + B["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")
        names.append(m["name"])
    for m in B["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in B["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert _line(m["layer"])
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in B["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_every_per_layer_metric_moves_a_metric_its_cells_report():
    e2e = {m["name"]: m for m in B["end_to_end"]}
    for m in B["per_layer"]:
        assert m["moves"] in e2e
        for cell in m.get("workloads", CELLS):
            assert cell in CELLS
            reported = {x["name"] for x in cell_metrics(B, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)


def test_every_cell_reports_setup_another_e2e_and_a_per_layer_metric():
    for cell in CELLS:
        e2e = {m["name"] for m in cell_metrics(B, cell, False)}
        assert "setup_s" in e2e and len(e2e) >= 2, cell
        assert cell_metrics(B, cell, True), cell


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_cell_files(cell):
    w = CELLS[cell]
    wl = load_json(os.path.join(HERE, "workloads", f"{cell}.json"))
    assert wl["name"] == cell and wl["config"] == w["config"]
    assert os.path.isfile(os.path.join(HERE, "drivers",
                                       f"{wl['driver']}.py"))
    cfgs = {c["name"]: c for c in B["configs"]}
    assert os.path.isfile(os.path.join(ROOT, cfgs[w["config"]]["file"]))


def test_config_files():
    for c in B["configs"]:
        cfg = load_json(os.path.join(ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
        assert "assumed" in cfg and "source" in cfg
        assert any(w["config"] == c["name"] for w in B["workloads"])


def test_every_per_layer_metric_has_a_reader():
    for m in B["per_layer"]:
        stems = (m["name"], m["name"].split(".")[0])
        assert any(os.path.isfile(os.path.join(HERE, "metrics", f"{s}.py"))
                   for s in stems), m["name"]


def test_files_under_paths_are_named_from_name_characters():
    ok = re.compile(r"^[A-Za-z0-9_.\-/]+$")
    for dirpath, dirs, files in os.walk(HERE):
        dirs[:] = [d for d in dirs if d != "__pycache__"]
        for f in files:
            rel = os.path.relpath(os.path.join(dirpath, f), ROOT)
            assert ok.match(rel) and len(rel) <= 200, rel


def test_run_length_fits_a_full_check_of_24_cells():
    s = B["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_at_most_a_quarter_of_the_cells_take_four_chips():
    four = sum(w["chips"] == 4 for w in B["workloads"])
    assert four <= max(1, len(CELLS) // 4)
