"""BENCHMARK.json against the shape it must have, and every file the
harness finds by name."""

from __future__ import annotations

import json
import os
import re

import pytest

from benchmark import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def manifest():
    with open(run.MANIFEST, encoding="utf-8") as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def test_top_level(manifest):
    assert set(manifest) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert manifest["paths"] == ["benchmark"]
    assert all(TEXT.match(w) for w in manifest["command"])
    assert 1 <= manifest["run_seconds"] <= 51
    # A full check of 24 cells fits its 43,200 s.
    assert ((2 + 14 * 24) * (manifest["run_seconds"] + 60) + 24 * 180
            + 1200) <= 43200


def test_names_units_and_keys(manifest):
    names = []
    for c in manifest["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and TEXT.match(c["source"])
        assert TEXT.match(c["why"]) and len(c["reduced"]) <= 16
        assert all(NAME.match(k) for k in c["reduced"])
        assert c["file"].startswith("benchmark/")
        assert os.path.isfile(os.path.join(run.REPO, c["file"]))
        names.append(c["name"])
    for w in manifest["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["config"] in names and w["chips"] == 1
        assert TEXT.match(w["why"])
        names.append(w["name"])
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
        names.append(m["name"])
    for m in manifest["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in manifest["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert TEXT.match(m["layer"])
    assert len(names) == len(set(names))


def test_every_metric_reported_where_it_moves(manifest):
    cells = [w["name"] for w in manifest["workloads"]]
    e2e = {m["name"]: m.get("workloads", cells) for m in manifest["end_to_end"]}
    assert "setup_s" in e2e and set(e2e["setup_s"]) == set(cells)
    for cell in cells:
        mine = [n for n, ws in e2e.items() if cell in ws]
        assert "setup_s" in mine and len(mine) >= 2
        assert any(cell in m.get("workloads", cells)
                   for m in manifest["per_layer"])
    for m in manifest["per_layer"]:
        for cell in m.get("workloads", cells):
            assert cell in e2e[m["moves"]], (m["name"], cell)


def test_files_found_by_name(manifest):
    for w in manifest["workloads"]:
        spec = run.cell_spec(w["name"], manifest)
        assert spec["limits"] and all(v >= 0 for v in spec["limits"].values())
        assert os.path.isfile(os.path.join(
            run.HERE, "runners", f"{spec['traffic']['runner']}.py"))
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        assert callable(run.reader(m["name"]))


def test_configuration_files(manifest):
    for c in manifest["configs"]:
        with open(os.path.join(run.REPO, c["file"]), encoding="utf-8") as f:
            cfg = json.load(f)
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg["reduced"]) <= set(cfg["assumed"])
        for path in run.resolve_paths(cfg).get("structure_paths", []):
            assert os.path.isfile(path)
        if "topology" in cfg:
            assert os.path.isfile(run.resolve_paths(cfg)["topology_path"])
