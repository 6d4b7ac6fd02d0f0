"""BENCHMARK.json against the benchmark's contract, and the files each
entry names."""

import json
import os
import re

import pytest

from benchmark import harness

ROOT = harness.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def manifest():
    return harness.load_manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_sizes(manifest):
    assert set(manifest) == KEYS
    assert 1 <= manifest["run_seconds"] <= 51
    assert isinstance(manifest["run_seconds"], int)
    assert 1 <= len(manifest["paths"]) <= 16
    assert all(re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p)
               and not p.startswith("/") and ".." not in p
               and not p.endswith("_torch") for p in manifest["paths"])
    assert len(manifest["command"]) <= 32 and all(map(_line,
                                                      manifest["command"]))
    assert os.path.getsize(os.path.join(ROOT, "BENCHMARK.json")) <= 64 << 10


def test_names_units_and_entries(manifest):
    names = {}
    for group, keys in (("configs", {"name", "source", "file", "reduced",
                                     "why"}),
                        ("workloads", {"name", "config", "traffic", "chips",
                                       "why"}),
                        ("end_to_end", {"name", "unit", "better", "bound",
                                        "source"}),
                        ("per_layer", {"name", "unit", "better", "source",
                                       "layer", "moves"})):
        for e in manifest[group]:
            assert set(e) - {"workloads"} == keys, (group, e)
            assert NAME.match(e["name"]), e["name"]
            names.setdefault(group, set()).add(e["name"])
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
            for k in ("why", "layer", "source"):
                if k in e and group in ("configs", "workloads", "per_layer"):
                    assert _line(e[k]), (k, e)
        assert len(names[group]) == len(manifest[group])
    metric_names = names["end_to_end"] | names["per_layer"]
    assert len(metric_names) == len(manifest["end_to_end"]) + len(
        manifest["per_layer"])


def test_cells(manifest):
    configs = {c["name"] for c in manifest["configs"]}
    pairs = set()
    for w in manifest["workloads"]:
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert NAME.match(w["traffic"])
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        for sub, ext in (("traffic", w["traffic"]), ("limits", w["name"])):
            assert os.path.exists(os.path.join(harness.BENCH_DIR, sub,
                                               ext + ".json")), (sub, ext)
    used = {w["config"] for w in manifest["workloads"]}
    assert used == configs
    files = [c["file"] for c in manifest["configs"]]
    assert len(set(files)) == len(files)
    for c in manifest["configs"]:
        assert c["file"].startswith(tuple(p + "/" for p in manifest["paths"]))
        assert os.path.exists(os.path.join(ROOT, c["file"]))
        assert len(c["reduced"]) <= 16 and all(map(NAME.match, c["reduced"]))


def test_bounds(manifest):
    e2e = {m["name"]: m for m in manifest["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in e2e.values():
        assert 0.01 <= m["bound"] <= 0.25, m
        assert m["source"] in ("host_clock", "device_trace")


def test_every_cell_reports_setup_another_metric_and_a_layer(manifest):
    for w in manifest["workloads"]:
        e2e = [m["name"] for m in harness.cell_metrics(manifest, w["name"],
                                                       False)]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert harness.cell_metrics(manifest, w["name"], True), w["name"]


def test_per_layer_moves_a_metric_each_of_its_cells_reports(manifest):
    layers = set()
    for m in manifest["per_layer"]:
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        layers.add(m["layer"])
        cells = m.get("workloads",
                      [w["name"] for w in manifest["workloads"]])
        for cell in cells:
            reported = {e["name"] for e in harness.cell_metrics(
                manifest, cell, False)}
            assert m["moves"] in reported, (m["name"], cell)
        if "roofline" in m["name"] or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_metric_has_a_reader(manifest):
    for m in manifest["end_to_end"] + manifest["per_layer"]:
        reader = harness.metric_reader(m["name"])
        assert callable(reader.read), m["name"]


def test_the_command_names_only_files_under_paths(manifest):
    for word in manifest["command"]:
        if os.path.exists(os.path.join(ROOT, word)):
            assert word.startswith(tuple(p + "/" for p in manifest["paths"]))
