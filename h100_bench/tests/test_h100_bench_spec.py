"""BENCHMARK.json against the benchmark's contract, and every name in it
resolving to its files."""

import json
import os
import re

import pytest

from h100_bench import run as hr

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def spec():
    with open(os.path.join(hr.ROOT, "BENCHMARK.json")) as f:
        text = f.read()
    assert len(text.encode()) <= 64 * 1024
    return json.loads(text)


def test_top_level(spec):
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    assert 1 <= len(spec["command"]) <= 32
    assert spec["paths"] == ["h100_bench"]
    assert isinstance(spec["run_seconds"], int)
    assert 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its 43,200 s
    rs = spec["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_names_and_units(spec):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in spec[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e and group != "end_to_end" and (
                        group != "per_layer" or key != "source"):
                    assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]
                    assert "\t" not in e[key]
    assert len(set(names)) == len(names)
    for c in spec["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert len(c["reduced"]) <= 16
    for w in spec["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4)


def test_metrics(spec):
    e2e = {m["name"]: m for m in spec["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in spec["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    cells = {w["name"] for w in spec["workloads"]}
    layers = {}
    for m in spec["per_layer"]:
        assert m["moves"] in e2e and set(m["workloads"]) <= cells
        for w in m["workloads"]:
            moved = e2e[m["moves"]]
            assert w in moved.get("workloads", cells)
        layers.setdefault(m["layer"], []).append(m["name"])
    for w in cells:
        reported = [m for m in spec["end_to_end"] if m["name"] != "setup_s"
                    and w in m.get("workloads", cells)]
        assert reported, w
        assert any(w in m["workloads"] for m in spec["per_layer"]), w


def test_every_name_resolves(spec):
    """A cell reaches its configuration, traffic, driver, limits and
    metric files by name alone."""
    for c in spec["configs"]:
        assert c["file"].startswith("h100_bench/")
        with open(os.path.join(hr.ROOT, c["file"])) as f:
            conf = json.load(f)
        assert conf["source"] == c["source"]
        assert conf["reduced"] == c["reduced"]
        assert "config" in conf
    files = [c["file"] for c in spec["configs"]]
    assert len(set(files)) == len(files)
    for w in spec["workloads"]:
        mix = hr.load_json(hr.HERE, "traffic", f"{w['traffic']}.json")
        assert os.path.exists(os.path.join(hr.HERE, "drivers",
                                           f"{mix['driver']}.py"))
        limits = hr.load_json(hr.HERE, "limits", f"{w['name']}.json")
        assert limits and all(v > 0 for v in limits.values())
    for m in spec["per_layer"]:
        assert callable(hr.load_metric(m["name"]).read)


def test_command_stays_inside_paths(spec):
    for word in spec["command"]:
        assert not word.startswith("/") and ".." not in word
    assert spec["command"][:3] == ["python3", "-m", "h100_bench.run"]
