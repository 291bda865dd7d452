"""``BENCHMARK.json`` keeps to the benchmark's contract, and every name in
it has its file."""

import json
import os
import re

from conftest import BENCH, CHECKOUT

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
SOURCES_E2E = {"host_clock", "device_trace"}
SOURCES = SOURCES_E2E | {"program_span", "program_counter"}


def spec():
    with open(os.path.join(CHECKOUT, "BENCHMARK.json")) as fh:
        return json.load(fh)


def line_ok(text):
    return isinstance(text, str) and 1 <= len(text) <= 200 and \
        "\n" not in text and "\t" not in text


def test_top_level_keys_and_sizes():
    s = spec()
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert os.path.getsize(os.path.join(CHECKOUT, "BENCHMARK.json")) <= 64 * 1024
    assert s["paths"] == ["bench_h100"]
    assert all(PATH.match(p) and ".." not in p for p in s["paths"])
    assert 1 <= len(s["command"]) <= 32 and all(line_ok(w) for w in s["command"])
    assert not any(w.startswith("/") or ".." in w for w in s["command"])
    assert os.path.exists(os.path.join(CHECKOUT, s["command"][1]))
    assert s["command"][1].startswith("bench_h100/")
    assert isinstance(s["run_seconds"], int) and 1 <= s["run_seconds"] <= 51
    # a full check of 24 cells fits
    runs = 2 + 14 * 24
    assert runs * (s["run_seconds"] + 60) + 24 * 2 * 90 + 1200 <= 43200


def test_configs():
    s = spec()
    assert 1 <= len(s["configs"]) <= 24
    used = {w["config"] for w in s["workloads"]}
    files = set()
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["name"] in used
        assert line_ok(c["source"]) and line_ok(c["why"])
        assert c["file"].startswith("bench_h100/") and c["file"] not in files
        files.add(c["file"])
        assert c["file"] == f"bench_h100/configs/{c['name']}.json"
        with open(os.path.join(CHECKOUT, c["file"])) as fh:
            body = json.load(fh)
        assert body["reduced"] == c["reduced"] and len(c["reduced"]) <= 16
        assert body["precision"] in ("fp32", "bf16")
        assert body["control"] in ("tf32", "fp8")


def test_workloads():
    s = spec()
    cells = s["workloads"]
    assert 1 <= len(cells) <= 24
    assert len({w["name"] for w in cells}) == len(cells)
    assert len({(w["config"], w["traffic"]) for w in cells}) == len(cells)
    assert sum(w["chips"] == 4 for w in cells) <= max(1, len(cells) // 4)
    for w in cells:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] in (1, 4) and line_ok(w["why"])
        assert os.path.exists(os.path.join(BENCH, "traffic", w["traffic"] + ".json"))


def test_metrics():
    s = spec()
    cells = {w["name"] for w in s["workloads"]}
    names = [m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(set(names)) == len(names)
    assert 1 <= len(s["end_to_end"]) <= 16 and 1 <= len(s["per_layer"]) <= 128
    e2e = {m["name"]: m for m in s["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in e2e["setup_s"]
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in SOURCES_E2E
    for m in s["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in SOURCES and m["moves"] in e2e and line_ok(m["layer"])
        assert m["workloads"]
        for cell in m["workloads"]:
            assert cell in e2e[m["moves"]].get("workloads", [cell])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in s["end_to_end"] + s["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert set(m.get("workloads", cells)) <= cells
        assert os.path.exists(os.path.join(BENCH, "metrics", m["name"] + ".py"))
    # every cell reports setup_s, another end-to-end metric and a per-layer one
    for cell in cells:
        mine = [m for m in s["end_to_end"] if cell in m.get("workloads", [cell])]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        assert any(cell in m.get("workloads", [cell]) for m in s["per_layer"])
    # a step's share of the peak stands beside the kernels' rooflines
    for m in s["per_layer"]:
        if m["name"].endswith("_roofline"):
            assert any("mfu" in x["name"] and x["moves"] == m["moves"]
                       for x in s["per_layer"])


def test_no_file_outside_the_paths_is_named():
    s = spec()
    for w in s["command"][1:]:
        assert not os.path.exists(os.path.join(CHECKOUT, w)) or \
            w.startswith("bench_h100/")
