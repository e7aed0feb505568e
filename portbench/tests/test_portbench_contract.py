"""BENCHMARK.json against the form the harness and its checker read: names,
units, lengths, and a file for every configuration, mix, limit and reader."""
from __future__ import annotations

import json
import os
import re

import portbench_tiny as tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _bench():
    with open(os.path.join(tiny.REPO, "BENCHMARK.json")) as f:
        return json.load(f)


def _line(s):
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_keys_names_and_units():
    b = _bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["portbench"] and 1 <= b["run_seconds"] <= 51
    assert all(_line(w) for w in b["command"])
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert all(NAME.match(n) for n in names) and len(set(names)) == len(names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"]) and all(NAME.match(k) for k in c["reduced"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in b["per_layer"]:
        assert m["moves"] in e2e and _line(m["layer"])
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}


def test_every_cell_finds_its_files():
    b = _bench()
    configs = {c["name"]: c for c in b["configs"]}
    pb = tiny.PORTBENCH
    for w in b["workloads"]:
        assert os.path.exists(os.path.join(tiny.REPO, configs[w["config"]]["file"]))
        assert os.path.exists(os.path.join(pb, "traffic", w["traffic"] + ".json"))
        with open(os.path.join(pb, "limits", w["name"] + ".json")) as f:
            limits = json.load(f)
        assert limits and all(set(v) in ({"max"}, {"min"}) for v in limits.values())
    for m in b["per_layer"]:
        assert os.path.exists(os.path.join(pb, "metrics", m["name"] + ".py"))
        assert set(m.get("workloads", [])) <= {w["name"] for w in b["workloads"]}
    used = {w["config"] for w in b["workloads"]}
    assert used == set(configs)


def test_every_cell_reports_what_its_metrics_move():
    """setup_s and another end-to-end metric in each cell, a per-layer metric
    in each, and every per-layer metric only where its end-to-end one is."""
    b = _bench()
    cells = [w["name"] for w in b["workloads"]]
    e2e = {m["name"]: set(m.get("workloads", cells)) for m in b["end_to_end"]}
    for c in cells:
        assert c in e2e["setup_s"] and sum(c in v for v in e2e.values()) >= 2
        assert any(c in m.get("workloads", cells) for m in b["per_layer"])
    for m in b["per_layer"]:
        assert set(m.get("workloads", cells)) <= e2e[m["moves"]], m["name"]
