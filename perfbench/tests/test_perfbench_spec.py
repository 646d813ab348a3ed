"""BENCHMARK.json against the benchmark's contract, and the harness
finding a new configuration, traffic mix and metric by file name."""

import json
import re

import pytest

import perfbench_smoke as S
from perfbench.harness.spec import find_cell, metric_reader

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_json_keeps_the_contract():
    b = S.bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["perfbench"] and 1 <= b["run_seconds"] <= 51
    cfgs = {c["name"]: c for c in b["configs"]}
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and c["file"].startswith("perfbench/")
        assert all(NAME.match(k) for k in c["reduced"])
        assert not any(k.endswith(("_dim", "_rank", "_size"))
                       for k in c["reduced"])
        conf = json.loads((S.ROOT / c["file"]).read_text())
        assert conf["name"] == c["name"] and conf["source"] == c["source"]
        for k in c["reduced"]:
            assert k in conf.get("source_values", {})
    used = {w["config"] for w in b["workloads"]}
    assert used == set(cfgs)
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"])
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
        assert (S.ROOT / "perfbench/traffic" / f"{w['traffic']}.json"
                ).exists()
    names = [m["name"] for m in b["end_to_end"] + b["per_layer"]]
    assert len(names) == len(set(names))
    assert any(m["name"] == "setup_s" for m in b["end_to_end"])
    for m in b["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in b["workloads"]}
    for m in b["end_to_end"] + b["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"])
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", cells)) <= cells
    e2e = {m["name"] for m in b["end_to_end"]}
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e
        assert (S.ROOT / "perfbench/metrics"
                / f"{m['name'].split('.')[0]}.py").exists()
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"
    assert len(json.dumps(b)) < 64 * 1024


def test_every_cell_loads():
    b = S.bench()
    for w in b["workloads"]:
        cell = find_cell(w["name"], b, S.ROOT)
        assert cell.config["serving"]["max_slots"] >= 1
        assert {m["name"] for m in cell.end_to_end} >= {"setup_s"}
        assert cell.per_layer


def test_a_new_configuration_mix_and_metric_are_found_by_file(tmp_path):
    (tmp_path / "perfbench/configs").mkdir(parents=True)
    (tmp_path / "perfbench/traffic").mkdir()
    (tmp_path / "perfbench/metrics").mkdir()
    (tmp_path / "perfbench/configs/tiny.json").write_text(
        json.dumps({"name": "tiny", "serving": {"max_slots": 2}}))
    (tmp_path / "perfbench/traffic/burst.json").write_text(
        json.dumps({"loop": "closed", "clients": 2}))
    (tmp_path / "perfbench/metrics/answer_count.py").write_text(
        "def read(rec):\n    return float(len(rec))\n")
    (tmp_path / "perfbench/metrics/answer_count.open.py").write_text(
        "def read(rec):\n    return -1.0\n")
    bench = {"configs": [{"name": "tiny",
                          "file": "perfbench/configs/tiny.json"}],
             "workloads": [{"name": "tiny.burst", "config": "tiny",
                            "traffic": "burst", "chips": 1}],
             "end_to_end": [{"name": "setup_s"}],
             "per_layer": [{"name": "answer_count",
                            "workloads": ["tiny.burst"]},
                           {"name": "elsewhere", "workloads": ["other"]}]}
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = find_cell("tiny.burst", root=tmp_path)
    assert cell.config["serving"]["max_slots"] == 2
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.per_layer] == ["answer_count"]
    assert metric_reader("answer_count", root=tmp_path)([1, 2, 3]) == 3.0
    # a split quantity reads its base file unless it has its own
    assert metric_reader("answer_count.closed", root=tmp_path)([1]) == 1.0
    assert metric_reader("answer_count.open", root=tmp_path)([1]) == -1.0
    with pytest.raises(KeyError):
        find_cell("tiny.other", root=tmp_path)
