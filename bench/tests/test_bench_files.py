"""BENCHMARK.json and the files it names: every cell, configuration,
traffic mix and metric resolves by name, and the file keeps to the
benchmark's contract of names, keys and bounds."""
import json

import pytest

from bench.tests.helpers import NAME, ROOT, benchmark, cells


def test_top_level_keys_and_command():
    b = benchmark()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["command"] == ["python3", "bench/run.py"]
    assert b["paths"] == ["bench"]
    assert 1 <= b["run_seconds"] <= 51 and isinstance(b["run_seconds"], int)
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("cell", cells())
def test_cell_resolves_by_name(cell):
    from bench.harness import Cell

    c = Cell(cell)
    assert c.runner_path.exists() and c.generator_path.exists()
    assert (ROOT / c.config_entry["file"]).exists()
    for m in c.per_layer:
        assert c.metric_paths[m["name"]].exists(), m["name"]
    metrics = {m["name"] for m in c.end_to_end}
    assert "setup_s" in metrics and len(metrics) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    assert c.entry["chips"] == 1


def test_names_units_and_entries():
    check_entries(benchmark())


def check_entries(b):
    names = [w["name"] for w in b["workloads"]]
    seen = set()
    for group, keys in (("configs", {"name", "source", "file", "reduced", "why"}),
                        ("workloads", {"name", "config", "traffic", "chips", "why"})):
        for e in b[group]:
            assert set(e) == keys, e
            assert NAME.match(e["name"]) and e["name"] not in seen
            seen.add(e["name"])
            assert 1 <= len(e["why"]) <= 200 and "\n" not in e["why"]
    for group in ("end_to_end", "per_layer"):
        for m in b[group]:
            assert NAME.match(m["name"]) and m["name"] not in seen
            seen.add(m["name"])
            assert m["better"] in ("lower", "higher")
            assert 1 <= len(m["unit"]) <= 16 and " " not in m["unit"]
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    layers = set()
    for m in b["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e and m["source"] in (
            "device_trace", "program_span", "program_counter", "host_clock")
        for w in m["workloads"]:
            assert w in names and w in e2e[m["moves"]].get("workloads", names)
        layers.add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for c in b["configs"]:
        assert any(w["config"] == c["name"] for w in b["workloads"])
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]


def test_every_cell_has_a_rate_and_a_layer_metric():
    b = benchmark()
    for cell in cells():
        rates = [m for m in b["end_to_end"]
                 if m["name"] != "setup_s" and cell in m.get("workloads", [cell])]
        assert len(rates) == 1
        assert any(cell in m.get("workloads", [cell]) for m in b["per_layer"])
