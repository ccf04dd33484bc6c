"""A later change adds a configuration, a cell and a per-layer metric with
new files and new BENCHMARK.json entries only: shown on a copy with a toy
cell added."""
import json
import shutil

from bench.tests.helpers import ROOT, toy_run


def test_a_cell_added_by_files_alone(tmp_path):
    shutil.copytree(ROOT / "bench", tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    b = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "bench/configs/set-mlp-t4-500k.json").read_text())
    cfg.update(name="set-mlp-narrow", layer_dims=[4096, 1000, 1000, 2], epsilon=20)
    (tmp_path / "bench/configs/set-mlp-narrow.json").write_text(json.dumps(cfg))
    traffic = json.loads((ROOT / "bench/traffic/extreme_10k_b32.json").read_text())
    traffic.update(batch=64, toy={"n_samples": 600})
    (tmp_path / "bench/traffic/extreme_b64.json").write_text(json.dumps(traffic))
    wl = json.loads((ROOT / "bench/workloads/t4_500k.train_b32.json").read_text())
    wl.update(config="set-mlp-narrow", traffic="extreme_b64", why="a toy cell")
    (tmp_path / "bench/workloads/narrow.train_b64.json").write_text(json.dumps(wl))
    (tmp_path / "bench/metrics/toy_count.py").write_text("def read(tr):\n    return None\n")
    b["configs"].append({"name": "set-mlp-narrow", "source": "toy",
                         "file": "bench/configs/set-mlp-narrow.json", "reduced": [],
                         "why": "toy"})
    b["workloads"].append({"name": "narrow.train_b64", "config": "set-mlp-narrow",
                           "traffic": "extreme_b64", "chips": 1, "why": "a toy cell"})
    for m in b["end_to_end"]:
        if m["name"] == "train_samples_per_s":
            m["workloads"].append("narrow.train_b64")
    b["per_layer"].append({"name": "toy_count", "unit": "launches", "better": "lower",
                           "source": "device_trace", "layer": "step",
                           "moves": "train_samples_per_s", "workloads": ["narrow.train_b64"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(b))
    from bench.harness import Cell

    cell = Cell("narrow.train_b64", root=tmp_path)
    assert cell.metric_paths["toy_count"].parent == tmp_path / "bench/metrics"
    r = toy_run("narrow.train_b64", root=tmp_path)
    assert r["correct"] is True and r["attempted"] > 0
