"""Cells, configurations, traffic mixes and metrics are found by name: a new
one is files and entries, and no file changes."""

import json
import shutil
from pathlib import Path

from flowbench import manifest as mf

ROOT = Path(__file__).resolve().parents[2]


def test_every_cell_finds_its_files():
    m = mf.load()
    for cell in m["workloads"]:
        assert mf.config(m, cell["config"])["train"]
        assert mf.traffic(cell["traffic"])["driver"]
        assert set(mf.limits(cell["name"]))
        e2e, layer = mf.metrics(m, cell["name"])
        assert "setup_s" in {x["name"] for x in e2e} and len(e2e) >= 2 and layer
        for metric in e2e + layer:
            assert callable(mf.reader(metric["name"]))


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    here = tmp_path / "flowbench"
    shutil.copytree(ROOT / "flowbench", here, ignore=shutil.ignore_patterns("__pycache__"))
    m = mf.load()
    m["configs"].append({"name": "unflow-c-f32", "source": "https://arxiv.org/abs/1711.07837",
                         "file": "flowbench/configs/unflow-c-f32.json", "reduced": [],
                         "why": "TF32 off"})
    m["workloads"].append({"name": "c-train-f32", "config": "unflow-c-f32",
                           "traffic": "kitti-packed-train-small", "chips": 1, "why": "f32"})
    m["per_layer"].append({"name": "steps_seen", "unit": "steps", "better": "higher",
                           "source": "program_counter", "layer": "trainer",
                           "moves": "train_pairs_per_s", "workloads": ["c-train-f32"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(m))
    cfg = json.loads((here / "configs" / "unflow-c.json").read_text())
    cfg["train"]["compute_dtype"] = "float32"
    (here / "configs" / "unflow-c-f32.json").write_text(json.dumps(cfg))
    traffic = {**mf.traffic("kitti-packed-train"), "drives": 4}
    (here / "traffic" / "kitti-packed-train-small.json").write_text(json.dumps(traffic))
    (here / "metrics" / "steps_seen.py").write_text("def read(run):\n    return run.units\n")

    loaded = mf.load(tmp_path)
    cell = mf.cell(loaded, "c-train-f32")
    assert mf.config(loaded, cell["config"], tmp_path)["train"]["compute_dtype"] == "float32"
    assert mf.traffic(cell["traffic"], here)["drives"] == 4
    e2e, layer = mf.metrics(loaded, "c-train-f32")
    assert [x["name"] for x in layer] == ["steps_seen"]
    assert {x["name"] for x in e2e} == {"setup_s"}

    class Run:
        units = 17

    assert mf.reader("steps_seen", here)(Run) == 17
    # the cells already there report what they did
    assert mf.metrics(loaded, "c-train-kitti") == mf.metrics(mf.load(), "c-train-kitti")
