"""The last line a run prints: its keys, the metrics of each trace setting,
and the numbers compared, each beside its limit, last."""

import json
import subprocess
import sys
from pathlib import Path

from flowbench import manifest as mf
from flowbench.tests.tiny import execute, session

ROOT = Path(__file__).resolve().parents[2]


def check_line(line, cell, trace):
    assert list(line)[-1] == "checks"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert isinstance(line["correct"], bool) and line["attempted"] > 0 and line["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(line["device"])
    e2e, layer = mf.metrics(mf.load(), cell)
    allowed = {m["name"]: m["unit"] for m in (layer if trace else e2e)}
    for name, m in line["metrics"].items():
        assert set(m) == {"value", "unit"} and m["unit"] == allowed[name]
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"}
    json.dumps(line)


def test_an_untraced_line_holds_the_end_to_end_metrics(tmp_path):
    line = execute(session("c-train-kitti", tmp_path, compute_dtype="float32"))
    check_line(line, "c-train-kitti", False)
    assert {"train_pairs_per_s", "train_peak_gib", "setup_s"} == set(line["metrics"])


def test_a_traced_line_holds_the_per_layer_metrics_it_can_read(tmp_path):
    line = execute(session("c-infer-kitti", tmp_path, trace=True, compute_dtype="float32"))
    check_line(line, "c-infer-kitti", True)
    assert "infer_ms_p50" not in line["metrics"]
    line = execute(session("c-train-kitti", tmp_path, trace=True, compute_dtype="float32"))
    check_line(line, "c-train-kitti", True)
    # the CPU has no device trace: only the host spans and their counts read
    assert {"host_step_ms.train", "input_wait_ms.train"} == set(line["metrics"])


def test_without_a_gpu_the_run_prints_nothing_and_fails():
    p = subprocess.run([sys.executable, "flowbench/run.py", "--workload", "c-train-kitti",
                        "--seed", str(2**31 + 3), "--seconds", "1", "--trace", "0"],
                       cwd=ROOT, capture_output=True, text=True, timeout=300,
                       env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert p.returncode != 0 and p.stdout == ""
