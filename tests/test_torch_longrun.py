"""The port's long-run stability run (``python -m unflow_tpu_torch.longrun``)
against ``scripts/longrun_stability.py``: its config (every train key the
script sets, at several step counts), its audit of ``metrics.jsonl`` (a gap,
an overlap, a missed halving and a non-finite loss are each caught), and a
shortened run on the CPU in three segment processes across both learning
rate halvings (10 steps at 64x128, batch 2, float32)."""

import importlib.util
import json
import math
import os
from pathlib import Path

import pytest
import torch

from unflow_tpu_torch import longrun

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


def _script():
    spec = importlib.util.spec_from_file_location("longrun_stability",
                                                  ROOT / "scripts" / "longrun_stability.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


@pytest.mark.parametrize("steps", [10, 12_500, 50_000])
def test_config_is_the_scripts(steps):
    want = _script().make_config(steps).train
    mine = longrun.make_config(steps).train
    for key in ("flownet", "height", "width", "batch_size", "num_iters", "learning_rate",
                "decay_after", "decay_interval", "display_interval", "save_interval",
                "eval_interval", "image_summary_interval", "compute_dtype"):
        assert getattr(mine, key) == getattr(want, key), key


def _rows(steps=10, display=1, lr=1e-4, decay_after=4, interval=2):
    sched = lambda s: lr * 0.5 ** max(0, (s - decay_after) // interval + 1)  # noqa: E731
    return [{"step": s, "loss": 300.0 - s, "grad_norm": 50.0, "lr": sched(s), "step_ms": 10.0}
            for s in range(display, steps + 1, display)]


def test_audit_catches_each_fault():
    cfg = longrun.make_config(10, (64, 128), 2, 1, "float32")
    bounds = longrun.segment_bounds(10, 3)
    out = longrun.audit(_rows(), cfg, bounds)
    assert out["lr_crossings"] == {"initial": 1e-4, "step_5": 5e-5, "step_7": 2.5e-5}
    assert out["logged_points"] == 10 and out["all_finite"]
    faults = {
        "a gap": [r for r in _rows() if r["step"] != 6],
        "an overlap": _rows() + [_rows()[3]],
        "a missed halving": [{**r, "lr": 1e-4} for r in _rows()],
        "a non-finite loss": [{**r, "loss": math.nan if r["step"] == 8 else r["loss"]}
                              for r in _rows()],
        "a non-finite grad_norm": [{**r, "grad_norm": math.inf if r["step"] == 2 else 1.0}
                                   for r in _rows()],
        "a short run": _rows(steps=9),
    }
    for name, rows in faults.items():
        with pytest.raises(RuntimeError):
            longrun.audit(rows, cfg, bounds)


def test_three_segment_run_across_both_halvings(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    out = tmp_path / "longrun.json"
    assert longrun.main(["--steps", "10", "--segments", "3", "--hw", "64", "128", "--batch",
                         "2", "--display-interval", "1", "--dtype", "float32", "--device",
                         "cpu", "--exp", str(tmp_path / "ex"), "--out", str(out)]) == 0
    summary = json.loads(out.read_text())
    assert summary["ok"] and summary["all_finite"]
    assert summary["resume_boundaries"] == [3, 6]
    assert summary["lr_crossings"] == {"initial": 1e-4, "step_5": 5e-5, "step_7": 2.5e-5}
    assert summary["logged_points"] == 10
    # each segment process records its kernel launches: none on the CPU,
    # where the correlation runs its plain version
    assert summary["kernel_launches"] == {}
    assert (tmp_path / "ex" / "launches.jsonl").read_text().splitlines() == ["{}"] * 3
    rows = [json.loads(line) for line in (tmp_path / "ex" / "metrics.jsonl").read_text()
            .splitlines()]
    assert [r["step"] for r in rows] == list(range(1, 11))  # no gap, no overlap
    assert json.loads((tmp_path / "ex" / "stability_summary.json").read_text()) == summary
    assert sorted(os.listdir(tmp_path / "ex" / "checkpoints")) == ["10.pt", "3.pt", "6.pt"]
