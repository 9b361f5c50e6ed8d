"""Process-level crash and resume of the port's train CLI: ``tests/
test_crash_resume.py``'s SIGKILL test on ``unflow_tpu_torch.cli.train``.

A run is killed with SIGKILL (no cleanup, perhaps in the middle of a
checkpoint's write) once a finished checkpoint exists, and restarted with the
same ``--ex``. It must resume from its last finished checkpoint, complete,
and end with the parameters and Adam's state of a run that was never
interrupted, bit for bit.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import time
from pathlib import Path

import torch

from unflow_tpu_torch.train import CheckpointManager

REPO = Path(__file__).resolve().parents[1]
NUM_ITERS, SAVE_INTERVAL = 6, 3


def _write_ini(tmp_path: Path) -> Path:
    path = tmp_path / "crash.ini"
    path.write_text("\n".join([
        "[dirs]",
        f"log = {tmp_path / 'log'}",
        "[train]",
        "dataset = synthetic",
        "flownet = S",
        "batch_size = 2",
        "height = 64",
        "width = 64",
        f"num_iters = {NUM_ITERS}",
        "display_interval = 1",
        f"save_interval = {SAVE_INTERVAL}",
        "image_summary_interval = -1",
        "compute_dtype = float32",
    ]) + "\n")
    return path


def _spawn(ini: Path, ex: str) -> subprocess.Popen:
    env = {**os.environ, "PYTHONPATH": str(REPO), "OMP_NUM_THREADS": "1"}
    return subprocess.Popen(
        [sys.executable, "-m", "unflow_tpu_torch.cli.train", "--config", str(ini), "--ex", ex,
         "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO,
    )


def _steps_logged(metrics: Path) -> list[int]:
    steps = []
    for line in metrics.read_text().splitlines() if metrics.exists() else []:
        try:
            steps.append(int(json.loads(line)["step"]))
        except (ValueError, KeyError):
            pass  # a torn last line from the kill
    return steps


def test_sigkill_mid_training_then_restart_completes(tmp_path):
    ini = _write_ini(tmp_path)
    crash_dir = tmp_path / "log" / "ex" / "crash"
    ckpts = CheckpointManager(crash_dir)
    whole = _spawn(ini, "whole")  # the uninterrupted run, beside the one killed
    proc = _spawn(ini, "crash")
    deadline = time.time() + 240
    try:
        while not ckpts.steps():
            assert proc.poll() is None, "run ended before it could be killed:\n" + (
                proc.communicate()[0][-2000:])
            assert time.time() < deadline, "no checkpoint in time"
            time.sleep(0.02)
    finally:
        if proc.poll() is None:
            proc.send_signal(signal.SIGKILL)
        proc.wait()
    assert proc.returncode == -signal.SIGKILL
    killed_at = max(_steps_logged(crash_dir / "metrics.jsonl") + ckpts.steps())
    assert killed_at < NUM_ITERS, "the run was to die mid-training"

    restart = _spawn(ini, "crash")
    out, _ = restart.communicate(timeout=240)
    assert restart.returncode == 0, out[-3000:]
    # resumed, not restarted: from a finished checkpoint no later than the
    # kill (a save in flight at the kill is a temporary file, never read)
    (start,) = [line for line in out.splitlines() if line.startswith("experiment crash: step ")]
    resumed = int(start.split("step ")[1].split(" ")[0])
    assert 0 < resumed <= killed_at and resumed % SAVE_INTERVAL == 0
    assert f"done at step {NUM_ITERS}" in out

    out_whole, _ = whole.communicate(timeout=240)
    assert whole.returncode == 0, out_whole[-3000:]
    want = CheckpointManager(tmp_path / "log" / "ex" / "whole").load()
    got = ckpts.load()
    assert got["step"] == want["step"] == NUM_ITERS
    assert list(got["model"]) == list(want["model"])
    for key, value in want["model"].items():
        assert torch.equal(got["model"][key], value), key
    for index, slot in want["optimizer"]["state"].items():
        for name, value in slot.items():
            assert torch.equal(got["optimizer"]["state"][index][name], value), (index, name)
    shutil.rmtree(tmp_path / "log")  # checkpoints of half a GB each
