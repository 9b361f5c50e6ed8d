"""A cell of BENCHMARK.json at a size the CPU runs in seconds."""

from __future__ import annotations

import json
import time
from pathlib import Path

import torch

from flowbench import manifest as mf
from flowbench.session import Session

SMALL = {"height": 64, "width": 128, "batch_size": 2, "max_displacement": 4}
# out of BENCHMARK.json until its runs are steadier (PERF.md); its configuration
# and limits stay, so that it returns as entries, and these tests keep its path running
CSS = {"name": "css-train-kitti", "config": "unflow-css", "traffic": "kitti-packed-train",
       "chips": 1, "why": "csS training"}
SMALL_TRAFFIC = {"frame_hw": [70, 140], "drives": 2, "frames_per_drive": 5, "profile_steps": 2,
                 "profile_requests": 3, "warmup_requests": 1, "keep_every": 4}


def cell_config(cell_name: str) -> tuple[dict, dict]:
    """A cell and its configuration, from BENCHMARK.json or :data:`CSS`."""
    if cell_name == CSS["name"]:
        return CSS, json.loads((mf.HERE / "configs" / f"{CSS['config']}.json").read_text())
    m = mf.load()
    cell = mf.cell(m, cell_name)
    return cell, mf.config(m, cell["config"])


def session(cell_name: str, workdir: Path, seed: int = 2**31 + 11, trace: bool = False,
            seconds: float = 1.0, **train_keys) -> Session:
    cell, config = cell_config(cell_name)
    return Session(cell=cell, config=config,
                   traffic={**mf.traffic(cell["traffic"]), **SMALL_TRAFFIC}, seed=seed,
                   seconds=seconds, trace=trace, device=torch.device("cpu"), workdir=workdir,
                   t0=time.time(), overrides={**SMALL, **train_keys})


def execute(s):
    """The result line of a run of ``s``, as ``flowbench/run.py`` prints it."""
    from flowbench.run import execute as run_cell

    e2e, layer = mf.metrics(mf.load(), s.cell["name"])
    return run_cell(s, e2e, layer)
