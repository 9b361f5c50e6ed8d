"""On the card, at each one-chip cell's own size: the control (the reference
in fp8 in the program's place) and the planted faults fail the cell's
limits, and the program passes them.

    python -m pytest flowbench/tests/test_bench_control.py -q   # on a machine with a GPU
"""

import tempfile
import time
from pathlib import Path

import pytest
import torch

from flowbench import calibrate, manifest as mf
from flowbench.session import Session
from flowbench.tests.tiny import cell_config


def fails(numbers: dict, limits: dict) -> bool:
    return any(v > limits[k] for k, v in numbers.items())


@pytest.mark.cuda
@pytest.mark.parametrize("cell_name", ["c-train-kitti", "css-train-kitti", "c-infer-kitti"])
def test_the_control_and_the_faults_fail_and_the_program_passes(cell_name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    cell, config = cell_config(cell_name)
    traffic = mf.traffic(cell["traffic"])
    limits = mf.limits(cell_name)
    with tempfile.TemporaryDirectory() as workdir:
        s = Session(cell=cell, config=config, traffic=traffic,
                    seed=2**31 + 77, seconds=5.0, trace=False, device=torch.device("cuda", 0),
                    workdir=Path(workdir), t0=time.time())
        out = (calibrate.train_readings(s) if traffic["driver"] == "train"
               else calibrate.infer_readings(s))
    assert not fails(out["program"], limits), out
    assert fails(out["control"], limits), out
    for fault in ("half_batch", "altered"):
        if fault in out:
            assert fails(out[fault], limits), out
