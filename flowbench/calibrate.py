"""Readings that the limits of ``limits/<cell>.json`` are set from, on the
chip, at the cell's own size, many seeds in one process.

    python3 flowbench/calibrate.py --workload <name> --seeds 1 2 3 ... [--seconds 10]

For each seed it prints one JSON line with the compared numbers of:

* ``program``: the program against the reference, as a run compares them;
* ``control``: the reference in fp8 (``reference/quant.py``) put in the
  program's place;
* the faults a cell can have, planted in the reference put in the program's
  place: ``half_batch`` (half of the batch's rows left out, the mean taken
  over the rest), ``altered`` (serving: every kept flow moved by one pixel
  along x where it is produced). A step that leaves the state unchanged
  reads 1 on ``change_gap`` without a run.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def train_readings(s) -> dict:
    from flowbench import check
    from flowbench.drivers import train

    st = train.setup(s)
    train.teardown(s, st)
    batches = train.reference_batches(st["drives"], st["pairs"], st["fed"], st["hw"])
    ref = train.reference_result(s, st["weights"], batches)
    return {"program": check.train_numbers(st["program"], ref),
            "control": check.train_numbers(
                train.reference_result(s, st["weights"], batches, precision="fp8"), ref),
            "half_batch": check.train_numbers(
                train.reference_result(s, st["weights"], batches, fault="half_batch"), ref)}


def infer_readings(s) -> dict:
    import numpy as np

    from flowbench import check
    from flowbench.drivers import infer

    st = infer.setup(s)
    w = infer.window(s, st)
    ids = [k for k, _ in w["kept"]]
    flows = [f for _, f in w["kept"]]
    ref = infer.reference_flows(s, st["weights"], st["ims"], ids)
    fp8 = infer.reference_flows(s, st["weights"], st["ims"], ids, precision="fp8")
    altered = [f + np.asarray([1.0, 0.0], np.float32) for f in flows]
    return {"program": {"flow_gap": check.flow_gap(flows, ref)},
            "control": {"flow_gap": check.flow_gap(fp8, ref)},
            "altered": {"flow_gap": check.flow_gap(altered, ref)},
            "requests": w["requests"], "compared": len(ids)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    args = ap.parse_args(argv)

    import torch

    from flowbench import manifest as mf
    from flowbench.session import Session

    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    traffic = mf.traffic(cell["traffic"])
    config = mf.config(manifest, cell["config"])
    for seed in args.seeds:
        with tempfile.TemporaryDirectory(prefix="flowbench-cal-") as workdir:
            s = Session(cell=cell, config=config, traffic=traffic, seed=seed,
                        seconds=args.seconds, trace=False, device=torch.device("cuda", 0),
                        workdir=Path(workdir), t0=time.time())
            a = time.time()
            out = (train_readings(s) if traffic["driver"] == "train"
                   else infer_readings(s))
            out.update(seed=seed, seconds=time.time() - a)
            print(json.dumps(out), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
