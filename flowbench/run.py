"""Run one cell of BENCHMARK.json once on this machine's GPUs and print one
JSON line last.

    python3 flowbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell names its configuration (``configs/<name>.json``), its traffic
(``traffic/<name>.json``, whose ``driver`` is a module of
``flowbench/drivers``) and its chips; its metrics are read by
``metrics/<name>.py``. With ``--trace 0`` the line holds the cell's
end-to-end metrics, with ``--trace 1`` its per-layer ones. It runs cells on
one chip. Without as many CUDA devices as the cell asks for, it prints
nothing and exits with 2; if JAX or the JAX package is loaded once the
window has closed, it names them and exits with 3.
"""

from __future__ import annotations

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "unflow_tpu")


def forbidden_modules(modules=None) -> list[str]:
    """Loaded modules whose top-level name is one of :data:`FORBIDDEN`."""
    modules = sys.modules if modules is None else modules
    return sorted(m for m in modules if m.split(".")[0] in FORBIDDEN)


def parse(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def execute(session, e2e: list, layer: list) -> dict:
    """Run the cell's driver; the result line (a dict)."""
    import importlib

    import torch

    from flowbench import check
    from flowbench.manifest import limits, reader
    from flowbench.peaks import peaks

    driver = importlib.import_module(f"flowbench.drivers.{session.traffic['driver']}")
    run, out = driver.run(session)
    name = torch.cuda.get_device_name(session.device) if session.device.type == "cuda" else "cpu"
    found = peaks(name)
    if found:
        run.peak_flops, run.bytes_per_s = found
    wanted = layer if session.trace else e2e
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    ok, checks = check.verdict(out["numbers"], limits(session.cell["name"]))
    device = {"platform": "gpu" if session.device.type == "cuda" else session.device.type,
              "kind": name, "count": run.chips, "memory_peak_bytes": run.peak_bytes,
              "power_limit_w": power_limit()}
    if session.trace and out["busy"]:
        device["busy_s"] = sum(b for b, _ in out["busy"]) / len(out["busy"])
        device["window_s"] = sum(w for _, w in out["busy"]) / len(out["busy"])
    result = {"correct": ok, "attempted": out["attempted"], "failed": 0, "metrics": metrics,
              "device": device}
    if session.trace and run.trace is not None:
        result["breakdown"] = run.trace.breakdown()
    result["checks"] = checks
    return result


def power_limit():
    """The card's power limit in W as nvidia-smi reads it, or None."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit", "--format=csv,noheader,nounits",
                              "-i", "0"], capture_output=True, text=True, timeout=20)
        return float(out.stdout.split()[0])
    except (OSError, ValueError, IndexError, subprocess.SubprocessError):
        return None


def main(argv=None) -> int:
    args = parse(argv)
    from flowbench import manifest as mf

    manifest = mf.load()
    cell = mf.cell(manifest, args.workload)
    if cell["chips"] != 1:
        print(f"flowbench: {args.workload} asks for {cell['chips']} chips; "
              "the harness runs cells on one", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print(f"flowbench: {args.workload} needs a CUDA device, found none", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    workdir = tempfile.mkdtemp(prefix="flowbench-")
    from flowbench.session import Session

    try:
        session = Session(cell=cell, config=mf.config(manifest, cell["config"]),
                          traffic=mf.traffic(cell["traffic"]), seed=args.seed,
                          seconds=args.seconds, trace=bool(args.trace),
                          device=torch.device("cuda", 0), workdir=Path(workdir), t0=T0)
        e2e, layer = mf.metrics(manifest, cell["name"])
        result = execute(session, e2e, layer)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    bad = forbidden_modules()
    if bad:
        print(f"flowbench: loaded in the measuring process: {', '.join(bad)}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
