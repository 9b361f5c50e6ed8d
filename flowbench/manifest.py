"""Everything a run needs, found by name: the cell in ``BENCHMARK.json``,
its configuration file, its traffic file (``traffic/<name>.json``), the
limits of its correctness check (``limits/<cell>.json``) and a reader per
metric (``metrics/<name>.py``, whose ``read(run)`` returns the value or
None). A configuration, a traffic mix, a cell or a metric is added as files
and entries; no file here changes."""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _named(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell(manifest: dict, name: str) -> dict:
    return _named(manifest["workloads"], name, "workload")


def config(manifest: dict, name: str, root: Path = ROOT) -> dict:
    entry = _named(manifest["configs"], name, "config")
    return json.loads((root / entry["file"]).read_text())


def traffic(name: str, here: Path = HERE) -> dict:
    return json.loads((here / "traffic" / f"{name}.json").read_text())


def limits(cell_name: str, here: Path = HERE) -> dict:
    return json.loads((here / "limits" / f"{cell_name}.json").read_text())


def metrics(manifest: dict, cell_name: str) -> tuple[list, list]:
    """The end-to-end and per-layer metrics the cell reports."""
    e2e = [m for m in manifest["end_to_end"] if cell_name in m.get("workloads", [cell_name])]
    names = {m["name"] for m in e2e}

    def reported(m):
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in names

    return e2e, [m for m in manifest["per_layer"] if reported(m)]


def reader(name: str, here: Path = HERE):
    """The ``read(run)`` function of ``metrics/<name>.py``."""
    path = here / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"flowbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read
