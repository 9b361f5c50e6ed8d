"""Structured metrics logging: one JSON record per display interval in
``metrics.jsonl`` (machine-readable) plus a brief line on stderr. A copy of
``unflow_tpu/utils/logging.py``."""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path


class MetricsLogger:
    def __init__(self, directory: str | Path, filename: str = "metrics.jsonl"):
        self._path = Path(directory) / filename
        self._path.parent.mkdir(parents=True, exist_ok=True)
        self._file = open(self._path, "a")
        self._t0 = time.time()

    def log(self, step: int, metrics: dict, echo: bool = True) -> None:
        record = {"step": int(step), "time": round(time.time() - self._t0, 3)}
        for key, value in metrics.items():
            try:
                record[key] = float(value)
            except (TypeError, ValueError):
                record[key] = str(value)
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()
        if echo:
            brief = {k: v for k, v in record.items() if "/" not in k}
            print(
                " ".join(
                    f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                    for k, v in brief.items()
                ),
                file=sys.stderr,
            )

    def close(self):
        self._file.close()
