"""Profiling hooks: a ``torch.profiler`` trace around a block, and a synced
throughput meter.

Port of ``unflow_tpu/utils/profiling.py``. ``trace`` records the CPU's
activity and, when a GPU is present, the card's kernels, and writes a
Chrome trace (``trace.json``: open it in Perfetto or ``chrome://tracing``)
into ``log_dir``. ``StepTimer`` waits for the card before each reading, so
the time it reports is the time the queued work took, not the time it took
to enqueue it.
"""

from __future__ import annotations

import contextlib
import time
from pathlib import Path

import torch


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the enclosed block; on exit write ``<log_dir>/trace.json``.
    Yields the ``torch.profiler.profile`` (``key_averages()`` sums the
    recorded ops and kernels by name)."""
    log_dir = Path(log_dir)
    log_dir.mkdir(parents=True, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(str(log_dir / "trace.json"))


def _sync(sync_scalar=None) -> None:
    """Wait for the queued work: read ``sync_scalar`` back (as the JAX
    timer does), else synchronize the current CUDA device if there is one."""
    if sync_scalar is not None:
        float(sync_scalar)
    elif torch.cuda.is_available():
        torch.cuda.synchronize()


class StepTimer:
    """Items per second between ``start()`` and ``rate()``, each synced."""

    def __init__(self):
        self.reset()

    def reset(self) -> None:
        self._t0 = None
        self._items = 0

    def start(self, sync_scalar=None) -> None:
        _sync(sync_scalar)
        self._t0 = time.perf_counter()
        self._items = 0

    def tick(self, items: int) -> None:
        self._items += items

    def rate(self, sync_scalar=None) -> float:
        """Items per second since ``start()``; waits for the card first."""
        _sync(sync_scalar)
        return self._items / max(time.perf_counter() - self._t0, 1e-9)
