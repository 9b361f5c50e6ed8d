"""Profiling hooks: a ``torch.profiler`` trace around a block, the port's
spans at its layer boundaries, and always-on host counters.

Port of ``unflow_tpu/utils/profiling.py``. ``trace`` records the CPU's
activity and, when a GPU is present, the card's kernels, and writes a
Chrome trace (``trace.json``: open it in Perfetto or ``chrome://tracing``)
into ``log_dir``.

:func:`span` marks a phase of the program (``unflow.train.loss``,
``unflow.infer.d2h``, ...). It records only while a ``torch.profiler``
profile is active (``trace``, or any other ``torch.profiler.profile``):
then it is a ``record_function`` annotation on the profiler's own timeline,
and a record in a bounded buffer with its thread, its start and end on the
clock of ``time.time_ns()`` (the profiler's time base), its parent on the
same thread and its ``unit`` (the step or request it belongs to). With no
profile active it costs one flag read and returns a shared no-op context.
:func:`summary` sums the spans by name: count, total and self time (total
less the time its children on the same thread cover).

:func:`count` adds to a registry of integer counters that is always on: the
correlation kernels' launches (``ops/cuda/correlation.py``), the Loader's
gets and the requests and copied bytes of ``Evaluator.predict_batch``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from pathlib import Path

import torch
from torch.autograd import profiler as _profiler

# records kept in the buffer; past it only the totals by name grow
SPAN_CAP = 100_000

_COUNTS: dict[str, int] = {}
_RECORDS: list[tuple] = []  # (name, thread, start_ns, end_ns, parent, unit)
_TOTALS: dict[str, list[int]] = {}  # name -> [count, total ns, self ns]
_LOCK = threading.Lock()
_LOCAL = threading.local()


@contextlib.contextmanager
def trace(log_dir: str | Path):
    """Profile the enclosed block; on exit write ``<log_dir>/trace.json``.
    Yields the ``torch.profiler.profile`` (``key_averages()`` sums the
    recorded ops and kernels by name). The port's spans record inside it and
    are named in ``trace.json``."""
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


class _Off:
    """The context of a span while no profile is active."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()


class _Span:
    __slots__ = ("name", "unit", "parent", "start", "children_ns", "annotation")

    def __init__(self, name: str, unit):
        self.name = name
        self.unit = unit

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        if self.unit is None and self.parent is not None:
            self.unit = self.parent.unit
        self.children_ns = 0
        self.annotation = torch.profiler.record_function(self.name)
        self.annotation.__enter__()
        stack.append(self)
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc):
        end = time.time_ns()
        self.annotation.__exit__(*exc)
        _stack().pop()
        total = end - self.start
        parent = self.parent
        if parent is not None:
            parent.children_ns += total
        with _LOCK:
            totals = _TOTALS.setdefault(self.name, [0, 0, 0])
            totals[0] += 1
            totals[1] += total
            totals[2] += total - self.children_ns
            if len(_RECORDS) < SPAN_CAP:
                _RECORDS.append((self.name, threading.get_ident(), self.start, end,
                                 None if parent is None else parent.name, self.unit))
        return False


def _stack() -> list:
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    return stack


def span(name: str, unit=None):
    """Context of the phase ``name``: a ``record_function`` annotation and a
    record while a ``torch.profiler`` profile is active, else nothing.
    ``unit`` names the step or request; a span without one takes its
    parent's."""
    if not _profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, unit)


def records() -> list[tuple]:
    """The buffered spans, oldest first, as ``(name, thread, start_ns,
    end_ns, parent, unit)``: at most :data:`SPAN_CAP` of them."""
    with _LOCK:
        return list(_RECORDS)


def summary() -> dict:
    """``{"spans": {name: {"count", "total_ns", "self_ns"}}, "counters":
    {name: value}}``: every span recorded since :func:`reset`, the buffer's
    cap notwithstanding, and the counters."""
    with _LOCK:
        spans = {name: {"count": c, "total_ns": t, "self_ns": s}
                 for name, (c, t, s) in _TOTALS.items()}
        counters = dict(_COUNTS)
    return {"spans": spans, "counters": counters}


def reset() -> None:
    """Forget the recorded spans (the counters stay)."""
    with _LOCK:
        _RECORDS.clear()
        _TOTALS.clear()


def count(name: str, n: int = 1) -> int:
    """Add ``n`` to the counter ``name``; its new value."""
    with _LOCK:
        value = _COUNTS[name] = _COUNTS.get(name, 0) + n
    return value


def counts() -> dict[str, int]:
    with _LOCK:
        return dict(_COUNTS)


def reset_counts(names) -> None:
    with _LOCK:
        for name in names:
            _COUNTS.pop(name, None)
