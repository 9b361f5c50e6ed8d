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
gets and the requests, the requests whose frames were padded and the copied
bytes of ``Evaluator.predict_batch``.

:func:`device_span` times a region of a train step on the card: a pair of
CUDA timing events recorded on the current stream before and after it. The
events are ``external``, so that inside a CUDA graph's capture each becomes
a node of the graph and every replay records it again. A step's spans are
collected by :func:`device_step` and queued; :func:`read_device_steps`
reads each queued step once the device has passed its last event (a query,
never a wait) into the counters ``device_us.<name>`` (integer microseconds,
summed) and ``device_steps`` (the steps read). Outside a :func:`device_step`
and on the CPU a device span is a shared no-op context.
:func:`device_span_after_grad` starts a device span from a gradient hook on a
tensor, on autograd's device thread, and ends it with a named span of the
same step.
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
_DEVICE_OPEN: list | None = None  # the device spans of the step being recorded
_DEVICE_QUEUE: list[list] = []  # recorded steps not yet read, oldest first


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
    cap notwithstanding, and the counters, with every queued device step the
    device has passed read into them (read it after a synchronize to have
    them all)."""
    read_device_steps()
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


class _Step(list):
    """A step's device spans, in the order they end, and the spans started by
    a gradient hook that wait, by the name of the span they end with, for it
    to end."""

    __slots__ = ("waiting",)

    def __init__(self):
        super().__init__()
        self.waiting: dict[str, list] = {}


class _DeviceSpan:
    __slots__ = ("name", "start", "end", "step")

    def __init__(self, name: str, step: _Step):
        self.name = name
        self.step = step
        self.start = torch.cuda.Event(enable_timing=True, external=True)
        self.end = torch.cuda.Event(enable_timing=True, external=True)

    def __enter__(self):
        self.start.record()
        return self

    def __exit__(self, *exc):
        self.end.record()
        # in the order the spans end, so that a step's last one ends last; the
        # hooked spans that end with this one go just before it
        for hooked in self.step.waiting.pop(self.name, ()):
            hooked.end = self.end
            self.step.append(hooked)
        self.step.append(self)
        return False


class _AfterGrad:
    """A tensor's gradient hook that starts a device span once autograd has
    computed the gradient. It runs where autograd runs the node that takes
    the gradient: on the device's thread, on the stream of that node's
    forward (the capture stream, inside a CUDA graph's capture)."""

    __slots__ = ("span", "until")

    def __init__(self, span: _DeviceSpan, until: str):
        self.span = span
        self.until = until

    def __call__(self, grad):
        self.span.start.record()
        self.span.step.waiting.setdefault(self.until, []).append(self.span)


def device_span(name: str, like: torch.Tensor):
    """Context that times its body on the device of ``like`` into the step
    that :func:`device_step` records; a no-op outside one or on the CPU."""
    if _DEVICE_OPEN is None or not like.is_cuda:
        return _OFF
    return _DeviceSpan(name, _DEVICE_OPEN)


def device_span_after_grad(name: str, tensor: torch.Tensor, until: str) -> None:
    """Time on the device, into the step that :func:`device_step` records,
    from the moment autograd has computed ``tensor``'s gradient (a hook on
    the tensor) to the end of the step's device span ``until``. The span is
    read only if the hook ran before ``until`` ended. Nothing outside a
    :func:`device_step`, on the CPU or where ``tensor`` takes no gradient."""
    if _DEVICE_OPEN is None or not tensor.is_cuda or not tensor.requires_grad:
        return
    tensor.register_hook(_AfterGrad(_DeviceSpan(name, _DEVICE_OPEN), until))


@contextlib.contextmanager
def device_step(queue: bool = True):
    """Collect the device spans of the enclosed step; yields their list
    (filled as each span ends). With ``queue`` the step is queued for
    :func:`read_device_steps` when the block ends; a CUDA graph's capture
    keeps the list instead and queues it after each replay."""
    global _DEVICE_OPEN
    outer, spans = _DEVICE_OPEN, _Step()
    _DEVICE_OPEN = spans
    try:
        yield spans
    finally:
        _DEVICE_OPEN = outer
    if queue:
        queue_device_step(spans)


def queue_device_step(spans: list) -> None:
    """Queue a step's device spans, recorded or replayed, for reading."""
    if spans:
        _DEVICE_QUEUE.append(spans)


def read_device_steps(drop: list | None = None) -> None:
    """Add the times of every queued step whose last event the device has
    passed to the counters, oldest first, without waiting for the device;
    then forget ``drop`` if it is still queued (a graph about to record its
    events again)."""
    while _DEVICE_QUEUE and _DEVICE_QUEUE[0][-1].end.query():
        spans = _DEVICE_QUEUE.pop(0)
        times = [(f"device_us.{s.name}", round(1000 * s.start.elapsed_time(s.end))) for s in spans]
        with _LOCK:
            for name, us in times:
                _COUNTS[name] = _COUNTS.get(name, 0) + us
            _COUNTS["device_steps"] = _COUNTS.get("device_steps", 0) + 1
    if drop is not None:
        _DEVICE_QUEUE[:] = [s for s in _DEVICE_QUEUE if s is not drop]
