"""What the program records of itself: the spans and counters of
``unflow_tpu_torch.utils.profiling.summary()``, read by the ``program_span``
and ``program_counter`` metrics.

The spans record only while a ``torch.profiler`` profile is on, which in a
``--trace 1`` run is the profiled stretch after the window; the counters
count over the whole run. Both are read beside the stretch's device trace:
a run without one (untraced, or with no device work) reads nothing, and so
does a program that records no such span or counter.
"""

from __future__ import annotations


def program_summary():
    """The program's ``summary()``, or None where it has none."""
    try:
        from unflow_tpu_torch.utils.profiling import summary
    except ImportError:
        return None
    return summary()


def summary(run, kind: str):
    if run.kind != kind or run.trace is None:
        return None
    return program_summary()


def span_ms(run, kind: str, name: str, per: str):
    """Host ms of the span ``name``'s self time per ``per`` span (a step, a
    request, a get), or None where either was not recorded."""
    s = summary(run, kind)
    if s is None:
        return None
    spans = s["spans"]
    if name not in spans or not spans.get(per, {}).get("count"):
        return None
    return spans[name]["self_ns"] / spans[per]["count"] / 1e6


def counters(run, kind: str, *names):
    """The values of the counters ``names``, or None where one is missing."""
    s = summary(run, kind)
    if s is None or any(n not in s["counters"] for n in names):
        return None
    return [s["counters"][n] for n in names]
