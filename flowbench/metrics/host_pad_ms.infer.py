"""Host ms a request in the program's span ``unflow.infer.pad`` (its
self time over the profiled stretch, per ``unflow.infer.request``)."""

from flowbench.program import span_ms


def read(run):
    return span_ms(run, "infer", "unflow.infer.pad", "unflow.infer.request")
