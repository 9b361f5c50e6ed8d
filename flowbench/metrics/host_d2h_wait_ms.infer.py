"""Host ms a request in the program's span ``unflow.infer.d2h``: the flow's
copy back, which first waits for the request's queued kernels (self time
over the profiled stretch, per ``unflow.infer.request``)."""

from flowbench.program import span_ms


def read(run):
    return span_ms(run, "infer", "unflow.infer.d2h", "unflow.infer.request")
