"""MiB copied between host and device per request over the run (the
program's counters ``infer.h2d_bytes`` and ``infer.d2h_bytes`` over
``infer.requests``)."""

from flowbench.program import counters


def read(run):
    values = counters(run, "infer", "infer.h2d_bytes", "infer.d2h_bytes", "infer.requests")
    if not values or not values[2]:
        return None
    return (values[0] + values[1]) / values[2] / 2**20
