"""Host ms the Loader's producer thread takes to gather one batch (the
program's span ``unflow.loader.gather`` over the profiled stretch)."""

from flowbench.program import span_ms


def read(run):
    return span_ms(run, "train", "unflow.loader.gather", "unflow.loader.gather")
