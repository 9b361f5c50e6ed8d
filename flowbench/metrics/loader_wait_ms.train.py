"""Host ms the training loop waits in the Loader's queue per get (the
program's span ``unflow.loader.wait`` over the profiled stretch)."""

from flowbench.program import span_ms


def read(run):
    return span_ms(run, "train", "unflow.loader.wait", "unflow.loader.wait")
