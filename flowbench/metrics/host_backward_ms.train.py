"""Host ms a training step in the program's span ``unflow.train.backward``
(its self time over the profiled stretch, per ``unflow.train.step``)."""

from flowbench.program import span_ms


def read(run):
    return span_ms(run, "train", "unflow.train.backward", "unflow.train.step")
