"""Share (%) of the chip's bf16 peak reached by flowbench/flops.py's count of a
request's forward."""

from flowbench.readers import mfu


def read(run):
    return mfu(run) if run.kind == "infer" else None
