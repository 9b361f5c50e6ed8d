"""Share (%) of the chips' bf16 peak reached by flowbench/flops.py's count of a
training step."""

from flowbench.readers import mfu


def read(run):
    return mfu(run) if run.kind == "train" else None
