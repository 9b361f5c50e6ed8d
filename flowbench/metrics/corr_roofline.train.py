"""Share (%) of the correlation kernels' device time in a training step that
their least time would take (forward and both gradients)."""

from flowbench.readers import corr_roofline


def read(run):
    return corr_roofline(run) if run.kind == "train" else None
