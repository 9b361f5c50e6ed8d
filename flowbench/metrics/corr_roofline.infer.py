"""Share (%) of the correlation forward's device time per request that its
least time would take."""

from flowbench.readers import corr_roofline


def read(run):
    return corr_roofline(run) if run.kind == "infer" else None
