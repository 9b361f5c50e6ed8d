"""Share (%) of the traced stretch of training in which the lead chip ran no
kernel, copy or set."""

from flowbench.readers import idle_share


def read(run):
    return idle_share(run) if run.kind == "train" else None
