"""Share (%) of the traced stretch of serving in which the chip ran no kernel,
copy or set."""

from flowbench.readers import idle_share


def read(run):
    return idle_share(run) if run.kind == "infer" else None
