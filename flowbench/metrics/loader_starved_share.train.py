"""Share (%) of the Loader's gets over the run that found no batch ready (the
program's counters ``loader.starved`` and ``loader.gets``)."""

from flowbench.program import counters


def read(run):
    values = counters(run, "train", "loader.starved", "loader.gets")
    if not values or not values[1]:
        return None
    return 100.0 * values[0] / values[1]
