"""Share (%) of the train steps over the run whose update was replayed as a
CUDA graph (the program's counters ``train.graph_replays`` and
``train.steps``; a program that counts steps and never replays reads 0)."""

from flowbench.program import counters


def read(run):
    steps = counters(run, "train", "train.steps")
    if not steps or not steps[0]:
        return None
    replays = counters(run, "train", "train.graph_replays")
    return 100.0 * (replays[0] if replays else 0) / steps[0]
