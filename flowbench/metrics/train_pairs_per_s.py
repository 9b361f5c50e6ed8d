"""Image pairs of the global batch completed per second over the whole window."""


def read(run):
    return run.units * run.pairs_per_unit / run.window_s if run.kind == "train" else None
