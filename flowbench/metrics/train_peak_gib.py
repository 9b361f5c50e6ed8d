"""Peak device memory allocated during the window, on the fullest chip, in GiB."""


def read(run):
    return run.peak_bytes / 2**30 if run.kind == "train" else None
