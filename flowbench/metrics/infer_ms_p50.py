"""Median latency of every request in the window, host frames in to host flow out."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies_s, 50)) if run.latencies_s else None
