"""95th percentile of the latency of every request in the window."""

import numpy as np


def read(run):
    return 1e3 * float(np.percentile(run.latencies_s, 95)) if run.latencies_s else None
