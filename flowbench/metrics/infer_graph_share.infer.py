"""Share (%) of the requests over the run whose forward was replayed as a CUDA
graph (the program's counters ``infer.graph_replays`` and ``infer.requests``;
a program that does not count replays reads nothing)."""

from flowbench.program import counters


def read(run):
    got = counters(run, "infer", "infer.requests", "infer.graph_replays")
    if not got or not got[0]:
        return None
    requests, replays = got
    return 100.0 * replays / requests
