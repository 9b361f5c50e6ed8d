"""Device time of host-device copies per request."""

from flowbench.readers import per_traced_unit_ms


def read(run):
    if run.kind != "infer" or run.trace is None:
        return None
    return per_traced_unit_ms(run, run.trace.groups.get("copy"))
