"""Host time blocked in the Loader's next batch, per step."""

from flowbench.readers import mean_ms


def read(run):
    return mean_ms(run, "input")
