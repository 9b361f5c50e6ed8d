"""Host time inside Trainer.train_step per step: it returns without waiting
for the device, so this is the cost of dispatching a step."""

from flowbench.readers import mean_ms


def read(run):
    return mean_ms(run, "train_step")
