"""Device ms a training step in the program's device span
``unflow.dev.trainable_fwd``: the forward of the trainable stage's network.
The program's counter ``device_us.unflow.dev.trainable_fwd`` (CUDA timing
events around the region, recorded by every step and by every replay of its
CUDA graph) over ``device_steps``, the steps it was read in, over the run."""

from flowbench.program import counters


def read(run):
    found = counters(run, "train", "device_us.unflow.dev.trainable_fwd", "device_steps")
    if not found or not found[1]:
        return None
    return found[0] / found[1] / 1000.0
