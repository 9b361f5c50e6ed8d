"""Device ms a training step in the program's device span
``unflow.dev.cascade_bwd``: the backward pass from the last stage's input on,
that is the glue's backward and the earlier stages' (a stack whose earlier
stages are trainable). It starts when autograd has computed the gradient of
the last stage's 12-channel input and ends with ``unflow.dev.backward``. The
program's counter ``device_us.unflow.dev.cascade_bwd`` over ``device_steps``,
the steps it was read in, over the run."""

from flowbench.program import counters


def read(run):
    found = counters(run, "train", "device_us.unflow.dev.cascade_bwd", "device_steps")
    if not found or not found[1]:
        return None
    return found[0] / found[1] / 1000.0
