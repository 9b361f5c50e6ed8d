"""UnFlow-csS (frozen FlowNetC, frozen FlowNetS, trainable FlowNetS) trained by
the port's ``Trainer`` through the benchmark's own path (``flowbench/drivers/
train.py``: synthetic drives packed and fed by the ``Loader``), held against
the benchmark's plain reference (``flowbench/reference/``, plain PyTorch that
imports nothing of the port) over the same three steps from the same seeded
random weights, at a tiny size on the CPU.

The numbers are those that decide the cell ``css-train-kitti``'s ``correct``
(``flowbench/check.py``): ``loss_gap`` of the three losses, ``grad_gap`` of
the first gradient's norm leaf by leaf, ``change_gap`` of each leaf's change
after step 3. They run in float32 here: the cell's limits hold bf16 at the
cell's own size (16 directed pairs at 320x1152), and a tiny bf16 step reads
above them (1.6e-3 on ``loss_gap``, 8.3e-2 on ``grad_gap`` on two of these
seeds), while in float32 both sides compute the same function and differ by
the order of float32 sums alone.
"""

import pytest

from flowbench import check, manifest
from flowbench.drivers import train
from flowbench.tests.tiny import session
from unflow_tpu_torch.utils.profiling import counts

# float32 on both sides, so what separates them is the order of float32 sums
# (the port's convs, correlation and loss against the reference's plain ones).
# The loss is a mean over every pixel: 3e-7 to 6e-7 read on three seeds, so
# 1e-5 leaves 15x.
LOSS_GAP = 1e-5
# a leaf's gradient norm is a sum over the whole batch's pixels; its worst
# leaf read 4e-5 to 1.1e-4, so 1e-3 leaves 9x
GRAD_GAP = 1e-3
# Adam's first updates are close to lr * sign(g), so a gradient element near
# zero whose sign the sums' order flips moves its leaf's change by up to 2 lr:
# the worst leaf read 2.9e-4 to 1.4e-3, so 1e-2 leaves 7x
CHANGE_GAP = 1e-2


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_the_css_trainer_follows_the_plain_reference_in_float32(tmp_path, seed):
    s = session("css-train-kitti", tmp_path, seed=seed, compute_dtype="float32")
    before = {k: v for k, v in counts().items() if k.startswith("device_")}
    st = train.setup(s)  # the Trainer's three checked steps and two more
    train.teardown(s, st)
    batches = train.reference_batches(st["drives"], st["pairs"], st["fed"], st["hw"])
    assert batches is not None  # every fed row is one of the packed pairs
    numbers = check.train_numbers(st["program"], train.reference_result(s, st["weights"],
                                                                        batches))
    assert numbers["loss_gap"] <= LOSS_GAP, numbers
    assert numbers["grad_gap"] <= GRAD_GAP, numbers
    assert numbers["change_gap"] <= CHANGE_GAP, numbers
    # and within the cell's committed limits, which a run on the card holds
    ok, checks = check.verdict(numbers, manifest.limits("css-train-kitti"))
    assert ok, checks
    # on the CPU the stages' device spans are no-ops: no counter moved
    assert {k: v for k, v in counts().items() if k.startswith("device_")} == before
