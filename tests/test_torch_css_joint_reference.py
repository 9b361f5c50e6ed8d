"""UnFlow-CSS trained end to end (FlowNetC, FlowNetS and a FlowNetS fed 12
channels, all three trainable) by the port's ``Trainer`` through the
benchmark's own path (``flowbench/drivers/train.py``: synthetic drives packed
and fed by the ``Loader``), held against the benchmark's plain reference
(``flowbench/reference/``, plain PyTorch that imports nothing of the port)
over the same three steps from the same seeded random weights, at a tiny size
on the CPU.

The numbers are those that decide the cell ``cssjoint-train-kitti``'s
``correct`` (``flowbench/check.py``): ``loss_gap`` of the three losses,
``grad_gap`` of the first gradient's norm leaf by leaf, ``change_gap`` of each
leaf's change after step 3. They run in float32, as for csS
(``test_torch_css_reference.py``): the cell's limits hold bf16 at the cell's
own size, and in float32 both sides compute the same function and differ by
the order of float32 sums alone. Here the gradient of the last stage's loss
crosses both glue blocks (the warp, the brightness error, the upsampled flow)
into the earlier stages, so every leaf of all three networks is compared.
"""

import pytest
import torch

from flowbench import check, manifest
from flowbench.drivers import train
from flowbench.tests.tiny import session
from unflow_tpu_torch.utils.profiling import counts

torch.set_num_threads(1)

CELL = "cssjoint-train-kitti"
# float32 on both sides, so what separates them is the order of float32 sums
# (the port's convs, correlation, warp and loss against the reference's plain
# ones), amplified by the step: trained end to end, this stack is far less
# well conditioned than csS. The reference against itself, its weights moved
# by 1e-7 of their size (float32's rounding), read a loss_gap of 3.3e-6 and
# 1.1e-5 on these seeds, a grad_gap of 2.3e-4 and 1.3e-3 (worst in the first
# two stages' decoder leaves, through the glue's backward) and a change_gap
# of 1.6e-3 and 2.3e-3; the port read 4.8e-6 and 5.9e-6, 3.7e-4 and 2.2e-3,
# 1.7e-3 and 2.2e-3. The port's glue alone (warp, brightness error, the
# upsampled flow) matches the reference's to 4e-6 in value and gradient.
# The loss's limit leaves 4.5x over the reference's own spread.
LOSS_GAP = 5e-5
# a leaf's gradient norm: 4.5x over the port's worst and 7.5x over the
# reference's own spread; a gradient that stopped at the glue reads 1
GRAD_GAP = 1e-2
# Adam's first updates are close to lr * sign(g), so a gradient element near
# zero whose sign the sums' order flips moves its leaf's change by up to 2 lr:
# 4.5x over the worst leaf read on either side
CHANGE_GAP = 1e-2


@pytest.mark.parametrize("seed", [2**31 + 11, 5])
def test_the_joint_css_trainer_follows_the_plain_reference_in_float32(tmp_path, seed):
    s = session(CELL, tmp_path, seed=seed, compute_dtype="float32")
    assert s.train_keys()["flownet"] == "CSS"
    before = {k: v for k, v in counts().items() if k.startswith("device_")}
    st = train.setup(s)  # the Trainer's three checked steps and two more
    names = [k for k, _ in st["trainer"].model.named_parameters()]
    train.teardown(s, st)
    batches = train.reference_batches(st["drives"], st["pairs"], st["fed"], st["hw"])
    assert batches is not None  # every fed row is one of the packed pairs
    reference = train.reference_result(s, st["weights"], batches)
    # every leaf of all three stages is trained and compared, and the last
    # stage's loss reaches each of them: through both glue blocks into the
    # first two networks
    assert set(st["program"]["grad_norms"]) == set(reference["grad_norms"]) == set(names)
    assert {k.split(".")[0] for k in names} == {"stage0_C", "stage1_S", "stage2_S"}
    assert all(v > 0 for v in reference["grad_norms"].values()), reference["grad_norms"]
    numbers = check.train_numbers(st["program"], reference)
    assert numbers["loss_gap"] <= LOSS_GAP, numbers
    assert numbers["grad_gap"] <= GRAD_GAP, numbers
    assert numbers["change_gap"] <= CHANGE_GAP, numbers
    # and within the cell's committed limits, which a run on the card holds
    ok, checks = check.verdict(numbers, manifest.limits(CELL))
    assert ok, checks
    # on the CPU the step's device spans are no-ops: no counter moved
    assert {k: v for k, v in counts().items() if k.startswith("device_")} == before
