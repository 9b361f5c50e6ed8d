"""The traffic generator: the same frames for one seed, others for another,
the same sizes for every seed."""

import torch

from flowbench.frames import make_drives

MOTION = {"max_translate_px": 4.0, "max_zoom": 0.01, "max_rotate_deg": 0.2}


def test_one_seed_repeats_exactly_and_another_differs():
    a = make_drives(7, 2, 3, (40, 72), MOTION, "cpu")
    b = make_drives(7, 2, 3, (40, 72), MOTION, "cpu")
    c = make_drives(2**31 + 7, 2, 3, (40, 72), MOTION, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 3, 40, 72, 3) == c.shape
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_consecutive_frames_differ_by_motion_not_by_content():
    d = make_drives(3, 1, 3, (64, 96), MOTION, "cpu")[0].float()
    step = (d[1] - d[0]).abs().mean()
    other = (d[0] - make_drives(4, 1, 1, (64, 96), MOTION, "cpu")[0, 0].float()).abs().mean()
    assert 0 < step < other
