"""flowbench/flops.py against arithmetic by hand."""

from flowbench.flops import infer_flops, stage_flops, train_step_flops


def conv(b, h, w, cout, cin, k):
    return 2 * b * h * w * cout * cin * k * k


def deconv(b, h_in, w_in, cin, cout):
    return 2 * b * h_in * w_in * cin * cout * 16


def flownet_c_64(rows):
    """FlowNetC's forward on ``rows`` inputs of 64x64, layer by layer."""
    first = conv(rows, 32, 32, 64, 3, 7)
    convs = (conv(rows, 16, 16, 128, 64, 5) + conv(rows, 8, 8, 256, 128, 5)
             + conv(rows, 8, 8, 32, 256, 1) + conv(rows, 8, 8, 256, 441 + 32, 3)
             + conv(rows, 4, 4, 512, 256, 3) + conv(rows, 4, 4, 512, 512, 3)
             + conv(rows, 2, 2, 512, 512, 3) + conv(rows, 2, 2, 512, 512, 3)
             + conv(rows, 1, 1, 1024, 512, 3) + conv(rows, 1, 1, 1024, 1024, 3))
    heads = (conv(rows, 1, 1, 2, 1024, 3) + conv(rows, 2, 2, 2, 1026, 3)
             + conv(rows, 4, 4, 2, 770, 3) + conv(rows, 8, 8, 2, 386, 3)
             + conv(rows, 16, 16, 2, 194, 3))
    deconvs = (deconv(rows, 1, 1, 1024, 512) + deconv(rows, 1, 1, 2, 2)
               + deconv(rows, 2, 2, 1026, 256) + deconv(rows, 2, 2, 2, 2)
               + deconv(rows, 4, 4, 770, 128) + deconv(rows, 4, 4, 2, 2)
               + deconv(rows, 8, 8, 386, 64) + deconv(rows, 8, 8, 2, 2))
    corr = 2 * rows * 8 * 8 * 441 * 256
    return first, convs + heads + deconvs, corr


def test_one_conv_one_transposed_conv_and_the_correlation():
    f = stage_flops("C", 3, 2, 64, 64, 21)
    first, rest, corr = flownet_c_64(2)
    assert f == {"first": first, "convs": rest, "corr": corr}
    # a lone layer each, as a reader would check it
    assert conv(1, 32, 32, 64, 3, 7) == 2 * 32 * 32 * 64 * 3 * 49
    assert deconv(1, 1, 1, 1024, 512) == 2 * 1024 * 512 * 16


def test_training_counts_gradients_but_not_into_the_images():
    first, rest, corr = flownet_c_64(2 * 3)
    assert train_step_flops("C", 3, 64, 64) == 2 * first + 3 * rest + 3 * corr


def test_frozen_stages_count_their_forward_only():
    c = stage_flops("C", 3, 4, 64, 64, 21)
    s = stage_flops("S", 12, 4, 64, 64, 21)
    assert s["corr"] == 0
    assert train_step_flops("csS", 2, 64, 64) == (
        sum(c.values()) + sum(s.values()) + 2 * s["first"] + 3 * s["convs"])


def test_inference_runs_the_tower_on_both_frames():
    first, rest, corr = flownet_c_64(1)
    two = stage_flops("C", 3, 2, 64, 64, 21, corr_rows=1)
    tower = (conv(1, 16, 16, 128, 64, 5) + conv(1, 8, 8, 256, 128, 5))
    assert two["first"] == 2 * first
    assert two["convs"] == rest + tower
    assert infer_flops("C", 1, 64, 64) == sum(two.values())
