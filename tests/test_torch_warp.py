"""Port's warps against the JAX package's: the backward warp's values and both
gradients, against the 4-tap reference ``backward_warp_jnp`` and the default
packed route, and the forward splat's (``forward_warp``,
``forward_warp_image``) values and gradients, with flows that leave the frame
on every side and a 1x2 map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.warp import backward_warp as backward_warp_jax
from unflow_tpu.ops.warp import backward_warp_jnp
from unflow_tpu.ops.warp import forward_warp as forward_warp_jax
from unflow_tpu.ops.warp import forward_warp_image as forward_warp_image_jax
from unflow_tpu_torch.ops.warp import backward_warp, forward_warp, forward_warp_image

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2).contiguous()


def _nhwc(t):
    return t.permute(0, 2, 3, 1).detach().numpy()


def _case(name):
    """(image, flow) in NHWC numpy. Flows stay off the integer lattice, where
    floor() has a kink and the two frameworks may pick either side."""
    rng = np.random.RandomState(0)
    if name == "inside":
        im = rng.randn(2, 6, 8, 3)
        flow = rng.uniform(-1.4, 1.4, (2, 6, 8, 2))
    elif name == "leaves_frame":  # up to 6 px past every border of a 6x8 frame
        im = rng.randn(2, 6, 8, 5)
        flow = rng.uniform(-6.0, 6.0, (2, 6, 8, 2))
        flow[0, :, :, 0] -= 7.0  # all of example 0 samples left of the frame
        flow[1, :, :, 1] += 7.0  # all of example 1 samples below it
    elif name == "1x2":  # the coarsest loss scale of a 64x128 crop
        im = rng.randn(2, 1, 2, 5)
        flow = rng.uniform(-1.5, 1.5, (2, 1, 2, 2))
    else:
        raise KeyError(name)
    flow = np.where(np.abs(flow - np.round(flow)) < 0.05, flow + 0.1, flow)
    return im.astype(np.float32), flow.astype(np.float32)


CASES = ["inside", "leaves_frame", "1x2"]


@pytest.mark.parametrize("reference", [backward_warp_jnp, backward_warp_jax], ids=["jnp", "packed"])
@pytest.mark.parametrize("case", CASES)
def test_backward_warp_values_match_jax(case, reference):
    im, flow = _case(case)
    want = np.asarray(reference(jnp.asarray(im), jnp.asarray(flow)))
    got = _nhwc(backward_warp(_nchw(im), _nchw(flow)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("reference", [backward_warp_jnp, backward_warp_jax], ids=["jnp", "packed"])
@pytest.mark.parametrize("case", CASES)
def test_backward_warp_gradients_match_jax(case, reference):
    im, flow = _case(case)
    proj = np.random.RandomState(1).randn(*im.shape).astype(np.float32)
    want_im, want_flow = jax.grad(
        lambda a, f: jnp.sum(reference(a, f) * proj), argnums=(0, 1)
    )(jnp.asarray(im), jnp.asarray(flow))
    t_im, t_flow = _nchw(im).requires_grad_(), _nchw(flow).requires_grad_()
    (backward_warp(t_im, t_flow) * _nchw(proj)).sum().backward()
    np.testing.assert_allclose(_nhwc(t_im.grad), np.asarray(want_im), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(t_flow.grad), np.asarray(want_flow), rtol=1e-4, atol=1e-4)


def test_backward_warp_keeps_coordinates_in_f32():
    # bf16 cannot hold column 300: the taps must come from f32 coordinates
    im = torch.arange(320, dtype=torch.float32).reshape(1, 1, 1, 320).bfloat16()
    flow = torch.zeros(1, 2, 1, 320, dtype=torch.bfloat16)
    assert torch.equal(backward_warp(im, flow), im)


def test_backward_warp_rejects_mismatched_flow():
    with pytest.raises(ValueError, match="does not fit"):
        backward_warp(torch.zeros(1, 3, 4, 4), torch.zeros(1, 2, 4, 5))


@pytest.mark.parametrize("case", CASES)
def test_forward_warp_values_match_jax(case):
    """The splat density and the splatted image, float32 at 1e-5: up to four
    taps land on a pixel, summed in another order."""
    im, flow = _case(case)
    want = np.asarray(forward_warp_jax(jnp.asarray(flow)))
    got = _nhwc(forward_warp(_nchw(flow)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    want = np.asarray(forward_warp_image_jax(jnp.asarray(im), jnp.asarray(flow)))
    got = _nhwc(forward_warp_image(_nchw(im), _nchw(flow)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("sign", [1.0, -1.0], ids=["right_bottom", "left_top"])
def test_forward_warp_drops_the_mass_that_leaves_the_frame(sign):
    """A uniform flow of (0.25, 0.5) px pushes a quarter of the last column's
    mass and half of the last row's out of a 6x8 frame (the first ones' with
    the sign flipped): dropped, never clamped onto the border, so the density
    sums to (7 + 0.75) * (5 + 0.5) of the 48 pixels."""
    flow = torch.empty(1, 2, 6, 8)
    flow[:, 0], flow[:, 1] = sign * 0.25, sign * 0.5
    density = forward_warp(flow)
    assert density.sum().item() == 7.75 * 5.5
    assert torch.equal(forward_warp(torch.zeros(1, 2, 6, 8)), torch.ones(1, 1, 6, 8))


@pytest.mark.parametrize("case", CASES)
def test_forward_warp_gradients_match_jax(case):
    im, flow = _case(case)
    proj = np.random.RandomState(2).randn(*im.shape).astype(np.float32)
    proj1 = proj[..., :1]
    want_flow = jax.grad(lambda f: jnp.sum(forward_warp_jax(f) * proj1))(jnp.asarray(flow))
    t_flow = _nchw(flow).requires_grad_()
    (forward_warp(t_flow) * _nchw(proj1)).sum().backward()
    np.testing.assert_allclose(_nhwc(t_flow.grad), np.asarray(want_flow), rtol=1e-4, atol=1e-4)

    want_im, want_flow = jax.grad(
        lambda a, f: jnp.sum(forward_warp_image_jax(a, f) * proj), argnums=(0, 1)
    )(jnp.asarray(im), jnp.asarray(flow))
    t_im, t_flow = _nchw(im).requires_grad_(), _nchw(flow).requires_grad_()
    (forward_warp_image(t_im, t_flow) * _nchw(proj)).sum().backward()
    np.testing.assert_allclose(_nhwc(t_im.grad), np.asarray(want_im), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(_nhwc(t_flow.grad), np.asarray(want_flow), rtol=1e-4, atol=1e-4)
