"""Port's backward warp against the JAX package's: values and both gradients,
against the 4-tap reference ``backward_warp_jnp`` and the default packed
route, with flows that leave the frame on every side and a 1x2 map."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.warp import backward_warp as backward_warp_jax
from unflow_tpu.ops.warp import backward_warp_jnp
from unflow_tpu_torch.ops.warp import backward_warp, forward_warp

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


def test_forward_warp_is_not_ported_yet():
    with pytest.raises(NotImplementedError, match="A9"):
        forward_warp(torch.zeros(1, 2, 4, 4))
