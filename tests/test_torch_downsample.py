"""Port's downsample ops against the JAX package's (NCHW against NHWC)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from unflow_tpu.ops.downsample import downsample as downsample_jax
from unflow_tpu.ops.downsample import downsample_flow as downsample_flow_jax
from unflow_tpu.ops.downsample import upsample2x_bilinear as upsample2x_bilinear_jax
from unflow_tpu_torch.ops.downsample import downsample, downsample_flow, upsample2x_bilinear

torch.set_num_threads(1)


def _nchw(x):
    return torch.from_numpy(x).permute(0, 3, 1, 2)


def _nhwc(t):
    return t.permute(0, 2, 3, 1).float().numpy()


@pytest.mark.parametrize("factor", [1, 2, 4])
def test_downsample_matches_jax(factor):
    x = np.random.RandomState(0).randn(2, 8, 12, 3).astype(np.float32)
    want = np.asarray(downsample_jax(jnp.asarray(x), factor))
    np.testing.assert_allclose(_nhwc(downsample(_nchw(x), factor)), want, rtol=1e-6, atol=1e-6)


def test_downsample_sums_bf16_in_f32():
    # tolerance: one bf16 rounding of the result (2^-8 relative)
    x = np.random.RandomState(1).randn(1, 8, 8, 2).astype(np.float32)
    want = np.asarray(downsample_jax(jnp.asarray(x).astype(jnp.bfloat16), 4).astype(jnp.float32))
    got = downsample(_nchw(x).bfloat16(), 4)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(_nhwc(got), want, rtol=2**-7, atol=1e-6)
    exact = downsample(_nchw(x).bfloat16().float(), 4).bfloat16()
    assert torch.equal(got, exact)


def test_downsample_rejects_indivisible_shapes():
    with pytest.raises(ValueError, match="not divisible"):
        downsample(torch.zeros(1, 2, 6, 9), 2)


@pytest.mark.parametrize("rescale", [False, True])
def test_downsample_flow_matches_jax(rescale):
    x = np.random.RandomState(2).randn(2, 8, 12, 2).astype(np.float32)
    want = np.asarray(downsample_flow_jax(jnp.asarray(x), 2, rescale=rescale))
    got = downsample_flow(_nchw(x), 2, rescale=rescale)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-6, atol=1e-6)


def test_upsample2x_bilinear_matches_jax():
    x = np.random.RandomState(3).randn(2, 5, 7, 2).astype(np.float32)
    want = np.asarray(upsample2x_bilinear_jax(jnp.asarray(x)))
    got = upsample2x_bilinear(_nchw(x))
    assert got.shape == (2, 2, 10, 14)
    np.testing.assert_allclose(_nhwc(got), want, rtol=1e-5, atol=1e-5)
